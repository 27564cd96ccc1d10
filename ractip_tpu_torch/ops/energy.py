"""Scalar nearest-neighbor loop energies (the model's single source of truth).

These are exact integer/float dekacal energies following the Vienna-1.8-era rules
that the reference's duplex DP spells out (reference src/pf_duplex.c:305-393) with
the BL* tables (reference src/boltzmann_param.c).  Every other component -- the
partition-function DPs, the structure-energy evaluator, and the brute-force test
oracles -- is defined in terms of these functions, so DP correctness can be
tested independently of parameter-set questions.

Conventions: sequences are 0-based int arrays (1=A..4=U); a pair (i, j) has i as
the 5' partner; `size` arguments count unpaired bases.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import INF, MAXLOOP, PAIR_TYPE
from ..params.tables import EnergyParams


def pair_type(a: int, b: int) -> int:
    return PAIR_TYPE[a][b]


def loop_extrapolate(table: np.ndarray, size: int, lxc: float) -> float:
    if size <= 30:
        return float(table[size])
    return float(table[30]) + lxc * math.log(size / 30.0)


def e_hairpin(p: EnergyParams, S: np.ndarray, i: int, j: int) -> float:
    """Hairpin loop closed by pair (i, j); requires j - i - 1 >= 3."""
    size = j - i - 1
    t = pair_type(S[i], S[j])
    if t == 0:
        return INF
    e = loop_extrapolate(p.hairpin, size, p.lxc)
    if size == 3:
        if t > 2:
            e += p.terminal_au
    else:
        e += p.mismatch_h[t, S[i + 1], S[j - 1]]
    if size == 4:
        key = 0
        for k in range(i, i + 6):
            key = key * 5 + int(S[k])
        hit = np.nonzero(p.tetraloop_keys == key)[0]
        if hit.size:
            e += p.tetraloop_bonus[hit[0]]
    return e


def e_intloop(p: EnergyParams, n1: int, n2: int, t: int, t2: int,
              si1: int, sj1: int, sp1: int, sq1: int) -> float:
    """Interior loop between outer pair (type t) and inner pair (type t2).

    n1/n2 are the unpaired counts on the 5'/3' side; si1, sj1 are the bases
    adjacent to the outer pair inside the loop; sp1, sq1 adjacent to the inner
    pair outside it.  Mirrors the LoopEnergy call pattern of
    reference src/pf_duplex.c:332-333.
    """
    if t == 0 or t2 == 0:
        return INF
    nl, ns = (n1, n2) if n1 >= n2 else (n2, n1)
    if nl == 0:
        return float(p.stack[t, t2])
    if ns == 0:  # bulge
        e = loop_extrapolate(p.bulge, nl, p.lxc)
        if nl == 1:
            e += p.stack[t, t2]
        else:
            if t > 2:
                e += p.terminal_au
            if t2 > 2:
                e += p.terminal_au
        return e
    if ns == 1 and nl == 1:
        return float(p.int11[t, t2, si1, sj1])
    if ns == 1 and nl == 2:
        if n1 == 1:
            return float(p.int21[t, t2, si1, sq1, sj1])
        return float(p.int21[t2, t, sq1, si1, sp1])
    if ns == 2 and nl == 2:
        return float(p.int22[t, t2, si1, sp1, sq1, sj1])
    e = loop_extrapolate(p.internal, n1 + n2, p.lxc)
    e += min(p.max_ninio, (nl - ns) * p.ninio_m)
    e += p.mismatch_i[t, si1, sj1]
    e += p.mismatch_i[t2, sq1, sp1]
    return e


def e_ext_stem(p: EnergyParams, t: int, s5: int, s3: int) -> float:
    """Exterior-loop helix end of pair type t with optional dangling neighbors.

    s5/s3 are the 5'/3' dangling bases, or -1 when absent (sequence boundary or
    strand cut).  "dangles=2" model: both contributions applied unconditionally
    when the neighbor exists, plus TerminalAU for non-CG/GC closings -- the exact
    rule at reference src/pf_duplex.c:322-325.
    """
    if t == 0:
        return INF
    e = 0.0
    if s5 >= 0:
        e += p.dangle5[t, s5]
    if s3 >= 0:
        e += p.dangle3[t, s3]
    if t > 2:
        e += p.terminal_au
    return e


def e_ml_stem(p: EnergyParams, t: int, s5: int, s3: int) -> float:
    """Multiloop branch of pair type t (ml_intern + dangles + TerminalAU)."""
    return p.ml_intern + e_ext_stem(p, t, s5, s3)


def boltz(p: EnergyParams, e: float) -> float:
    """Boltzmann factor of a dekacal energy at the parameter temperature."""
    from ..constants import GASCONST, K0

    kt = (p.temperature + K0) * GASCONST
    if e >= INF / 2:
        return 0.0
    return math.exp(-e * 10.0 / kt)


def kt_cal(p: EnergyParams) -> float:
    from ..constants import GASCONST, K0

    return (p.temperature + K0) * GASCONST
