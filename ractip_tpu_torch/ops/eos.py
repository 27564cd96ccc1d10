"""Energy evaluation of a fixed (joint) secondary structure by loop decomposition.

Equivalent of ViennaRNA's energy_of_structure as used by the reference for the
-e/--show-energy report and the z-score statistic (reference src/ractip.cpp:1254,
:1299, :1528-1558).  Supports a two-strand evaluation via `cut`: any loop whose
interior contains the cut point is scored as an exterior loop (the RNAcofold
convention), which is how the reference scores the hybridization energy e3
(reference src/ractip.cpp:1549-1556).

Dangle model: "dangles=2" (both dangles applied whenever the neighboring base
exists on the same strand), consistent with the partition-function DPs here.
Energies returned in dekacal/mol; divide by 100 for kcal/mol.
"""

from __future__ import annotations

import numpy as np

from ..constants import RTYPE
from ..params.tables import EnergyParams
from . import energy as E


def parse_pairs(struct: str, open_ch: str = "(", close_ch: str = ")") -> list[tuple[int, int]]:
    """Extract (i, j) pairs (0-based) for one bracket alphabet."""
    st: list[int] = []
    out: list[tuple[int, int]] = []
    for i, c in enumerate(struct):
        if c == open_ch:
            st.append(i)
        elif c == close_ch:
            if not st:
                raise ValueError(f"unbalanced '{close_ch}' at {i}")
            out.append((st.pop(), i))
    if st:
        raise ValueError(f"unbalanced '{open_ch}'")
    return sorted(out)


def _same_strand(i: int, j: int, cut: int | None) -> bool:
    return cut is None or (i < cut) == (j < cut)


def _neighbor(S: np.ndarray, i: int, cut: int | None) -> int:
    """Base code at i, or -1 if out of range or across the strand cut."""
    if i < 0 or i >= len(S):
        return -1
    return int(S[i])


def _dangle_ok(i: int, ref: int, n: int, cut: int | None) -> bool:
    """Neighbor position i exists and is on the same strand as position ref."""
    return 0 <= i < n and _same_strand(i, ref, cut)


def structure_energy(p: EnergyParams, S: np.ndarray,
                     pairs: list[tuple[int, int]], cut: int | None = None) -> float:
    """Free energy (dekacal) of the structure given by `pairs` over sequence S.

    `cut` is the 0-based index of the first base of strand 2 (None = single
    strand).  Pairs must be non-crossing.
    """
    n = len(S)
    pairs = sorted(pairs)
    partner = {}
    for i, j in pairs:
        partner[i] = j
        partner[j] = i

    def children_of(i: int, j: int) -> list[tuple[int, int]]:
        out = []
        k = i + 1
        while k < j:
            if k in partner and partner[k] > k:
                out.append((k, partner[k]))
                k = partner[k] + 1
            else:
                k += 1
        return out

    def stem_energy(k: int, l: int, exterior: bool) -> float:
        """Branch (k,l) seen from the enclosing loop (exterior or multiloop)."""
        t = E.pair_type(S[k], S[l])
        s5 = int(S[k - 1]) if _dangle_ok(k - 1, k, n, cut) else -1
        s3 = int(S[l + 1]) if _dangle_ok(l + 1, l, n, cut) else -1
        e = E.e_ext_stem(p, t, s5, s3)
        if not exterior:
            e += p.ml_intern
        return e

    def closing_stem_energy(i: int, j: int, exterior: bool) -> float:
        """Closing pair (i,j) seen from inside its loop (reversed orientation)."""
        t = E.pair_type(S[i], S[j])
        rt = RTYPE[t]
        s5 = int(S[j - 1]) if _dangle_ok(j - 1, j, n, cut) else -1
        s3 = int(S[i + 1]) if _dangle_ok(i + 1, i, n, cut) else -1
        e = E.e_ext_stem(p, rt, s5, s3)
        if not exterior:
            e += p.ml_intern
        return e

    def cut_in_loop(i: int, j: int, kids: list[tuple[int, int]]) -> bool:
        """Is the strand cut inside the loop closed by (i,j) (not inside a child)?"""
        if cut is None or not (i < cut <= j):
            return False
        return not any(k < cut <= l for k, l in kids)

    total = 0.0

    def loop_energy(i: int, j: int) -> float:
        kids = children_of(i, j)
        if cut_in_loop(i, j, kids):
            # loop containing the cut is scored as an exterior loop
            e = closing_stem_energy(i, j, exterior=True)
            for k, l in kids:
                e += stem_energy(k, l, exterior=True)
            return e
        if len(kids) == 0:
            return E.e_hairpin(p, S, i, j)
        if len(kids) == 1:
            k, l = kids[0]
            t = E.pair_type(S[i], S[j])
            t2 = E.pair_type(S[l], S[k])
            return E.e_intloop(p, k - i - 1, j - l - 1, t, t2,
                               int(S[i + 1]), int(S[j - 1]), int(S[k - 1]), int(S[l + 1]))
        # multiloop
        e = float(p.ml_closing) + closing_stem_energy(i, j, exterior=False)
        unpaired = j - i - 1
        for k, l in kids:
            e += stem_energy(k, l, exterior=False)
            unpaired -= l - k + 1
        e += p.ml_base * unpaired
        return e

    # exterior loop: top-level branches
    top = []
    k = 0
    while k < n:
        if k in partner and partner[k] > k:
            top.append((k, partner[k]))
            k = partner[k] + 1
        else:
            k += 1
    for k, l in top:
        total += stem_energy(k, l, exterior=True)
        # recurse into every pair below
    stack = list(top)
    while stack:
        i, j = stack.pop()
        total += loop_energy(i, j)
        stack.extend(children_of(i, j))

    return total


def duplex_structure_energy(p: EnergyParams, s1: np.ndarray, s2: np.ndarray,
                            r1: str, r2: str) -> float:
    """Energy e3 of the external ([]) pairs only, per reference src/ractip.cpp:1528-1558:
    '[' / ']' become a joint-structure pair across the cut; internal '(' ')' dropped."""
    rr = (r1 + r2).replace("(", ".").replace(")", ".")
    rr = rr.replace("[", "(").replace("]", ")")
    S = np.concatenate([s1, s2])
    pairs = parse_pairs(rr)
    return structure_energy(p, S, pairs, cut=len(s1))
