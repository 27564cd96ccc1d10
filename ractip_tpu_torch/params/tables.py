"""Energy-parameter tables as a JAX pytree.

The default parameter set is the BL* set bundled by the reference
(reference src/boltzmann_param.c, applied over ViennaRNA's globals by
copy_boltzmann_parameters(), reference src/ractip.cpp:1566-1567).  The loop-energy
*rules* follow the Vienna-1.8-era model that the reference's own duplex code spells
out (reference src/pf_duplex.c:305-393): dangle5/dangle3 end contributions
("dangles=2" style), TerminalAU for non-CG closings, int11/int21/int22 special
cases, and generic interior loops with ninio asymmetry and mismatchI terms.

All energies are integers in dekacal/mol at 37C; INF marks forbidden entries.
Tables are padded so that pair-type index 0 (= "no pair") is a valid row holding
INF/0 as appropriate, letting downstream code gather without branching.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import INF, NBPAIRS
from . import bl_star_data as bl


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """Nearest-neighbor parameter tables, all numpy int32 in dekacal/mol.

    Index conventions (t = pair type 0..7, n = nucleotide 0..4):
      stack[t1][t2]        : stack of pair t1 on top of pair t2
      mismatch_h[t][n5][n3]: hairpin terminal mismatch
      mismatch_i[t][n5][n3]: interior-loop terminal mismatch
      dangle5[t][n]        : 5' dangle on pair t
      dangle3[t][n]        : 3' dangle on pair t
      int11[t1][t2][n][n]  : 1x1 interior loops
      int21[t1][t2][n][n][n]
      int22[t1][t2][n][n][n][n]
      hairpin/bulge/internal[size 0..30]
    """

    stack: np.ndarray
    mismatch_h: np.ndarray
    mismatch_i: np.ndarray
    dangle5: np.ndarray
    dangle3: np.ndarray
    int11: np.ndarray
    int21: np.ndarray
    int22: np.ndarray
    hairpin: np.ndarray
    bulge: np.ndarray
    internal: np.ndarray
    ml_base: int          # per unpaired base in a multiloop
    ml_closing: int       # multiloop closing penalty
    ml_intern: int        # per branch in a multiloop
    terminal_au: int
    ninio_m: int
    max_ninio: int
    lxc: float
    duplex_init: int
    temperature: float
    # tetraloop bonuses: 6-mer (closing pair + 4 loop bases) -> bonus energy
    tetraloop_keys: np.ndarray    # [T] int32, base-5 encoded 6-mers
    tetraloop_bonus: np.ndarray   # [T] int32


def _pad_pairtype_rows(a: np.ndarray, fill: int) -> np.ndarray:
    """Pad a table whose leading axes index pair types 1..7 to size 8 with `fill`."""
    out = a
    pad = [(1, 0)] + [(0, 0)] * (a.ndim - 1)
    out = np.pad(out, pad, constant_values=fill)
    return out


def _pad_nuc(a: np.ndarray, axes: tuple[int, ...], fill: int = 0) -> np.ndarray:
    """Pad nucleotide axes that start at 1 (int22) to include index 0."""
    pad = [(0, 0)] * a.ndim
    for ax in axes:
        pad[ax] = (1, 0)
    return np.pad(a, pad, constant_values=fill)


def encode_kmer(s: str) -> int:
    from ..constants import BASES

    v = 0
    for c in s:
        v = v * 5 + BASES.index(c)
    return v


def default_params() -> EnergyParams:
    """The BL* parameter set (reference defaults: --no-bl absent)."""
    stack = _pad_pairtype_rows(np.array(bl.stack, dtype=np.int32), INF)
    stack = np.pad(stack[:, :], ((0, 0), (1, 0)), constant_values=INF)  # col pad for t2=0
    mm_h = _pad_pairtype_rows(np.array(bl.mismatch_h, dtype=np.int32), 0)
    mm_i = _pad_pairtype_rows(np.array(bl.mismatch_i, dtype=np.int32), 0)
    d5 = np.array(bl.dangle5, dtype=np.int32)   # already [8,5]
    d3 = np.array(bl.dangle3, dtype=np.int32)
    int11 = _pad_pairtype_rows(np.array(bl.int11, dtype=np.int32), INF)
    int11 = np.pad(int11, ((0, 0), (1, 0), (0, 0), (0, 0)), constant_values=INF)
    int21 = _pad_pairtype_rows(np.array(bl.int21, dtype=np.int32), INF)
    int21 = np.pad(int21, ((0, 0), (1, 0)) + ((0, 0),) * 3, constant_values=INF)
    int22 = np.array(bl.int22, dtype=np.int32)          # [7,7,4,4,4,4]
    int22 = _pad_nuc(int22, (2, 3, 4, 5), 0)            # nucleotide axes -> 5
    int22 = _pad_pairtype_rows(int22, INF)
    int22 = np.pad(int22, ((0, 0), (1, 0)) + ((0, 0),) * 4, constant_values=INF)

    cu, cc, ci, term_au = bl.ml_params
    ninio_m, max_ninio = bl.ninio

    keys = np.array([encode_kmer(s) for s, _ in bl.tetraloops], dtype=np.int32)
    bonus = np.array([e for _, e in bl.tetraloops], dtype=np.int32)

    return EnergyParams(
        stack=stack,
        mismatch_h=mm_h,
        mismatch_i=mm_i,
        dangle5=d5,
        dangle3=d3,
        int11=int11,
        int21=int21,
        int22=int22,
        hairpin=np.array(bl.hairpin, dtype=np.int32),
        bulge=np.array(bl.bulge, dtype=np.int32),
        internal=np.array(bl.internal, dtype=np.int32),
        ml_base=cu,
        ml_closing=cc,
        ml_intern=ci,
        terminal_au=term_au,
        ninio_m=ninio_m,
        max_ninio=max_ninio,
        lxc=107.856,
        duplex_init=410,
        temperature=37.0,
        tetraloop_keys=keys,
        tetraloop_bonus=bonus,
    )


_DEFAULT: EnergyParams | None = None


def get_default_params() -> EnergyParams:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = default_params()
    return _DEFAULT
