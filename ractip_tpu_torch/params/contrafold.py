"""CONTRAfold learned-CRF scoring tables as float64 tensors on a device.

Port of ractip_tpu/params/contrafold.py (CFTables :42, _build :78,
get_cf_tables :163): the logical parameters of the reference's vendored
CONTRAfold model (reference src/contrafold/InferenceEngine.ipp:419-946
RegisterParameters, with the feature groups of
src/contrafold/Config.hpp:173-196) assembled with numpy into dense tables
indexed by the package's nucleotide encoding (0=N/pad, 1=A, 2=C, 3=G, 4=U;
the reference uses 0..3=ACGU, 4=N), then moved once per (model, device) to
float64 tensors.  Length features arrive as "at_least_k" increments and are
folded into cumulative caches as the reference's InitializeCache does
(InferenceEngine.ipp:1106-1200), including the combined single-branch-loop
table cache_score_single[l1][l2].
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAXLOOP
from .contrafold_data import COMPLEMENTARY, NONCOMPLEMENTARY

ALPHA = "ACGU"
# permutation from this package's encoding (N,A,C,G,U) to CONTRAfold's (A..U,N)
_PERM = np.array([4, 0, 1, 2, 3])

D_MAX_HAIRPIN_LENGTH = 30
D_MAX_BULGE_LENGTH = 30
D_MAX_INTERNAL_LENGTH = 30
D_MAX_INTERNAL_SYMMETRIC_LENGTH = 15
D_MAX_INTERNAL_ASYMMETRY = 28
D_MAX_INTERNAL_EXPLICIT_LENGTH = 4
C_MAX_SINGLE_LENGTH = MAXLOOP  # 30 in both models (Config.hpp:212-213)


class CFTables(NamedTuple):
    """Dense score tables, every nucleotide axis indexed by codes 0..4."""

    bp: torch.Tensor          # [5,5] base_pair (symmetric)
    tm: torch.Tensor          # [5,5,5,5] terminal_mismatch[i][j+1][i+1][j]
    hairpin_len: torch.Tensor  # [31] cumulative hairpin-length score
    single: torch.Tensor      # [31,31] cache_score_single[l1][l2]
    bulge0x1: torch.Tensor    # [5] (shared by 1x0)
    int1x1: torch.Tensor      # [5,5] (symmetric)
    stack: torch.Tensor       # [5,5,5,5] helix_stacking[i][j][i'][j']
    closing: torch.Tensor     # [5,5] helix_closing[i][j+1]
    dangle_l: torch.Tensor    # [5,5,5] dangle_left[i][j+1][i+1]
    dangle_r: torch.Tensor    # [5,5,5] dangle_right[i][j+1][j]
    multi_base: torch.Tensor
    multi_unpaired: torch.Tensor
    multi_paired: torch.Tensor
    ext_unpaired: torch.Tensor
    ext_paired: torch.Tensor
    compl: torch.Tensor       # [5,5] bool complementarity mask


def _perm_axes(a: np.ndarray, naxes: int) -> np.ndarray:
    for ax in range(naxes):
        a = np.take(a, _PERM, axis=ax)
    return a


def _cumulative(v: dict, family: str, last: int) -> np.ndarray:
    out = np.zeros(last + 1)
    acc = 0.0
    for k in range(last + 1):
        acc += v.get(f"{family}_{k}", 0.0)
        out[k] = acc
    return out


def _build(v: dict) -> dict[str, np.ndarray]:
    """The tables of one parameter dict, as numpy (float64, compl bool)."""
    A = len(ALPHA)

    bp = np.zeros((A + 1, A + 1))
    for i, a in enumerate(ALPHA):
        for j, b in enumerate(ALPHA):
            bp[i, j] = v.get("base_pair_" + min(a + b, b + a), 0.0)

    tm = np.zeros((A + 1,) * 4)
    for idx in np.ndindex(A, A, A, A):
        name = "terminal_mismatch_" + "".join(ALPHA[k] for k in idx)
        tm[idx] = v.get(name, 0.0)

    hairpin_len = _cumulative(v, "hairpin_length_at_least", D_MAX_HAIRPIN_LENGTH)
    cum_bulge = _cumulative(v, "bulge_length_at_least", D_MAX_BULGE_LENGTH)
    cum_internal = _cumulative(v, "internal_length_at_least", D_MAX_INTERNAL_LENGTH)
    cum_sym = _cumulative(v, "internal_symmetric_length_at_least",
                          D_MAX_INTERNAL_SYMMETRIC_LENGTH)
    cum_asym = _cumulative(v, "internal_asymmetry_at_least", D_MAX_INTERNAL_ASYMMETRY)

    single = np.zeros((C_MAX_SINGLE_LENGTH + 1, C_MAX_SINGLE_LENGTH + 1))
    for l1 in range(C_MAX_SINGLE_LENGTH + 1):
        for l2 in range(C_MAX_SINGLE_LENGTH + 1 - l1):
            if l1 == 0 and l2 == 0:
                continue
            if l1 == 0 or l2 == 0:
                single[l1, l2] = cum_bulge[min(D_MAX_BULGE_LENGTH, l1 + l2)]
            else:
                s = cum_internal[min(D_MAX_INTERNAL_LENGTH, l1 + l2)]
                if l1 <= D_MAX_INTERNAL_EXPLICIT_LENGTH and \
                        l2 <= D_MAX_INTERNAL_EXPLICIT_LENGTH:
                    s += v.get(f"internal_explicit_{min(l1, l2)}_{max(l1, l2)}", 0.0)
                if l1 == l2:
                    s += cum_sym[min(D_MAX_INTERNAL_SYMMETRIC_LENGTH, l1)]
                s += cum_asym[min(D_MAX_INTERNAL_ASYMMETRY, abs(l1 - l2))]
                single[l1, l2] = s

    bulge0x1 = np.zeros(A + 1)
    for i, a in enumerate(ALPHA):
        bulge0x1[i] = v.get("bulge_0x1_nucleotides_" + a, 0.0)

    int1x1 = np.zeros((A + 1, A + 1))
    for i, a in enumerate(ALPHA):
        for j, b in enumerate(ALPHA):
            int1x1[i, j] = v.get("internal_1x1_nucleotides_" + min(a + b, b + a), 0.0)

    stack = np.zeros((A + 1,) * 4)
    for i1, j1, i2, j2 in np.ndindex(A, A, A, A):
        n1 = "".join(ALPHA[k] for k in (i1, j1, i2, j2))
        n2 = "".join(ALPHA[k] for k in (j2, i2, j1, i1))
        stack[i1, j1, i2, j2] = v.get("helix_stacking_" + min(n1, n2), 0.0)

    closing = np.zeros((A + 1, A + 1))
    for i, a in enumerate(ALPHA):
        for j, b in enumerate(ALPHA):
            closing[i, j] = v.get(f"helix_closing_{a}{b}", 0.0)

    dangle_l = np.zeros((A + 1,) * 3)
    dangle_r = np.zeros((A + 1,) * 3)
    for idx in np.ndindex(A, A, A):
        suff = "".join(ALPHA[k] for k in idx)
        dangle_l[idx] = v.get("dangle_left_" + suff, 0.0)
        dangle_r[idx] = v.get("dangle_right_" + suff, 0.0)

    compl = np.zeros((A + 1, A + 1), bool)
    for a, b in ("AU", "UA", "GU", "UG", "CG", "GC"):
        compl[ALPHA.index(a), ALPHA.index(b)] = True

    return dict(
        bp=_perm_axes(bp, 2), tm=_perm_axes(tm, 4),
        hairpin_len=hairpin_len, single=single,
        bulge0x1=_perm_axes(bulge0x1, 1), int1x1=_perm_axes(int1x1, 2),
        stack=_perm_axes(stack, 4), closing=_perm_axes(closing, 2),
        dangle_l=_perm_axes(dangle_l, 3), dangle_r=_perm_axes(dangle_r, 3),
        multi_base=np.float64(v.get("multi_base", 0.0)),
        multi_unpaired=np.float64(v.get("multi_unpaired", 0.0)),
        multi_paired=np.float64(v.get("multi_paired", 0.0)),
        ext_unpaired=np.float64(v.get("external_unpaired", 0.0)),
        ext_paired=np.float64(v.get("external_paired", 0.0)),
        compl=_perm_axes(compl, 2),
    )


MODELS = {"complementary": COMPLEMENTARY,
          "noncomplementary": NONCOMPLEMENTARY}


@lru_cache(maxsize=8)
def _tables(model: str, device: torch.device) -> CFTables:
    if model not in MODELS:
        raise ValueError(f"unknown CONTRAfold model {model!r}")
    return CFTables(**{k: torch.as_tensor(v, device=device)
                       for k, v in _build(MODELS[model]).items()})


def get_cf_tables(model: str = "complementary", device="cuda") -> CFTables:
    """Default learned weights as dense float64 tensors on `device`, built
    once per (model, device).

    model="complementary" is what the reference program loads
    (reference src/ractip.cpp:202 GetDefaultComplementaryValues).
    """
    return _tables(model, torch.device(device))
