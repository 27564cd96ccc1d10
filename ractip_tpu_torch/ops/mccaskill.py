"""Single-strand McCaskill partition function: one call, one strand.

Port of ractip_tpu/ops/mccaskill.py's public functions (fold :464,
log_partition :483, base_pair_probs :492) for a user who wants one
strand's posteriors without the joint ILP.  They run the batched fold of
ops/scan.py at B = 1, so on a card the inside, outside and exterior q2
kernels (K1, K2, K3) do the work; on the CPU their plain versions.

S is [L] codes (a padded encoding), n the strand's length; scale_e pins
the per-base scale energy (cal/mol: one inside pass at sigma =
exp(-scale_e / kT)), else it adapts as in the batched fold; allow (bool
[L, L]) is the -c pair mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from .scan import SCALE_E0, adaptive, as_tables, batch1, batch_fold, \
    batch_inside, on_device


class InsideState(NamedTuple):
    qb: torch.Tensor     # [L, L] paired partition function (scaled)
    qm: torch.Tensor     # [L, L] multiloop segment, >= 1 branch
    qm1: torch.Tensor    # [L, L] multiloop segment, 1 branch at the 5' end
    qm2: torch.Tensor    # [L, L] multiloop segment, >= 2 branches
    q1: torch.Tensor     # [L] exterior prefix partition function
    q2: torch.Tensor     # [L + 1] exterior suffix partition function
    zn: torch.Tensor     # scaled total partition function
    sat: torch.Tensor    # some DP column hit the HUGE ceiling


class OutsideState(NamedTuple):
    ob: torch.Tensor     # [L, L] outer weights: p = qb * ob / zn
    bpp: torch.Tensor    # [L, L] pair probabilities (i < j)


def fold_one(params, S, n, device, dtype=torch.float32, scale_e=None,
             allow=None) -> dict:
    """batch_fold of one strand (B = 1); its dict (ins, ff, ob, bpp, sig,
    es), every tensor with its batch axis of 1."""
    dev = resolve(device)
    return batch_fold(
        params, *batch1(dev, S, n), dev,
        max_iter=8 if scale_e is None else 0,
        es0=SCALE_E0 if scale_e is None else float(scale_e), dtype=dtype,
        allow=None if allow is None else on_device(allow, dev,
                                                   torch.bool)[None])


def fold(params, S, n, dtype=torch.float32, scale_e=None, allow=None,
         device="cuda"):
    """Full inside/outside of one strand on `device`: (InsideState,
    OutsideState)."""
    r = fold_one(params, S, n, device, dtype, scale_e, allow)
    ins = InsideState(*[r["ins"][k][0] for k in InsideState._fields])
    return ins, OutsideState(ob=r["ob"][0], bpp=r["bpp"][0])


def log_partition(params, S, n, dtype=torch.float32, device="cuda"):
    """ln Z (unscaled) = ln zn + n * es / kT, from the inside pass alone
    (sigma = exp(-es / kT), es adapted)."""
    dev = resolve(device)
    tt = as_tables(params, dev, dtype)
    S, n = batch1(dev, S, n)
    es, ins, _, _ = adaptive(lambda es: batch_inside(tt, S, n, es), SCALE_E0,
                             n, tt.bt.kt, 8, tt.dtype)
    kt = tt.scalar(tt.bt.kt)
    return (torch.log(ins["zn"]) + n.to(tt.dtype) * es / kt)[0]


def base_pair_probs(params, S, n, dtype=torch.float32, allow=None,
                    device="cuda"):
    """[L, L] base-pair probability matrix (upper triangle)."""
    return fold(params, S, n, dtype, allow=allow, device=device)[1].bpp
