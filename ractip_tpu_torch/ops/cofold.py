"""Batched co-folding of s1 ++ s2: the cut-aware joint McCaskill DP.

Port of ractip_tpu/ops/cofold_pallas.py.  Two wrappers hold the kernels:

  co_inside   (K4)  csrc/inside.cu  <- cofold_pallas.co_inside_pallas_streamed
  co_outside  (K5)  csrc/outside.cu <- cofold_pallas.co_outside_pallas_streamed

They share their plain versions and their CUDA templates with the fold's
inside/outside (ops/scan.py), switched by the per-instance cut = n1.
batch_cofold returns the cross-cut hybridization posteriors hp [B, L1, L2]
(the reference's co_pf_fold source, reference src/ractip.cpp:384-459);
cofold and cofold_hybrid_probs are its single-pair calls at B = 1
(ractip_tpu/ops/cofold.py:514, :570).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda
from .factors import co_factors
from .scan import (SCALE_E0, _on_cpu, adaptive, as_tables, batch1,
                   inside_plain, lengths, on_device, outside_plain,
                   pair_probs, q2, saturated, stack_cols)
from ..params.boltz import TorchTables, sig_tables
from ..utils.timing import stage


def co_inside(F, w2k, bulge_k, sig, pows, cut, n=None):
    """K4: cut-aware inside scan -> (qm1_c, qb_c, qm_c, qx_c, q1).  n [B]:
    the concatenations' lengths (None: the whole bucket); the kernel sweeps
    only those, the plain version everything (the tables agree either way,
    padding included)."""
    if _on_cpu(F):
        return inside_plain(F, w2k, bulge_k, sig, pows, cut)
    return _cuda.launch_inside(F, w2k, bulge_k, sig, pows,
                               cut.to(torch.int32).contiguous(), lengths(n))


def co_outside(F, qmN, qm1_c, qxN, qxA, qBpref, q1pad, q2v, w2k, bulge_k,
               sig, pows, cut, n=None):
    """K5: cut-aware outside scan -> ob_c (n as for co_inside)."""
    if _on_cpu(F):
        return co_outside_plain(F, qmN, qm1_c, qxN, qxA, qBpref, q1pad, q2v,
                                w2k, bulge_k, sig, pows, cut)
    return _cuda.launch_outside(F, qmN, qm1_c, q1pad, q2v, w2k, bulge_k, sig,
                                pows, cut.to(torch.int32).contiguous(), qxN,
                                qxA, qBpref, lengths(n))


def co_outside_plain(F, qmN, qm1_c, qxN, qxA, qBpref, q1pad, q2v, w2k,
                     bulge_k, sig, pows, cut):
    """K5's plain version, with co_outside's argument order."""
    return outside_plain(F, qmN, qm1_c, q1pad, q2v, w2k, bulge_k, sig, pows,
                         cut, qxN, qxA, qBpref)


def _pack_concat(S1, S2, n1):
    """Per-instance concatenation S1[:n1] ++ S2 into one padded buffer."""
    B, L1 = S1.shape
    L2 = S2.shape[1]
    L = L1 + L2
    idx = torch.arange(L, device=S1.device)[None, :]
    s1 = torch.cat([S1, torch.zeros_like(S2)], 1)
    src = (idx - n1[:, None]).clamp(0, L2 - 1)
    s2 = torch.where(idx - n1[:, None] < L2, S2.gather(1, src), 0)
    return torch.where(idx < n1[:, None], s1, s2)


def _co_inside_once(tt: TorchTables, S, n, cut, es, timer=None, allow=None,
                    span_loop_penalty=None):
    """One batched cofold inside pass at scale energies es [B] (allow: the
    optional bool [B, Lc, Lc] pair mask in concatenation coordinates;
    span_loop_penalty as for co_factors)."""
    B, L = S.shape
    dt = tt.dtype
    sig = torch.exp(-es.to(dt) / tt.scalar(tt.bt.kt))
    with stage(timer, "factors"):
        ff = co_factors(tt, S, n, cut, sig, allow, span_loop_penalty)
        F = stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
    qm1_c, qb_c, qm_c, qx_c, q1 = co_inside(F, w2k, bulge_k, sig, pows, cut,
                                            n)
    qb, qx = qb_c.transpose(1, 2), qx_c.transpose(1, 2)
    zn = q1.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
    q2v = q2((qb * ff.fe).contiguous(), sig, n)
    sat = saturated(zn, qb_c, qm_c, qx_c, q1)
    ins = dict(qb=qb, qm=qm_c.transpose(1, 2), qm1=qm1_c.transpose(1, 2),
               qx=qx, q1=q1, q2=q2v, zn=zn, sat=sat)
    aux = dict(ff=ff, F=F, qm1_c=qm1_c, w2k=w2k, bulge_k=bulge_k, pows=pows)
    return ins, aux, sig


def exterior_vectors(qx, cut):
    """(qxA, qBpref) [B, L]: qxA[p] = qx[p, cut-1] (1 at p == cut, 0 past
    it) and qBpref[k] = qx[cut, k-1] for k > cut (1 at k == cut, 0 before)."""
    B, L, _ = qx.shape
    dt, dev = qx.dtype, qx.device
    lanes = torch.arange(L, device=dev)[None, :]
    ct = cut.to(torch.long)[:, None]
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    qxa = qx.gather(2, (ct - 1).clamp(min=0)[:, :, None].expand(B, L, 1))[
        :, :, 0]
    qxA = torch.where(lanes < ct, qxa, torch.where(lanes == ct, one, zero))
    qbrow = qx.gather(1, ct.clamp(max=L - 1)[:, :, None].expand(B, 1, L))[
        :, 0, :]
    qbp = torch.where(lanes == ct, one,
                      torch.cat([torch.zeros_like(qbrow[:, :1]),
                                 qbrow[:, :-1]], 1))
    qBpref = torch.where(lanes >= ct, qbp, zero)
    return qxA.contiguous(), qBpref.contiguous()


def cross_block(bpp, n1, n2, L1: int, L2: int):
    """hp[b, i1, i2] = bpp[b, i1, n1 + i2], zero past the real lengths."""
    B, L, _ = bpp.shape
    dev = bpp.device
    cols = (n1[:, None] + torch.arange(L2, device=dev)[None, :]).clamp(
        0, L - 1)
    hp = bpp[:, :L1, :].gather(2, cols[:, None, :].expand(B, L1, L2))
    rows_ok = torch.arange(L1, device=dev)[None, :, None] < n1[:, None, None]
    cols_ok = torch.arange(L2, device=dev)[None, None, :] < n2[:, None, None]
    return torch.where(rows_ok & cols_ok, hp, torch.zeros_like(hp))


def batch_cofold(tables, S1, S2, n1, n2, device, max_iter: int = 8,
                 es0: float = SCALE_E0, dtype=torch.float32,
                 timer=None, allow=None, span_loop_penalty=None) -> dict:
    """Batched joint fold of the concatenations s1[:n1] ++ s2.

    allow (optional bool [B, Lc, Lc], Lc = L1 + L2, numpy or torch) is the
    -c pair mask over the concatenation, strand-2 base j at n1 + j
    (ops/constraints.py::cofold_allow), applied in every rescale round;
    span_loop_penalty (kcal/mol) scores the loops closed by cut-spanning
    pairs (co_factors).  max_iter=0 runs one inside pass at es0.
    Returns a dict with ins (natural-layout inside tables over the
    concatenation), ob, bpp [B, L, L], hp [B, L1, L2] (hp[i1, i2] =
    bpp[i1, n1 + i2], masked to the real lengths), sig and es."""
    from ..device import resolve
    dev = resolve(device)
    tt = as_tables(tables, dev, dtype)
    t = lambda a: on_device(a, dev, torch.long)
    S1, S2 = t(S1), t(S2)
    n1, n2 = t(n1).clamp(min=1), t(n2).clamp(min=1)
    B, L1 = S1.shape
    L2 = S2.shape[1]
    S = _pack_concat(S1, S2, n1)
    n = n1 + n2
    cut = n1
    if allow is not None:
        allow = on_device(allow, dev, torch.bool)

    es, ins, aux, sig = adaptive(
        lambda es: _co_inside_once(tt, S, n, cut, es, timer, allow,
                                   span_loop_penalty), es0, n, tt.bt.kt,
        max_iter, tt.dtype)
    q1pad = torch.cat([torch.ones(B, 1, dtype=tt.dtype, device=dev),
                       ins["q1"][:, :-1]], 1).contiguous()
    qx = ins["qx"].contiguous()
    qxA, qBpref = exterior_vectors(qx, cut)
    ob_c = co_outside(aux["F"], ins["qm"].contiguous(), aux["qm1_c"], qx,
                      qxA, qBpref, q1pad, ins["q2"], aux["w2k"],
                      aux["bulge_k"], sig, aux["pows"], cut, n)
    ob = ob_c.transpose(1, 2)
    bpp = pair_probs(ins["qb"], ob, ins["zn"])
    hp = cross_block(bpp, n1, n2, L1, L2)
    return dict(ins=ins, ob=ob, bpp=bpp, hp=hp, sig=sig, es=es)


class CoInsideState(NamedTuple):
    qb: torch.Tensor     # [Lc, Lc] paired partition function (scaled)
    qm: torch.Tensor
    qm1: torch.Tensor
    qx: torch.Tensor     # [Lc, Lc] exterior-segment pf (within-strand use)
    q1: torch.Tensor     # [Lc] exterior prefix over the concatenation
    q2: torch.Tensor     # [Lc + 1] exterior suffix
    zn: torch.Tensor     # scaled total partition function
    sat: torch.Tensor    # some DP column hit the HUGE ceiling


class CoOutsideState(NamedTuple):
    ob: torch.Tensor     # [Lc, Lc] outer weights
    bpp: torch.Tensor    # [Lc, Lc] pair probabilities (i < j)


def _one(tables, S1, S2, n1, n2, device, dtype, scale_e, allow,
         span_loop_penalty) -> dict:
    """batch_cofold of one pair (B = 1): adaptive scaling, or one inside
    pass at the pinned scale energy scale_e."""
    from ..device import resolve
    dev = resolve(device)
    return batch_cofold(
        tables, *batch1(dev, S1, S2, n1, n2), dev,
        max_iter=8 if scale_e is None else 0,
        es0=SCALE_E0 if scale_e is None else float(scale_e), dtype=dtype,
        allow=None if allow is None else on_device(allow, dev,
                                                   torch.bool)[None],
        span_loop_penalty=span_loop_penalty)


def cofold(params, S1, S2, n1, n2, dtype=torch.float32, scale_e=None,
           allow=None, span_loop_penalty=None, device="cuda"):
    """Joint fold of s1[:n1] ++ s2[:n2] on `device` (K4, K5 and K3 on a
    card): (CoInsideState, CoOutsideState) over the concatenation's
    padded length L1 + L2.  Port of ractip_tpu/ops/cofold.py::cofold.

    S1 [L1], S2 [L2] codes, n1, n2 lengths; scale_e pins the per-base scale
    energy (cal/mol), else it adapts; allow (bool [L1+L2, L1+L2]) restricts
    the pairs, in concatenation coordinates; span_loop_penalty as for
    co_factors."""
    r = _one(params, S1, S2, n1, n2, device, dtype, scale_e, allow,
             span_loop_penalty)
    ins = CoInsideState(*[r["ins"][k][0] for k in CoInsideState._fields])
    return ins, CoOutsideState(ob=r["ob"][0], bpp=r["bpp"][0])


def cofold_hybrid_probs(params, S1, S2, n1, n2, dtype=torch.float32,
                        allow=None, span_loop_penalty=None, device="cuda"):
    """hp [L1, L2]: P(S1[i1] pairs S2[i2]) under the joint (cofold)
    ensemble, the reference's default hybridization posteriors (reference
    src/ractip.cpp:442-453).  Port of
    ractip_tpu/ops/cofold.py::cofold_hybrid_probs."""
    return _one(params, S1, S2, n1, n2, device, dtype, None, allow,
                span_loop_penalty)["hp"][0]
