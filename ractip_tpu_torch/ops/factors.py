"""Batched Boltzmann-factor matrices for the fold and cofold DPs.

Port of ractip_tpu/ops/mccaskill.py::fold_factors (FoldFactors, 15 fields)
and ractip_tpu/ops/cofold.py::co_factors (CoFactors, 16 fields), written as
plain index gathers from the table tensors over a batch [B, L].  The JAX
package's one-hot bilinear matmul form (ops/factors_mm.py) exists only
because XLA lowers multi-index gathers poorly on the TPU; the values are
the same.  Every matrix is in the natural [B, L_i, L_j] layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import TURN

from ..params.boltz import TorchTables


class FoldFactors(NamedTuple):
    fhn: torch.Tensor     # hairpin (sigma^(span+2) folded in)
    pstk: torch.Tensor    # stack: outer (i,j) on inner (i+1,j-1)
    p11: torch.Tensor     # 1x1 interior (inner (i+2, j-2))
    p21a: torch.Tensor    # 1x2 interior (inner (i+2, j-3))
    p21b: torch.Tensor    # 2x1 interior (inner (i+3, j-2))
    p22: torch.Tensor     # 2x2 interior (inner (i+3, j-3))
    pb15: torch.Tensor    # 1-bulge 5' (inner (i+2, j-1))
    pb13: torch.Tensor    # 1-bulge 3' (inner (i+1, j-2))
    tau: torch.Tensor     # TerminalAU factor of the pair at (i,j)
    taur: torch.Tensor    # TerminalAU factor of the reversed pair at (i,j)
    mout: torch.Tensor    # generic-interior mismatch, outer side
    minn: torch.Tensor    # generic-interior mismatch, inner side
    fmb: torch.Tensor     # multiloop branch stem factor
    fmc: torch.Tensor     # multiloop closing factor
    fe: torch.Tensor      # exterior stem factor


class CoFactors(NamedTuple):
    fhn: torch.Tensor
    pstk: torch.Tensor
    p11: torch.Tensor
    p21a: torch.Tensor
    p21b: torch.Tensor
    p22: torch.Tensor
    pb15: torch.Tensor
    pb13: torch.Tensor
    tau: torch.Tensor
    taur: torch.Tensor
    mout: torch.Tensor
    minn: torch.Tensor
    fmb: torch.Tensor
    fmc: torch.Tensor
    fe: torch.Tensor      # exterior stem factor, cut-aware dangles
    fcx: torch.Tensor     # exposed-cut closing factor for spanning pairs


class _Ctx:
    """Shared gathers of one batch of encoded sequences S [B, L].  allow
    (optional bool [B, L, L]) narrows the pairable mask tv once, so every
    factor gated by tv sees it (mccaskill.py:147-148, cofold.py:114-115);
    taur and minn stay on the reversed pair's type, as there."""

    def __init__(self, tt: TorchTables, S: torch.Tensor, sig: torch.Tensor,
                 allow: torch.Tensor | None = None):
        self.tt = tt
        self.S = S = S.to(device=tt.device, dtype=torch.long)
        B, L = S.shape
        self.L = L
        ar = torch.arange(L, device=tt.device)
        self.I = ar[None, :, None]
        self.J = ar[None, None, :]
        self.span = self.J - self.I - 1
        P = tt.pair
        self.t = P[S[:, :, None], S[:, None, :]]
        self.rt = tt.rtype[self.t]
        self.tv = self.t > 0
        if allow is not None:
            self.tv = self.tv & allow.to(device=tt.device, dtype=torch.bool)
        self.sig = sig.to(tt.dtype)[:, None, None]
        self.si1, self.sj1 = self.row(1), self.col(-1)
        self.si2, self.sj2 = self.row(2), self.col(-2)
        self.sim1, self.sjp1 = self.row(-1), self.col(1)
        self.tr = self.tr_at(0, 0)

    def sg(self, off: int) -> torch.Tensor:
        """S[:, i + off] with 0 outside the array."""
        L = self.L
        idx = torch.arange(L, device=self.S.device) + off
        ok = (idx >= 0) & (idx < L)
        return torch.where(ok[None], self.S[:, idx.clamp(0, L - 1)], 0)

    def row(self, off):
        return self.sg(off)[:, :, None]

    def col(self, off):
        return self.sg(off)[:, None, :]

    def tr_at(self, di: int, dj: int) -> torch.Tensor:
        """Pair type of (j+dj, i+di): the reversed inner pair of a loop."""
        return self.tt.pair[self.col(dj), self.row(di)]

    def hairpin(self, mask) -> torch.Tensor:
        tt, L = self.tt, self.L
        span = self.span
        span_c = span.clamp(0, L)
        mism = torch.where(span == 3, tt.term_au[self.t],
                           tt.mismatch_h[self.t, self.si1, self.sj1])
        key6 = torch.zeros_like(self.S)
        for k in range(6):
            key6 = key6 * 5 + self.sg(k)
        one = tt.scalar(1.0)
        tetra = torch.where(span == 4, tt.tetra[key6][:, :, None], one)
        hp = tt.hairpin_ext(L)[span_c]
        fhn = torch.where(mask & (span >= TURN), hp * mism * tetra,
                          tt.scalar(0.0))
        return fhn * self.sig ** (span_c + 2).to(tt.dtype)

    def specials(self, gate):
        """Stack / small interior / 1-bulge factors; gate(d5, d3) -> mask."""
        tt, t, sig = self.tt, self.t, self.sig
        z = tt.scalar(0.0)
        b1 = tt.scalar(float(tt.bt.bulge[1]))
        si1, sj1, si2, sj2 = self.si1, self.sj1, self.si2, self.sj2
        tr = self.tr_at
        return dict(
            pstk=torch.where(gate(1, 1), tt.stack[t, tr(1, -1)] * sig ** 2, z),
            p11=torch.where(gate(2, 2), tt.int11[t, tr(2, -2), si1, sj1]
                            * sig ** 4, z),
            p21a=torch.where(gate(2, 3), tt.int21[t, tr(2, -3), si1, sj2, sj1]
                             * sig ** 5, z),
            p21b=torch.where(gate(3, 2), tt.int21[tr(3, -2), t, sj1, si1, si2]
                             * sig ** 5, z),
            p22=torch.where(gate(3, 3), tt.int22[t, tr(3, -3), si1, si2, sj2,
                                                 sj1] * sig ** 6, z),
            pb15=torch.where(gate(2, 1), tt.stack[t, tr(2, -1)] * b1
                             * sig ** 3, z),
            pb13=torch.where(gate(1, 2), tt.stack[t, tr(1, -2)] * b1
                             * sig ** 3, z))

    def loop_sides(self):
        tt, t, tv, tr = self.tt, self.t, self.tv, self.tr
        z = tt.scalar(0.0)
        d5, d3 = tt.dangle5, tt.dangle3
        bt = tt.bt
        return dict(
            tau=torch.where(tv, tt.term_au[t], z),
            taur=torch.where(tr > 0, tt.term_au[tr], z),
            mout=torch.where(tv, tt.mismatch_i[t, self.si1, self.sj1], z),
            minn=torch.where(tr > 0, tt.mismatch_i[tr, self.sjp1, self.sim1],
                             z),
            fmb=torch.where(tv, tt.scalar(bt.ml_intern) * tt.term_au[t]
                            * d5[t, self.sim1] * d3[t, self.sjp1], z),
            fmc=torch.where(tv, tt.scalar(bt.ml_closing * bt.ml_intern)
                            * tt.term_au[self.rt] * d3[self.rt, self.si1]
                            * d5[self.rt, self.sj1], z))


def fold_factors(tt: TorchTables, S: torch.Tensor, n: torch.Tensor,
                 sig: torch.Tensor, allow=None) -> FoldFactors:
    """FoldFactors of a batch: S [B, L] codes, n [B] lengths, sig [B],
    allow (optional bool [B, L, L]) the -c pair mask."""
    c = _Ctx(tt, S, sig, allow)
    n = n.to(tt.device)[:, None, None]
    one, z = tt.scalar(1.0), tt.scalar(0.0)
    t, d5, d3 = c.t, tt.dangle5, tt.dangle3
    fe = torch.where(c.tv, tt.term_au[t]
                     * torch.where(c.I > 0, d5[t, c.sim1], one)
                     * torch.where(c.J < n - 1, d3[t, c.sjp1], one), z)
    return FoldFactors(fhn=c.hairpin(c.tv), **c.specials(lambda a, b: c.tv),
                       **c.loop_sides(), fe=fe)


def co_factors(tt: TorchTables, S: torch.Tensor, n: torch.Tensor,
               cut: torch.Tensor, sig: torch.Tensor, allow=None,
               span_loop_penalty: float | None = None) -> CoFactors:
    """Cut-aware CoFactors of concatenations S = s1[:n1] ++ s2, cut = n1.

    A loop stretch i..k (junctions included) must not cross the cut unless
    hidden inside a nested pair: forbidden iff i < cut <= k.  allow
    (optional bool [B, Lc, Lc]) is the -c mask in concatenation
    coordinates (strand-2 base j at n1 + j).  span_loop_penalty (kcal/mol,
    the JAX package's experimental probe, ractip_tpu/ops/cofold.py:93-99,
    :169-183) multiplies every two-sided loop (stack, bulge, interior) and
    the tau and mout factors of a pair whose closing pair spans the cut by
    exp(-penalty / kT); np.inf forbids them.  None leaves every factor as
    it is."""
    c = _Ctx(tt, S, sig, allow)
    n = n.to(tt.device)[:, None, None]
    ct = cut.to(tt.device)[:, None, None]
    I, J, tv = c.I, c.J, c.tv
    one, z = tt.scalar(1.0), tt.scalar(0.0)
    same = ~((I < ct) & (ct <= J))
    spanning = (I < ct) & (ct <= J) & tv

    def gate(d5_, d3_):
        m5 = ~((I < ct) & (ct <= I + d5_))
        m3 = ~((J - d3_ < ct) & (ct <= J))
        return tv & m5 & m3

    t, rt, d5, d3 = c.t, c.rt, tt.dangle5, tt.dangle3
    fe = torch.where(tv, tt.term_au[t]
                     * torch.where((I > 0) & (I != ct), d5[t, c.sim1], one)
                     * torch.where((J < n - 1) & (J + 1 != ct),
                                   d3[t, c.sjp1], one), z)
    fcx = torch.where(spanning, tt.term_au[rt]
                      * torch.where(I + 1 < ct, d3[rt, c.si1], one)
                      * torch.where(J - 1 >= ct, d5[rt, c.sj1], one)
                      * c.sig ** 2, z)
    sp, sides = c.specials(gate), c.loop_sides()
    if span_loop_penalty is not None:
        # kt is in cal/mol (params.boltz); the penalty in kcal/mol
        pen = tt.scalar(float(np.exp(-span_loop_penalty * 1000.0
                                     / tt.bt.kt)))
        span_cl = ((I < ct) & (ct <= J)).to(tt.dtype)
        sc = span_cl * pen + (1.0 - span_cl)
        sp = {k: v * sc for k, v in sp.items()}
        sides["tau"] = sides["tau"] * sc
        sides["mout"] = sides["mout"] * sc
    return CoFactors(fhn=c.hairpin(tv & same), **sp, **sides, fe=fe,
                     fcx=fcx)
