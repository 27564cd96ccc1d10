"""Duplex (pure inter-molecular) partition function and pair posteriors.

Port of ractip_tpu/ops/duplex.py, batched: the hybridization model of the
``--duplex`` flag.  Its ensemble is every chain of inter-strand pairs
(i_1 < ... < i_p on s1 with j_1 > ... > j_p on s2) whose consecutive pairs
form stacks, bulges or interior loops of at most MAXLOOP unpaired bases,
with a duplex-initiation term and dangles at both helix ends.  pr[b, i, j]
is the posterior probability that (i, j) pairs, given a duplex.

All pair-dependent energies live in factor matrices [B, L1, L2]
(duplex_factors_fw / duplex_factors_bk).  The forward and backward chain
sums are row sweeps with per-row renormalisation; one wrapper holds the
kernel:

  sweep  (K6)  csrc/duplex.cu  <- duplex_pallas.sweep_pallas

It runs the plain PyTorch version (sweep_plain) when the factors lie on the
CPU, and launches the CUDA kernel, both directions in one launch, when they
lie on a GPU.  The posteriors tail (log Z, the log-space product of the two
sweeps) is plain tensor code, as it is outside any kernel in the JAX package.
duplex and hybrid_probs are the single-pair calls (ops/duplex.py:268, :303).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as tnf

from ..constants import MAXLOOP
from ..device import resolve
from ..params.boltz import TorchTables
from . import _cuda
from .scan import _on_cpu, as_tables, batch1

W = MAXLOOP + 1


class DuplexFactors(NamedTuple):
    """Factor matrices [B, L1, L2] of one sweep direction.

    The forward sweep anchors loops at the inner/new pair (i, j) and reads
    the previous pair at (i-di, j+dj); the backward sweep anchors at the
    outer pair and reads the next pair at (i+di, j-dj)."""

    start: torch.Tensor    # chain start factor at (i, j)
    close: torch.Tensor    # chain end factor (for the total sum)
    mm_here: torch.Tensor  # generic-loop mismatch at the anchored pair
    mm_other: torch.Tensor  # generic-loop mismatch folded into the window
    pstk: torch.Tensor
    p11: torch.Tensor
    p21a: torch.Tensor
    p21b: torch.Tensor
    p22: torch.Tensor
    pb1a: torch.Tensor
    pb1b: torch.Tensor
    tau: torch.Tensor


# the 11 factors a sweep reads, in the kernel's order
SWEEP_FIELDS = ("start", "mm_here", "mm_other", "tau", "pstk", "p11", "p21a",
                "p21b", "p22", "pb1a", "pb1b")


def _shift_j(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., j] = v[..., j+k], zero fill (k may be negative)."""
    L = v.shape[-1]
    out = torch.zeros_like(v)
    if k >= 0:
        if k < L:
            out[..., :L - k] = v[..., k:]
    elif -k < L:
        out[..., -k:] = v[..., :L + k]
    return out


class _Grid(NamedTuple):
    t: torch.Tensor        # [B, L1, L2] pair type of (i, j)
    rt: torch.Tensor       # reversed type
    tv: torch.Tensor       # t > 0
    t_at: Callable         # (di, dj) -> pair type of (i+di, j+dj)
    s1r: Callable          # off -> S1[i+off] as [B, L1, 1]
    s2c: Callable          # off -> S2[j+off] as [B, 1, L2]
    I: torch.Tensor        # [1, L1, 1]
    J: torch.Tensor        # [1, 1, L2]


def _grid(tt: TorchTables, S1, S2) -> _Grid:
    S1, S2 = S1.to(torch.long), S2.to(torch.long)
    s1r = lambda off: _shift_j(S1, off)[:, :, None]
    s2c = lambda off: _shift_j(S2, off)[:, None, :]
    t_at = lambda di, dj: tt.pair[s1r(di), s2c(dj)]
    t = t_at(0, 0)
    dev = S1.device
    return _Grid(t=t, rt=tt.rtype[t], tv=t > 0, t_at=t_at, s1r=s1r, s2c=s2c,
                 I=torch.arange(S1.shape[1], device=dev)[None, :, None],
                 J=torch.arange(S2.shape[1], device=dev)[None, None, :])


def _ends(tt: TorchTables, g: _Grid, n1, n2):
    """(init end, closing end) factors: the chain start of the forward and
    of the backward sweep respectively."""
    one = torch.ones((), dtype=tt.dtype, device=tt.device)
    n1 = n1.to(torch.long)[:, None, None]
    n2 = n2.to(torch.long)[:, None, None]
    zero = torch.zeros((), dtype=tt.dtype, device=tt.device)
    tau_t = tt.term_au[g.t]
    init = torch.where(g.tv, tt.duplex_init * tau_t
                       * torch.where(g.I > 0, tt.dangle5[g.t, g.s1r(-1)], one)
                       * torch.where(g.J < n2 - 1, tt.dangle3[g.t, g.s2c(1)],
                                     one), zero)
    closing = torch.where(g.tv, tau_t
                          * torch.where(g.I < n1 - 1,
                                        tt.dangle3[g.rt, g.s1r(1)], one)
                          * torch.where(g.J > 0, tt.dangle5[g.rt, g.s2c(-1)],
                                        one), zero)
    return init, closing


def duplex_factors_fw(tt: TorchTables, S1, S2, n1, n2) -> DuplexFactors:
    """Forward factors: loops between the previous pair (i-di, j+dj) and
    (i, j) (reference src/pf_duplex.c:332-333).  S1 [B, L1], S2 [B, L2],
    n1, n2 [B]."""
    g = _grid(tt, S1, S2)
    t, rt, tv, t_at, s1r, s2c = g.t, g.rt, g.tv, g.t_at, g.s1r, g.s2c
    zero = torch.zeros((), dtype=tt.dtype, device=tt.device)
    w = lambda v: torch.where(tv, v, zero)
    start, close = _ends(tt, g, n1, n2)
    return DuplexFactors(
        start=start, close=close,
        mm_here=w(tt.mismatch_i[rt, s2c(1), s1r(-1)]),
        mm_other=w(tt.mismatch_i[t, s1r(1), s2c(-1)]),
        pstk=w(tt.stack[t_at(-1, 1), rt]),
        p11=w(tt.int11[t_at(-2, 2), rt, s1r(-1), s2c(1)]),
        p21a=w(tt.int21[t_at(-2, 3), rt, s1r(-1), s2c(1), s2c(2)]),
        p21b=w(tt.int21[rt, t_at(-3, 2), s2c(1), s1r(-2), s1r(-1)]),
        p22=w(tt.int22[t_at(-3, 3), rt, s1r(-2), s1r(-1), s2c(1), s2c(2)]),
        pb1a=w(tt.stack[t_at(-2, 1), rt] * tt.bulge[1]),
        pb1b=w(tt.stack[t_at(-1, 2), rt] * tt.bulge[1]),
        tau=w(tt.term_au[t]))


def duplex_factors_bk(tt: TorchTables, S1, S2, n1, n2) -> DuplexFactors:
    """Backward factors: loops between (i, j) (outer) and the next pair
    (i+di, j-dj)."""
    g = _grid(tt, S1, S2)
    t, rt, tv, t_at, s1r, s2c = g.t, g.rt, g.tv, g.t_at, g.s1r, g.s2c
    zero = torch.zeros((), dtype=tt.dtype, device=tt.device)
    w = lambda v: torch.where(tv, v, zero)
    rt_in = lambda di, dj: tt.rtype[t_at(di, dj)]
    close, start = _ends(tt, g, n1, n2)
    return DuplexFactors(
        start=start, close=close,
        mm_here=w(tt.mismatch_i[t, s1r(1), s2c(-1)]),
        mm_other=w(tt.mismatch_i[rt, s2c(1), s1r(-1)]),
        pstk=w(tt.stack[t, rt_in(1, -1)]),
        p11=w(tt.int11[t, rt_in(2, -2), s1r(1), s2c(-1)]),
        p21a=w(tt.int21[t, rt_in(2, -3), s1r(1), s2c(-2), s2c(-1)]),
        p21b=w(tt.int21[rt_in(3, -2), t, s2c(-1), s1r(1), s1r(2)]),
        p22=w(tt.int22[t, rt_in(3, -3), s1r(1), s1r(2), s2c(-2), s2c(-1)]),
        pb1a=w(tt.stack[t, rt_in(2, -1)] * tt.bulge[1]),
        pb1b=w(tt.stack[t, rt_in(1, -2)] * tt.bulge[1]),
        tau=w(tt.term_au[t]))


def _gen_kernel(tt: TorchTables) -> torch.Tensor:
    """[1, W, W+1] conv1d weight: K[W-1-u1, u2+1] = w2_raw[u1, u2].

    Window row W-d holds the row at distance d, so the kernel row for u1
    unpaired bases on s1 is W-1-u1."""
    K = torch.zeros(W, W + 1, dtype=tt.dtype, device=tt.device)
    for u1 in range(1, MAXLOOP):
        K[W - 1 - u1, 2:W + 1 - u1] = tt.w2_raw[u1, 1:MAXLOOP + 1 - u1]
    return K[None]


def sweep_plain(ff: DuplexFactors, tt: TorchTables, reverse: bool):
    """Row sweep (plain PyTorch; port of ops/duplex.py::_sweep).  Returns
    (M [B, L1, L2] row-normalised values, lsc [B, L1] log scales): the true
    value is M[b, i, j] * exp(lsc[b, i]).  reverse=False: rows ascending,
    the window reads rows above with positive j-shifts; reverse=True: rows
    descending, negative j-shifts (the factors must match the direction).
    The generic loop is one conv1d over the window (no TF32: the caller on
    a GPU turns cuDNN's TF32 off)."""
    _cuda.note_plain("duplex_sweep", ff.start)
    B, L1, L2 = ff.start.shape
    dt, dev = ff.start.dtype, ff.start.device
    K = _gen_kernel(tt).to(dt)
    bk_raw = tt.bulge_raw.to(dt)
    bcoef = torch.zeros(W, dtype=dt, device=dev)   # window row of distance m+1
    for m in range(2, MAXLOOP + 1):
        bcoef[W - 1 - m] = bk_raw[m]
    sgn = -1 if reverse else 1
    sh = lambda v, k: _shift_j(v, sgn * k)
    M = torch.zeros(B, L1, L2, dtype=dt, device=dev)
    lsc = torch.zeros(B, L1, dtype=dt, device=dev)
    Fb, FAb, FTb = (torch.zeros(B, W, L2, dtype=dt, device=dev)
                    for _ in range(3))
    off = torch.zeros(B, dtype=dt, device=dev)
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)
    big = torch.tensor(1e4, dtype=dt, device=dev)
    pad = torch.zeros(B, W, W + 1, dtype=dt, device=dev)
    for step in range(L1):
        i = L1 - 1 - step if reverse else step
        row = lambda x: x[:, i]
        FA = FAb.flip(-1) if reverse else FAb
        gen = tnf.conv1d(torch.cat([FA, pad], -1), K)[:, 0, :L2]
        if reverse:
            gen = gen.flip(-1)
        gen = gen * row(ff.mm_here)
        b1 = sh(torch.einsum("w,bwj->bj", bcoef, FTb), 1)
        rT = FTb[:, W - 1]
        b2 = torch.zeros(B, L2, dtype=dt, device=dev)
        for m in range(2, MAXLOOP + 1):
            b2 = b2 + bk_raw[m] * sh(rT, m + 1)
        bulges = row(ff.tau) * (b1 + b2)
        r1, r2, r3 = Fb[:, W - 1], Fb[:, W - 2], Fb[:, W - 3]
        val = (row(ff.start) * torch.exp(-off)[:, None]
               + gen + bulges
               + row(ff.pstk) * sh(r1, 1)
               + row(ff.p11) * sh(r2, 2)
               + row(ff.p21a) * sh(r2, 3)
               + row(ff.p21b) * sh(r3, 2)
               + row(ff.p22) * sh(r3, 3)
               + row(ff.pb1a) * sh(r2, 1)
               + row(ff.pb1b) * sh(r1, 2))
        m0 = torch.maximum(val.max(1).values, tiny)
        scale = torch.where(m0 > big, m0, torch.ones_like(m0))
        val_n = val / scale[:, None]
        off = off + torch.log(scale)
        M[:, i] = val_n
        lsc[:, i] = off
        s3 = scale[:, None, None]
        Fb = torch.cat([Fb[:, 1:] / s3, val_n[:, None]], 1)
        FAb = torch.cat([FAb[:, 1:] / s3, (val_n * row(ff.mm_other))[:, None]],
                        1)
        FTb = torch.cat([FTb[:, 1:] / s3, (val_n * row(ff.tau))[:, None]], 1)
    return M, lsc


def _sweep_inputs(tt: TorchTables, ffw: DuplexFactors, fbk: DuplexFactors,
                  n1, n2):
    """The kernel's inputs: both directions' factors [2, 11, B, L1, L2],
    w2_raw [W, W], bulge_raw [W] and the lengths n1, n2 [B] as int32."""
    fac = torch.stack([torch.stack([getattr(ff, k) for k in SWEEP_FIELDS])
                       for ff in (ffw, fbk)]).contiguous()
    return (fac, tt.w2_raw.contiguous(), tt.bulge_raw.contiguous(),
            n1.to(torch.int32).contiguous(), n2.to(torch.int32).contiguous())


def sweep(tt: TorchTables, ffw: DuplexFactors, fbk: DuplexFactors, n1, n2):
    """K6: ((M, lsc) of the forward sweep of ffw, (M, lsc) of the backward
    sweep of fbk); n1, n2 [B] bound the chain region, past which the factors
    are zero.  On CPU tensors the plain version; on CUDA tensors one kernel
    launch for both directions, which sweeps the n1 x n2 region only."""
    if _on_cpu(ffw.start):
        return sweep_plain(ffw, tt, False), sweep_plain(fbk, tt, True)
    M, lsc = _cuda.launch_duplex_sweep(*_sweep_inputs(tt, ffw, fbk, n1, n2))
    return (M[0], lsc[0]), (M[1], lsc[1])


class DuplexResult(NamedTuple):
    pr: torch.Tensor      # [B, L1, L2] posterior pair probabilities
    log_zd: torch.Tensor  # [B] ln(duplex partition function), unscaled


def posteriors(fw, lfw, bk, lbk, close) -> DuplexResult:
    """log Z from the forward sweep, pr from both (ops/duplex.py:290-300)."""
    tiny = torch.finfo(fw.dtype).tiny
    rowsum = (fw * close).sum(2)
    mx = lfw.max(1).values
    zd = (rowsum * torch.exp(lfw - mx[:, None])).sum(1)
    log_zd = torch.log(zd.clamp(min=tiny)) + mx
    logpr = (torch.log(fw.clamp(min=tiny)) + lfw[:, :, None]
             + torch.log(bk.clamp(min=tiny)) + lbk[:, :, None]
             - log_zd[:, None, None])
    pr = torch.where((fw > 0) & (bk > 0), torch.exp(logpr),
                     torch.zeros((), dtype=fw.dtype, device=fw.device))
    return DuplexResult(pr=pr, log_zd=log_zd)


def batch_duplex(tt: TorchTables, S1, S2, n1, n2) -> DuplexResult:
    """Duplex posteriors of a batch: pr [B, L1, L2] and log_zd [B]."""
    ffw = duplex_factors_fw(tt, S1, S2, n1, n2)
    fbk = duplex_factors_bk(tt, S1, S2, n1, n2)
    (fw, lfw), (bk, lbk) = sweep(tt, ffw, fbk, n1, n2)
    return posteriors(fw, lfw, bk, lbk, ffw.close)


def duplex(params, S1, S2, n1, n2, dtype=torch.float32,
           device="cuda") -> DuplexResult:
    """Duplex posteriors of one pair on `device`: DuplexResult(pr [L1, L2],
    log_zd), K6 on a card.  Port of ractip_tpu/ops/duplex.py::duplex; its
    use_pallas and pallas_interpret have no counterpart here: the tensors'
    device chooses the kernel (CUDA) or its plain version (CPU)."""
    dev = resolve(device)
    tt = as_tables(params, dev, dtype)
    r = batch_duplex(tt, *batch1(dev, S1, S2, n1, n2))
    return DuplexResult(pr=r.pr[0], log_zd=r.log_zd[0])


def hybrid_probs(params, S1, S2, n1, n2, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """[L1, L2] duplex pair posteriors (the reference's hp_ under
    --duplex)."""
    return duplex(params, S1, S2, n1, n2, dtype, device).pr
