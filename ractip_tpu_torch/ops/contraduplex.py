"""CONTRAfold learned-score duplex (inter-molecular) engine.

Port of ractip_tpu/ops/contraduplex.py (_cd_logz :48, cd_logz :126,
cd_hybrid_probs :136-162), the reference's vendored CONTRAfold DuplexEngine
(reference src/contrafold/DuplexEngine.ipp: ComputeInside :1015-1077,
ComputeOutside :1080-1143, ComputePosterior :1146-1169, LoopScore
:974-1012; used by src/ractip.cpp:226-246): the ensemble of pure
antiparallel duplexes -- chains of inter-strand pairs (i ascending in s1, j
descending in s2) whose consecutive pairs are separated by at most
C_MAX_SINGLE_LENGTH = 30 unpaired bases -- scored with the learned
complementary weights.

Scoring per the reference: a chain start (5' s1 side) gets external-unpaired
counts and the reversed-orientation base pair, helix closing and dangles;
each extension is a helix stack (helix_stacking + base_pair) or a generic
loop (two terminal mismatches + base_pair + the 0x1 / 1x1 nucleotide
features); the chain end adds the mirrored closing scores.  The reference
builds cache_score_single but its duplex inside / outside never consume it
(DuplexEngine.ipp:1040-1060), so bulge / internal length features do not
apply here, as there.

Plain PyTorch in float64 on `device` (the JAX package has no Pallas kernel
here): a row loop over s1 positions in log space with a rolling 31-row
window; a row's generic loops, (l1, l2) over the window, are gathered at
once and reduced with one logsumexp.  Posterior pair marginals are
d logZ / d eps through torch.autograd.grad, as in ops/contrafold.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import MAXLOOP
from ..device import resolve
from ..params.contrafold import CFTables, get_cf_tables

W = MAXLOOP + 1
NEG = -1e30


def _shift_left(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., j] = v[..., j+k], NEG fill (k >= 0)."""
    k = min(k, v.shape[-1])
    return torch.cat([v[..., k:], v.new_full(v.shape[:-1] + (k,), NEG)], -1)


def _cd_logz(tb: CFTables, S1: torch.Tensor, S2: torch.Tensor, n1: int,
             n2: int, eps: torch.Tensor) -> torch.Tensor:
    """log Z of the duplex ensemble; eps [L1, L2+1] perturbs the base pair
    of s1[i] (1-based row i-1) with s2[j]."""
    dev, dt = eps.device, eps.dtype
    L1, L2 = S1.shape[0], S2.shape[0]
    z1 = S1.new_zeros(1)
    s1 = torch.cat([z1, S1, z1])                     # 1-based, sentinels
    s2 = torch.cat([z1, S2, z1])
    jdx = torch.arange(L2 + 1, device=dev)
    jf = jdx.to(dt)
    t2, t2p = s2[:L2 + 1], s2[1:L2 + 2]              # s2[j], s2[j+1]
    t2m = torch.cat([z1, s2[:L2]])                   # s2[j-1]
    eu = tb.ext_unpaired

    # every row's sequence-only terms, row r = position i = r + 1 of s1
    I = torch.arange(1, L1 + 1, device=dev)
    i_f = I.to(dt)[:, None]
    a1, a1m, a1p = s1[I][:, None], s1[I - 1][:, None], s1[I + 1][:, None]
    row = lambda v: v[None, :]
    OKP = (row((jdx >= 1) & (jdx <= n2)) & (I <= n1)[:, None]
           & tb.compl[a1, row(t2)])
    BPF = tb.bp[a1, row(t2)]                         # forward orientation
    INIT = (eu * ((i_f - 1) + (n2 - row(jf)))
            + tb.dangle_r[row(t2), a1, a1m]
            + tb.dangle_l[row(t2), a1, row(t2p)] + tb.bp[row(t2), a1])
    CL = tb.closing[row(t2), a1]
    STK = tb.stack[a1m, row(t2p), a1, row(t2)]
    TMH = tb.tm[row(t2), a1, row(t2p), a1m]          # inner-side mismatch
    CLOSE = (eu * ((n1 - i_f) + (row(jf) - 1.0))
             + tb.dangle_l[a1, row(t2), a1p]
             + tb.dangle_r[a1, row(t2), row(t2m)] + tb.closing[a1, row(t2)])
    TMG = tb.tm[a1, row(t2), a1p, row(t2m)]          # outer-mismatch factor

    # generic loops from (p, q) = (i-1-l1, j+1+l2), (l1, l2) != (0, 0):
    # window row l1 of INg read at column j+1+l2, the nucleotide specials
    # at (0, 1) s2[q-1] = s2[j+1], (1, 0) s1[p+1] = s1[i-1], (1, 1)
    lv = torch.arange(W, device=dev)
    cols = lv[:, None] + jdx[None, :] + 1            # [l2, j]
    gmask = ((lv[None, :] <= MAXLOOP - lv[:, None])
             & ~((lv[:, None] == 0) & (lv[None, :] == 0)))[:, :, None]
    zero = torch.zeros_like(OKP, dtype=dt)
    SP = torch.stack([
        torch.stack([zero, tb.bulge0x1[row(t2p)].expand_as(zero)], 1),
        torch.stack([tb.bulge0x1[a1m].expand_as(zero),
                     tb.int1x1[a1m, row(t2p)]], 1)], 1)   # [L1, 2, 2, L2+1]
    neg_cols = eps.new_full((W, W + 1), NEG)

    INg = eps.new_full((W, L2 + 1), NEG)   # rows i-1-r, + outer mismatch
    INr1 = eps.new_full((L2 + 1,), NEG)    # raw row i-1
    logz = eps.new_full((), NEG)
    for r in range(L1):
        epsrow = eps[r]
        bp_f = BPF[r] + epsrow
        init = INIT[r] + epsrow + CL[r]
        stk = _shift_left(INr1, 1) + bp_f + STK[r]
        y = torch.cat([INg, neg_cols], dim=1)[:, cols]   # [l1, l2, j]
        y = y + F.pad(SP[r], (0, 0, 0, W - 2, 0, W - 2))
        gen = torch.logsumexp(torch.where(gmask, y, NEG).reshape(-1, L2 + 1),
                              dim=0) + (TMH[r] + bp_f)
        inside = torch.where(OKP[r], torch.logaddexp(
            init, torch.logaddexp(stk, gen)), NEG)
        logz = torch.logaddexp(logz, torch.logsumexp(
            torch.where(OKP[r], inside + CLOSE[r], NEG), dim=0))
        INg = torch.cat([(inside + TMG[r])[None, :], INg[:-1]], dim=0)
        INr1 = inside
    return logz


def _args(S1, S2, dev):
    return (torch.as_tensor(S1, device=dev).long(),
            torch.as_tensor(S2, device=dev).long())


def cd_logz(S1, S2, n1: int, n2: int, model: str = "complementary",
            device="cuda") -> torch.Tensor:
    """log partition function (float64, 0-d) of the CONTRAfold duplex
    ensemble."""
    dev = resolve(device)
    S1, S2 = _args(S1, S2, dev)
    with torch.no_grad():
        return _cd_logz(get_cf_tables(model, dev), S1, S2, int(n1), int(n2),
                        torch.zeros(S1.shape[0], S2.shape[0] + 1,
                                    dtype=torch.float64, device=dev))


def cd_hybrid_probs(S1, S2, n1: int, n2: int, model: str = "complementary",
                    device="cuda") -> torch.Tensor:
    """[L1, L2] posterior P(s1[i] pairs s2[j]) under the duplex ensemble
    (0-based, float64 on `device`; the reference program's hp under
    --contraduplex, src/ractip.cpp:226-246)."""
    dev = resolve(device)
    S1, S2 = _args(S1, S2, dev)
    eps = torch.zeros(S1.shape[0], S2.shape[0] + 1, dtype=torch.float64,
                      device=dev, requires_grad=True)
    with torch.enable_grad():
        logz = _cd_logz(get_cf_tables(model, dev), S1, S2, int(n1), int(n2),
                        eps)
        g, = torch.autograd.grad(logz, eps)
    return g[:, 1:]
