"""CONTRAfold learned-CRF single-sequence inference: log Z and posteriors.

Port of the sum semiring of ractip_tpu/ops/contrafold.py (_cf_logz :70-313,
cf_logz :331, cf_base_pair_probs :346, cf_unpaired_probs :366), the
reference's vendored CONTRAfold InferenceEngine inside / outside /
posterior path (reference src/contrafold/InferenceEngine.ipp: ComputeInside
:3356-3722, ComputeOutside :3731-4087, ComputePosterior :4498; used by
src/ractip.cpp:195-222) for the shipped feature configuration
(Config.hpp:173-196: no helix-length or isolated-pair features, so the DP
is over F5 / FC / FM / FM1 only).

The JAX package has no Pallas kernel here, so this is plain PyTorch: a
column loop over j in log space, in float64 on `device`.

* Everything that depends on the sequence only (junction, hairpin, stack
  and loop-closing scores, the pairing masks) is gathered for every column
  at once before the loop; a column then costs a few dozen tensor ops.
* The single-branch loops of a column read a 31-column window of FC
  (FCwin[:, d] = FC[:, j-1-d]); the 31 x 31 (l1, d) terms are gathered at
  once and reduced with one logsumexp.
* FM is split on its LAST helix, so a column is a closed-form function of
  earlier columns (ractip_tpu/ops/contrafold.py:12-26): with FMH[k, j] =
  FC[k+1, j-1] + JunctionA(j, k) + c + BasePair(k+1, j),
      FM1[., j] = R @ FMH[., j]          (R: the unpaired-run prefix)
      FM2[i, j] = logsum_k FM[i, k] + FMH[k, j]
      FM[., j]  = FM1 (+) FM[., j-1] + b (+) FM2
      FMT[., j] = FM2 (+) FMT[., j-1] + b
* Posterior pair probabilities are d logZ / d eps, eps a perturbation of
  every ScoreBasePair(a, b), through torch.autograd.grad (the JAX package
  uses jax.grad, :360): reverse mode through the column loop is the outside
  pass.  The columns live in Python lists and every step builds new
  tensors, so nothing that autograd saved is written in place.
* Impossible states hold NEG = -1e30, not -inf: logaddexp of two -inf
  gives NaN gradients.

Positions are 1-based as in the reference; padded tail positions encode 0
("N"), whose score-table entries are all zero, which reproduces the
reference's sequence-edge guards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import MAXLOOP
from ..device import resolve
from ..params.contrafold import CFTables, get_cf_tables

W = MAXLOOP + 1          # single-branch loop window (l1, l2 in 0..30)
NEG = -1e30


def _shift_up(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = v[i+k] along dim 0, NEG fill."""
    k = min(k, v.shape[0])
    return torch.cat([v[k:], v.new_full((k,) + v.shape[1:], NEG)])


def _codes(S, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(S, device=dev).long()


def _cf_logz(tb: CFTables, S: torch.Tensor, n: int,
             eps: torch.Tensor) -> torch.Tensor:
    """log partition function of the CONTRAfold CRF of S ([Lp] codes, n
    valid); eps is an [Lp+1, Lp+1] perturbation added to every
    ScoreBasePair(a, b) (1-based)."""
    dev, dt = eps.device, eps.dtype
    Lp = S.shape[0]
    L1 = Lp + 1
    z1 = S.new_zeros(1)
    s = torch.cat([z1, S, z1])                       # [Lp+2], s[1..Lp]
    spad = torch.cat([S.new_zeros(W), s])            # index +W
    idx = torch.arange(L1, device=dev)               # positions 0..Lp
    s0, sp1 = s[:L1], s[1:L1 + 1]                    # s[k], s[k+1]
    sm1 = torch.cat([z1, s[:L1 - 1]])                # s[k-1]
    mp, mb = tb.multi_paired, tb.multi_base
    ep, b_mul = tb.ext_paired, tb.multi_unpaired
    b_ext = torch.where((idx >= 1) & (idx <= n), tb.ext_unpaired,
                        torch.zeros((), dtype=dt, device=dev))

    # pair (a, b) allowed iff 1 <= a < b <= n and the letters are
    # complementary (reference InferenceEngine.ipp:1083-1096)
    pairable = (tb.compl[s0[:, None], s0[None, :]]
                & (idx[:, None] >= 1) & (idx[None, :] <= n)
                & (idx[:, None] < idx[None, :]))
    D = idx[None, :] - idx[:, None]
    R = torch.where(D >= 0, D.to(dt) * b_mul, NEG)   # R[i,k] = (k-i)*b

    # every column's sequence-only terms, row t = column j = t + 1
    J = torch.arange(1, L1, device=dev)
    sj, sjp1 = s[J][:, None], s[J + 1][:, None]      # [Lp, 1]
    jc = J[:, None]
    row = lambda v: v[None, :]
    # JA(j, k) = closing[s_j, s_{k+1}] + dangle_l[s_j, s_{k+1}, s_{j+1}]
    #          + dangle_r[s_j, s_{k+1}, s_k]
    JA = (tb.closing[sj, row(sp1)] + tb.dangle_l[sj, row(sp1), sjp1]
          + tb.dangle_r[sj, row(sp1), row(s0)])
    BPJ = tb.bp[row(sp1), sj]                        # BasePair(k+1, j)
    okP = (pairable[row(torch.clamp(idx + 1, max=Lp)), jc]
           & row(idx + 1 <= Lp))
    M_FMH = okP & (row(idx) <= jc - 2)
    M_STK = okP & (row(idx) + 2 <= jc)
    BJ = torch.where(J <= n, b_mul, torch.zeros((), dtype=dt, device=dev))
    # JB(i, j) = closing[s_i, s_{j+1}] + tm[s_i, s_{j+1}, s_{i+1}, s_j]
    JB = tb.closing[row(s0), sjp1] + tb.tm[row(s0), sjp1, row(sp1), sj]
    OKFC = pairable[row(idx), torch.clamp(jc + 1, max=Lp)] & (jc + 1 <= Lp)
    span = jc - row(idx)
    HP = torch.where(span >= 3,
                     tb.hairpin_len[torch.clamp(span, 0, 30)] + JB, NEG)
    ST = tb.stack[row(s0), sjp1, row(sp1), sj]
    JAI = (tb.closing[row(s0), sjp1] + tb.dangle_l[row(s0), sjp1, row(sp1)]
           + tb.dangle_r[row(s0), sjp1, sj])

    # generic single-branch loops: inner pair (a, q), a = i+l1+1, q = j-d;
    # Acoef[a, d] = BP(a, q) + eps[a, q] + JB(q, a-1)
    dvec = torch.arange(W, device=dev)
    qpos = jc - dvec[None, :]                        # [Lp, W]
    s_q = spad[qpos + W][:, None, :]                 # [Lp, 1, W]
    s_qp1 = spad[qpos + 1 + W][:, None, :]
    col = lambda v: v[None, :, None]                 # over a
    OKA = (pairable[:, torch.clamp(qpos, 0, Lp)].permute(1, 0, 2)
           & (qpos >= 1)[:, None, :]
           & (col(idx) + 1 <= qpos[:, None, :]))     # [Lp, L1, W]
    BPA = tb.bp[col(s0), s_q]
    CLA = tb.closing[s_q, col(s0)]
    TMA = tb.tm[s_q, col(s0), s_qp1, col(sm1)]
    eps_pad = torch.cat([eps.new_zeros(L1, W), eps], dim=1)
    eps_cols = jc + W - dvec[None, :]                # [:, d] -> eps[:, j-d]

    # the (l1, d) window: rows a = i+l1+1 of Xw, score single[l1][d], the
    # nucleotide specials at (0, 1), (1, 0), (1, 1)
    l1v = torch.arange(W, device=dev)
    rows = idx[:, None] + l1v[None, :] + 1           # [L1, W]
    dmask = ((dvec[None, :] <= MAXLOOP - l1v[:, None])
             & ~((l1v[:, None] == 0) & (dvec[None, :] == 0)))
    cs = tb.single
    SP = torch.stack([
        torch.stack([torch.zeros_like(JB), tb.bulge0x1[sj].expand_as(JB)],
                    -1),
        torch.stack([tb.bulge0x1[row(sp1)].expand_as(JB),
                     tb.int1x1[row(sp1), sj]], -1)], -2)   # [Lp, L1, 2, 2]
    neg_rows = eps.new_full((W, W), NEG)

    FCwin = eps.new_full((L1, W), NEG)
    FMcols = [eps.new_full((L1,), NEG)]              # FM[:, 0]
    FMT = eps.new_full((L1,), NEG)
    F5 = [eps.new_zeros(())]                         # F5[0]
    for t in range(Lp):
        j = t + 1
        epscol = eps[:, j]
        bp_col = BPJ[t] + torch.cat([epscol[1:], eps.new_zeros(1)])
        sh = _shift_up(FCwin[:, 0], 1)
        # ---- FMH / external-pair column ------------------------------
        fmh = torch.where(M_FMH[t], sh + JA[t] + mp + bp_col, NEG)
        # ---- FM1 / FM2 / FMT / FM ------------------------------------
        fm1 = torch.logsumexp(R + fmh[None, :], dim=1)
        fm2 = torch.logsumexp(torch.stack(FMcols, 1) + fmh[None, :j], dim=1)
        FMT_new = torch.logaddexp(fm2, FMT + BJ[t])
        fm = torch.logaddexp(fm1, torch.logaddexp(FMcols[j - 1] + BJ[t], fm2))
        # ---- FC column: pair (i, j+1) --------------------------------
        stk = torch.where(M_STK[t], sh + bp_col + ST[t], NEG)
        epw = eps_pad[:, eps_cols[t]]
        acoef = torch.where(OKA[t], BPA[t] + epw + CLA[t] + TMA[t], NEG)
        Xw = FCwin + acoef                           # FC[a, q-1] + Acoef
        y = torch.cat([Xw, neg_rows])[rows] + cs     # [L1, l1, d]
        y = y + F.pad(SP[t], (0, W - 2, 0, W - 2))
        y = torch.where(dmask, y, NEG)
        single = JB[t] + torch.logsumexp(y.reshape(L1, -1), dim=1)
        multi = FMT_new + JAI[t] + mp + mb
        fc = torch.where(OKFC[t], torch.logaddexp(
            torch.logaddexp(HP[t], stk), torch.logaddexp(single, multi)), NEG)
        # ---- F5 ------------------------------------------------------
        extcol = fmh - mp + ep
        f5j = torch.logaddexp(
            F5[j - 1] + b_ext[j],
            torch.logsumexp(torch.stack(F5) + extcol[:j], dim=0))
        F5.append(f5j)
        FCwin = torch.cat([fc[:, None], FCwin[:, :-1]], dim=1)
        FMcols.append(fm)
        FMT = FMT_new
    return F5[Lp]


def cf_logz(S, n: int, model: str = "complementary",
            device="cuda") -> torch.Tensor:
    """log Z (float64, 0-d) of the CONTRAfold ensemble of the encoded
    sequence S (padded, [Lp]) with n valid positions."""
    dev = resolve(device)
    S = _codes(S, dev)
    L1 = S.shape[0] + 1
    with torch.no_grad():
        return _cf_logz(get_cf_tables(model, dev), S, int(n),
                        torch.zeros(L1, L1, dtype=torch.float64, device=dev))


def cf_base_pair_probs(S, n: int, model: str = "complementary",
                       device="cuda") -> torch.Tensor:
    """[Lp, Lp] posterior P(i pairs j), 0-based, upper triangle (the
    reference's triangular bp export), float64 on `device`.

    Posterior = d logZ / d eps where eps perturbs ScoreBasePair: reverse mode
    through the inside loop is the outside algorithm (reference
    InferenceEngine.ipp:3731-4087 and :4498 derive the same adjoint by
    hand)."""
    dev = resolve(device)
    S = _codes(S, dev)
    L1 = S.shape[0] + 1
    eps = torch.zeros(L1, L1, dtype=torch.float64, device=dev,
                      requires_grad=True)
    with torch.enable_grad():
        logz = _cf_logz(get_cf_tables(model, dev), S, int(n), eps)
        g, = torch.autograd.grad(logz, eps)
    return g[1:, 1:]


def cf_unpaired_probs(bpp: torch.Tensor) -> torch.Tensor:
    """up[i] = max(0, 1 - sum_j p(i,j)): the reference program's
    accessibility proxy under the CONTRAfold engine (reference
    src/ractip.cpp:213-222)."""
    tot = torch.sum(bpp, dim=0) + torch.sum(bpp, dim=1)
    return torch.clamp(1.0 - tot, min=0.0)
