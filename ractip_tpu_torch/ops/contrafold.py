"""CONTRAfold learned-CRF single-sequence inference: log Z, posteriors,
decoding and the max-margin surface.

Port of ractip_tpu/ops/contrafold.py (_cf_logz :70-313, cf_helix_features
:316, cf_logz :331, cf_base_pair_probs :346, cf_unpaired_probs :366,
cf_viterbi :381, cf_stochastic_traceback :420, cf_mea :611, cf_loss_matrix
:686, cf_loss_augmented_viterbi :701, cf_margin :735), the reference's
vendored CONTRAfold InferenceEngine (reference
src/contrafold/InferenceEngine.ipp: ComputeInside :3356-3722,
ComputeOutside :3731-4087, ComputePosterior :4498, ComputeViterbi :2519,
PredictPairingsPosterior :4837-5010, PredictPairingsStochasticTraceback
:5012-5256, UseLoss :1824; used by src/ractip.cpp:195-222).  The shipped
feature configuration (Config.hpp:173-196) has no helix-length or
isolated-pair features, so the default DP is over F5 / FC / FM / FM1 only;
`helix=` switches those feature groups on.

The JAX package has no Pallas kernel here, so this is plain PyTorch: a
column loop over j in log space, in float64 on `device`.

* Everything that depends on the sequence only (junction, hairpin, stack
  and loop-closing scores, the pairing masks, and with helix features every
  column's helix rollout) is gathered for every column at once before the
  loop; a column then costs a few dozen tensor ops.
* The single-branch loops of a column read a 31-column window of FC
  (FCwin[:, d] = FC[:, j-1-d]); the 31 x 31 (l1, d) terms are gathered at
  once and reduced with one logsumexp (amax in the max semiring).
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
  pass.  In the max semiring the same gradient is the 0/1 indicator of the
  optimal structure's pairs, so the Viterbi traceback is one backward pass.
  The columns live in Python lists and every step builds new tensors, so
  nothing that autograd saved is written in place.
* Impossible states hold NEG = -1e30, not -inf: logaddexp of two -inf
  gives NaN gradients.

Positions are 1-based as in the reference; padded tail positions encode 0
("N"), whose score-table entries are all zero, which reproduces the
reference's sequence-edge guards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import MAXLOOP
from ..device import resolve
from ..params.contrafold import CFTables, get_cf_tables

W = MAXLOOP + 1          # single-branch loop window (l1, l2 in 0..30)
D_HELIX = 30             # D_MAX_HELIX_LENGTH (reference Config.hpp:222)
NEG = -1e30


def _shift_up(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = v[i+k] along dim 0, NEG fill."""
    k = min(k, v.shape[0])
    return torch.cat([v[k:], v.new_full((k,) + v.shape[1:], NEG)])


def _codes(S, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(S, device=dev).long()


def _cf_logz(tb: CFTables, S: torch.Tensor, n: int, eps: torch.Tensor,
             semiring: str = "sum", allow=None, emit_tables: bool = False,
             helix=None):
    """log partition function of the CONTRAfold CRF of S ([Lp] codes, n
    valid); eps is an [Lp+1, Lp+1] perturbation added to every
    ScoreBasePair(a, b) (1-based).

    semiring="max" gives the Viterbi score (the same recurrences in the
    max-plus semiring, reference InferenceEngine.ipp:2519).  allow (optional
    [Lp, Lp] bool, 0-based) keeps only structures whose pairs (i, j) have
    allow[i, j] or allow[j, i] (reference :1870 UseConstraints).
    emit_tables returns (F5 [Lp+1], FC columns [Lp, Lp+1] with row j-1 the
    pairs (i, j+1), FM [Lp+1, Lp+1], FMT columns [Lp, Lp+1]) in place of
    the score, for cf_stochastic_traceback.  helix (length_at_least
    [D_HELIX+1], isolated), from cf_helix_features, switches on the
    helix-length and isolated-pair feature groups (reference Config.hpp:
    136-137): FC splits into FN (a pair whose next interaction is not a
    stack), FE (a stacking extension beyond D_HELIX) and a helix rollout
    that scores each maximal helix once (reference :3414-3555, ScoreHelix
    :2203-2235); zero weights give the default grammar's scores."""
    if helix is not None and emit_tables:
        raise ValueError("helix features: tables emission unsupported")
    dev, dt = eps.device, eps.dtype
    if semiring == "max":
        lse2 = torch.maximum
        lsev = torch.amax
    else:
        lse2 = torch.logaddexp
        lsev = torch.logsumexp
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
    if allow is not None:
        al = F.pad(torch.as_tensor(allow, dtype=torch.bool, device=dev)
                   [:Lp, :Lp], (1, 0, 1, 0))
        pairable = pairable & (al | al.T)
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

    if helix is not None:
        # the helix rollout of every column, k = t + 1 = 2..D_HELIX, as
        # [Lp (column), D_HELIX - 1 (t), L1 (i)]: RUNH[j, t, i] = sum over
        # t' <= t of HelixStacking(i+t'-1, j-t'+2) + BP(i+t', j-t'+1)
        # + eps[i+t', j-t'+1] (NEG where a pair is not allowed), plus the
        # cumulative length score hl[k]
        la, iso = helix
        hl = torch.cumsum(torch.as_tensor(la, dtype=dt, device=dev), 0)
        iso = torch.as_tensor(iso, dtype=dt, device=dev)
        T = torch.arange(1, D_HELIX, device=dev)
        sext = torch.cat([s, S.new_zeros(D_HELIX)])
        a_s = sext[row(idx) + T[:, None]][None]      # s[i+t]   [1, 29, L1]
        a_sm1 = sext[row(idx) + T[:, None] - 1][None]
        J3, T3, I3 = J[:, None, None], T[None, :, None], idx[None, None, :]
        q1 = torch.clamp(J3 - T3 + 1, 0, Lp + 1)      # partner j-t+1
        q2 = torch.clamp(J3 - T3 + 2, 0, Lp + 1)
        eps_h = F.pad(eps_pad, (0, 0, 0, D_HELIX))   # rows past Lp: 0
        HBP = tb.bp[a_s, s[q1]] + eps_h[I3 + T3, J3 - T3 + 1 + W]
        OKH = (pairable[torch.clamp(I3 + T3, 0, Lp),
                        torch.clamp(J3 - T3 + 1, 0, Lp)]
               & (I3 + T3 <= Lp) & (J3 - T3 + 1 >= 1))
        RUNH = torch.cumsum(torch.where(
            OKH, tb.stack[a_sm1, s[q2], a_s, s[q1]] + HBP, NEG), 1) \
            + hl[T + 1][None, :, None]
        SPAN_OK = I3 + 2 * T3 <= J3                  # i + 2k - 2 <= j
        # inner[t, i] = FN[i+t, j-t] (k < D_HELIX) or FE[i+29, j-29]
        RH = row(idx) + T[:, None]                   # [29, L1]
        CH = (T - 1)[:, None]
        neg_h = eps.new_full((D_HELIX, D_HELIX - 1), NEG)
        FNwin = eps.new_full((L1, W), NEG)
        FEwin = eps.new_full((L1, W), NEG)

    FCwin = eps.new_full((L1, W), NEG)
    FMcols = [eps.new_full((L1,), NEG)]              # FM[:, 0]
    FMT = eps.new_full((L1,), NEG)
    F5 = [eps.new_zeros(())]                         # F5[0]
    FCs, FMTs = [], []
    for t in range(Lp):
        j = t + 1
        epscol = eps[:, j]
        bp_col = BPJ[t] + torch.cat([epscol[1:], eps.new_zeros(1)])
        sh = _shift_up(FCwin[:, 0], 1)
        # ---- FMH / external-pair column ------------------------------
        fmh = torch.where(M_FMH[t], sh + JA[t] + mp + bp_col, NEG)
        # ---- FM1 / FM2 / FMT / FM ------------------------------------
        fm1 = lsev(R + fmh[None, :], dim=1)
        fm2 = lsev(torch.stack(FMcols, 1) + fmh[None, :j], dim=1)
        FMT_new = lse2(fm2, FMT + BJ[t])
        fm = lse2(fm1, lse2(FMcols[j - 1] + BJ[t], fm2))
        # ---- FC column: pair (i, j+1) --------------------------------
        epw = eps_pad[:, eps_cols[t]]
        acoef = torch.where(OKA[t], BPA[t] + epw + CLA[t] + TMA[t], NEG)
        Xw = FCwin + acoef                           # FC[a, q-1] + Acoef
        y = torch.cat([Xw, neg_rows])[rows] + cs     # [L1, l1, d]
        y = y + F.pad(SP[t], (0, W - 2, 0, W - 2))
        y = torch.where(dmask, y, NEG)
        single = JB[t] + lsev(y.reshape(L1, -1), dim=1)
        multi = FMT_new + JAI[t] + mp + mb
        if helix is None:
            stk = torch.where(M_STK[t], sh + bp_col + ST[t], NEG)
            fc = torch.where(OKFC[t], lse2(
                lse2(HP[t], stk), lse2(single, multi)), NEG)
        else:
            # FN: the default grammar less the stack; FE: stack extension
            # (+) FN; FC: isolated + FN (+) each helix of length k closed
            # by FN (k < D_HELIX) or FE (k = D_HELIX)
            fn = torch.where(OKFC[t], lse2(lse2(HP[t], single), multi), NEG)
            fe_stk = torch.where(M_STK[t], _shift_up(FEwin[:, 0], 1)
                                 + bp_col + ST[t], NEG)
            fe = torch.where(OKFC[t], lse2(fe_stk, fn), NEG)
            win = torch.cat([torch.cat([FNwin[:, :D_HELIX - 2],
                                        FEwin[:, D_HELIX - 2:D_HELIX - 1]],
                                       1), neg_h])
            contrib = torch.where(SPAN_OK[t], RUNH[t] + win[RH, CH], NEG)
            fc = torch.where(OKFC[t], lsev(
                torch.cat([(iso + fn)[None], contrib]), dim=0), NEG)
            FNwin = torch.cat([fn[:, None], FNwin[:, :-1]], dim=1)
            FEwin = torch.cat([fe[:, None], FEwin[:, :-1]], dim=1)
        # ---- F5 ------------------------------------------------------
        extcol = fmh - mp + ep
        f5j = lse2(F5[j - 1] + b_ext[j],
                   lsev(torch.stack(F5) + extcol[:j], dim=0))
        F5.append(f5j)
        FCwin = torch.cat([fc[:, None], FCwin[:, :-1]], dim=1)
        FMcols.append(fm)
        FMT = FMT_new
        if emit_tables:
            FCs.append(fc)
            FMTs.append(FMT_new)
    if emit_tables:
        return (torch.stack(F5), torch.stack(FCs), torch.stack(FMcols, 1),
                torch.stack(FMTs))
    return F5[Lp]


def cf_helix_features(length_at_least=None, isolated=0.0):
    """The non-default helix-length and isolated-pair feature weights
    (reference Config.hpp:136-137, RegisterParameters ipp:555-580) as
    _cf_logz's `helix`: (length_at_least [D_HELIX+1] float64,
    isolated float64).

    length_at_least holds the helix_length_at_least_t increments; a helix
    of length m >= 2 scores their cumulative sum up to t = min(m, D_HELIX)
    (the reference's cache, InferenceEngine.ipp:1127-1131), so indices 0
    and 1 add to the score of every helix of length 2 or more.  isolated
    scores a helix of length 1.  The shipped parameter files carry no
    trained values for these groups, so the caller supplies them; zeros
    give the default grammar's scores."""
    la = torch.zeros(D_HELIX + 1, dtype=torch.float64) \
        if length_at_least is None \
        else torch.as_tensor(length_at_least, dtype=torch.float64)
    if la.shape != (D_HELIX + 1,):
        raise ValueError(f"length_at_least has shape {tuple(la.shape)}, "
                         f"expected ({D_HELIX + 1},)")
    return la, torch.as_tensor(isolated, dtype=torch.float64)


def _zeros_eps(S: torch.Tensor) -> torch.Tensor:
    L1 = S.shape[0] + 1
    return torch.zeros(L1, L1, dtype=torch.float64, device=S.device)


def cf_logz(S, n: int, model: str = "complementary", device="cuda",
            allow=None, helix=None) -> torch.Tensor:
    """log Z (float64, 0-d) of the CONTRAfold ensemble of the encoded
    sequence S (padded, [Lp]) with n valid positions; allow (optional
    [Lp, Lp] bool) is the engine's constraint mask, helix (optional, from
    cf_helix_features) switches on the helix-length and isolated-pair
    feature groups."""
    dev = resolve(device)
    S = _codes(S, dev)
    with torch.no_grad():
        return _cf_logz(get_cf_tables(model, dev), S, int(n), _zeros_eps(S),
                        "sum", allow, False, helix)


def cf_base_pair_probs(S, n: int, model: str = "complementary",
                       device="cuda", allow=None,
                       helix=None) -> torch.Tensor:
    """[Lp, Lp] posterior P(i pairs j), 0-based, upper triangle (the
    reference's triangular bp export), float64 on `device`.

    Posterior = d logZ / d eps where eps perturbs ScoreBasePair: reverse mode
    through the inside loop is the outside algorithm (reference
    InferenceEngine.ipp:3731-4087 and :4498 derive the same adjoint by
    hand).  With helix features eps also perturbs every rolled-out helix
    pair, so the adjoint covers the FN / FE / FC split too."""
    dev = resolve(device)
    S = _codes(S, dev)
    eps = _zeros_eps(S).requires_grad_(True)
    with torch.enable_grad():
        logz = _cf_logz(get_cf_tables(model, dev), S, int(n), eps, "sum",
                        allow, False, helix)
        g, = torch.autograd.grad(logz, eps)
    return g[1:, 1:]


def cf_unpaired_probs(bpp: torch.Tensor) -> torch.Tensor:
    """up[i] = max(0, 1 - sum_j p(i,j)): the reference program's
    accessibility proxy under the CONTRAfold engine (reference
    src/ractip.cpp:213-222)."""
    tot = torch.sum(bpp, dim=0) + torch.sum(bpp, dim=1)
    return torch.clamp(1.0 - tot, min=0.0)


# --------------------------------------------------------------------------
# decoding: Viterbi / MEA / stochastic traceback (reference
# InferenceEngine.ipp ComputeViterbi :2519 + PredictPairingsViterbi :3023,
# PredictPairingsPosterior :4837-5010, PredictPairingsStochasticTraceback
# :5012-5256)
# --------------------------------------------------------------------------


def _tie_break(L1: int, dev: torch.device) -> torch.Tensor:
    """The JAX package's deterministic tie-break (ops/contrafold.py:397-406):
    an exact score tie splits the max's gradient across the tied optima, and
    the 0.5 threshold would then drop pairs unique to each; a tiny
    position-dependent eps makes the optimum unique, so the gradient is the
    0/1 indicator of ONE optimal structure."""
    ia = torch.arange(L1, device=dev)
    return 1e-9 * (((ia[:, None] * 31 + ia[None, :] * 17) % 997)
                   .to(torch.float64) / 997.0)


def _max_structure(tb: CFTables, S, n: int, eps, allow=None, helix=None):
    """(max score, [Lp, Lp] 0-based pair indicator) under perturbation eps:
    the gradient of the max-plus score picks the winning monomial."""
    eps = eps.detach().requires_grad_(True)
    with torch.enable_grad():
        score = _cf_logz(tb, S, n, eps, "max", allow, False, helix)
        g, = torch.autograd.grad(score, eps)
    return score.detach(), g[1:, 1:] > 0.5


def _mapping(ind: torch.Tensor) -> torch.Tensor:
    """[Lp] partner index or -1 (int32, 0-based) of a pair indicator."""
    Lp = ind.shape[0]
    ii, jj = torch.nonzero(ind, as_tuple=True)
    ii, jj = ii[:Lp].to(torch.int32), jj[:Lp].to(torch.int32)
    mapping = torch.full((Lp,), -1, dtype=torch.int32, device=ind.device)
    mapping[ii.long()] = jj
    mapping[jj.long()] = ii
    return mapping


def cf_viterbi(S, n: int, model: str = "complementary", device="cuda",
               allow=None, helix=None):
    """(score, mapping) of the maximum-scoring structure: the Viterbi score
    (float64, 0-d) and the [Lp] partner index or -1 (int32, 0-based).

    The max-plus score is the zero-temperature log Z, and its gradient with
    respect to the ScoreBasePair perturbation is the indicator of the argmax
    structure's pairs, so the reference's explicit traceback
    (InferenceEngine.ipp:3023) is one reverse-mode pass.  The tie-break
    perturbation is subtracted from the returned score."""
    dev = resolve(device)
    S = _codes(S, dev)
    eps = _tie_break(S.shape[0] + 1, dev)
    score, ind = _max_structure(get_cf_tables(model, dev), S, int(n), eps,
                                allow, helix)
    score = score - torch.sum(torch.where(ind, eps[1:, 1:], 0.0))
    return score, _mapping(ind)


def cf_stochastic_traceback(S, n: int, num_samples: int = 1,
                            model: str = "complementary", seed: int = 0,
                            device="cuda", allow=None):
    """Exact samples from the CRF structure distribution (reference
    InferenceEngine.ipp:5012 PredictPairingsStochasticTraceback): a list of
    num_samples mappings ([n] partner index or -1, 0-based, numpy int64).

    The inside loop runs once on `device` and emits the F5 / FC / FM / FMT
    tables; the recursive case sampling then runs on the host in numpy over
    this module's last-helix decomposition, as the JAX package's does
    (ops/contrafold.py:440-600), with np.random.default_rng(seed): a seed
    gives the JAX package's samples."""
    dev = resolve(device)
    S = _codes(S, dev)
    Lp = S.shape[0]
    tables = get_cf_tables(model, dev)
    with torch.no_grad():
        F5, FCs, FM, FMTs = (t.cpu().numpy() for t in _cf_logz(
            tables, S, int(n), _zeros_eps(S), "sum", allow, True))
    n = int(n)
    tb = CFTables(*[t.cpu().numpy() for t in tables])
    s = np.zeros((Lp + 2,), np.int64)
    s[1:Lp + 1] = S.cpu().numpy()
    al = None
    if allow is not None:
        al = np.asarray(allow, bool)
        al = al | al.T
    idx = np.arange(Lp + 1)
    b_mul = float(tb.multi_unpaired)

    def b_ext(j):
        return float(tb.ext_unpaired) if 1 <= j <= n else 0.0

    def pairable(a, b):
        if not (1 <= a < b <= n and bool(tb.compl[s[a], s[b]])):
            return False
        return al is None or bool(al[a - 1, b - 1])

    def FCv(i, jp):
        return FCs[jp - 2][i] if jp >= 2 else NEG

    def fmh(j):
        """fmh_j[k]: last helix (k+1, j) of a multiloop segment."""
        out = np.full((Lp + 1,), NEG)
        for k in range(0, j - 1):
            if pairable(k + 1, j):
                inner = FCv(k + 1, j)
                ja = (tb.closing[s[j], s[k + 1]]
                      + tb.dangle_l[s[j], s[k + 1], s[j + 1]]
                      + tb.dangle_r[s[j], s[k + 1], s[k]])
                out[k] = inner + ja + tb.multi_paired + tb.bp[s[k + 1], s[j]]
        return out

    rng = np.random.default_rng(seed)

    def choose(logw, ref):
        w = np.exp(np.asarray(logw) - ref)
        w = np.where(np.isfinite(w), w, 0.0)
        t = w.sum()
        if not t > 0.5:
            raise RuntimeError(f"stochastic traceback: case weights sum to "
                               f"{t} of their table entry {ref}")
        return int(rng.choice(len(w), p=w / t))

    def sample_F5(j, pairs):
        while j > 0:
            fm_ = fmh(j)
            ext = fm_ - tb.multi_paired + tb.ext_paired
            logw = np.concatenate([[F5[j - 1] + b_ext(j)], F5 + ext])
            c = choose(logw, F5[j])
            if c == 0:
                j -= 1
                continue
            k = c - 1
            pairs.append((k + 1, j))
            sample_FC(k + 1, j, pairs)
            j = k

    def sample_FC(i, jp, pairs):
        m = jp - 1
        span = m - i
        cases, logw = [], []
        jb = (tb.closing[s[i], s[m + 1]]
              + tb.tm[s[i], s[m + 1], s[i + 1], s[m]])
        if span >= 3:
            cases.append(("hp",))
            logw.append(tb.hairpin_len[min(span, 30)] + jb)
        if pairable(i + 1, m) and i + 2 <= m:
            cases.append(("stk",))
            logw.append(FCv(i + 1, m) + tb.bp[s[i + 1], s[m]]
                        + tb.stack[s[i], s[m + 1], s[i + 1], s[m]])
        for l1 in range(W):
            a = i + l1 + 1
            if a > Lp:
                break
            for d in range(W):
                if d > MAXLOOP - l1 or (l1 == 0 and d == 0):
                    continue
                q = m - d
                if not (q >= 1 and a + 1 <= q and pairable(a, q)):
                    continue
                v = (FCv(a, q) + tb.bp[s[a], s[q]] + tb.closing[s[q], s[a]]
                     + tb.tm[s[q], s[a], s[q + 1], s[a - 1]]
                     + tb.single[l1][d] + jb)
                if l1 == 0 and d == 1:
                    v += tb.bulge0x1[s[m]]
                elif l1 == 1 and d == 0:
                    v += tb.bulge0x1[s[i + 1]]
                elif l1 == 1 and d == 1:
                    v += tb.int1x1[s[i + 1], s[m]]
                cases.append(("sng", a, q))
                logw.append(v)
        ja = (tb.closing[s[i], s[m + 1]]
              + tb.dangle_l[s[i], s[m + 1], s[i + 1]]
              + tb.dangle_r[s[i], s[m + 1], s[m]])
        cases.append(("mul",))
        logw.append(FMTs[m - 1][i] + ja + tb.multi_paired + tb.multi_base
                    if m >= 1 else NEG)
        c = cases[choose(logw, FCv(i, jp))]
        if c[0] == "stk":
            pairs.append((i + 1, m))
            sample_FC(i + 1, m, pairs)
        elif c[0] == "sng":
            pairs.append((c[1], c[2]))
            sample_FC(c[1], c[2], pairs)
        elif c[0] == "mul":
            sample_FMT(i, m, pairs)

    def last_helix(start_of, j, ref, pairs):
        """Split off the last helix (kk+1, j) of a >=2-branch segment."""
        fm_ = fmh(j)
        logw = start_of + fm_
        kk = choose(logw, ref)
        pairs.append((kk + 1, j))
        sample_FC(kk + 1, j, pairs)
        return kk

    def sample_FMT(k, j, pairs):
        while True:
            fm2 = _np_lse(FM[k] + fmh(j))
            prev = FMTs[j - 2][k] + (b_mul if j <= n else 0.0) \
                if j >= 2 else NEG
            c = choose([fm2, prev], FMTs[j - 1][k])
            if c == 1:
                j -= 1
                continue
            kk = last_helix(FM[k], j, fm2, pairs)
            sample_FM(k, kk, pairs)
            return

    def sample_FM(i, k, pairs):
        while True:
            fm_ = fmh(k)
            R = np.where(idx >= i, (idx - i) * b_mul, NEG)
            fm1 = _np_lse(R + fm_)
            fm2 = _np_lse(FM[i] + fm_)
            prev = FM[i][k - 1] + (b_mul if k <= n else 0.0) if k >= 1 else NEG
            c = choose([fm1, prev, fm2], FM[i][k])
            if c == 1:
                k -= 1
                continue
            if c == 0:
                kk = choose(R + fm_, fm1)
                pairs.append((kk + 1, k))
                sample_FC(kk + 1, k, pairs)
                return
            kk = last_helix(FM[i], k, fm2, pairs)
            k = kk

    out = []
    for _ in range(num_samples):
        pairs = []
        sample_F5(n, pairs)
        mp = -np.ones((n,), np.int64)
        for a, b in pairs:
            mp[a - 1], mp[b - 1] = b - 1, a - 1
        out.append(mp)
    return out


def _np_lse(v):
    m = np.max(v)
    if not np.isfinite(m):
        return NEG
    return float(m + np.log(np.exp(v - m).sum()))


def cf_mea(bpp, n: int, gamma: float = 6.0):
    """Maximum-expected-accuracy decode (reference
    InferenceEngine.ipp:4837-5010 PredictPairingsPosterior): maximize
    sum_unpaired q_i + 2*gamma * sum_pairs p_ij with q_i = 1 - sum_j p_ij
    by the Nussinov-style DP on the host in numpy (the JAX package's,
    ops/contrafold.py:611-669); bpp may be a tensor on any device.  Returns
    the mapping [n] with partner index or -1 (0-based, numpy int64)."""
    if isinstance(bpp, torch.Tensor):
        bpp = bpp.detach().cpu().numpy()
    bpp = np.asarray(bpp, np.float64)[:n, :n]
    p = bpp + bpp.T
    # unclamped, as the reference's unpaired posterior (tie-break parity;
    # accumulated float error can push q_i marginally below 0)
    q = 1.0 - p.sum(axis=1)
    M = np.full((n, n), 0.0)
    for i in range(n):
        M[i, i] = q[i]
    ps = 2.0 * gamma * bpp
    # choice recorded during the DP, as the reference's traceback does
    # (InferenceEngine.ipp:4917-4997): 0 = i unpaired, 1 = j unpaired,
    # 2 = (i, j) paired, 3+off = bifurcation at k = i + off
    C = np.zeros((n, n), np.int64)
    for s in range(1, n):
        i = np.arange(0, n - s)
        j = i + s
        cand = np.empty((3 + s, n - s))
        cand[0] = M[i + 1, j] + q[i]
        cand[1] = M[i, j - 1] + q[j]
        pair = ps[i, j].copy()
        if s >= 2:
            pair += M[i + 1, j - 1]
        cand[2] = pair
        for off in range(s):
            k = i + off
            cand[3 + off] = M[i, k] + M[k + 1, j]
        am = np.argmax(cand, axis=0)
        M[i, j] = cand[am, np.arange(n - s)]
        C[i, j] = am
    mapping = -np.ones((n,), np.int64)
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if i >= j:
            continue
        c = C[i, j]
        if c == 0:
            stack.append((i + 1, j))
        elif c == 1:
            stack.append((i, j - 1))
        elif c == 2:
            mapping[i], mapping[j] = j, i
            stack.append((i + 1, j - 1))
        else:
            k = i + int(c - 3)
            stack.append((i, k))
            stack.append((k + 1, j))
    return mapping


# --------------------------------------------------------------------------
# UseLoss: max-margin (loss-augmented) inference (reference
# InferenceEngine::UseLoss, InferenceEngine.ipp:1824).  The Hamming-style
# pair loss decomposes onto the ScoreBasePair perturbation eps:
#     loss(y; y*) = sum_{ij in y} [fp*(ij not in y*) - fn*(ij in y*)]
#                   + fn*|y*|                         (a constant)
# so loss-augmented inference is one max-semiring pass with eps = the loss
# matrix, plus the constant.
# --------------------------------------------------------------------------


def cf_loss_matrix(mapping_true, Lp: int, fp: float = 1.0, fn: float = 1.0,
                   device="cuda"):
    """(eps [Lp+1, Lp+1] float64 on `device`, 1-based; const): the pair-
    decomposed Hamming loss against the true 0-based mapping (partner index
    or -1)."""
    dev = resolve(device)
    eps = np.full((Lp + 1, Lp + 1), fp, np.float64)
    npairs = 0
    for i, m in enumerate(np.asarray(mapping_true)):
        if m >= 0 and i < m:
            eps[i + 1, m + 1] = -fn
            npairs += 1
    return torch.as_tensor(eps, device=dev), fn * npairs


def cf_loss_augmented_viterbi(S, n: int, mapping_true, fp: float = 1.0,
                              fn: float = 1.0, model: str = "complementary",
                              device="cuda", allow=None):
    """argmax_y [score(y) + loss(y; y_true)], the separation oracle of
    max-margin training (reference UseLoss + ComputeViterbi).

    Returns (augmented_score, score, mapping): the loss-augmented optimum,
    the unaugmented score of that structure (float64, 0-d) and its mapping
    ([Lp] int32, partner or -1)."""
    dev = resolve(device)
    S = _codes(S, dev)
    eps, const = cf_loss_matrix(mapping_true, S.shape[0], fp, fn, dev)
    # the tie-break on top of the loss perturbation (see cf_viterbi)
    eps = eps + _tie_break(S.shape[0] + 1, dev)
    score_p, ind = _max_structure(get_cf_tables(model, dev), S, int(n), eps,
                                  allow)
    e = eps[1:, 1:]
    chosen_eps = torch.sum(torch.where(ind, e, 0.0))
    loss = torch.where(e < 0, torch.full_like(e, -fn), torch.full_like(e, fp))
    aug = score_p - chosen_eps + torch.sum(torch.where(ind, loss, 0.0)) \
        + const
    return aug, score_p - chosen_eps, _mapping(ind)


def cf_margin(S, n: int, mapping_true, fp: float = 1.0, fn: float = 1.0,
              model: str = "complementary", device="cuda", allow=None):
    """Structured hinge loss max(0, max_y[score(y)+loss(y)] - score(y*)),
    the per-example objective of CONTRAfold's max-margin training (reference
    Config USE_LOSS + InferenceEngine.ipp:1824); float64, 0-d."""
    dev = resolve(device)
    S = _codes(S, dev)
    Lp = S.shape[0]
    # score(y*): the max with only the true pairs allowed AND each forced by
    # a large eps bonus (subtracted back); the mask alone would let the max
    # drop an unfavourable true pair
    mt = np.asarray(mapping_true)
    allow_true = np.zeros((Lp, Lp), bool)
    M = 1e4
    eps_force = np.zeros((Lp + 1, Lp + 1))
    npairs = 0
    for i, m in enumerate(mt):
        if m >= 0:
            allow_true[i, m] = True
            if i < m:
                eps_force[i + 1, m + 1] = M
                npairs += 1
    with torch.no_grad():
        s_true = _cf_logz(get_cf_tables(model, dev), S, int(n),
                          torch.as_tensor(eps_force, device=dev), "max",
                          allow_true) - M * npairs
    aug, _, _ = cf_loss_augmented_viterbi(S, n, mapping_true, fp, fn, model,
                                          dev, allow)
    return torch.clamp(aug - s_true, min=0.0)
