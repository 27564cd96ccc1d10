"""Accessibility (unpaired-window) probabilities from the fold's tables.

Port of ractip_tpu/ops/accessibility.py::unpaired_probs, batched: pu[b, a, w]
= P(bases a .. a+w-1 of instance b are all unpaired), w in 1..max_w (column
0 unused), summed over the exterior (E), hairpin (H), interior (I) and
multiloop (M) contexts of the window, exactly as the JAX version does.  Its
bilinear chains are plain matrix products outside any kernel (torch.matmul).
"""

from __future__ import annotations

import torch

from ..constants import MAXLOOP

from ..params.boltz import W, TorchTables, sig_tables


def _shift_cols(M: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., j] = M[..., j+k] (zero fill), k may be negative."""
    if k == 0:
        return M
    L = M.shape[-1]
    out = torch.zeros_like(M)
    if abs(k) >= L:
        return out
    if k > 0:
        out[..., :L - k] = M[..., k:]
    else:
        out[..., -k:] = M[..., :L + k]
    return out


def _shift_rows(M: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i, :] = M[..., i+k, :] (zero fill)."""
    return _shift_cols(M.transpose(-1, -2), k).transpose(-1, -2)


def _segment_matrix(M: torch.Tensor) -> torch.Tensor:
    """S[p, q] = M[p+1, q-1] for q - 1 >= p + 1, else 0."""
    S = _shift_rows(_shift_cols(M, -1), 1)
    L = M.shape[-1]
    I = torch.arange(L, device=M.device)
    return torch.where((I[None, :] - I[:, None] >= 2)[None], S,
                       torch.zeros((), dtype=M.dtype, device=M.device))


def unpaired_probs(tt: TorchTables, ff, ins: dict, ob: torch.Tensor,
                   n: torch.Tensor, max_w: int, sig: torch.Tensor
                   ) -> torch.Tensor:
    """pu [B, L, max_w+1] from FoldFactors ff, inside tables ins (natural
    layout: qb, qm, qm2, q1, q2, zn) and outer weights ob, per-instance
    lengths n [B] and scale factors sig [B]."""
    dt, dev = tt.dtype, ob.device
    B, L, _ = ob.shape
    sig = sig.to(dt)
    w2k, bulge_k, _ = sig_tables(tt, sig)
    smlb = sig * tt.scalar(tt.bt.ml_base)
    zn = ins["zn"][:, None, None]
    qb = ins["qb"]
    I = torch.arange(L, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    ws = torch.arange(max_w + 1, device=dev)
    b_of = I[:, None] + ws[None, :] - 1                      # [L, max_w+1]
    in_range = (ws[None, None, :] >= 1) & (b_of[None] < n[:, None, None])

    def at_ab(M):
        """M[b, a, a+w-1] for every window; zero out of range."""
        idx = b_of.clamp(0, L - 1)[None].expand(B, L, max_w + 1)
        return torch.where(in_range, M.gather(2, idx), zero)

    # ---- E: exterior
    q1pad = torch.cat([torch.ones(B, 1, dtype=dt, device=dev),
                       ins["q1"][:, :-1]], 1)
    q2pad = torch.cat([ins["q2"], torch.ones(B, max_w, dtype=dt, device=dev)],
                      1)
    end_idx = (I[:, None] + ws[None, :]).clamp(0, L + max_w - 1)
    q2e = q2pad.gather(1, end_idx.reshape(1, -1).expand(B, -1)).reshape(
        B, L, max_w + 1)
    puE = torch.where(in_range, q1pad[:, :, None]
                      * sig[:, None, None] ** ws[None, None, :].to(dt)
                      * q2e / zn, zero)

    # ---- H: hairpin
    X = ob * ff.fhn / zn
    row_pref = _shift_rows(torch.cumsum(X, 1), -1)
    col_suff = torch.flip(torch.cumsum(torch.flip(row_pref, [2]), 2), [2])
    puH = at_ab(_shift_cols(col_suff, 1))

    # ---- I: interior loops (band-exact 5'/3' probabilities)
    P5 = torch.zeros(B, L, W + 1, dtype=dt, device=dev)
    P3 = torch.zeros(B, L, W + 1, dtype=dt, device=dev)
    A = ob * ff.mout
    Bm = qb * ff.minn
    for u1 in range(1, MAXLOOP):
        Bs = torch.zeros_like(Bm)
        for u2 in range(1, MAXLOOP + 1 - u1):
            Bs = Bs + w2k[:, u1, u2, None, None] * _shift_cols(Bm, -(1 + u2))
        P5[:, :, u1 + 1] += (A * _shift_rows(Bs, u1 + 1)).sum(2)
    for u2 in range(1, MAXLOOP):
        Bs = torch.zeros_like(Bm)
        for u1 in range(1, MAXLOOP + 1 - u2):
            Bs = Bs + w2k[:, u1, u2, None, None] * _shift_rows(Bm, 1 + u1)
        P3[:, :, u2 + 1] += (A * _shift_cols(Bs, -(1 + u2))).sum(1)
    Aqt = qb * ff.taur
    obt = ob * ff.tau
    for m in range(2, MAXLOOP + 1):
        g5 = (obt * _shift_rows(_shift_cols(Aqt, -1), m + 1)).sum(2)
        P5[:, :, m + 1] += bulge_k[:, m:m + 1] * g5
        g3 = (obt * _shift_rows(_shift_cols(Aqt, -(m + 1)), 1)).sum(1)
        P3[:, :, m + 1] += bulge_k[:, m:m + 1] * g3
    for P, di, dj, d5, d3 in ((ff.pb15, 2, 1, 2, None),
                              (ff.pb13, 1, 2, None, 2),
                              (ff.p11, 2, 2, 2, 2), (ff.p21a, 2, 3, 2, 3),
                              (ff.p21b, 3, 2, 3, 2), (ff.p22, 3, 3, 3, 3)):
        contrib = ob * P * _shift_rows(_shift_cols(qb, -dj), di)
        if d5 is not None:
            P5[:, :, d5] += contrib.sum(2)
        if d3 is not None:
            P3[:, :, d3] += contrib.sum(1)
    S5 = torch.flip(torch.cumsum(torch.flip(P5, [2]), 2), [2]) / zn
    S3 = torch.flip(torch.cumsum(torch.flip(P3, [2]), 2), [2]) / zn

    puI = torch.zeros(B, L, max_w + 1, dtype=dt, device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    Ic = I[:, None]
    for t in range(MAXLOOP):
        i5 = Ic - 1 - t
        m5 = (b_of - i5 + 1).clamp(2, W)
        ok5 = (i5 >= 0) & (b_of - i5 <= MAXLOOP) & in_range
        v5 = S5[bidx, i5.clamp(0, L - 1)[None], torch.where(ok5, m5, W)]
        puI = puI + torch.where(ok5, v5, zero)
        j3 = b_of + 1 + t
        m3 = (j3 - Ic + 1).clamp(2, W)
        ok3 = (j3 < L) & (j3 - Ic <= MAXLOOP) & in_range
        v3 = S3[bidx, j3.clamp(0, L - 1)[None], torch.where(ok3, m3, W)]
        puI = puI + torch.where(ok3, v3, zero)

    # ---- M: multiloop
    C = ob * ff.fmc * (sig ** 2)[:, None, None] / zn
    qmS = _segment_matrix(ins["qm"])
    qm2S = _segment_matrix(ins["qm2"])
    d = I[None, :] - I[:, None]
    Erun = torch.where((d >= 1)[None], smlb[:, None, None]
                       ** (d - 1).clamp(min=0).to(dt)[None], zero)
    T = lambda M: M.transpose(1, 2)
    M_ab = (T(qm2S) @ C) @ T(qmS + Erun) + (T(qmS - qm2S) @ C) @ T(qmS) \
        + (T(Erun) @ C) @ T(qm2S)
    puM = at_ab(M_ab) * smlb[:, None, None] ** ws[None, None, :].to(dt)

    pu = puE + puH + puI + puM
    return torch.where(in_range, pu, zero)
