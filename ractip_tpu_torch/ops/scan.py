"""Batched McCaskill fold: inside/outside column scans and pair probabilities.

Port of ractip_tpu/ops/scan_pallas.py.  Three wrappers hold the kernels:

  inside   (K1)  csrc/inside.cu   <- scan_pallas.inside_pallas_streamed
  outside  (K2)  csrc/outside.cu  <- scan_pallas.outside_pallas_streamed
  q2       (K3)  csrc/q2.cu       <- scan_pallas.q2_pallas

Each wrapper runs its plain PyTorch version when the tensors it is given lie
on the CPU, and launches its CUDA kernel (or raises) when they lie on a GPU.
The plain versions are column loops over j with tensor ops over (B, i); the
inside and outside ones also serve the cofold (ops/cofold.py), whose cut
masks they apply when given a per-instance cut.

Kernel layout: the scans stream every [B, L, L] matrix per instance in
column-major order, X[b, j, i] = M[b, i, j], and take the factor
matrices stacked as F[f, b, j, i].  The public functions batch_inside and
batch_fold return the natural [B, L_i, L_j] layout of the JAX versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAXLOOP
from ..params.boltz import (POW2, W, BoltzTables, TorchTables, get_boltz,
                            sig_tables, tables_to_torch)
from ..utils.timing import stage
from . import _cuda
from .factors import FoldFactors, fold_factors

FACTOR_FIELDS = FoldFactors._fields           # 15 names, fixed order
HUGE = 1e30
ZLO = 1e-12
ZHI = 1e12
SCALE_E0 = 185.0
_SPECIALS = (("pstk", 1, 1), ("p11", 2, 2), ("p21a", 2, 3), ("p21b", 3, 2),
             ("p22", 3, 3), ("pb15", 2, 1), ("pb13", 1, 2))


# --------------------------------------------------------------------------
# layout and lane helpers
# --------------------------------------------------------------------------

def stack_cols(ff) -> torch.Tensor:
    """Factor NamedTuple -> F[f, b, j, i] in the tuple's field order."""
    return torch.stack([t.transpose(-1, -2) for t in ff]).contiguous()


def _up(t: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = t[..., i+k], zero fill."""
    if k == 0:
        return t
    out = torch.zeros_like(t)
    if k < t.shape[-1]:
        out[..., :-k] = t[..., k:]
    return out


def _dn(t: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = t[..., i-k], zero fill."""
    if k == 0:
        return t
    out = torch.zeros_like(t)
    if k < t.shape[-1]:
        out[..., k:] = t[..., :-k]
    return out


def _scan(v: torch.Tensor, pows: torch.Tensor, up: bool) -> torch.Tensor:
    """Suffix (up) or prefix sums sum_k a^|k-i| v[k] by recursive doubling,
    pows[:, s] = a^(2^s): the TPU kernels' lane-shift scan, step for step."""
    L = v.shape[-1]
    y, s = v, 1
    for idx in range(POW2):
        if s >= L:
            break
        y = y + pows[:, idx:idx + 1] * (_up(y, s) if up else _dn(y, s))
        s *= 2
    return y


def _clamp(t: torch.Tensor) -> torch.Tensor:
    """min(t, HUGE), keeping NaN (as the kernels and jnp.minimum do)."""
    return torch.where(t > HUGE, torch.full_like(t, HUGE), t)


def _cut_masks(L: int, cut: torch.Tensor, dtype):
    """(M5 [W+2, B, L], J1 [B, L], low [B, L]) for per-instance cuts [B]."""
    lane = torch.arange(L, device=cut.device)[None, :]
    ct = cut.to(torch.long)[:, None]
    d = torch.arange(W + 2, device=cut.device)[:, None, None]
    M5 = (~((lane[None] < ct[None]) & (ct[None] <= lane[None] + d))).to(dtype)
    J1 = (lane != ct).to(dtype)
    return M5, J1, (lane < ct).to(dtype)


def _contract(Mcols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """acc[b, i] = sum_l Mcols[b, l, i] v[b, l]."""
    return torch.einsum("bli,bl->bi", Mcols, v)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def inside_plain(F, w2k, bulge_k, sig, pows, cut=None):
    """Inside column scan (plain PyTorch).  Returns (qm1_c, qb_c, qm_c, aux_c,
    q1): aux is qm2 for the fold (column j-1 written at step j, column L-1
    left zero) and the exterior-segment table qx for the cofold (cut given).
    """
    _cuda.note_plain("co_inside" if cut is not None else "inside", F)
    co = cut is not None
    names = FACTOR_FIELDS + (("fcx",) if co else ())
    f = dict(zip(names, F))
    NF, B, L, _ = F.shape
    dt, dev = F.dtype, F.device
    zeros = lambda *s: torch.zeros(*s, dtype=dt, device=dev)
    qm1_c, qb_c, qm_c, aux_c = (zeros(B, L, L) for _ in range(4))
    q1 = zeros(B, L)
    sg = sig[:, None]
    sm = pows[:, 0:1]
    lane = torch.arange(L, device=dev)[None, :]
    qm1P, qxP, qxA = zeros(B, L), zeros(B, L), zeros(B, L)
    one = torch.ones((), dtype=dt, device=dev)
    if co:
        M5, J1, low = _cut_masks(L, cut, dt)
        ct = cut.to(torch.long)[:, None]
    u2 = torch.arange(W, device=dev)                  # window offsets 0..30
    for j in range(L):
        col = lambda n: f[n][:, j]
        if co:
            new = torch.where(lane < ct, qxP, (lane == ct).to(dt))
            qxA = torch.where(ct == j, new, qxA)
        # window source columns k = j-1-u2 (u2 = 0..30), zero when k < 0
        k = j - 1 - u2
        kc = k.clamp(min=0)
        ok = (k >= 0).to(dt)[None, :, None]
        if co:
            ok = ok * ((k[None, :] >= ct) | (j < ct)).to(dt)[:, :, None]
        qbw = qb_c[:, kc] * ok                         # [B, W, L]
        X = qbw * f["minn"][:, kc]
        A = qbw * f["taur"][:, kc]
        acc = torch.einsum("bvu,bui->bvi", w2k, X)     # [B, W(u1), L]
        gen = torch.zeros_like(qm1P)
        for u1 in range(1, MAXLOOP):
            t = _up(acc[:, u1], u1 + 1)
            gen = gen + (M5[u1 + 1] * t if co else t)
        gen = gen * col("mout")
        acol = A[:, 0]
        b5 = torch.zeros_like(qm1P)
        for m in range(2, MAXLOOP + 1):
            t = _up(acol, m + 1)
            b5 = b5 + bulge_k[:, m:m + 1] * (M5[m + 1] * t if co else t)
        b3 = torch.einsum("bm,bmi->bi", bulge_k[:, 2:], A[:, 2:])
        bulges = col("tau") * (b5 + (M5[1] * _up(b3, 1) if co else _up(b3, 1)))

        v = _up(qm1P, 1) * (_up(J1, 1) if co else one)
        qm2col = _clamp(_contract(qm_c, v))

        def qbat(di, dj):
            return _up(qb_c[:, j - dj], di) if j - dj >= 0 else zeros(B, L)

        qbcol = (col("fhn") + gen + bulges
                 + col("pstk") * qbat(1, 1) + col("p11") * qbat(2, 2)
                 + col("p21a") * qbat(2, 3) + col("p21b") * qbat(3, 2)
                 + col("p22") * qbat(3, 3) + col("pb15") * qbat(2, 1)
                 + col("pb13") * qbat(1, 2))
        if co:
            mlgate = (ct != j).to(dt)
            qxB = torch.where(ct < j, qxP.gather(1, ct.clamp(max=L - 1)), one)
            qbcol = (qbcol + mlgate * col("fmc") * sg * sg
                     * (M5[1] * _up(qm2col, 1))
                     + col("fcx") * _up(qxA, 1) * qxB)
        else:
            qbcol = qbcol + col("fmc") * sg * sg * _up(qm2col, 1)
        qbcol = _clamp(qbcol)

        if co:
            qm1col = _clamp(mlgate * sm * qm1P + qbcol * col("fmb"))
            dterm = torch.where(lane < ct, _scan(qm1col * low, pows, True),
                                _scan(qm1col, pows, True))
            v2 = _up(qm1col, 1) * _up(J1, 1)
        else:
            qm1col = _clamp(sm * qm1P + qbcol * col("fmb"))
            dterm = _scan(qm1col, pows, True)
            v2 = _up(qm1col, 1)
        qmcol = _clamp(dterm + _contract(qm_c, v2))

        q1prev = q1[:, j - 1:j] if j >= 1 else one.expand(B, 1)
        q1pad = torch.cat([one.expand(B, 1), q1[:, :-1]], dim=1)
        qbecol = qbcol * col("fe")
        term = q1pad * qbecol if co else q1pad * qbcol * col("fe")
        q1[:, j] = _clamp(sg * q1prev + term.sum(1, keepdim=True))[:, 0]

        if co:
            qxsh = _contract(aux_c, _up(qbecol, 1))
            qxcol = _clamp(sg * (qxP + (lane == j).to(dt)) + qxsh + qbecol)
            aux_c[:, j] = qxcol
            qxP = qxcol
        else:
            aux_c[:, max(j - 1, 0)] = qm2col
        qm_c[:, j] = qmcol
        qb_c[:, j] = qbcol
        qm1_c[:, j] = qm1col
        qm1P = qm1col
    if not co:
        aux_c[:, L - 1] = 0.0
    return qm1_c, qb_c, qm_c, aux_c, q1


def outside_plain(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig, pows,
                  cut=None, qxN=None, qxA=None, qBpref=None):
    """Outside column scan (plain PyTorch) -> ob_c.  qmN/qxN: natural
    [B, L_i, L_j]; qm1_c: column layout; the cofold (cut given) adds the
    exposed-cut spanning-pair adjoints from qxN, qxA and qBpref."""
    _cuda.note_plain("co_outside" if cut is not None else "outside", F)
    co = cut is not None
    names = FACTOR_FIELDS + (("fcx",) if co else ())
    f = dict(zip(names, F))
    NF, B, L, _ = F.shape
    dt, dev = F.dtype, F.device
    zeros = lambda *s: torch.zeros(*s, dtype=dt, device=dev)
    ob_c = zeros(B, L, L)
    om = zeros(B, L, L)                   # om[b, m, i] = om(i, m)
    pend, sm1S = zeros(B, L), zeros(B, L)
    vvec, wvec, GA = zeros(B, L), zeros(B, L), zeros(B, L)
    sg = sig[:, None]
    sm = pows[:, 0:1]
    lane = torch.arange(L, device=dev)[None, :]
    one = torch.ones((), dtype=dt, device=dev)
    if co:
        M5, J1, low = _cut_masks(L, cut, dt)
        ct = cut.to(torch.long)[:, None]
    u2 = torch.arange(W, device=dev)
    for j in range(L):
        c = L - 1 - j
        col = lambda n: f[n][:, c]
        omcol = om[:, c]
        qmt = _contract(qmN, omcol)
        if co:
            dterm = torch.where(lane < ct, _scan(omcol, pows, False),
                                _scan(omcol * (1 - low), pows, False))
            om1col = pend + dterm + J1 * _dn(qmt, 1)
            sm1 = om1col + (ct != c + 1).to(dt) * sm * sm1S
        else:
            om1col = pend + _scan(omcol, pows, False) + _dn(qmt, 1)
            sm1 = om1col + sm * sm1S
        sm1S = sm1
        obcol = q1pad * col("fe") * q2[:, c + 1:c + 2]
        obcol = obcol + col("fmb") * sm1
        # window columns k = c+1+u2 (u2 = 0..30), zero past L
        k = c + 1 + u2
        kc = k.clamp(max=L - 1)
        ok = (k < L).to(dt)[None, :, None]
        if co:
            ok = ok * ((c >= ct) | (k[None, :] < ct)).to(dt)[:, :, None]
        obw = ob_c[:, kc] * ok                         # [B, W, L]
        OM = obw * f["mout"][:, kc]
        OA = obw * f["tau"][:, kc]
        acc = torch.einsum("bvu,bui->bvi", w2k, OM)
        gen = torch.zeros_like(pend)
        for u1 in range(1, MAXLOOP):
            gen = gen + _dn(M5[u1 + 1] * acc[:, u1] if co else acc[:, u1],
                            u1 + 1)
        obcol = obcol + gen * col("minn")
        oa1 = OA[:, 0]
        b5 = torch.zeros_like(pend)
        for m in range(2, MAXLOOP + 1):
            b5 = b5 + bulge_k[:, m:m + 1] * _dn(M5[m + 1] * oa1 if co else oa1,
                                                m + 1)
        b3 = torch.einsum("bm,bmi->bi", bulge_k[:, 2:], OA[:, 2:])
        if co:
            b3 = M5[1] * b3
        obcol = obcol + col("taur") * (b5 + _dn(b3, 1))
        for name, di, dj in _SPECIALS:
            if c + dj < L:
                obcol = obcol + _dn(f[name][:, c + dj] * ob_c[:, c + dj], di)
        if co:
            qrow = qxN[:, min(c + 1, L - 1)]
            hb = (_up(vvec, 1) * qrow).sum(1, keepdim=True)
            if c + 1 < L:
                hb = hb + vvec[:, c + 1:c + 2]
            obcol = obcol + torch.where(ct <= c, hb, 0.0) * col("fe") * qBpref
            if bool(((ct[:, 0] == c + 1) & (ct[:, 0] > 0)).any()):
                wv = _dn(wvec, 1)
                ga = wv + _dn(_contract(qxN, wv), 1)
                GA = torch.where(ct == c + 1, ga, GA)
            qseg = qxA[:, c + 1:c + 2] if c + 1 < L else zeros(B, 1)
            obcol = obcol + torch.where(ct > c, qseg, 0.0) * col("fe") * GA
        obcol = _clamp(obcol)

        if co:
            a = M5[1] * (obcol * col("fmc") * sg * sg * (ct != c).to(dt))
            w1 = (_up(qm1_c[:, c - 1], 1) if c >= 1 else zeros(B, L)) \
                * _up(J1, 1)
            w2 = _up(qm1_c[:, c], 1) * _up(J1, 1)
        else:
            a = obcol * col("fmc") * sg * sg
            w1 = _up(qm1_c[:, c - 1], 1) if c >= 1 else zeros(B, L)
            w2 = _up(qm1_c[:, c], 1)
        ash = _dn(a, 1)
        om = om + ash[:, None, :] * w1[:, :, None] \
            + omcol[:, None, :] * w2[:, :, None]
        pend = _dn(_contract(qmN, ash), 1)
        if co:
            pend = J1 * pend
            vval = (obcol * col("fcx") * _up(qxA, 1)).sum(1, keepdim=True)
            vvec[:, c] = torch.where(ct <= c, vval, 0.0)[:, 0]
            wvec = wvec + (ct <= c).to(dt) * obcol * col("fcx") \
                * qBpref[:, c:c + 1]
        ob_c[:, c] = obcol
    return ob_c


def q2_plain(qbe, sig, n):
    """Exterior suffix q2 [B, L+1] from qbe [B, L_i, L_k] (plain PyTorch)."""
    _cuda.note_plain("q2", qbe)
    B, L, _ = qbe.shape
    q2 = torch.ones(B, L + 1, dtype=qbe.dtype, device=qbe.device)
    sg = sig[:, None]
    nn = n.to(torch.long)[:, None]
    for i in range(L - 1, -1, -1):
        s = (qbe[:, i] * q2[:, 1:]).sum(1, keepdim=True)
        val = torch.where(nn <= i, torch.ones_like(s),
                          _clamp(sg * q2[:, i + 1:i + 2] + s))
        q2[:, i] = val[:, 0]
    return q2


# --------------------------------------------------------------------------
# kernel wrappers: plain version on CPU tensors, CUDA kernel on GPU tensors
# --------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def on_device(a, dev, dtype) -> torch.Tensor:
    """a (numpy, a sequence or a tensor) as a tensor of dtype on dev."""
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                           device=dev).to(dtype)


def lengths(n):
    """The kernels' lengths argument: n [B] as contiguous int32 (or None)."""
    return None if n is None else n.to(torch.int32).contiguous()


def inside(F, w2k, bulge_k, sig, pows, n=None):
    """K1: fold inside scan -> (qm1_c, qb_c, qm_c, qm2_c, q1).  n [B]: the
    sequences' lengths (None: the whole bucket); the kernel sweeps only
    those, the plain version everything (the tables agree either way,
    padding included)."""
    if _on_cpu(F):
        return inside_plain(F, w2k, bulge_k, sig, pows)
    return _cuda.launch_inside(F, w2k, bulge_k, sig, pows, n=lengths(n))


def outside(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig, pows, n=None):
    """K2: fold outside scan -> ob_c (n as for inside)."""
    if _on_cpu(F):
        return outside_plain(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig,
                             pows)
    return _cuda.launch_outside(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig,
                                pows, n=lengths(n))


def q2(qbe, sig, n):
    """K3: exterior suffix partition function -> q2 [B, L+1]."""
    if _on_cpu(qbe):
        return q2_plain(qbe, sig, n)
    return _cuda.launch_q2(qbe, sig, n.to(torch.int32).contiguous())


# --------------------------------------------------------------------------
# batched fold with adaptive per-instance scaling
# --------------------------------------------------------------------------

def as_tables(tables, device, dtype=torch.float32) -> TorchTables:
    if isinstance(tables, TorchTables):
        return tables
    if not isinstance(tables, BoltzTables):
        tables = get_boltz(tables)
    return tables_to_torch(tables, device, dtype)


def _good(zn, sat):
    return (~sat) & (zn > ZLO) & (zn < ZHI) & torch.isfinite(zn)


def rescale(es, zn, sat, nf, kt):
    """One step of the adaptive scaling loop (scan_pallas.py:698-707)."""
    step = kt * 60.0 / nf
    bad_hi = sat | ~torch.isfinite(zn) | (zn >= ZHI)
    es2 = torch.where(bad_hi, es + step,
                      torch.where(zn > 0, es + kt * torch.log(zn) / nf,
                                  es - step))
    return torch.where(_good(zn, sat), es, es2)


def saturated(zn, *tables):
    hi = 0.99 * HUGE
    sat = ~torch.isfinite(zn)
    for t in tables:
        sat = sat | (t.reshape(t.shape[0], -1).max(1).values >= hi)
    return sat


def batch_inside(tt: TorchTables, S, n, es, timer=None, allow=None):
    """One batched inside pass at per-instance scale energies es [B]
    (allow: the optional bool [B, L, L] pair mask of -c).

    Returns (ins dict of natural [B, ...] tensors: qb, qm, qm1, qm2, q1, q2,
    zn, sat; aux dict with the kernel-layout tensors the outside pass
    consumes; sig [B])."""
    B, L = S.shape
    dt = tt.dtype
    sig = torch.exp(-es.to(dt) / tt.scalar(tt.bt.kt))
    with stage(timer, "factors"):
        ff = fold_factors(tt, S, n, sig, allow)
        F = stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
    qm1_c, qb_c, qm_c, qm2_c, q1 = inside(F, w2k, bulge_k, sig, pows, n)
    qb, qm, qm1 = qb_c.transpose(1, 2), qm_c.transpose(1, 2), \
        qm1_c.transpose(1, 2)
    # last qm2 column (segment ending at L-1), as ops.mccaskill.inside does
    v = torch.cat([qm1[:, 1:, L - 1], torch.zeros(B, 1, dtype=dt,
                                                 device=S.device)], 1)
    qm2 = qm2_c.transpose(1, 2).clone()
    qm2[:, :, L - 1] = torch.einsum("bli,bl->bi", qm_c, v)
    zn = q1.gather(1, (n.to(torch.long) - 1).clamp(min=0)[:, None])[:, 0]
    qbe = (qb * ff.fe).contiguous()
    q2v = q2(qbe, sig, n)
    sat = saturated(zn, qb_c, qm_c, q1)
    ins = dict(qb=qb, qm=qm, qm1=qm1, qm2=qm2, q1=q1, q2=q2v, zn=zn, sat=sat)
    aux = dict(ff=ff, F=F, qm1_c=qm1_c, w2k=w2k, bulge_k=bulge_k, pows=pows)
    return ins, aux, sig


def adaptive(run, es0: float, n, kt: float, max_iter: int, dtype):
    """Adaptive per-instance scaling as a host loop (scan_pallas.py:687-710):
    re-run `run(es)` on the whole batch, es held where the scaled Z is in
    range, until every instance is in range or max_iter passes.
    Returns (es, ins, aux, sig)."""
    nf = n.to(dtype).clamp(min=1.0)
    es = torch.full((n.shape[0],), es0, dtype=dtype, device=n.device)
    ins, aux, sig = run(es)
    for _ in range(max_iter):
        if bool(_good(ins["zn"], ins["sat"]).all()):
            break
        es = rescale(es, ins["zn"], ins["sat"], nf, kt)
        ins, aux, sig = run(es)
    return es, ins, aux, sig


def pair_probs(qb, ob, zn):
    """bpp = qb * ob / Z per instance (0 where Z <= 0)."""
    z = zn[:, None, None]
    return torch.where(z > 0, qb * ob / z, torch.zeros_like(ob))


def batch_fold(tables, S, n, device, max_iter: int = 8,
               es0: float = SCALE_E0, dtype=torch.float32,
               timer=None, allow=None) -> dict:
    """Batched inside+outside with per-instance adaptive pf scaling.

    S [B, L] codes, n [B] lengths (numpy or torch), allow (optional bool
    [B, L, L], numpy or torch) the -c pair mask, applied to the factors of
    every rescale round.  Returns a dict with
    ins (natural-layout inside tables), ff (FoldFactors), ob, bpp [B, L, L],
    sig [B], es [B]."""
    from ..device import resolve
    dev = resolve(device)
    tt = as_tables(tables, dev, dtype)
    S = on_device(S, dev, torch.long)
    n = on_device(n, dev, torch.long).clamp(min=1)
    B, L = S.shape
    if allow is not None:
        allow = on_device(allow, dev, torch.bool)

    es, ins, aux, sig = adaptive(
        lambda es: batch_inside(tt, S, n, es, timer, allow), es0, n,
        tt.bt.kt, max_iter, tt.dtype)
    q1pad = torch.cat([torch.ones(B, 1, dtype=tt.dtype, device=dev),
                       ins["q1"][:, :-1]], 1).contiguous()
    ob_c = outside(aux["F"], ins["qm"].contiguous(), aux["qm1_c"], q1pad,
                   ins["q2"], aux["w2k"], aux["bulge_k"], sig, aux["pows"], n)
    ob = ob_c.transpose(1, 2)
    return dict(ins=ins, ff=aux["ff"], ob=ob, bpp=pair_probs(ins["qb"], ob,
                                                            ins["zn"]),
                sig=sig, es=es)
