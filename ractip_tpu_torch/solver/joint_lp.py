"""Matrix-free PDHG for the joint-structure LP relaxation, batched.

Port of ractip_tpu/solver/joint_lp.py (make_ops :69, apply_A :128, rhs :174,
apply_AT :206, _op_norm :300, pdhg_solve :318, dual_bound :387) with the
batch axis written out in place of vmap: every operator and iterate carries
a leading batch dimension, and per-instance step sizes broadcast over it.
The constraint families are those of reference src/ractip.cpp:715-1222.
Plain PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .candidates import JointProblem, SolverConfig


def _sd(v):  # out[..., i] = v[..., i-1]
    return torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)


def _su(v):  # out[..., i] = v[..., i+1]
    return torch.cat([v[..., 1:], torch.zeros_like(v[..., :1])], -1)


def _mv(M, v):   # [B, R, K] @ [B, K] -> [B, R]
    return torch.einsum("brk,bk->br", M, v)


def _mtv(M, v):  # [B, R, K]^T @ [B, R] -> [B, K]
    return torch.einsum("brk,br->bk", M, v)


class Ops(NamedTuple):
    """Dense indicator operators of a batch of problems ([B, rows, K])."""

    Xb: torch.Tensor; X5: torch.Tensor; X3: torch.Tensor
    Yb: torch.Tensor; Y5: torch.Tensor; Y3: torch.Tensor
    Z1: torch.Tensor; Z2: torch.Tensor
    Cov1: torch.Tensor; St1: torch.Tensor; En1: torch.Tensor
    Cov2: torch.Tensor; St2: torch.Tensor; En2: torch.Tensor
    Cx: torch.Tensor; Cy: torch.Tensor; Cz: torch.Tensor


def make_ops(p: JointProblem, L1: int, L2: int) -> Ops:
    f32 = p.xc.dtype

    def oh(idx, m, L):  # [B, L, K]
        r = torch.arange(L, device=idx.device)[None, :, None]
        return (r == idx[:, None, :].long()).to(f32) * m[:, None, :]

    X5, X3 = oh(p.xi, p.xm, L1), oh(p.xj, p.xm, L1)
    Y5, Y3 = oh(p.yi, p.ym, L2), oh(p.yj, p.ym, L2)
    Z1, Z2 = oh(p.zi, p.zm, L1), oh(p.zj, p.zm, L2)

    def cover(lo, hi, m, L):
        r = torch.arange(L, device=lo.device)[None, :, None]
        return ((r >= lo[:, None, :]) & (r <= hi[:, None, :])).to(f32) \
            * m[:, None, :]

    Cov1, Cov2 = cover(p.vp, p.vq, p.vm, L1), cover(p.wp, p.wq, p.wm, L2)
    St1, En1 = oh(p.vp, p.vm, L1), oh(p.vq, p.vm, L1)
    St2, En2 = oh(p.wp, p.wm, L2), oh(p.wq, p.wm, L2)

    def crossing(i, j, m):
        # a strictly opens before b and they interleave: i_a<i_b<j_a<j_b
        c = ((i[:, :, None] < i[:, None, :]) & (i[:, None, :] < j[:, :, None])
             & (j[:, :, None] < j[:, None, :]))
        return c.to(f32) * m[:, :, None] * m[:, None, :]

    Cz = ((p.zi[:, :, None] < p.zi[:, None, :])
          & (p.zj[:, :, None] < p.zj[:, None, :])).to(f32) \
        * p.zm[:, :, None] * p.zm[:, None, :]
    return Ops(Xb=X5 + X3, X5=X5, X3=X3, Yb=Y5 + Y3, Y5=Y5, Y3=Y3, Z1=Z1,
               Z2=Z2, Cov1=Cov1, St1=St1, En1=En1, Cov2=Cov2, St2=St2,
               En2=En2, Cx=crossing(p.xi, p.xj, p.xm),
               Cy=crossing(p.yi, p.yj, p.ym), Cz=Cz)


def _families(cfg: SolverConfig):
    fam = ["az1", "az2", "crz"]
    if cfg.structure:
        fam += ["ax", "ay"]
        if cfg.in_pk:
            fam += ["crx", "cry"]
    if cfg.accessibility:
        fam += ["cov1", "cov2", "zv", "zw", "st1", "en1", "st2", "en2",
                "adj1", "adj2"]
        if cfg.structure:
            fam += ["xv", "yw"]
        if cfg.acc_num > 0:
            fam += ["nv", "nw"]
        if cfg.beta > 0.0:
            fam += ["regv", "regw"]
    elif cfg.structure:
        fam += ["cxz", "cyz"]
    if cfg.stacking:
        fam += ["sz1", "sz2"]
        if cfg.structure:
            fam += ["sx5", "sx3", "sy5", "sy3"]
    return tuple(fam)


def apply_A(cfg: SolverConfig, ops: Ops, u) -> dict:
    """A u, one [B, rows...] tensor per active constraint family."""
    x, y, z, v, w = u
    rx, ry = _mv(ops.Xb, x), _mv(ops.Yb, y)
    rz1, rz2 = _mv(ops.Z1, z), _mv(ops.Z2, z)
    cv, cw = _mv(ops.Cov1, v), _mv(ops.Cov2, w)
    out = {}
    for f in _families(cfg):
        if f == "ax": out[f] = rx
        elif f == "ay": out[f] = ry
        elif f == "az1": out[f] = rz1
        elif f == "az2": out[f] = rz2
        elif f == "cxz": out[f] = rx + rz1
        elif f == "cyz": out[f] = ry + rz2
        elif f == "cov1": out[f] = cv
        elif f == "cov2": out[f] = cw
        elif f == "xv": out[f] = rx + cv
        elif f == "yw": out[f] = ry + cw
        elif f == "zv": out[f] = rz1 - cv
        elif f == "zw": out[f] = rz2 - cw
        elif f == "st1": out[f] = _mv(ops.St1, v)
        elif f == "en1": out[f] = _mv(ops.En1, v)
        elif f == "st2": out[f] = _mv(ops.St2, w)
        elif f == "en2": out[f] = _mv(ops.En2, w)
        elif f == "adj1": out[f] = _sd(_mv(ops.En1, v)) + _mv(ops.St1, v)
        elif f == "adj2": out[f] = _sd(_mv(ops.En2, w)) + _mv(ops.St2, w)
        elif f == "nv": out[f] = v.sum(-1, keepdim=True)
        elif f == "nw": out[f] = w.sum(-1, keepdim=True)
        elif f == "regv": out[f] = v - _mtv(ops.Cov1, rz1)
        elif f == "regw": out[f] = w - _mtv(ops.Cov2, rz2)
        elif f == "crx": out[f] = ops.Cx * (x[:, :, None] + x[:, None, :])
        elif f == "cry": out[f] = ops.Cy * (y[:, :, None] + y[:, None, :])
        elif f == "crz": out[f] = ops.Cz * (z[:, :, None] + z[:, None, :])
        elif f in ("sx5", "sx3", "sy5", "sy3"):
            M, t = {"sx5": (ops.X5, x), "sx3": (ops.X3, x),
                    "sy5": (ops.Y5, y), "sy3": (ops.Y3, y)}[f]
            r = _mv(M, t)
            out[f] = r - _sd(r) - _su(r)
        elif f == "sz1": out[f] = rz1 - _sd(rz1) - _su(rz1)
        elif f == "sz2": out[f] = rz2 - _sd(rz2) - _su(rz2)
    return out


def rhs(cfg: SolverConfig, ops: Ops) -> dict:
    """b, matching apply_A's structure (with the batch axis)."""
    B, L1, _ = ops.Z1.shape
    L2 = ops.Z2.shape[1]
    Kv, Kw = ops.Cov1.shape[2], ops.Cov2.shape[2]
    kw = dict(dtype=ops.Z1.dtype, device=ops.Z1.device)
    b = {}
    for f in _families(cfg):
        if f in ("ax", "az1", "cxz", "cov1", "xv", "st1", "en1", "adj1"):
            b[f] = torch.ones(B, L1, **kw)
        elif f in ("ay", "az2", "cyz", "cov2", "yw", "st2", "en2", "adj2"):
            b[f] = torch.ones(B, L2, **kw)
        elif f in ("zv", "sx5", "sx3", "sz1"):
            b[f] = torch.zeros(B, L1, **kw)
        elif f in ("zw", "sy5", "sy3", "sz2"):
            b[f] = torch.zeros(B, L2, **kw)
        elif f in ("nv", "nw"):
            b[f] = torch.full((B, 1), float(cfg.acc_num), **kw)
        elif f == "regv":
            b[f] = torch.zeros(B, Kv, **kw)
        elif f == "regw":
            b[f] = torch.zeros(B, Kw, **kw)
        elif f == "crx":
            b[f] = ops.Cx  # 1 on supported entries, 0 elsewhere
        elif f == "cry":
            b[f] = ops.Cy
        elif f == "crz":
            b[f] = ops.Cz
    return b


def apply_AT(cfg: SolverConfig, ops: Ops, ydual: dict):
    """A^T y, as a primal-structured tuple (gx, gy, gz, gv, gw)."""
    z1 = torch.zeros_like(ops.Z1[:, :, 0])
    z2 = torch.zeros_like(ops.Z2[:, :, 0])
    acc1, acc1z, accv = z1, z1, z1
    acc2, acc2z, accw = z2, z2, z2
    gx = torch.zeros_like(ops.Cx[:, 0])
    gy = torch.zeros_like(ops.Cy[:, 0])
    gz = torch.zeros_like(ops.Cz[:, 0])
    gv = torch.zeros_like(ops.Cov1[:, 0])
    gw = torch.zeros_like(ops.Cov2[:, 0])
    for f in _families(cfg):
        yk = ydual[f]
        if f == "ax": acc1 = acc1 + yk
        elif f == "ay": acc2 = acc2 + yk
        elif f == "az1": acc1z = acc1z + yk
        elif f == "az2": acc2z = acc2z + yk
        elif f == "cxz": acc1 = acc1 + yk; acc1z = acc1z + yk
        elif f == "cyz": acc2 = acc2 + yk; acc2z = acc2z + yk
        elif f == "cov1": accv = accv + yk
        elif f == "cov2": accw = accw + yk
        elif f == "xv": acc1 = acc1 + yk; accv = accv + yk
        elif f == "yw": acc2 = acc2 + yk; accw = accw + yk
        elif f == "zv": acc1z = acc1z + yk; accv = accv - yk
        elif f == "zw": acc2z = acc2z + yk; accw = accw - yk
        elif f == "st1": gv = gv + _mtv(ops.St1, yk)
        elif f == "en1": gv = gv + _mtv(ops.En1, yk)
        elif f == "st2": gw = gw + _mtv(ops.St2, yk)
        elif f == "en2": gw = gw + _mtv(ops.En2, yk)
        elif f == "adj1": gv = gv + _mtv(ops.En1, _su(yk)) + _mtv(ops.St1, yk)
        elif f == "adj2": gw = gw + _mtv(ops.En2, _su(yk)) + _mtv(ops.St2, yk)
        elif f == "nv": gv = gv + yk[:, :1]
        elif f == "nw": gw = gw + yk[:, :1]
        elif f == "regv":
            gv = gv + yk
            acc1z = acc1z - _mv(ops.Cov1, yk)
        elif f == "regw":
            gw = gw + yk
            acc2z = acc2z - _mv(ops.Cov2, yk)
        elif f == "crx":
            yc = ops.Cx * yk; gx = gx + yc.sum(2) + yc.sum(1)
        elif f == "cry":
            yc = ops.Cy * yk; gy = gy + yc.sum(2) + yc.sum(1)
        elif f == "crz":
            yc = ops.Cz * yk; gz = gz + yc.sum(2) + yc.sum(1)
        elif f == "sx5": gx = gx + _mtv(ops.X5, yk - _su(yk) - _sd(yk))
        elif f == "sx3": gx = gx + _mtv(ops.X3, yk - _su(yk) - _sd(yk))
        elif f == "sy5": gy = gy + _mtv(ops.Y5, yk - _su(yk) - _sd(yk))
        elif f == "sy3": gy = gy + _mtv(ops.Y3, yk - _su(yk) - _sd(yk))
        elif f == "sz1": acc1z = acc1z + yk - _su(yk) - _sd(yk)
        elif f == "sz2": acc2z = acc2z + yk - _su(yk) - _sd(yk)
    gx = gx + _mtv(ops.Xb, acc1)
    gy = gy + _mtv(ops.Yb, acc2)
    gz = gz + _mtv(ops.Z1, acc1z) + _mtv(ops.Z2, acc2z)
    gv = gv + _mtv(ops.Cov1, accv)
    gw = gw + _mtv(ops.Cov2, accw)
    return (gx, gy, gz, gv, gw)


def coefs(p: JointProblem):
    return (p.xc * p.xm, p.yc * p.ym, p.zc * p.zm, p.vc * p.vm, p.wc * p.wm)


def bounds(p: JointProblem, fix_lb=None, fix_ub=None):
    """Box bounds; fix_lb/fix_ub pin variables (stage-2 region fixings)."""
    lb = (p.xlb, p.ylb, p.zlb, torch.zeros_like(p.vc), torch.zeros_like(p.wc))
    ub = (p.xm, p.ym, p.zm, p.vm, p.wm)
    if fix_lb is not None:
        lb = tuple(torch.maximum(a, b) for a, b in zip(lb, fix_lb))
    if fix_ub is not None:
        ub = tuple(torch.minimum(a, b) for a, b in zip(ub, fix_ub))
    return lb, ub


def _dot(a, b):
    """Per-instance inner product of two tuples/lists of [B, ...] tensors."""
    return sum((x * y).flatten(1).sum(1) for x, y in zip(a, b))


def _bc(s, t):
    """Per-instance scalar s [B] broadcast against t [B, ...]."""
    return s.view(-1, *([1] * (t.dim() - 1)))


def _op_norm(cfg, ops, u0, iters: int = 30):
    """Power iteration for ||A||_2 of each instance's composite operator."""
    nrm = torch.sqrt(_dot(u0, u0))
    u = tuple(t / _bc(nrm.clamp(min=1e-30), t) for t in u0)
    nrm2 = torch.ones_like(nrm)
    for _ in range(iters):
        w = apply_AT(cfg, ops, apply_A(cfg, ops, u))
        nrm2 = torch.sqrt(_dot(w, w))
        u = tuple(t / _bc(nrm2.clamp(min=1e-30), t) for t in w)
    return torch.sqrt(nrm2.clamp(min=1e-6))


def pdhg_solve(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
               iters: int = 4000, fix_lb=None, fix_ub=None, u0=None, y0=None):
    """PDHG on the LP relaxation: returns (u, ydual, ub_bound) with the
    averaged tail iterate and a rigorous per-instance upper bound."""
    ops = make_ops(p, L1, L2)
    c = coefs(p)
    lb, ub = bounds(p, fix_lb, fix_ub)
    b = rhs(cfg, ops)
    nrm = _op_norm(cfg, ops, tuple(torch.ones_like(t) for t in c))
    tau = 1.0 / nrm.clamp(min=1e-3)
    sig = tau
    if u0 is None:
        u0 = tuple(0.5 * (l + h) for l, h in zip(lb, ub))
    else:
        u0 = tuple(torch.minimum(torch.maximum(t, l), h)
                   for t, l, h in zip(u0, lb, ub))
    if y0 is None:
        y0 = {k: torch.zeros_like(v) for k, v in b.items()}

    def run_segment(u, y, n):
        ua = tuple(torch.zeros_like(t) for t in u)
        ya = {k: torch.zeros_like(v) for k, v in y.items()}
        for _ in range(n):
            g = apply_AT(cfg, ops, y)
            un = tuple(torch.minimum(torch.maximum(
                uu + _bc(tau, uu) * (cc - gg), l), h)
                for uu, cc, gg, l, h in zip(u, c, g, lb, ub))
            ue = tuple(2.0 * a - bb for a, bb in zip(un, u))
            au = apply_A(cfg, ops, ue)
            y = {k: torch.clamp(y[k] + _bc(sig, y[k]) * (au[k] - b[k]), min=0)
                 for k in y}
            u = un
            ua = tuple(a + bb for a, bb in zip(ua, un))
            ya = {k: ya[k] + y[k] for k in y}
        return u, y, tuple(t / float(n) for t in ua), \
            {k: v / float(n) for k, v in ya.items()}

    half = iters // 2
    u, y, _, _ = run_segment(u0, y0, max(half, 1))
    u, y, uavg, yavg = run_segment(u, y, max(iters - half, 1))
    bound = dual_bound(p, cfg, ops, yavg, fix_lb, fix_ub)
    bound_last = dual_bound(p, cfg, ops, y, fix_lb, fix_ub)
    return uavg, yavg, torch.minimum(bound, bound_last)


def dual_bound(p: JointProblem, cfg: SolverConfig, ops: Ops, ydual: dict,
               fix_lb=None, fix_ub=None):
    """b^T y + max_{lb<=u<=ub} (c - A^T y)^T u, valid for any y >= 0."""
    c = coefs(p)
    lb, ub = bounds(p, fix_lb, fix_ub)
    b = rhs(cfg, ops)
    g = apply_AT(cfg, ops, ydual)
    box = sum((ubk * r.clamp(min=0) + lbk * r.clamp(max=0)).sum(-1)
              for r, lbk, ubk in zip((cc - gg for cc, gg in zip(c, g)), lb,
                                      ub))
    bty = sum((ydual[k] * b[k]).flatten(1).sum(1) for k in ydual)
    return bty + box
