"""Device-side problem assembly and batched integral solving.

Port of ractip_tpu/solver/device.py (_topk_select :37, _topk_scored :57,
build_problem_device :84, region_candidate_count :176, round_and_repair
:189, _region_fixings :258, solve_joint_device :300) with a batch axis
written out in place of vmap.  The repair loop's data-dependent trip count
becomes a host loop over the instances still violating a row.
"""

from __future__ import annotations

import torch

from .candidates import JointProblem, SolverConfig
from .joint_lp import (_dot, apply_A, apply_AT, bounds, coefs, make_ops,
                       pdhg_solve, rhs)

_IMAX = torch.iinfo(torch.int64).max


def _topk_order(keep, idx):
    """Permutation putting kept slots first, in ascending flat index."""
    return torch.argsort(torch.where(keep, idx, _IMAX), dim=1, stable=True)


def _topk_select(score, valid, th: float, K: int):
    """Top-K entries of each flattened score matrix above th, re-sorted to
    ascending flat index.  Returns (idx [B, K], val, mask)."""
    B = score.shape[0]
    flat = torch.where(valid, score, float("-inf")).reshape(B, -1)
    if flat.shape[1] < K:
        flat = torch.cat([flat, flat.new_full((B, K - flat.shape[1]),
                                              float("-inf"))], 1)
    val, idx = torch.topk(flat, K, dim=1)
    m = val > th
    order = _topk_order(m, idx)
    idx, val, m = idx.gather(1, order), val.gather(1, order), m.gather(1, order)
    return idx, torch.where(m, val, torch.zeros_like(val)), m.to(score.dtype)


def _topk_scored(score, value, valid, K: int):
    """Top-K valid entries ranked by score, carrying value through."""
    B = score.shape[0]
    fs = torch.where(valid, score, float("-inf")).reshape(B, -1)
    fv = value.reshape(B, -1)
    if fs.shape[1] < K:
        pad = K - fs.shape[1]
        fs = torch.cat([fs, fs.new_full((B, pad), float("-inf"))], 1)
        fv = torch.cat([fv, fv.new_zeros((B, pad))], 1)
    sv, idx = torch.topk(fs, K, dim=1)
    m = sv > float("-inf")
    order = _topk_order(m, idx)
    idx, m = idx.gather(1, order), m.gather(1, order)
    val = torch.where(m, fv.gather(1, idx), torch.zeros_like(sv))
    return idx, val, m.to(score.dtype)


def _window_vals(pu, L, cfg: SolverConfig):
    wn = cfg.max_w - cfg.min_w + 1
    dev = pu.device
    widths = cfg.min_w + torch.arange(wn, device=dev)[None, :]
    starts = torch.arange(L, device=dev)[:, None]
    ends = starts + widths - 1
    if pu.shape[-1] >= cfg.min_w + wn:
        vals = pu[:, :, cfg.min_w:cfg.min_w + wn]
    else:
        vals = pu.new_zeros(pu.shape[0], L, wn)
    return wn, starts, ends, vals


def build_problem_device(bpp1, bpp2, hp, pu1, pu2, n1, n2,
                         cfg: SolverConfig, buckets) -> JointProblem:
    """Batched JointProblem assembly with static candidate buckets."""
    kx, ky, kz, kv, kw = buckets
    B, L1 = bpp1.shape[:2]
    L2 = bpp2.shape[1]
    dev, f32 = bpp1.device, bpp1.dtype
    n1 = n1.to(dev).long()
    n2 = n2.to(dev).long()
    i32 = torch.int32

    def intra(bpp, n, L, K):
        I = torch.arange(L, device=dev)[None, :, None]
        J = torch.arange(L, device=dev)[None, None, :]
        valid = (I < J) & (J < n[:, None, None])
        idx, p, m = _topk_select(bpp, valid, cfg.th_ss, K)
        c = torch.where(m > 0, p - cfg.th_ss, torch.zeros_like(p))
        return (idx // L).to(i32), (idx % L).to(i32), c, m

    zeros = lambda K, dt=f32: torch.zeros(B, K, dtype=dt, device=dev)
    if cfg.structure:
        xi, xj, xc, xm = intra(bpp1, n1, L1, kx)
        yi, yj, yc, ym = intra(bpp2, n2, L2, ky)
    else:
        xi, xj, xc, xm = zeros(kx, i32), zeros(kx, i32), zeros(kx), zeros(kx)
        yi, yj, yc, ym = zeros(ky, i32), zeros(ky, i32), zeros(ky), zeros(ky)

    I1 = torch.arange(L1, device=dev)[None, :, None]
    I2 = torch.arange(L2, device=dev)[None, None, :]
    zvalid = (I1 < n1[:, None, None]) & (I2 < n2[:, None, None])
    idx, p, zm = _topk_select(hp, zvalid, cfg.th_hy, kz)
    zi, zj = (idx // L2).to(i32), (idx % L2).to(i32)
    zc = torch.where(zm > 0, cfg.alpha * (p - cfg.th_hy), torch.zeros_like(p))

    zgain = torch.where(zvalid, (hp - cfg.th_hy).clamp(min=0.0),
                        torch.zeros_like(hp))
    zmass1 = cfg.alpha * zgain.max(2).values
    zmass2 = cfg.alpha * zgain.max(1).values

    def regions(pu, n, L, K, zmass):
        wn, starts, ends, vals = _window_vals(pu, L, cfg)
        valid = (ends[None] < n[:, None, None]) & (vals > cfg.th_ac)
        cs = torch.cat([zmass.new_zeros(B, 1), torch.cumsum(zmass, 1)], 1)
        e1 = (ends.clamp(0, L - 1) + 1).reshape(1, -1).expand(B, -1)
        s0 = starts.expand(-1, wn).reshape(1, -1).expand(B, -1)
        cover = (cs.gather(1, e1) - cs.gather(1, s0)).reshape(B, L, wn)
        score = cover + cfg.beta * (vals - cfg.th_ac) + 1e-6 * vals
        idx, u, m = _topk_scored(score, vals, valid, K)
        i = (idx // wn).to(i32)
        q = i + cfg.min_w + (idx % wn).to(i32) - 1
        c = torch.where(m > 0, cfg.beta * (u - cfg.th_ac), torch.zeros_like(u))
        zi_ = torch.zeros_like(i)
        return (torch.where(m > 0, i, zi_), torch.where(m > 0, q, zi_), c, m)

    if cfg.accessibility and pu1 is not None:
        vp, vq, vc, vm = regions(pu1, n1, L1, kv, zmass1)
        wp, wq, wc, wm = regions(pu2, n2, L2, kw, zmass2)
    else:
        vp, vq, vc, vm = zeros(kv, i32), zeros(kv, i32), zeros(kv), zeros(kv)
        wp, wq, wc, wm = zeros(kw, i32), zeros(kw, i32), zeros(kw), zeros(kw)
    return JointProblem(
        xi=xi, xj=xj, xc=xc, xm=xm, yi=yi, yj=yj, yc=yc, ym=ym,
        zi=zi, zj=zj, zc=zc, zm=zm, vp=vp, vq=vq, vc=vc, vm=vm,
        wp=wp, wq=wq, wc=wc, wm=wm, xlb=zeros(kx), ylb=zeros(ky),
        zlb=zeros(kz), n1=n1.to(i32), n2=n2.to(i32))


def region_candidate_count(pu, n, L, cfg: SolverConfig):
    """Admissible accessible-region candidates per instance (overflow
    accounting against the static v/w buckets)."""
    _, _, ends, vals = _window_vals(pu, L, cfg)
    ok = (ends[None] < n.to(pu.device).long()[:, None, None]) \
        & (vals > cfg.th_ac)
    return ok.flatten(1).sum(1)


def round_and_repair(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                     u_lp, tol: float = 1e-3, fix_lb=None, fix_ub=None):
    """Round an LP iterate and greedily drop until feasible.

    Each step drops, per instance with a violated row, the lowest-
    coefficient candidate taking part in one.  Returns (u, n_dropped,
    max_violation)."""
    ops = make_ops(p, L1, L2)
    b = rhs(cfg, ops)
    lbs, masks = bounds(p, fix_lb, fix_ub)
    sizes = tuple(m.shape[1] for m in masks)
    flat_c = torch.cat((p.xc, p.yc, p.zc, p.vc, p.wc), 1)
    flat_lb = torch.cat(lbs, 1)
    u = torch.cat([torch.maximum(torch.round(t) * m, l)
                   for t, m, l in zip(u_lp, masks, lbs)], 1)

    def split(flat):
        return tuple(torch.split(flat, sizes, 1))

    def viol(uf):
        au = apply_A(cfg, ops, split(uf))
        return {k: (au[k] - b[k] > tol).to(uf.dtype) for k in au}

    def nviol(v):
        return sum(t.flatten(1).sum(1) for t in v.values())

    B = u.shape[0]
    dropped = torch.zeros(B, dtype=torch.int32, device=u.device)
    v = viol(u)
    active = nviol(v) > 0
    while bool(active.any()):
        g = torch.cat(apply_AT(cfg, ops, v), 1)
        elig = (u > 0.5) & (g > tol) & (flat_lb < 0.5)
        key = torch.where(elig, flat_c, torch.full_like(flat_c, float("inf")))
        k = torch.argmin(key, 1)
        stuck = ~elig.any(1)
        drop = active & ~stuck
        u = torch.where(drop[:, None] & (torch.arange(
            u.shape[1], device=u.device)[None] == k[:, None]),
            torch.zeros_like(u), u)
        dropped = dropped + drop.to(torch.int32)
        v = viol(u)
        active = drop & (nviol(v) > 0)
    au = apply_A(cfg, ops, split(u))
    mv = torch.stack([(au[k] - b[k]).flatten(1).max(1).values.clamp(min=0.0)
                      for k in au], 1).max(1).values
    return split(u), dropped, mv


def _region_fixings(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                    u_lp):
    """Integral region choice from the stage-1 LP iterate: per side, the
    acc_num windows covering the most LP external-pair mass, pinned as
    (fix_lb, fix_ub) for a near-integral stage-2 LP."""
    x, y, z, v, w = u_lp
    B = z.shape[0]
    zrow1 = z.new_zeros(B, L1).scatter_add(1, p.zi.long(), z * p.zm)
    zrow2 = z.new_zeros(B, L2).scatter_add(1, p.zj.long(), z * p.zm)

    def pick(zrow, vp, vq, vc, vm, v_lp):
        cs = torch.cat([zrow.new_zeros(B, 1), torch.cumsum(zrow, 1)], 1)
        gain = cs.gather(1, vq.long() + 1) - cs.gather(1, vp.long())
        base = gain + vc + 1e-3 * v_lp
        avail = vm > 0
        lb = torch.zeros_like(vm)
        rows = torch.arange(B, device=vm.device)
        for _ in range(cfg.acc_num):
            score = torch.where(avail, base, torch.full_like(base,
                                                             float("-inf")))
            k = torch.argmax(score, 1)
            ok = score[rows, k] > 1e-4
            lb = torch.where(ok[:, None] & (torch.arange(
                vm.shape[1], device=vm.device)[None] == k[:, None]),
                torch.ones_like(lb), lb)
            touch = (vp <= vq[rows, k][:, None] + 1) \
                & (vq >= vp[rows, k][:, None] - 1)
            avail = avail & torch.where(ok[:, None], ~touch, avail)
        return lb, lb

    vlb, vub = pick(zrow1, p.vp, p.vq, p.vc * p.vm, p.vm, v)
    wlb, wub = pick(zrow2, p.wp, p.wq, p.wc * p.wm, p.wm, w)
    fix_lb = (torch.zeros_like(p.xm), torch.zeros_like(p.ym),
              torch.zeros_like(p.zm), vlb, wlb)
    fix_ub = (torch.ones_like(p.xm), torch.ones_like(p.ym),
              torch.ones_like(p.zm), vub, wub)
    return fix_lb, fix_ub


def solve_joint_device(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                       iters: int = 2000, timer=None):
    """PDHG LP + (region stage) + round/repair for a batch of problems.

    Returns (u, objective, lp_bound, max_violation), each batched;
    objective <= optimum <= lp_bound."""
    u_lp, ydual, bound = pdhg_solve(p, cfg, L1, L2, iters=iters)
    u, _, mv = round_and_repair(p, cfg, L1, L2, u_lp)
    c = coefs(p)
    obj = _dot(c, u)
    if cfg.accessibility and cfg.acc_num > 0:
        # stage 2: pin the LP-guided integral region choice and re-solve,
        # warm-started from the stage-1 primal/dual iterates
        fix_lb, fix_ub = _region_fixings(p, cfg, L1, L2, u_lp)
        u_lp2, _, _ = pdhg_solve(p, cfg, L1, L2, iters=max(iters // 3, 200),
                                 fix_lb=fix_lb, fix_ub=fix_ub, u0=u_lp,
                                 y0=ydual)
        u2, _, mv2 = round_and_repair(p, cfg, L1, L2, u_lp2, fix_lb=fix_lb,
                                      fix_ub=fix_ub)
        obj2 = _dot(c, u2)
        better = (mv2 <= 1e-6) & ((obj2 > obj) | (mv > 1e-6))
        u = tuple(torch.where(better[:, None], b2, a) for a, b2 in zip(u, u2))
        obj = torch.where(better, obj2, obj)
        mv = torch.where(better, mv2, mv)
    return u, obj, bound, mv
