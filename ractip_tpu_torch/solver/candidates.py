"""Solver configuration, the padded joint-structure problem, and its host
assembly for one pair.

Port of ractip_tpu/solver/candidates.py (SolverConfig, JointProblem,
build_problem and its helpers :83-229), with the same fields in the same
order.  JointProblem holds tensors with a leading batch axis on the device
path and numpy arrays of one instance on the host paths (solver/milp.py):
the certify step, and the single-pair exact path, whose problem
build_problem assembles from numpy posteriors exactly as the JAX package
does (the reference's ILP columns, reference src/ractip.cpp:551-713).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Mirrors the reference's option state (reference src/ractip.cpp:95-192)."""

    alpha: float = 0.7
    beta: float = 0.0
    th_ss: float = 0.5
    th_hy: float = 0.1
    th_ac: float = 0.003
    max_w: int = 15
    min_w: int = 5
    acc_num: int = 1
    acc_max: bool = False          # accessibility-only objective (--acc-max)
    acc_max_ss: bool = False
    in_pk: bool = True             # ban internal pseudoknots (no --no-pk)
    stacking: bool = True          # no isolated pairs (no --allow-isolated)
    force_constraint: bool = False

    @property
    def accessibility(self) -> bool:
        # reference src/ractip.cpp:526
        return self.min_w > 1 and self.max_w >= self.min_w

    @property
    def structure(self) -> bool:
        return not self.acc_max


class JointProblem(NamedTuple):
    """Padded joint-structure binary program.

      x: internal pairs of s1 (xi < xj), coefficient p - th_ss
      y: internal pairs of s2
      z: external pairs, zi in s1 / zj in s2, coefficient alpha (p - th_hy)
      v: accessible regions of s1 [vp, vq], coefficient beta (up - th_ac)
      w: accessible regions of s2
    *m are 0/1 slot masks; *lb the forced lower bounds."""

    xi: object; xj: object; xc: object; xm: object
    yi: object; yj: object; yc: object; ym: object
    zi: object; zj: object; zc: object; zm: object
    vp: object; vq: object; vc: object; vm: object
    wp: object; wq: object; wc: object; wm: object
    xlb: object; ylb: object; zlb: object
    n1: object; n2: object

    @property
    def sizes(self):
        return (self.xm.shape[-1], self.ym.shape[-1], self.zm.shape[-1],
                self.vm.shape[-1], self.wm.shape[-1])


def _bucket(k: int, minimum: int = 8) -> int:
    b = minimum
    while b < k:
        b *= 2
    return b


def _pad(arr, k, fill=0):
    arr = np.asarray(arr)
    out = np.full((k,), fill, arr.dtype if arr.size else np.int32)
    out[: len(arr)] = arr
    return out


def _extract_pairs(bpp: np.ndarray, n: int, th: float):
    """(i, j, p) lists with i < j and bpp[i, j] > th, in the reference's
    column order (j ascending, i descending below j; src/ractip.cpp:557-568)."""
    ii, jj, pp = [], [], []
    for j in range(1, n):
        for i in range(j - 1, -1, -1):
            p = bpp[i, j]
            if p > th:
                ii.append(i); jj.append(j); pp.append(p)
    return ii, jj, pp


def _extract_hyb(hp: np.ndarray, n1: int, n2: int, th: float):
    ii, jj, pp = [], [], []
    for i in range(n1):
        for j in range(n2):
            p = hp[i, j]
            if p > th:
                ii.append(i); jj.append(j); pp.append(p)
    return ii, jj, pp


def _extract_regions(pu: np.ndarray, n: int, cfg: SolverConfig):
    """Regions [i, i+wd-1] with pu[i, wd] > th_ac, min_w <= wd <= max_w
    (the reference's up1_[i][j], src/ractip.cpp:621-627)."""
    pp_, qq, uu = [], [], []
    for i in range(n):
        for wd in range(cfg.min_w, cfg.max_w + 1):
            if i + wd - 1 >= n:
                break
            u = pu[i, wd]
            if u > cfg.th_ac:
                pp_.append(i); qq.append(i + wd - 1); uu.append(u)
    return pp_, qq, uu


def _forced_pairs(struct: str, open_ch: str, close_ch: str):
    st, out = [], []
    for i, ch in enumerate(struct):
        if ch == open_ch:
            st.append(i)
        elif ch == close_ch:
            out.append((st.pop(), i))
    return out


def build_problem(bpp1: np.ndarray, bpp2: np.ndarray, hp: np.ndarray,
                  pu1: np.ndarray | None, pu2: np.ndarray | None,
                  n1: int, n2: int, cfg: SolverConfig,
                  str1: str = "", str2: str = "",
                  buckets: tuple[int, ...] | None = None) -> JointProblem:
    """The padded problem of one pair from numpy posteriors (host side).

    bpp*: [L, L] intra-molecular pair probabilities (upper triangle).
    hp:   [L1, L2] hybridization probabilities.
    pu*:  [L, max_w+1] accessibility (column wd = width-wd window), or None.
    str*: constraint strings (used when cfg.force_constraint)."""
    xs = _extract_pairs(bpp1, n1, cfg.th_ss) if cfg.structure else ([], [], [])
    ys = _extract_pairs(bpp2, n2, cfg.th_ss) if cfg.structure else ([], [], [])
    zs = _extract_hyb(hp, n1, n2, cfg.th_hy)
    if cfg.accessibility and pu1 is not None:
        vs = _extract_regions(pu1, n1, cfg)
        ws = _extract_regions(pu2, n2, cfg)
    else:
        vs, ws = ([], [], []), ([], [], [])

    xs = [list(a) for a in xs]; ys = [list(a) for a in ys]
    zs = [list(a) for a in zs]
    fx = []; fy = []; fz = []
    if cfg.force_constraint:
        # add missing forced pairs as candidates, then pin them to 1
        # (reference src/ractip.cpp:655-713 and :1170-1222)
        for (i, j) in _forced_pairs(str1, "(", ")"):
            if cfg.structure:
                fx.append((i, j))
                if not any(a == i and b == j for a, b in zip(xs[0], xs[1])):
                    xs[0].append(i); xs[1].append(j); xs[2].append(bpp1[i, j])
        for (i, j) in _forced_pairs(str2, "(", ")"):
            if cfg.structure:
                fy.append((i, j))
                if not any(a == i and b == j for a, b in zip(ys[0], ys[1])):
                    ys[0].append(i); ys[1].append(j); ys[2].append(bpp2[i, j])
        zo = [i for i, ch in enumerate(str1) if ch == "["]
        zcl = [j for j, ch in enumerate(str2) if ch == "]"]
        for (i, j) in zip(zo, reversed(zcl)):
            fz.append((i, j))
            if not any(a == i and b == j for a, b in zip(zs[0], zs[1])):
                zs[0].append(i); zs[1].append(j); zs[2].append(hp[i, j])

    if buckets is None:
        buckets = tuple(_bucket(len(c[0])) for c in (xs, ys, zs, vs, ws))
    kx, ky, kz, kv, kw = buckets

    def block(cand, k, coef_fn):
        ii, jj, pp = cand
        m = np.zeros((k,), np.float32); m[: len(ii)] = 1.0
        c = np.zeros((k,), np.float32)
        c[: len(pp)] = [coef_fn(p) for p in pp]
        return (_pad(ii, k).astype(np.int32), _pad(jj, k).astype(np.int32),
                c, m)

    xi, xj, xc, xm = block(xs, kx, lambda p: p - cfg.th_ss)
    yi, yj, yc, ym = block(ys, ky, lambda p: p - cfg.th_ss)
    zi, zj, zc, zm = block(zs, kz, lambda p: cfg.alpha * (p - cfg.th_hy))
    vp, vq, vc, vm = block(vs, kv, lambda u: cfg.beta * (u - cfg.th_ac))
    wp, wq, wc, wm = block(ws, kw, lambda u: cfg.beta * (u - cfg.th_ac))

    def lbounds(forced, ii, jj, k):
        lb = np.zeros((k,), np.float32)
        for (i, j) in forced:
            for t in range(k):
                if ii[t] == i and jj[t] == j:
                    lb[t] = 1.0
        return lb

    return JointProblem(
        xi=xi, xj=xj, xc=xc, xm=xm, yi=yi, yj=yj, yc=yc, ym=ym,
        zi=zi, zj=zj, zc=zc, zm=zm, vp=vp, vq=vq, vc=vc, vm=vm,
        wp=wp, wq=wq, wc=wc, wm=wm,
        xlb=lbounds(fx, xi, xj, kx), ylb=lbounds(fy, yi, yj, ky),
        zlb=lbounds(fz, zi, zj, kz), n1=np.int32(n1), n2=np.int32(n2))
