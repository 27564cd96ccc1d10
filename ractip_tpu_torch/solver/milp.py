"""Exact host solves over the candidate-space joint program (HiGHS).

A numpy/scipy copy of ractip_tpu/solver/milp.py (_np_problem, build_milp,
_solve_built, solve_joint_milp, certify_or_solve, _backend, exact_solve;
milp.py:29-336), taking the port's JointProblem of one instance with numpy
leaves: the batched path's certify step, and the single-pair exact path's
MILP (pipeline/ractip.py).  It is a copy only because the JAX module cannot
be imported without jax (ractip_tpu/solver/__init__.py imports the jax
solvers).  RACTIP_TPU_EXACT_BACKEND (auto|milp|bnb) picks the exact
backend as in the JAX package: HiGHS where scipy imports (auto), or the
native branch-and-bound (solver/bnb.py), whose node LPs run on the device.
"""

from __future__ import annotations

import os

import numpy as np

from .candidates import JointProblem, SolverConfig


def _np_problem(p: JointProblem):
    return {k: np.asarray(getattr(p, k)) for k in p._fields}


class _Rows:
    """Sparse <=-row accumulator (COO triplets)."""

    def __init__(self):
        self.ri, self.ci, self.val, self.b = [], [], [], []

    def add_row(self, cols, vals, rhs):
        r = len(self.b)
        self.b.append(rhs)
        self.ri.extend([r] * len(cols))
        self.ci.extend(cols)
        self.val.extend(vals)
        return r

    def add_pair_rows(self, cols_a, cols_b):
        """Bulk x_a + x_b <= 1 rows (vectorized crossing-ban families)."""
        m = len(cols_a)
        if not m:
            return
        r0 = len(self.b)
        self.b.extend([1.0] * m)
        self.ri.extend(np.repeat(np.arange(r0, r0 + m), 2).tolist())
        ci = np.empty(2 * m, np.int64)
        ci[0::2] = cols_a
        ci[1::2] = cols_b
        self.ci.extend(ci.tolist())
        self.val.extend([1.0] * (2 * m))

    def matrix(self, n):
        from scipy.sparse import coo_matrix
        m = len(self.b)
        A = coo_matrix((self.val, (self.ri, self.ci)), shape=(m, n))
        return A.tocsr(), np.asarray(self.b, np.float64)


def build_milp(p: JointProblem, cfg: SolverConfig, L1: int, L2: int):
    """(c, A_csr, b, lb, ub): maximize c@u s.t. A u <= b, lb <= u <= ub,
    u integral.  Candidate-space twin of joint_lp.apply_A/rhs."""
    d = _np_problem(p)
    xm, ym, zm, vm, wm = d["xm"], d["ym"], d["zm"], d["vm"], d["wm"]
    Kx, Ky, Kz, Kv, Kw = len(xm), len(ym), len(zm), len(vm), len(wm)
    ox, oy, oz, ov, ow = 0, Kx, Kx + Ky, Kx + Ky + Kz, Kx + Ky + Kz + Kv
    N = Kx + Ky + Kz + Kv + Kw

    c = np.concatenate([d["xc"] * xm, d["yc"] * ym, d["zc"] * zm,
                        d["vc"] * vm, d["wc"] * wm]).astype(np.float64)
    lb = np.concatenate([d["xlb"], d["ylb"], d["zlb"],
                         np.zeros(Kv), np.zeros(Kw)]).astype(np.float64)
    ub = np.concatenate([xm, ym, zm, vm, wm]).astype(np.float64)
    lb = np.minimum(lb, ub)

    rows = _Rows()

    def live(m):
        return np.where(m > 0)[0]

    kx, ky, kz = live(xm), live(ym), live(zm)
    kv, kw = live(vm), live(wm)
    xi, xj = d["xi"], d["xj"]
    yi, yj = d["yi"], d["yj"]
    zi, zj = d["zi"], d["zj"]
    vp, vq = d["vp"], d["vq"]
    wp, wq = d["wp"], d["wq"]

    def per_pos(L, contribs, rhs_val):
        """One row per position i in [0, L): sum(contribs at i) <= rhs.

        contribs: list of (offset, cand_idx_array, pos_array, coef)."""
        cols = [[] for _ in range(L)]
        vals = [[] for _ in range(L)]
        for off, ks, pos, coef in contribs:
            for k in ks:
                pp = int(pos[k])
                if 0 <= pp < L:
                    cols[pp].append(off + int(k))
                    vals[pp].append(coef)
        for i in range(L):
            if cols[i]:
                rows.add_row(cols[i], vals[i], rhs_val)

    def cover_cols(ks, pos_lo, pos_hi, L):
        """cols[i] = candidates whose [lo, hi] interval covers position i."""
        cols = [[] for _ in range(L)]
        for k in ks:
            for i in range(int(pos_lo[k]), min(int(pos_hi[k]), L - 1) + 1):
                cols[i].append(int(k))
        return cols

    st = cfg.structure
    acc = cfg.accessibility

    # az1/az2: at most one external pair per base (ref :731-762)
    per_pos(L1, [(oz, kz, zi, 1.0)], 1.0)
    per_pos(L2, [(oz, kz, zj, 1.0)], 1.0)

    # crz: external pseudoknot ban (ref :996-1012), vectorized
    if len(kz):
        za, zb = zi[kz], zj[kz]
        aa, bb = np.nonzero((za[:, None] < za[None, :])
                            & (zb[:, None] < zb[None, :]))
        rows.add_pair_rows(oz + kz[aa], oz + kz[bb])

    if st:
        # ax/ay: at most one internal pairing per base (ref :717-728)
        per_pos(L1, [(ox, kx, xi, 1.0), (ox, kx, xj, 1.0)], 1.0)
        per_pos(L2, [(oy, ky, yi, 1.0), (oy, ky, yj, 1.0)], 1.0)
        if cfg.in_pk:
            # crx/cry: internal pseudoknot ban (ref :1014-1057), vectorized
            for off, ks, ii, jj in ((ox, kx, xi, xj), (oy, ky, yi, yj)):
                if not len(ks):
                    continue
                ia, ja = ii[ks], jj[ks]
                aa, bb = np.nonzero((ia[:, None] < ia[None, :])
                                    & (ia[None, :] < ja[:, None])
                                    & (ja[:, None] < ja[None, :]))
                rows.add_pair_rows(off + ks[aa], off + ks[bb])

    if acc:
        cv_cols = cover_cols(kv, vp, vq, L1)
        cw_cols = cover_cols(kw, wp, wq, L2)
        # cov: at most one region covering a position (ref :894-903)
        for cols_l, off in ((cv_cols, ov), (cw_cols, ow)):
            for cols in cols_l:
                if cols:
                    rows.add_row([off + k for k in cols],
                                 [1.0] * len(cols), 1.0)
        # zv/zw: external pair must sit inside a chosen region (ref :848-861)
        for i in range(L1):
            zc = [oz + int(k) for k in kz if int(zi[k]) == i]
            if zc:
                cols = zc + [ov + k for k in cv_cols[i]]
                rows.add_row(cols, [1.0] * len(zc) + [-1.0] * len(cv_cols[i]),
                             0.0)
        for i in range(L2):
            zc = [oz + int(k) for k in kz if int(zj[k]) == i]
            if zc:
                cols = zc + [ow + k for k in cw_cols[i]]
                rows.add_row(cols, [1.0] * len(zc) + [-1.0] * len(cw_cols[i]),
                             0.0)
        # st/en: at most one region start/end per position (ref :764-781)
        per_pos(L1, [(ov, kv, vp, 1.0)], 1.0)
        per_pos(L1, [(ov, kv, vq, 1.0)], 1.0)
        per_pos(L2, [(ow, kw, wp, 1.0)], 1.0)
        per_pos(L2, [(ow, kw, wq, 1.0)], 1.0)
        # adj: no adjoining regions: v_en[i-1] + v_st[i] <= 1 (ref :905-913)
        for ks, pos_lo, pos_hi, off, L in ((kv, vp, vq, ov, L1),
                                           (kw, wp, wq, ow, L2)):
            for i in range(L):
                cols = [off + int(k) for k in ks if int(pos_hi[k]) == i - 1]
                cols += [off + int(k) for k in ks if int(pos_lo[k]) == i]
                if cols:
                    rows.add_row(cols, [1.0] * len(cols), 1.0)
        if st:
            # xv/yw: internal pair endpoints not inside a region (ref :832-846)
            for i in range(L1):
                xc = [ox + int(k) for k in kx
                      if int(xi[k]) == i or int(xj[k]) == i]
                if xc and cv_cols[i]:
                    rows.add_row(xc + [ov + k for k in cv_cols[i]],
                                 [1.0] * (len(xc) + len(cv_cols[i])), 1.0)
            for i in range(L2):
                yc = [oy + int(k) for k in ky
                      if int(yi[k]) == i or int(yj[k]) == i]
                if yc and cw_cols[i]:
                    rows.add_row(yc + [ow + k for k in cw_cols[i]],
                                 [1.0] * (len(yc) + len(cw_cols[i])), 1.0)
        if cfg.acc_num > 0:
            # region count cap (ref :971-994)
            if len(kv):
                rows.add_row([ov + int(k) for k in kv], [1.0] * len(kv),
                             float(cfg.acc_num))
            if len(kw):
                rows.add_row([ow + int(k) for k in kw], [1.0] * len(kw),
                             float(cfg.acc_num))
        if cfg.beta > 0.0:
            # beta-gated region-contains-interaction (ref :936-958)
            for ks, off, pos_lo, pos_hi, zpos in ((kv, ov, vp, vq, zi),
                                                  (kw, ow, wp, wq, zj)):
                for k in ks:
                    zc = [oz + int(q) for q in kz
                          if int(pos_lo[k]) <= int(zpos[q]) <= int(pos_hi[k])]
                    rows.add_row([off + int(k)] + zc,
                                 [1.0] + [-1.0] * len(zc), 0.0)
    elif st:
        # cxz/cyz: paired at most once across internal+external (ref :802-828)
        per_pos(L1, [(ox, kx, xi, 1.0), (ox, kx, xj, 1.0),
                     (oz, kz, zi, 1.0)], 1.0)
        per_pos(L2, [(oy, ky, yi, 1.0), (oy, ky, yj, 1.0),
                     (oz, kz, zj, 1.0)], 1.0)

    if cfg.stacking:
        # stacked-pair / no-isolated-pair rows (ref :1059-1167):
        # r_i - r_{i-1} - r_{i+1} <= 0 for each endpoint-indicator vector r
        def stack_rows(ks, pos, off, L):
            at = [[] for _ in range(L)]
            for k in ks:
                pp = int(pos[k])
                if 0 <= pp < L:
                    at[pp].append(off + int(k))
            for i in range(L):
                if not at[i]:
                    continue
                cols = list(at[i])
                vals = [1.0] * len(cols)
                for nb in (i - 1, i + 1):
                    if 0 <= nb < L:
                        cols += at[nb]
                        vals += [-1.0] * len(at[nb])
                rows.add_row(cols, vals, 0.0)

        stack_rows(kz, zi, oz, L1)
        stack_rows(kz, zj, oz, L2)
        if st:
            stack_rows(kx, xi, ox, L1)
            stack_rows(kx, xj, ox, L1)
            stack_rows(ky, yi, oy, L2)
            stack_rows(ky, yj, oy, L2)

    A, b = rows.matrix(N)
    return c, A, b, lb, ub


def _solve_built(c, A, b, lb, ub, sizes):
    from scipy.optimize import Bounds, LinearConstraint, milp

    res = milp(c=-c, constraints=LinearConstraint(A, -np.inf, b),
               integrality=np.ones_like(c), bounds=Bounds(lb, ub),
               options={"mip_rel_gap": 0.0})
    if not res.success or res.x is None:
        raise RuntimeError(f"HiGHS MILP failed: {res.message}")
    u = np.round(res.x)
    obj = float(c @ u)
    out, o = [], 0
    for K in sizes:
        out.append(u[o:o + K].astype(np.float32))
        o += K
    nodes = int(getattr(res, "mip_node_count", 0) or 0)
    return tuple(out), obj, obj, nodes


def solve_joint_milp(p: JointProblem, cfg: SolverConfig, L1: int, L2: int):
    """Exact solve via SciPy/HiGHS branch-and-cut: (u, objective, bound,
    nodes), u a tuple of 5 binary float arrays over candidate slots, bound
    == objective (the reference's glp_intopt, src/ip.cpp:112-122)."""
    return _solve_built(*build_milp(p, cfg, L1, L2), p.sizes)


def certify_or_solve(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                     dev_obj: float, gap_tol: float):
    """Certify a device solution against the EXACT LP bound, or solve.

    The device PDHG bound is f32-noisy (~1e-3 floor), so most instances it
    flags as "gapped" already hold the optimum.  An exact HiGHS LP solve of
    the relaxation gives the true bound lp_opt >= ip_opt in a fraction of a
    MILP's time: if lp_opt - dev_obj <= gap_tol the device solution is
    certified within tolerance and returned as-is.  Only instances with a
    REAL integrality/rounding gap pay for the branch-and-cut.

    Returns (u_or_None, obj, bound, nodes): u is None when the device
    solution stands (bound then carries the certified LP bound)."""
    from scipy.optimize import linprog

    c, A, b, lb, ub = build_milp(p, cfg, L1, L2)
    res = linprog(-c, A_ub=A, b_ub=b,
                  bounds=np.stack([lb, ub], axis=1), method="highs")
    if res.status == 0:
        lp_opt = float(-res.fun)
        if lp_opt - dev_obj <= gap_tol:
            return None, dev_obj, lp_opt, 0
    return _solve_built(c, A, b, lb, ub, p.sizes)


def _backend() -> str:
    """The exact host backend, from RACTIP_TPU_EXACT_BACKEND (auto|milp|bnb):
    auto is HiGHS (milp) where scipy imports, else the branch-and-bound."""
    be = os.environ.get("RACTIP_TPU_EXACT_BACKEND", "auto")
    if be not in ("auto", "milp", "bnb"):
        raise ValueError(f"RACTIP_TPU_EXACT_BACKEND={be!r} "
                         "(expected auto|milp|bnb)")
    if be == "auto":
        try:
            import scipy.optimize  # noqa: F401
            return "milp"
        except ImportError:
            return "bnb"
    return be


def exact_solve(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                iters: int = 6000, device="cuda"):
    """Exact solve of one pair by the selected backend (the L3 facade role,
    reference src/ip.h:25-44): the HiGHS MILP, or the branch-and-bound whose
    node LPs (iters at the root) run on `device`."""
    if _backend() == "milp":
        return solve_joint_milp(p, cfg, L1, L2)
    from .bnb import solve_joint
    return solve_joint(p, cfg, L1, L2, iters=iters, device=device)
