"""Exact binary optimization by branch-and-bound over the PDHG LP relaxation.

Port of ractip_tpu/solver/bnb.py (_Search :40, solve_joint :127).  The
reference delegates integrality to an external MIP library's branch-and-bound
(glp_intopt, reference src/ip.cpp:112-122).  Here the host drives the search
while every node's LP relaxation is solved on the device by the port's PDHG
(joint_lp.pdhg_solve, at B=1): any dual iterate gives a rigorous upper bound
(box-LP duality), so pruning is sound at finite iteration counts, and nodes
warm-start from their parent's primal and dual iterates so child LPs
converge in a fraction of the root's iterations.

The search is one LP-guided dive for a quick incumbent, then best-first
expansion branching on the most fractional variable.  Pairing LPs are
integral at most nodes, so trees stay small on real instances; the node cap
bounds the work on adversarial ones (the incumbent is still returned, with
its certified gap).  Node bookkeeping is numpy on the host.
"""

from __future__ import annotations

import heapq
import itertools

import numpy as np
import torch

from ..device import resolve
from .candidates import JointProblem, SolverConfig
from .joint_lp import check_feasible, pdhg_solve


def _to_np(u):
    return tuple(t[0].cpu().numpy() for t in u)


class _Search:
    def __init__(self, p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                 root_iters: int, node_iters: int, gap_tol: float,
                 dev: torch.device):
        self.cfg, self.L1, self.L2, self.dev = cfg, L1, L2, dev
        # the problem at B=1 on the device, as the batched LP takes it
        self.p = JointProblem(*[torch.as_tensor(np.asarray(t))[None].to(dev)
                                for t in p])
        self.root_iters, self.node_iters = root_iters, node_iters
        self.gap_tol = gap_tol
        self.masks = tuple(np.asarray(getattr(p, f))
                           for f in ("xm", "ym", "zm", "vm", "wm"))
        self.coefs = tuple(np.asarray(getattr(p, f), np.float64) * m
                           for f, m in zip(("xc", "yc", "zc", "vc", "wc"),
                                           self.masks))
        self.best_u = None
        self.best_obj = -np.inf
        self.lp_calls = 0

    def dev_tuple(self, u):
        return tuple(torch.as_tensor(t, dtype=torch.float32)[None]
                     .to(self.dev) for t in u)

    def obj(self, u):
        return float(sum(np.vdot(c, t) for c, t in zip(self.coefs, u)))

    def lp(self, lb, ub, warm=None, root=False):
        self.lp_calls += 1
        u0, y0 = warm if warm is not None else (None, None)
        u, y, bound = pdhg_solve(
            self.p, self.cfg, self.L1, self.L2,
            iters=self.root_iters if root else self.node_iters,
            fix_lb=self.dev_tuple(lb), fix_ub=self.dev_tuple(ub), u0=u0,
            y0=y0)
        return _to_np(u), (u, y), float(bound[0])

    def try_incumbent(self, u_np, lb, ub):
        u_round = tuple(np.clip(np.round(t) * m, l, h)
                        for t, m, l, h in zip(u_np, self.masks, lb, ub))
        viol = float(check_feasible(self.p, self.cfg, self.L1, self.L2,
                                    self.dev_tuple(u_round))[0])
        if viol < 0.5:
            o = self.obj(u_round)
            if o > self.best_obj:
                self.best_obj, self.best_u = o, u_round
            return True
        return False

    def most_fractional(self, u_np, lb, ub):
        blk, idx, val, score = -1, -1, 0.0, 0.0
        for bi, (t, m, l, h) in enumerate(zip(u_np, self.masks, lb, ub)):
            free = (m > 0) & (h - l > 0.5)
            if not free.any():
                continue
            fr = np.where(free, 0.5 - np.abs(t - 0.5), -1.0)
            k = int(np.argmax(fr))
            if fr[k] > score:
                score, blk, idx, val = fr[k], bi, k, t[k]
        return blk, idx, val, score

    def branch(self, lb, ub, blk, idx, side):
        nlb = tuple(a.copy() for a in lb)
        nub = tuple(a.copy() for a in ub)
        if side == 1:
            nlb[blk][idx] = 1.0
        else:
            nub[blk][idx] = 0.0
        return nlb, nub

    def dive(self, lb, ub, u_np, warm, max_depth=64, int_tol=0.01):
        """Fix most-fractional variables toward the LP until integral."""
        for _ in range(max_depth):
            if self.try_incumbent(u_np, lb, ub):
                return
            blk, idx, val, score = self.most_fractional(u_np, lb, ub)
            if blk < 0 or score < int_tol:
                return
            for side in ((1, 0) if val >= 0.5 else (0, 1)):
                nlb, nub = self.branch(lb, ub, blk, idx, side)
                u_np2, warm2, bound = self.lp(nlb, nub, warm)
                if bound > self.best_obj + self.gap_tol:
                    lb, ub, u_np, warm = nlb, nub, u_np2, warm2
                    break
            else:
                return


def solve_joint(p: JointProblem, cfg: SolverConfig, L1: int, L2: int,
                iters: int = 6000, node_iters: int = 1500,
                gap_tol: float = 1e-4, max_nodes: int = 4096,
                int_tol: float = 0.01, device="cuda"):
    """Returns (solution, objective, bound, nodes) for one instance p
    (numpy leaves, as solver/candidates.py::build_problem gives it), its
    LPs solved on `device`.

    solution: tuple of 5 binary numpy arrays (x, y, z, v, w) over candidates.
    objective: its objective value (float64 recompute).
    bound: certified upper bound on the optimum (the objective when the
    search closed the tree; otherwise the residual gap is real and
    reported)."""
    s = _Search(p, cfg, L1, L2, iters, node_iters, gap_tol, resolve(device))
    zeros = tuple(np.zeros_like(m) for m in s.masks)
    ones = tuple(np.ones_like(m) for m in s.masks)

    u_np, warm, root_bound = s.lp(zeros, ones, root=True)
    s.try_incumbent(u_np, zeros, ones)
    blk, idx, val, score = s.most_fractional(u_np, zeros, ones)
    if blk < 0 or score < int_tol:
        if s.best_u is not None:
            return s.best_u, s.best_obj, min(root_bound,
                                             s.best_obj + gap_tol), 1

    s.dive(zeros, ones, u_np, warm)

    # best-first: heap of (-bound, tiebreak, lb, ub, warm)
    tie = itertools.count()
    heap = [(-root_bound, next(tie), zeros, ones, warm)]
    nodes = 1
    bound_out = root_bound
    while heap and nodes < max_nodes:
        neg_bound, _, lb, ub, pwarm = heapq.heappop(heap)
        parent_bound = -neg_bound
        bound_out = min(parent_bound, bound_out) if not heap else bound_out
        if parent_bound <= s.best_obj + gap_tol:
            heap = []
            bound_out = min(bound_out, parent_bound)
            break
        nodes += 1
        u_np, warm, bound = s.lp(lb, ub, pwarm)
        bound = min(bound, parent_bound)
        if bound <= s.best_obj + gap_tol:
            continue
        s.try_incumbent(u_np, lb, ub)
        if bound <= s.best_obj + gap_tol:
            continue
        blk, idx, val, score = s.most_fractional(u_np, lb, ub)
        if blk < 0 or score < int_tol:
            continue
        for side in (0, 1):
            nlb, nub = s.branch(lb, ub, blk, idx, side)
            heapq.heappush(heap, (-bound, next(tie), nlb, nub, warm))

    if heap:
        bound_out = max(s.best_obj, -min(h[0] for h in heap))
    else:
        bound_out = s.best_obj if s.best_u is not None else bound_out

    if s.best_u is None:
        # always-feasible fallback: all-zero assignment respecting forced lbs
        s.best_u = tuple(np.asarray(t) for t in
                         (p.xlb, p.ylb, p.zlb, zeros[3], zeros[4]))
        s.best_obj = s.obj(s.best_u)
    return s.best_u, s.best_obj, bound_out, nodes
