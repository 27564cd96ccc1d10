"""Solver configuration and the padded joint-structure problem.

Port of ractip_tpu/solver/candidates.py (SolverConfig, JointProblem), with
the same fields in the same order.  JointProblem holds tensors with a
leading batch axis on the device path and numpy arrays of one instance on
the host certify path (solver/milp.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple


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
