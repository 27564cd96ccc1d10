"""Scenario sharding over the ranks of a torch.distributed process group.

Port of ractip_tpu/parallel/mesh.py (scenario_mesh :31, pad_to_mesh :46,
shard_scenarios :52, sharded_mean_var :58).  The reference re-runs its batch
workloads (1000-decoy z-score loops, corpus sweeps) one after another on one
thread (reference src/ractip.cpp:1494); every instance's pipeline is
independent, so the scenario axis splits cleanly over devices.  The JAX
package shards it over a two-axis ("pairs", "replicates") jax.sharding.Mesh
whose split only places the shards on the TPU's interconnect; the math is
identical (its :13-16).  Here the mesh is one flat scenario axis over the
ranks, one process a card: each rank runs a contiguous share of every
chunk, the shares are gathered so that every rank holds the whole result,
and the z-score's mean and variance come from one all-reduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One flat scenario axis over the `size` ranks of a process group;
    this process is rank `rank` (group None: the default group)."""

    size: int
    rank: int
    group: object = None

    def share(self, B: int) -> slice:
        """This rank's contiguous rows of a B-row axis (B a multiple of
        size)."""
        per = B // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def scenario_mesh(group=None) -> Mesh:
    """The mesh over the ranks of `group` (init_distributed() first)."""
    if not dist.is_initialized():
        raise RuntimeError("scenario_mesh needs a process group: call "
                           "parallel.distributed.init_distributed() first")
    return Mesh(dist.get_world_size(group), dist.get_rank(group), group)


def pad_to_mesh(B: int, mesh: Mesh) -> int:
    """Scenario count padded up to a multiple of the mesh size."""
    n = mesh.size
    return ((B + n - 1) // n) * n


def shard_scenarios(tree, mesh: Mesh):
    """This rank's share of every [B, ...] leaf (an array, a tensor or a
    list) of a dict or tuple of them (B a multiple of the mesh size)."""
    if isinstance(tree, dict):
        return {k: shard_scenarios(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shard_scenarios(v, mesh) for v in tree)
    return tree[mesh.share(len(tree))]


def gather_scenarios(part: dict, mesh: Mesh) -> dict:
    """Every rank's share of a dict of numpy [b, ...] arrays, concatenated
    in rank order on every rank (the inverse of shard_scenarios)."""
    parts = [None] * mesh.size
    dist.all_gather_object(parts, part, group=mesh.group)
    return {k: np.concatenate([p[k] for p in parts]) for k in part}


def _comm_device(mesh: Mesh) -> torch.device:
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sharded_mean_var(x, mesh: Mesh, valid):
    """Mean and variance over the (sharded) scenario axis: each rank sums
    count, sum and sum of squares of the valid rows of its share in float32,
    and one all-reduce adds them, as the JAX package's psum does.

    x: [B] statistic per scenario, valid: [B] 0/1 mask (padding scenarios
    excluded), both whole on every rank.  This is the z-score reduction of
    reference src/ractip.cpp:1648-1669.  Returns (mean, variance) as float32
    0-d tensors."""
    xs, ms = shard_scenarios((torch.as_tensor(np.asarray(x, np.float32)),
                              torch.as_tensor(np.asarray(valid, np.float32))),
                             mesh)
    acc = torch.stack([ms.sum(), (xs * ms).sum(), (xs * xs * ms).sum()]) \
        .to(_comm_device(mesh))
    dist.all_reduce(acc, group=mesh.group)
    cnt, s, s2 = acc.cpu()
    m = s / cnt
    return m, torch.clamp(s2 / cnt - m * m, min=0.0)
