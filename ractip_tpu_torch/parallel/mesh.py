"""Scenario sharding over the ranks of a torch.distributed process group.

Port of ractip_tpu/parallel/mesh.py (SCENARIO_AXES :28, scenario_mesh :31,
scenario_sharding :41, pad_to_mesh :46, shard_scenarios :52,
sharded_mean_var :58).  The reference re-runs its batch
workloads (1000-decoy z-score loops, corpus sweeps) one after another on one
thread (reference src/ractip.cpp:1494); every instance's pipeline is
independent, so the scenario axis splits cleanly over devices.  The JAX
package shards it over a two-axis ("pairs", "replicates") jax.sharding.Mesh
whose split only places the shards on the TPU's interconnect; the math is
identical (its :13-16).  Here the mesh is one flat scenario axis over the
ranks, one process a card (SCENARIO_AXES keeps the JAX package's two
names for it): each rank runs a contiguous share of every
chunk, the shares are gathered so that every rank holds the whole result,
and the z-score's mean and variance come from one all-reduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

SCENARIO_AXES = ("pairs", "replicates")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One flat scenario axis over the `size` ranks of a process group;
    this process is rank `rank` (group None: the default group)."""

    size: int
    rank: int
    group: object = None


def scenario_mesh(group=None) -> Mesh:
    """The mesh over the ranks of `group` (init_distributed() first)."""
    if not dist.is_initialized():
        raise RuntimeError("scenario_mesh needs a process group: call "
                           "parallel.distributed.init_distributed() first")
    return Mesh(dist.get_world_size(group), dist.get_rank(group), group)


def scenario_sharding(mesh: Mesh):
    """This rank's placement of a leading scenario axis: B -> the slice of
    its contiguous rows (B a multiple of the mesh size)."""
    def rows(B: int) -> slice:
        per = B // mesh.size
        return slice(mesh.rank * per, (mesh.rank + 1) * per)
    return rows


def pad_to_mesh(B: int, mesh: Mesh) -> int:
    """Scenario count padded up to a multiple of the mesh size."""
    n = mesh.size
    return ((B + n - 1) // n) * n


def _same_tuple(like: tuple, vals: list) -> tuple:
    """vals as a tuple of like's type (a NamedTuple keeps its type)."""
    return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)


def map_tree(fn, tree):
    """fn over the leaves of a tree of dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _same_tuple(tree, [map_tree(fn, v) for v in tree])
    return fn(tree)


def shard_scenarios(tree, mesh: Mesh):
    """This rank's share of every [B, ...] leaf (an array, a tensor or a
    list) of a tree of them (B a multiple of the mesh size)."""
    rows = scenario_sharding(mesh)
    return map_tree(lambda t: t[rows(len(t))], tree)


def _concat(parts: list):
    """Leafwise concatenation of same-shaped trees of numpy arrays."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return _same_tuple(first, [_concat(list(z)) for z in zip(*parts)])
    return np.concatenate(parts)


def gather_scenarios(part, mesh: Mesh):
    """Every rank's share of a tree (dicts, tuples, NamedTuples) of numpy
    [b, ...] arrays, concatenated in rank order on every rank (the inverse
    of shard_scenarios)."""
    parts = [None] * mesh.size
    dist.all_gather_object(parts, part, group=mesh.group)
    return _concat(parts)


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
