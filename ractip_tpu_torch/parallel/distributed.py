"""Multi-process initialization for sharded sweeps, on torch.distributed.

Port of ractip_tpu/parallel/distributed.py (init_distributed :39).  The
reference is a single-process binary (reference src/ractip.cpp:1494); the
port scales batch workloads over GPUs by running one process a card, each
of which calls init_distributed() and then shards the scenario axis over
the process group (parallel/mesh.py).  NCCL carries the gathers of each
chunk's results and the z-score's mean / variance reduction.

One command a host, e.g. on one machine with four cards:

    torchrun --standalone --nproc-per-node 4 -m ractip_tpu_torch \\
        --zscore 12 a.fa b.fa

or programmatically:

    from ractip_tpu_torch.parallel.distributed import init_distributed
    from ractip_tpu_torch.parallel.mesh import scenario_mesh
    if init_distributed():                   # False without a launcher
        mesh = scenario_mesh()
    predict_batch(..., mesh=mesh)

Every rank must make the same predict_batch calls; each runs its share of
every chunk and ends with the whole result.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(address: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     local_rank: int | None = None,
                     backend: str = "nccl") -> bool:
    """Join the process group from the arguments or torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).

    address is "host:port" of rank 0's store, or a URL such as
    "file:///dir/store" (entry.rendezvous: a file all ranks of one host
    share).  Returns True once this process is in
    a process group, False (doing nothing) where no multi-process launch is
    configured (no address and no MASTER_ADDR), so callers can take the
    same path either way.  Idempotent.  With NCCL each rank drives the card
    cuda:local_rank; backend="gloo" keeps the collectives on the host (the
    CPU tests; several ranks sharing one card, which NCCL refuses)."""
    if dist.is_initialized():
        return True
    if address is None and os.environ.get("MASTER_ADDR"):
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if not address:
        return False
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    url = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=world_size, rank=rank)
    return True
