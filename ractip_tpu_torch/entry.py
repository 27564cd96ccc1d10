"""Entry points: one forward step on a card, and a multi-rank dry run.

The port's counterparts of the JAX package's __graft_entry__.py (entry :29,
dryrun_multichip :53):

entry(device)              -- (fn, example_args): the batched forward step
                              of the main pipeline (posteriors -> device
                              problem -> PDHG -> repair), which launches the
                              fold and cofold kernels K1-K5 on a card.
dryrun_multichip(n, device) -- runs predict_batch with an n-rank scenario
                              mesh at B = 2n+1 (not a multiple of n) and
                              reduces the objectives with sharded_mean_var;
                              spawns its n ranks where none was launched.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve

BUCKETS = (16, 16, 16, 32, 32)
SPAWN_TIMEOUT = 600       # seconds a spawned rank may take


def _tiny_batch(B: int, L: int, dev: torch.device):
    """Deterministic synthetic sequence batch (padded encodings, lengths)."""
    rng = np.random.default_rng(0)
    n = np.full((B,), L - 4, np.int64)
    S = rng.integers(1, 5, size=(B, L)).astype(np.int64)
    for b in range(B):
        S[b, n[b]:] = 0
    return torch.as_tensor(S, device=dev), torch.as_tensor(n, device=dev)


def entry(device="cuda"):
    """(fn, example_args): fn(S1, n1, S2, n2) -> (objective, bound,
    violation) of each instance, the main pipeline's forward step on
    `device` at buckets (16, 16, 16, 32, 32) and 200 LP iterations."""
    from .params.boltz import get_boltz, tables_to_torch
    from .params.tables import get_default_params
    from .pipeline.batched import _predict_device
    from .pipeline.options import Options

    dev = resolve(device)
    tt = tables_to_torch(get_boltz(get_default_params()), dev)
    cfg = Options().solver_cfg()

    def fn(S1, n1, S2, n2):
        out = _predict_device(tt, cfg, BUCKETS, 200, False, False, 64, S1,
                              n1, S2, n2)
        return out["obj"], out["bound"], out["mv"]

    S1, n1 = _tiny_batch(2, 32, dev)
    S2, n2 = _tiny_batch(2, 32, dev)
    return fn, (S1, n1, S2, n2)


def _dryrun_rank(device) -> None:
    """One rank of the dry run: predict_batch over the mesh of the process
    group, then the z-score reduction of its objectives."""
    from .params.tables import get_default_params
    from .parallel.mesh import scenario_mesh, sharded_mean_var
    from .pipeline.batched import predict_batch
    from .pipeline.options import Options

    mesh = scenario_mesh()
    n = mesh.size
    rng = np.random.default_rng(0)
    B = 2 * n + 1                  # deliberately not a mesh multiple
    pairs = [("".join(rng.choice(list("ACGU"), 24)),
              "".join(rng.choice(list("ACGU"), 24))) for _ in range(B)]
    res = predict_batch(get_default_params(), pairs, Options(), chunk=B,
                        iters=100, buckets=BUCKETS, mesh=mesh, device=device)
    if len(res.r1) != B or res.objective.shape != (B,):
        raise RuntimeError(f"dry run: {len(res.r1)} results for {B} pairs")
    if float(np.max(res.violation)) >= 0.5:
        raise RuntimeError("dry run: an infeasible decoded structure")
    obj = np.concatenate([res.objective, np.zeros(2 * n - 1)]) \
        .astype(np.float32)
    valid = (np.arange(obj.shape[0]) < B).astype(np.float32)
    m, v = sharded_mean_var(obj, mesh, valid)
    want = res.objective.astype(np.float32)
    if not (np.isclose(float(m), want.mean(), rtol=1e-5, atol=1e-5)
            and np.isclose(float(v), want.var(), rtol=1e-3, atol=1e-4)):
        raise RuntimeError(f"dry run: sharded mean/var {float(m)} "
                           f"{float(v)} against {want.mean()} {want.var()}")


def _dryrun_child(rank: int, n: int, address: str, backend: str,
                  device: str) -> None:
    from .parallel.distributed import init_distributed
    init_distributed(address, n, rank, backend=backend)
    try:
        _dryrun_rank(device)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def rendezvous():
    """file:// address of a rendezvous file in a fresh temporary directory
    (removed on exit) for a process group of this host: the ranks meet in
    the file, so no port is chosen before they bind it."""
    with tempfile.TemporaryDirectory(prefix="ractip_rendezvous_") as d:
        yield "file://" + os.path.join(d, "store")


def spawn_ranks(target, n: int, args=(), timeout: float = SPAWN_TIMEOUT):
    """Run target(rank, *args) in n spawned processes; raise unless every
    one exits 0 within timeout seconds (the late ones are killed)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"spawned ranks exited with {codes}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Runs the production batched path (predict_batch with mesh=...) over
    an n-rank scenario mesh on `device`, then the psum-style z-score
    reduction.  Inside a launched process group (torchrun, or
    init_distributed) this process is one of its ranks; otherwise it spawns
    n ranks on this host: NCCL with one card a rank where there are n
    cards, else gloo (several ranks sharing a card, or the CPU)."""
    dev = resolve(device)
    if dist.is_initialized():
        _dryrun_rank(dev)
        return
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= n_devices
    with rendezvous() as address:
        spawn_ranks(_dryrun_child, n_devices,
                    (n_devices, address, "nccl" if nccl else "gloo",
                     dev.type))
