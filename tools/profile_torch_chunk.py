#!/usr/bin/env python3
"""Profile one CopA x CopT decoy chunk of the PyTorch port on a CUDA GPU.

The chunk is the first --chunk seeded decoys of zscore_batch(CopA, CopT,
seed=1), run through pipeline.batched._predict_device as zscore_batch runs
it (posteriors, sparsification, the PDHG LP with round/repair and the two
secondary-structure-only solves).  Three measurements:

  1. the stage seconds of an unprofiled call at --iters and at 2 x --iters;
     the LP's difference over the difference in PDHG iterations is the wall
     cost of one PDHG iteration of the batch;
  2. a torch.profiler trace (CPU + CUDA activity) of the call at --iters:
     device events (kernel launches, copies), their summed device time, the
     profiled wall, and the kernels with the most device time;
  3. the same trace of the posteriors alone (fold, accessibility, cofold).

Run from the root of a checkout:
    python3 tools/profile_torch_chunk.py [--iters 300] [--chunk 256]
It prints a summary and writes the full record to
chiprun_out/profile_torch_chunk.json.  It needs a GPU and imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def pdhg_iterations(iters: int) -> int:
    """PDHG iterations of one _predict_device call with accessibility on:
    stage 1, the region stage 2 (solver/device.py), two ss-only solves."""
    return iters + max(iters // 3, 200) + 2 * iters


def trace(fn):
    """(profiled wall s, summary dict) of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.elapsed_us() / 1e3
    copies = sum(c for n, (c, _) in per.items()
                 if n.startswith(("Memcpy", "Memset")))
    busy_ms = sum(ms for _, ms in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:12]
    return wall, dict(
        profiled_wall_s=wall, device_events=len(dev),
        kernel_launches=len(dev) - copies, copies=copies,
        device_busy_ms=busy_ms,
        busy_share_of_profiled_wall=busy_ms / 1e3 / wall,
        top=[dict(name=n[:120], calls=c, ms=ms) for n, (c, ms) in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "profile_torch_chunk.json"))
    a = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_chunk: needs a CUDA GPU")
        return 1
    from ractip_tpu_torch.evaluate.corpus import record
    from ractip_tpu_torch.ops.seq import bucket_length, encode
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.shuffle import shuffle_batch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops.scan import as_tables
    from ractip_tpu_torch.pipeline.batched import (DEFAULT_BUCKETS,
                                                   _batch_posteriors,
                                                   _predict_device)
    from ractip_tpu_torch.pipeline.options import Options
    from ractip_tpu_torch.utils.timing import StageTimer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    dev = torch.device("cuda")
    _cuda.lib()
    tt = as_tables(get_default_params(), dev)
    cfg = Options(zscore=12, seed=1).solver_cfg()
    a1, a2 = record("CopA.fa").seq, record("CopT.fa").seq
    seed = int(np.random.default_rng(1).integers(0, 2**63 - 1))
    d1 = shuffle_batch(a1, a.chunk, seed)
    d2 = shuffle_batch(a2, a.chunk, seed + 1)
    L1 = max(bucket_length(len(s)) for s in d1)
    L2 = max(bucket_length(len(s)) for s in d2)
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev).to(torch.long)
    S1 = t(np.stack([encode(s, L1) for s in d1]))
    S2 = t(np.stack([encode(s, L2) for s in d2]))
    n1, n2 = t([len(s) for s in d1]), t([len(s) for s in d2])

    def call(iters, timer=None):
        return _predict_device(tt, cfg, DEFAULT_BUCKETS, iters, False, True,
                               64, S1, n1, S2, n2, timer)

    call(a.iters)                                   # warm-up
    rec = dict(device=smi, chunk=a.chunk, L1=L1, L2=L2, iters=a.iters)
    stages = {}
    for it in (a.iters, 2 * a.iters):
        timer = StageTimer(dev)
        t0 = time.perf_counter()
        call(it, timer)
        torch.cuda.synchronize()
        stages[it] = dict(wall_s=time.perf_counter() - t0, **timer.report())
    d_it = pdhg_iterations(2 * a.iters) - pdhg_iterations(a.iters)
    per_iter_ms = (stages[2 * a.iters]["lp"] - stages[a.iters]["lp"]) / d_it \
        * 1e3
    rec.update(stages=stages, pdhg_iterations={
        it: pdhg_iterations(it) for it in stages}, per_pdhg_iteration_ms=
        per_iter_ms)
    print(f"unprofiled stage seconds: {json.dumps(stages)}")
    print(f"one PDHG iteration of the batch: {per_iter_ms:.3f} ms of wall "
          f"({d_it} iterations between the two runs)")

    _, full = trace(lambda: call(a.iters))
    full["busy_share_of_unprofiled_wall"] = (
        full["device_busy_ms"] / 1e3 / stages[a.iters]["wall_s"])
    _, post = trace(lambda: _batch_posteriors(tt, S1, n1, S2, n2, cfg, False))
    rec.update(trace_predict_device=full, trace_posteriors=post)
    for name, r in (("_predict_device", full), ("posteriors", post)):
        print(f"{name} at iters={a.iters}: profiled wall "
              f"{r['profiled_wall_s']:.3f} s, {r['kernel_launches']} kernel "
              f"launches + {r['copies']} copies, device busy "
              f"{r['device_busy_ms']:.1f} ms "
              f"({100 * r['busy_share_of_profiled_wall']:.1f} % of the "
              "profiled wall)")
        for row in r["top"][:6]:
            print(f"    {row['ms']:9.2f} ms  {row['calls']:7d}  "
                  f"{row['name'][:90]}")
    print(f"device busy against the unprofiled wall at iters={a.iters}: "
          f"{100 * full['busy_share_of_unprofiled_wall']:.1f} %")
    ok = full["kernel_launches"] > 0 and post["kernel_launches"] > 0
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"wrote {out}" if ok else "profile_torch_chunk: the trace holds no "
          "device events")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
