#!/usr/bin/env python
"""Write the JAX reference outputs of the port's CPU parity tests.

The port's tests hold ractip_tpu_torch against the JAX package on seeded
inputs.  The JAX half of each such comparison never changes between runs,
so this tool computes it once, from the JAX package on the CPU (x64 on, as
tests/conftest.py sets it up), and stores it beside its inputs in one
compressed numpy file per test module under tests/data/:

  torch_port_golden_fold.npz           tests/test_torch_fold.py: Pallas
      batch_inside (interpret, seed 0, B=8, L=32), batch_fold (seed 1 at
      es0 = 185; seed 2, B=4, at es0 = 400) and q2_pallas (seed 3);
  torch_port_golden_accessibility.npz  tests/test_torch_accessibility.py:
      unpaired_probs (max_w 15) vmapped over the Pallas batch_fold's
      tables (interpret, seed 3, B=4, L=32);
  torch_port_golden_cofold.npz         tests/test_torch_cofold.py: the
      Pallas _co_inside_once (seed 0) and batch_cofold (seed 1), interpret,
      B=4, L1 = L2 = 16;
  torch_port_golden_solver.npz         tests/test_torch_solver.py: the
      problems of build_problem_device, the PDHG objective and bound at 400
      iterations and certify_or_solve's (objective, bound) on the port's
      CPU posteriors of seed 5 (the posteriors are stored too);
  torch_port_golden_pipeline.npz       tests/test_torch_pipeline.py:
      zscore_batch (8 seeded decoys) and predict_batch (energies on) at
      chunk 1, 400 iterations, buckets (32, 32, 32, 64, 64), and
      predict_device's objective and bound on the predicted pairs.

Every part runs in a child process of its own, up to --jobs at a time:
this jaxlib's XLA:CPU compile path fails after a few compiles in one
process (tests/conftest.py).  Each test regenerates its seeded inputs and
asserts that they equal the stored ones before it compares.

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_test_golden.py
        [--parts fold,accessibility,cofold,solver,pipeline] [--jobs 5]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)
PARTS = ("fold", "accessibility", "cofold", "solver", "pipeline")


def path(part: str) -> str:
    return os.path.join(DATA, f"torch_port_golden_{part}.npz")


def _rand_strands(rng, B, L, nmin, encode):
    ns = rng.integers(nmin, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns]).astype(np.int32)
    return S, ns


def part_fold():
    import jax.numpy as jnp
    from ractip_tpu.ops import scan_pallas as sp
    from ractip_tpu.ops.mccaskill import SCALE_E0
    from ractip_tpu.ops.seq import encode
    from ractip_tpu.params.boltz import get_boltz
    from ractip_tpu.params.tables import get_default_params
    params = get_default_params()
    L, B = 32, 8
    out = {}
    S, n = _rand_strands(np.random.default_rng(0), B, L, 12, encode)
    es = np.full(B, SCALE_E0, np.float32)
    ref, _, _ = sp.batch_inside(get_boltz(params), jnp.asarray(S),
                                jnp.asarray(n), jnp.asarray(es), b_blk=B,
                                interpret=True)
    out.update(inside_S=S, inside_n=n, inside_es=es)
    for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn", "sat"):
        out[f"inside_{k}"] = np.asarray(getattr(ref, k))
    for tag, seed, b, es0 in (("fold", 1, B, SCALE_E0),
                              ("rescale", 2, 4, 400.0)):
        S, n = _rand_strands(np.random.default_rng(seed), b, L, 12, encode)
        ref = sp.batch_fold(params, jnp.asarray(S), jnp.asarray(n), b_blk=b,
                            interpret=True, es0=float(es0))
        out.update({f"{tag}_S": S, f"{tag}_n": n,
                    f"{tag}_es0": np.float64(es0)})
        for k in ("es", "bpp", "ob"):
            out[f"{tag}_{k}"] = np.asarray(ref[k])
    rng = np.random.default_rng(3)
    qbe = np.triu(rng.uniform(0, 2, (4, L, L)), 4).astype(np.float32)
    sig = rng.uniform(0.6, 0.9, 4).astype(np.float32)
    n = np.array([L, 20, 13, 31], np.int32)
    out.update(q2_qbe=qbe, q2_sig=sig, q2_n=n, q2_q2=np.asarray(sp.q2_pallas(
        jnp.asarray(qbe), jnp.asarray(sig)[:, None], jnp.asarray(n)[:, None],
        L, 4, 4, interpret=True)))
    return out


def part_accessibility():
    import jax
    import jax.numpy as jnp
    from ractip_tpu.ops import mccaskill as mc
    from ractip_tpu.ops import scan_pallas as sp
    from ractip_tpu.ops.accessibility import unpaired_probs
    from ractip_tpu.ops.seq import encode
    from ractip_tpu.params.boltz import get_boltz
    from ractip_tpu.params.tables import get_default_params
    params = get_default_params()
    L, B, max_w = 32, 4, 15
    S, n = _rand_strands(np.random.default_rng(3), B, L, 20, encode)
    bt = get_boltz(params)
    res = sp.batch_fold(params, jnp.asarray(S), jnp.asarray(n), b_blk=4,
                        interpret=True)
    pu = jax.vmap(lambda ff, ins, ob, sig, m: unpaired_probs(
        ff, bt, ins, mc.OutsideState(ob=ob, bpp=ob), m, max_w, jnp.float32,
        sig))(res["ff"], res["ins"], res["ob"], res["sig"], jnp.asarray(n))
    return dict(S=S, n=n, max_w=np.int64(max_w), pu=np.asarray(pu))


def _cofold_batch(seed, encode, B=4, L1=16, L2=16, nmin=8):
    rng = np.random.default_rng(seed)
    n1 = rng.integers(nmin, L1 + 1, B).astype(np.int32)
    n2 = rng.integers(nmin, L2 + 1, B).astype(np.int32)
    S1 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L1)
                   for m in n1]).astype(np.int32)
    S2 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L2)
                   for m in n2]).astype(np.int32)
    return S1, S2, n1, n2


def part_cofold():
    import jax.numpy as jnp
    from ractip_tpu.ops import cofold_pallas as cp
    from ractip_tpu.ops import mccaskill as mc
    from ractip_tpu.ops.seq import encode
    from ractip_tpu.params.boltz import get_boltz
    from ractip_tpu.params.tables import get_default_params
    params = get_default_params()
    bt = get_boltz(params)
    out = {}
    S1, S2, n1, n2 = _cofold_batch(0, encode)
    es = np.full(4, mc.SCALE_E0, np.float32)
    S = cp._pack_concat(jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(n1))
    ref, _, _, _ = cp._co_inside_once(
        bt, S, jnp.asarray(n1 + n2), jnp.asarray(n1), jnp.asarray(es), 4,
        True, None, emit_state=True)
    out.update(inside_S1=S1, inside_S2=S2, inside_n1=n1, inside_n2=n2,
               inside_es=es, inside_S=np.asarray(S))
    for k in ("qb", "qm", "qm1", "qx", "q1", "q2", "zn"):
        out[f"inside_{k}"] = np.asarray(getattr(ref, k))
    S1, S2, n1, n2 = _cofold_batch(1, encode)
    ref = cp.batch_cofold(params, jnp.asarray(S1), jnp.asarray(S2),
                          jnp.asarray(n1), jnp.asarray(n2), b_blk=4,
                          interpret=True)
    out.update(cofold_S1=S1, cofold_S2=S2, cofold_n1=n1, cofold_n2=n2)
    for k in ("es", "bpp", "hp"):
        out[f"cofold_{k}"] = np.asarray(ref[k])
    return out


def solver_posteriors():
    """The solver test's posteriors: the port's CPU slice on seed 5."""
    import torch
    torch.set_num_threads(2)
    from ractip_tpu_torch.ops.accessibility import unpaired_probs
    from ractip_tpu_torch.ops.cofold import batch_cofold
    from ractip_tpu_torch.ops.scan import as_tables, batch_fold
    from ractip_tpu_torch.ops.seq import encode
    from ractip_tpu_torch.params.tables import get_default_params
    L, B = 32, 2
    rng = np.random.default_rng(5)
    n1 = rng.integers(20, L + 1, B)
    n2 = rng.integers(20, L + 1, B)
    S1 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                   for m in n1])
    S2 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                   for m in n2])
    tt = as_tables(get_default_params(), "cpu")
    r1 = batch_fold(tt, S1, n1, "cpu")
    r2 = batch_fold(tt, S2, n2, "cpu")
    n1t, n2t = torch.as_tensor(n1), torch.as_tensor(n2)
    pu1 = unpaired_probs(tt, r1["ff"], r1["ins"], r1["ob"], n1t, 15, r1["sig"])
    pu2 = unpaired_probs(tt, r2["ff"], r2["ins"], r2["ob"], n2t, 15, r2["sig"])
    hp = batch_cofold(tt, S1, S2, n1, n2, "cpu")["hp"]
    post = [t.numpy().astype(np.float32) for t in
            (r1["bpp"], r2["bpp"], hp, pu1, pu2)]
    return S1, S2, post + [n1.astype(np.int32), n2.astype(np.int32)]


def part_solver():
    S1, S2, post = solver_posteriors()
    import jax
    import jax.numpy as jnp
    from ractip_tpu.solver import device as jdev
    from ractip_tpu.solver import joint_lp as jlp
    from ractip_tpu.solver import milp as jmilp
    from ractip_tpu.solver.candidates import JointProblem, SolverConfig
    L, iters = 32, 400
    buckets = (32, 32, 32, 256, 256)
    cfg = SolverConfig()
    jp = jax.vmap(lambda a, b, h, p1, p2, m1, m2: jdev.build_problem_device(
        a, b, h, p1, p2, m1, m2, cfg, buckets))(*[jnp.asarray(x)
                                                  for x in post])

    def one(p):
        uj, _, bj = jlp.pdhg_solve(p, cfg, L, L, iters=iters)
        return jlp.primal_objective(p, uj), bj

    jobj, jbound = jax.vmap(one)(jp)
    cert = []
    for b in range(len(post[5])):
        q = JointProblem(*[np.asarray(t)[b] for t in jp])
        _, obj, bound, _ = jmilp.certify_or_solve(q, cfg, L, L, -1.0, 1e-4)
        cert.append((obj, bound))
    return dict(S1=S1, S2=S2, buckets=np.asarray(buckets),
                iters=np.int64(iters), obj=np.asarray(jobj),
                bound=np.asarray(jbound), cert=np.asarray(cert, np.float64),
                **{f"post{k}": a for k, a in enumerate(post)},
                **{f"p_{f}": np.asarray(getattr(jp, f)) for f in jp._fields})


def pipeline_pairs(seed, k=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n1, n2 = int(rng.integers(16, 25)), int(rng.integers(16, 25))
        out.append(("".join(rng.choice(list("ACGU"), n1)),
                    "".join(rng.choice(list("ACGU"), n2))))
    return out


def part_pipeline():
    from ractip_tpu.io.fasta import Fasta
    from ractip_tpu.ops.seq import bucket_length, encode
    from ractip_tpu.params.tables import get_default_params
    from ractip_tpu.pipeline import batched as jb
    from ractip_tpu.pipeline.ractip import Options
    params = get_default_params()
    pairs, zpair = pipeline_pairs(0), pipeline_pairs(4, 1)[0]
    decoys, seed, iters = 8, 3, 400
    buckets = (32, 32, 32, 64, 64)
    kw = dict(chunk=1, iters=iters, buckets=buckets)
    z, zs, st = jb.zscore_batch(
        Fasta("s1", zpair[0]), Fasta("s2", zpair[1]),
        Options(zscore=12, num_shuffling=decoys, seed=seed), params, **kw)
    r = jb.predict_batch(params, pairs, Options(), want_energy=True, **kw)
    L1 = max(bucket_length(len(a)) for a, _ in pairs)
    L2 = max(bucket_length(len(b)) for _, b in pairs)
    S1 = np.stack([encode(a, L1) for a, _ in pairs]).astype(np.int32)
    S2 = np.stack([encode(b, L2) for _, b in pairs]).astype(np.int32)
    n1 = np.array([len(a) for a, _ in pairs], np.int32)
    n2 = np.array([len(b) for _, b in pairs], np.int32)
    dv = jb.predict_device(params, S1, n1, S2, n2, Options().solver_cfg(),
                           buckets=buckets, iters=iters)
    return dict(pairs=np.asarray(pairs), zpair=np.asarray(zpair),
                decoys=np.int64(decoys), seed=np.int64(seed),
                iters=np.int64(iters), buckets=np.asarray(buckets),
                z=np.float64(z), zs=np.float64(zs),
                brackets=np.asarray(list(st["brackets"])),
                decoy_e=np.asarray(st["decoy_e"]),
                decoy_es=np.asarray(st["decoy_es"]),
                r1=np.asarray(r.r1), r2=np.asarray(r.r2),
                objective=np.asarray(r.objective),
                device_S1=S1, device_S2=S2, device_n1=n1, device_n2=n2,
                device_obj=np.asarray(dv["obj"]),
                device_bound=np.asarray(dv["bound"]))


def _child(part: str, dst: str) -> None:
    out = globals()[f"part_{part}"]()
    np.savez(dst, **out)


def _spawn(part: str) -> str:
    t0 = time.time()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
           "PYTHONPATH": ROOT}
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "out.npz")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", part, "--out", dst], env=env,
                              capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            raise RuntimeError(f"part {part}: {proc.stderr[-3000:]}")
        with np.load(dst) as z:
            out = {k: z[k] for k in z.files}
    np.savez_compressed(path(part), **out)
    return f"{part}: {time.time() - t0:.1f} s, {os.path.getsize(path(part))} B"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child, args.out)
        return 0
    parts = [p for p in args.parts.split(",") if p]
    for p in parts:
        if p not in PARTS:
            raise SystemExit(f"unknown part {p!r} (expected {PARTS})")
    with ThreadPoolExecutor(args.jobs) as ex:
        for line in ex.map(_spawn, parts):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
