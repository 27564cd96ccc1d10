#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ractip_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(--only kernels,corpus,zscore runs a subset, for development; a subset
run never prints the final ok line).

Phases (each prints its own lines; the run exits 0 only if all pass):
  1. device   the card's name, and name + power limit from nvidia-smi;
  2. build    nvcc builds csrc/*.cu for sm_90a; seconds, registers, spills;
  3. kernels  each of K1-K5 against its plain PyTorch version on the same
              inputs, at the main path's shapes (fold B=512 L=96, cofold
              B=256 Lc=192 cut=70) and at the corpus cofold shape (Lc=288),
              with CUDA-event times of both; NaN or infinities in one
              version and not the other fail, as do non-finite pair
              probabilities and a second launch that is not bit-identical;
  4. corpus   predict_batch on the bundled 8-pair corpus against the golden
              file made by the JAX package (tests/data/torch_port_golden.json);
  5. zscore   CopA x CopT against 1000 seeded decoys at chunk 256 (per-stage
              times, decoy pipelines/s, z/zs sanity band), and the golden's
              64-decoy seeded run for parity;
  6. counts   every kernel launched on the main path (phases 4-5), and no
              plain version ran on a CUDA tensor there.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  A fuller record goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"

FOLD_B, FOLD_L = 512, 96
CO_B, CO_L1, CO_L2, CO_CUT = 256, 96, 96, 70
TOL_STATE = 1e-4          # inside states / ob, relative, at L <= 192
TOL_PROB = 1e-5           # bpp / hp, absolute, at L <= 192
TOL_STATE_288 = 1e-3      # corpus shape (Lc = 288): measured 2.7e-4 (PERF.md)
TOL_PROB_288 = 1e-5       # measured 1.2e-7 (PERF.md)
Z_TPU, ZS_TPU, Z_BAND = -6.374, -2.845, 0.5
KERNELS = [  # name, source, TPU kernel it replaces
    ("inside", "ractip_tpu_torch/csrc/inside.cu",
     "ractip_tpu/ops/scan_pallas.py:349"),
    ("outside", "ractip_tpu_torch/csrc/outside.cu",
     "ractip_tpu/ops/scan_pallas.py:488"),
    ("q2", "ractip_tpu_torch/csrc/q2.cu", "ractip_tpu/ops/scan_pallas.py:145"),
    ("co_inside", "ractip_tpu_torch/csrc/inside.cu",
     "ractip_tpu/ops/cofold_pallas.py:215"),
    ("co_outside", "ractip_tpu_torch/csrc/outside.cu",
     "ractip_tpu/ops/cofold_pallas.py:404"),
]


def say(*a):
    print(*a, flush=True)


def bail(msg: str) -> None:
    say(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


class Run:
    def __init__(self):
        self.failures: list[str] = []
        self.record: dict = {}

    def check(self, phase: str, ok: bool, what: str) -> bool:
        say(f"  [{'ok' if ok else 'FAIL'}] {phase}: {what}")
        if not ok:
            self.failures.append(f"{phase}: {what}")
        return ok

    def phase(self, name, fn, *a):
        say(f"== {name}")
        try:
            return fn(self, *a)
        except Exception as e:  # a phase that raises fails the run
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
            return None


def diff(a, b):
    """(max abs, max rel, non-finite count of a, of b) of a against b.

    NaN and the infinities must sit at the same positions in both: one
    position where they do not makes both differences infinite, so a NaN
    cannot hide inside a max().  The maxima are taken where both are finite;
    the relative one where b != 0, and a nonzero a where b == 0 makes it
    infinite."""
    inf = float("inf")
    a, b = a.double(), b.double()
    fa, fb = a.isfinite(), b.isfinite()
    counts = (int((~fa).sum()), int((~fb).sum()))
    same = (a == b) | (a.isnan() & b.isnan())
    if bool((~(fa & fb) & ~same).any()):
        return inf, inf, *counts
    a, b = a[fa & fb], b[fa & fb]
    if a.numel() == 0:
        return 0.0, 0.0, *counts
    d = (a - b).abs()
    nz = b.abs() > 0
    rel = (d[nz] / b.abs()[nz]).max().item() if bool(nz.any()) else 0.0
    if bool((a[~nz].abs() > 1e-30).any()):
        rel = inf
    return d.max().item(), rel, *counts


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------

def phase_device(run: Run):
    import torch
    name = torch.cuda.get_device_name(0)
    say(f"device: {name}  (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    run.record["nvidia_smi"] = line
    run.record["device"] = name
    run.check("device", bool(line), f"nvidia-smi: {line}")


def phase_build(run: Run):
    from ractip_tpu_torch.ops import _cuda
    path = _cuda.build(force=True)
    secs = _cuda.BUILD_LOG["seconds"]
    log = _cuda.BUILD_LOG["ptxas"]
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text(log)
    regs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            regs.setdefault(cur, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            regs.setdefault(cur, {})["regs"] = int(m.group(1))
    names = {"inside_kernelILb0": "inside", "inside_kernelILb1": "co_inside",
             "outside_kernelILb0": "outside",
             "outside_kernelILb1": "co_outside", "q2_kernel": "q2"}
    for mangled, v in sorted(regs.items()):
        short = next((s for k, s in names.items() if k in mangled), mangled)
        say(f"  ptxas {short}: {v.get('regs')} registers, "
            f"{v.get('spill', 0)} bytes spilled")
    run.record["build"] = dict(seconds=secs, ptxas=regs)
    _cuda.lib()
    run.check("build", path.exists(), f"nvcc built {path.name} in "
              f"{secs:.1f} s")


def _shuffled_pairs(B):
    from ractip_tpu_torch.data import record, shuffle_batch
    a, b = record("CopA.fa").seq, record("CopT.fa").seq
    return list(zip(shuffle_batch(a, B, 11), shuffle_batch(b, B, 12)))


def _encode(pairs, L1, L2, dev):
    import numpy as np
    import torch
    from ractip_tpu_torch.data import encode
    S1 = torch.as_tensor(np.stack([encode(a, L1) for a, _ in pairs]),
                         device=dev).long()
    S2 = torch.as_tensor(np.stack([encode(b, L2) for _, b in pairs]),
                         device=dev).long()
    n1 = torch.tensor([len(a) for a, _ in pairs], device=dev)
    n2 = torch.tensor([len(b) for _, b in pairs], device=dev)
    return S1, S2, n1, n2


def phase_kernels(run: Run):
    import torch
    from ractip_tpu_torch.data import (bucket_length, corpus_pairs,
                                       get_default_params)
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.factors import co_factors, fold_factors
    from ractip_tpu_torch.params.boltz import sig_tables

    dev = torch.device("cuda")
    tt = ts.as_tables(get_default_params(), dev)
    res = {}

    def rec(name, shape, kfn, pfn, tol_rel, tol_abs, probs=lambda o: []):
        """Hold the kernel call kfn() against its plain version pfn() on the
        same inputs, and a second kernel launch against the first (it must
        be bit-identical: a race would show here).  probs(outputs) gives the
        pair probabilities the outputs lead to.  Returns kfn()'s outputs."""
        tup = lambda o: o if isinstance(o, tuple) else (o,)
        outs_k, outs_p, again = tup(kfn()), tup(pfn()), tup(kfn())
        same = all(torch.equal(a, b) for a, b in zip(outs_k, again))
        worst_rel, worst_abs, nonfin = 0.0, 0.0, [0, 0]
        for a, b in zip(outs_k, outs_p):
            ab, rl, nk, np_ = diff(a, b)
            worst_rel, worst_abs = max(worst_rel, rl), max(worst_abs, ab)
            nonfin = [nonfin[0] + nk, nonfin[1] + np_]
        pab, pnonfin = 0.0, 0
        for a, b in zip(probs(outs_k), probs(outs_p)):
            ab, _, nk, np_ = diff(a, b)
            pab, pnonfin = max(pab, ab), pnonfin + nk + np_
        ms, plain_ms = cuda_ms(kfn, 5), cuda_ms(pfn, 1)
        # the probabilities leave the DP for the LP: they must be finite
        ok = (worst_rel <= tol_rel and pab <= tol_abs and pnonfin == 0
              and same)
        run.check("kernels", ok, f"{name} {shape}: max rel {worst_rel:.3e} "
                  f"(tol {tol_rel:g}), max abs {worst_abs:.3e}, non-finite "
                  f"kernel/plain {nonfin[0]}/{nonfin[1]}, probs max abs "
                  f"{pab:.3e} (tol {tol_abs:g}), probs non-finite {pnonfin},"
                  f" relaunch bit-identical {same}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms")
        res.setdefault(name, []).append(dict(
            shape=shape, max_rel=worst_rel, max_abs=worst_abs,
            nonfinite_kernel=nonfin[0], nonfinite_plain=nonfin[1],
            prob_max_abs=pab, prob_nonfinite=pnonfin, relaunch_same=same,
            ms=ms, plain_ms=plain_ms))
        return outs_k

    # ---- fold at the main path's shape: K1, K3, K2
    pairs = _shuffled_pairs(FOLD_B // 2)
    S1, S2, n1, n2 = _encode(pairs, FOLD_L, FOLD_L, dev)
    S, n = torch.cat([S1, S2]), torch.cat([n1, n2])
    # the per-instance scale energies the pipeline's adaptive loop picks
    es = ts.batch_fold(tt, S, n, dev)["es"]
    sig = torch.exp(-es / tt.scalar(tt.bt.kt))
    ff = fold_factors(tt, S, n, sig)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    args = (F, w2k, bulge_k, sig, pows)
    qm1_c, qb_c, qm_c, _, q1 = rec(
        "inside", [FOLD_B, FOLD_L], lambda: ts.inside(*args),
        lambda: ts.inside_plain(*args), TOL_STATE, TOL_PROB)
    qb = qb_c.transpose(1, 2)
    qbe = (qb * ff.fe).contiguous()
    n32 = n.to(torch.int32)
    q2k, = rec("q2", [FOLD_B, FOLD_L], lambda: ts.q2(qbe, sig, n32),
               lambda: ts.q2_plain(qbe, sig, n32), TOL_STATE, TOL_PROB)
    zn = q1.gather(1, (n - 1)[:, None])[:, 0]
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1).contiguous()
    qmN = qm_c.transpose(1, 2).contiguous()
    oargs = (F, qmN, qm1_c, q1pad, q2k, w2k, bulge_k, sig, pows)
    rec("outside", [FOLD_B, FOLD_L], lambda: ts.outside(*oargs),
        lambda: ts.outside_plain(*oargs), TOL_STATE, TOL_PROB,
        lambda o: [ts.pair_probs(qb, o[0].transpose(1, 2), zn)])

    # ---- cofold at the main path's shape and at the corpus shape: K4, K5
    def cofold_case(pairs, L1, L2, tol_rel, tol_abs):
        S1, S2, n1, n2 = _encode(pairs, L1, L2, dev)
        B = S1.shape[0]
        S = tc._pack_concat(S1, S2, n1)
        n, cut = n1 + n2, n1
        es = tc.batch_cofold(tt, S1, S2, n1, n2, dev)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = co_factors(tt, S, n, cut, sig)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows, cut)
        shape = [B, L1 + L2]
        qm1_c, qb_c, qm_c, qx_c, q1 = rec(
            "co_inside", shape, lambda: tc.co_inside(*args),
            lambda: ts.inside_plain(*args), tol_rel, tol_abs)
        qb = qb_c.transpose(1, 2)
        zn = q1.gather(1, (n - 1)[:, None])[:, 0]
        q2v = ts.q2((qb * ff.fe).contiguous(), sig, n)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        qx = qx_c.transpose(1, 2).contiguous()
        qxA, qBpref = tc.exterior_vectors(qx, cut)
        oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, qx, qxA,
                 qBpref, q1pad, q2v, w2k, bulge_k, sig, pows, cut)
        rec("co_outside", shape, lambda: tc.co_outside(*oargs),
            lambda: tc.co_outside_plain(*oargs), tol_rel, tol_abs,
            lambda o: [tc.cross_block(ts.pair_probs(qb, o[0].transpose(1, 2),
                                                    zn), n1, n2, L1, L2)])

    cofold_case([(a[:CO_CUT], b) for a, b in _shuffled_pairs(CO_B)],
                CO_L1, CO_L2, TOL_STATE, TOL_PROB)
    corpus = [(fa1.seq, fa2.seq) for _, fa1, fa2 in corpus_pairs()]
    L1 = max(bucket_length(len(a)) for a, _ in corpus)
    L2 = max(bucket_length(len(b)) for _, b in corpus)
    cofold_case(corpus, L1, L2, TOL_STATE_288, TOL_PROB_288)
    run.record["kernels"] = res
    torch.cuda.synchronize()


def phase_corpus(run: Run, timer_cls):
    import numpy as np
    import torch
    from ractip_tpu_torch.data import corpus_pairs, get_default_params
    from ractip_tpu_torch.pipeline.batched import predict_batch
    from ractip_tpu_torch.pipeline.options import Options
    gold = json.loads(GOLDEN.read_text())["corpus"]["pairs"]
    recs = list(corpus_pairs())
    pairs = [(fa1.seq, fa2.seq) for _, fa1, fa2 in recs]
    timer = timer_cls("cuda")
    t0 = time.perf_counter()
    res = predict_batch(get_default_params(), pairs, Options(), timer=timer,
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"  corpus wall {wall:.2f} s, stages {json.dumps(timer.report())}")
    rows = []
    for (name, _, _), r1, r2, obj in zip(recs, res.r1, res.r2, res.objective):
        g = next(x for x in gold if x["name"] == name)
        same = (r1, r2) == (g["r1"], g["r2"])
        dobj = abs(float(obj) - g["objective"])
        if same:
            run.check("corpus", dobj <= 1e-4, f"{name}: brackets identical, "
                      f"objective {obj:.6f} (golden {g['objective']:.6f})")
        else:
            run.check("corpus", dobj <= 1e-4, f"{name}: brackets differ, "
                      f"objective {obj:.6f} vs golden {g['objective']:.6f} "
                      f"(|d|={dobj:.2e}): alternative optimum")
            say(f"    port   {r1} / {r2}\n    golden {g['r1']} / {g['r2']}")
        rows.append(dict(name=name, same=same, objective=float(obj),
                         golden=g["objective"]))
    run.check("corpus", float(np.max(res.violation)) < 0.5,
              "all decoded structures feasible")
    run.record["corpus"] = dict(wall=wall, stages=timer.report(), pairs=rows)


def phase_zscore(run: Run, timer_cls):
    import numpy as np
    import torch
    from ractip_tpu_torch.data import get_default_params, native_shuffle, \
        record
    from ractip_tpu_torch.pipeline.batched import zscore_batch
    from ractip_tpu_torch.pipeline.options import Options
    fa1, fa2 = record("CopA.fa"), record("CopT.fa")
    params = get_default_params()
    nat = native_shuffle()
    run.check("zscore", nat, f"native uShuffle available: {nat}")
    timer = timer_cls("cuda")
    t0 = time.perf_counter()
    z, zs, st = zscore_batch(fa1, fa2, Options(zscore=12, num_shuffling=1000,
                                               seed=1), params, chunk=256,
                             timer=timer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = timer.report()
    say(f"  1000 decoys: z={z:.4f} zs={zs:.4f} e={st['e']:.2f} "
        f"es={st['es']:.2f}; wall {wall:.2f} s, "
        f"{1000 / wall:.2f} decoy pipelines/s")
    say(f"  stages (s): {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    run.check("zscore", abs(z - Z_TPU) <= Z_BAND and abs(zs - ZS_TPU) <= Z_BAND,
              f"z {z:.3f} within {Z_BAND} of {Z_TPU} and zs {zs:.3f} within "
              f"{Z_BAND} of {ZS_TPU} (unseeded TPU run: sanity band)")
    run.check("zscore", float(np.max(st["violation"])) < 0.5,
              "all decoy structures feasible")
    gz = json.loads(GOLDEN.read_text())["zscore"]
    z64, zs64, st64 = zscore_batch(
        fa1, fa2, Options(zscore=12, num_shuffling=gz["num_shuffling"],
                          seed=gz["seed"]), params, chunk=256, device="cuda")
    same = int(np.sum(np.abs(np.asarray(st64["decoy_e"])
                             - np.asarray(gz["decoy_e"])) < 1e-6))
    run.check("zscore", abs(z64 - gz["z"]) <= 1e-2
              and abs(zs64 - gz["zs"]) <= 1e-2,
              f"64-decoy seeded parity: z {z64:.4f} vs golden {gz['z']:.4f},"
              f" zs {zs64:.4f} vs {gz['zs']:.4f}; {same}/"
              f"{gz['num_shuffling']} decoy energies identical")
    run.record["zscore"] = dict(z=z, zs=zs, e=st["e"], es=st["es"],
                                wall=wall, rate=1000 / wall, stages=stages,
                                z64=z64, zs64=zs64, same64=same)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    ap.add_argument("--only", default="kernels,corpus,zscore",
                    help="comma list of phases after the build")
    only = set(ap.parse_args().only.split(","))
    full = only == {"kernels", "corpus", "zscore"}
    try:
        import torch
    except ImportError:
        bail("PyTorch is not installed")
    if not torch.cuda.is_available():
        bail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        import ractip_tpu_torch
    except ImportError as e:
        bail(f"the port is not next to this script ({e})")
    if Path(ractip_tpu_torch.__file__).resolve().parent.parent != ROOT:
        bail("ractip_tpu_torch was not imported from this checkout")
    if not GOLDEN.exists():
        bail(f"missing {GOLDEN.relative_to(ROOT)}")
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.utils.timing import StageTimer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = Run()
    run.phase("1 device", phase_device)
    run.phase("2 build", phase_build)
    if not run.failures:
        if "kernels" in only:
            run.phase("3 kernels vs plain", phase_kernels)
        _cuda.reset_counts()
        if "corpus" in only:
            run.phase("4 corpus", phase_corpus, StageTimer)
        if "zscore" in only:
            run.phase("5 zscore", phase_zscore, StageTimer)
        launches = dict(_cuda.LAUNCHES)
        plain = dict(_cuda.PLAIN_ON_CUDA)
        if only & {"corpus", "zscore"}:
            say("== 6 launch counts")
            for name, _, _ in KERNELS:
                run.check("counts", launches.get(name, 0) > 0,
                          f"{name}: {launches.get(name, 0)} launches on the "
                          "main path")
            run.check("counts", not any(plain.values()),
                      "plain versions on CUDA tensors during phases 4-5: "
                      f"{plain}")
        run.record["launches"] = launches
        kern = run.record.get("kernels", {})
        rows = []
        for name, src, rep in KERNELS:
            main_shape = (kern.get(name) or [{}])[0]
            rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                             launches=launches.get(name, 0),
                             max_abs_err=main_shape.get("max_abs"),
                             max_rel_err=main_shape.get("max_rel"),
                             ms=main_shape.get("ms"),
                             plain_ms=main_shape.get("plain_ms")))
        run.record["kernel_rows"] = rows
    run.check("imports", "jax" not in sys.modules, "jax was never imported")
    OUT.mkdir(exist_ok=True)
    run.record["failures"] = run.failures
    (OUT / "chip_smoke.json").write_text(json.dumps(run.record, indent=1,
                                                    default=str))
    if run.failures:
        say("chip_smoke: FAILED phases:")
        for f in run.failures:
            say(f"  - {f}")
        return 1
    if not full:
        say(f"chip_smoke: subset {sorted(only)} passed (no result line)")
        return 0
    say(json.dumps({"kernels": run.record["kernel_rows"]}))
    say(run.record["nvidia_smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
