#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ractip_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(--only kernels,corpus,zscore,duplex,single,contrafold runs a subset, for
development; a subset run never prints the final ok line).

Phases (each prints its own lines; the run exits 0 only if all pass):
  1. device   the card's name, and name + power limit from nvidia-smi;
  2. build    nvcc builds csrc/*.cu for sm_90a, one process per source;
              seconds, registers, spills; blocks an SM of the scans'
              variants at the main shapes (cudaOccupancy...);
  3. kernels  each of K1-K6 against its plain PyTorch version on the same
              inputs, at the main paths' shapes (fold B=512 L=96, cofold
              B=256 Lc=192 cut=70, duplex B=256 L1=L2=96), at the corpus
              shapes (fold B=8 at L=128 and at L=160, cofold Lc=288, duplex
              L1=128 L2=160), for K1/K2 at L=192 and L=256 (B=512 and B=8:
              two and four threads a row, qm in device memory) and at a
              small sigma (es + 500: the padding's qm leaves the normal
              floats; K2 held beyond 1e-30 absolute), for K4/K5 with the cut
              at both edges (cut=1, cut=n-1; Lc=192), at long shapes (fold
              B=2, L=1024; cofold B=2, Lc=512 and Lc=1024: past the sizes
              where their tables and rings fit in shared memory), for K3 at
              every fold and cofold case and on full random qbe with n < L
              (lower triangle and padding nonzero), and for K6 at a long
              target (B=2, L1=64, L2=2048: rings in device memory) and with
              each of its variants (1, 2, 4, 8 lanes a column group and 2 or
              4 columns a group with the rings in shared memory; 1 or 2
              lanes of 2 columns with them in device memory) at the corpus
              shape; and at B=1 with -c masks in the factors, as the
              single-pair path gives them (K1-K3 on CopA and on CopT with
              their constraint strings and on CopA banned whole, K4/K5 and K3
              on CopA x CopT with the strings and with CopA banned whole;
              K6 at B=1, 96x96), with
              CUDA-event times of both and each kernel's bound on the card;
              K1-K6 take the lengths; whole tables are compared, padding
              included; NaN or infinities in one version and not the other
              fail, as do non-finite pair probabilities and a second launch
              that is not bit-identical;
  4. corpus   predict_batch on the bundled 8-pair corpus against the golden
              file made by the JAX package (tests/data/torch_port_golden.json);
  5. zscore   CopA x CopT against 1000 seeded decoys at chunk 256 (per-stage
              times, decoy pipelines/s, z/zs sanity band; the first 256
              decoys' energies, z and zs against the golden's seeded
              256-decoy run, and the first 64 against its 64-decoy run);
  6. duplex   the pure-duplex model (--duplex, K6 in place of the cofold):
              the corpus against tests/data/torch_port_golden_duplex.json,
              then CopA x CopT against 1000 seeded decoys at chunk 256
              (stage times, decoy pipelines/s; the first 256 and the first
              64 decoys against the golden's seeded 256- and 64-decoy runs);
  7. single   the single-pair exact path (pipeline/ractip.py::predict, B=1
              posteriors on the card, the MILP on the host), each run routed
              by the CLI's cli.run_pair, on every case of
              tests/data/torch_port_golden_single.json but the posterior
              matrices: the corpus with -e, with -c, with
              --force-constraint and with --duplex, the solver flags, --rip,
              -P, the sequential -c z-score, and --acc-max --acc-max-ss on
              strands cut to 32 and 64 bases; brackets identical,
              objective within 1e-4, energies within 1e-6 kcal/mol, z and zs
              within 1e-4, and the JAX package's exception and message
              where it raises;
  8. contrafold  the CONTRAfold model, checkpoint resume and the corpus
              F-measure, against tests/data/torch_port_golden_contrafold.json
              (tools/make_torch_contrafold_golden.py, JAX with x64): the CRF
              log Z (within 1e-9 relative), pu and the 64 largest pair
              probabilities (within 1e-8) of every corpus strand at full
              length on the card, with its seconds; the golden's
              --contrafold (8 pairs), --contrafold --duplex,
              --contraduplex and --min-w 1 (hybridizing) cases through
              cli.run_pair (brackets identical, objective within 1e-4
              plus 1e-4 alpha for each hybridization chosen from the
              float32 cofold's hp, energies within 1e-6; the duplex
              engine's 64 largest probabilities within 1e-8); the
              sequential --contrafold z-scores (z, zs within 1e-4); a
              64-decoy batched z-score at chunk 16 into a checkpoint
              directory (the LP cut to 300 iterations), run again
              after two chunk files are deleted (z, zs and every decoy energy
              equal, only those two chunks' cofolds run again, K4 launches
              equal to theirs) and with another chunk size (a fresh sweep);
              the pooled F-measure (evaluate_corpus) of the port's corpus
              brackets for the default model and for --contrafold, equal to
              that of the golden brackets;
  9. counts   each path's kernels launched, the other model's kernels not,
              and no plain version on a CUDA tensor.  The counts are set to
              0 just before each path (phases 4-5, phase 6, phase 7, phase 8)
              and read just after it; the kernels line reports the default
              and duplex paths' counts.
The line before the last is the card's name and power limit, the one
before it the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  A fuller record goes to
chiprun_out/chip_smoke.json.

Bounds: a kernel's bound_ms is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (FP32 without tensor cores; NVIDIA's H100 SXM data sheet, at a
700 W limit).  The operations are those of the recurrences' dominant terms
on this run's valid cells (windows clipped at the sequence ends), so the
bound is a lower one.  The bytes are those of each kernel's inputs and
outputs.  K1, K2, K4 and K5 take the lengths n and read the factors (and
K2, K5 their resident tables qm, qm1, and K5 qx) only inside each
instance's n x n region, K6 takes n1, n2 and reads the factors only inside
the n1 x n2 chain region, and K3 needs the rows i < n of qbe (past n q2
is 1 whatever qbe holds): their bytes count those regions and the outputs
whole (K1-K5 also record the whole-bucket bound beside it).  No single
PyTorch call computes any of these DPs, so library_ms is null.
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
GOLDEN_DUPLEX = ROOT / "tests" / "data" / "torch_port_golden_duplex.json"
GOLDEN_SINGLE = ROOT / "tests" / "data" / "torch_port_golden_single.json"
GOLDEN_CF = ROOT / "tests" / "data" / "torch_port_golden_contrafold.json"

FOLD_B, FOLD_L = 512, 96
CO_B, CO_L1, CO_L2, CO_CUT = 256, 96, 96, 70
TOL_STATE = 1e-4          # inside states / ob, relative, at L <= 192
TOL_PROB = 1e-5           # bpp / hp, absolute, at L <= 192
TOL_STATE_288 = 1e-3      # corpus shape (Lc = 288): measured 2.7e-4 (PERF.md)
TOL_PROB_288 = 1e-5       # measured 1.2e-7 (PERF.md)
FOLD_MID = (192, 256)     # fold buckets with qm in device memory, rings not
FOLD_LONG = (1000, 1024)  # fold at L = 1024: rings and qm in device memory
SMALL_SIGMA_DES = 500.0   # the small-sigma batch: es raised by this much
# K6, the JAX package's own Pallas-vs-jnp gates (tests/test_duplex_pallas.py)
TOL_DUPLEX_LOG = 5e-4     # unscaled log chain sums, absolute, same support
TOL_DUPLEX_PR = 2e-5      # pr, absolute
TOL_DUPLEX_LOGZ = (1e-5, 1e-4)   # log_zd, rtol and atol
DUPLEX_B, DUPLEX_L = 256, 96
Z_TPU, ZS_TPU, Z_BAND = -6.374, -2.845, 0.5
# the first chunk of the 1000-decoy run against the JAX golden's seeded
# 256-decoy run (one chunk): energies, and z / zs over those 256 decoys
GOLD_DECOYS, TOL_DECOY_E, TOL_Z = (256, 64), 1e-6, 1e-2
# the single-pair path against the JAX package's single-pair golden
TOL_OBJ, TOL_ENERGY, TOL_SINGLE_Z = 1e-4, 1e-6, 1e-4
# the CONTRAfold model (float64) against the JAX golden made with x64 on
TOL_CF_LOGZ, TOL_CF_PROB = 1e-9, 1e-8
# the objective sums alpha (hp - th_hy) over the chosen hybridizations, hp
# from the float32 cofold, which the port holds to the JAX package's within
# 1e-4 relative (tests/test_torch_cofold.py): each chosen pair adds that
# much to the objective's tolerance (0 of them in every default-option case)
TOL_HP_REL = 1e-4
# the checkpoint resume: a 64-decoy z-score of CopA x CopT at chunk 16; the
# LP's iterations cut to this many (the certify step keeps it exact)
CKPT_DECOYS, CKPT_CHUNK, CKPT_ITERS = 64, 16, 300
KERNELS = [  # name, source, TPU kernel it replaces, path whose launches count
    ("inside", "ractip_tpu_torch/csrc/inside.cu",
     "ractip_tpu/ops/scan_pallas.py:349", "default"),
    ("outside", "ractip_tpu_torch/csrc/outside.cu",
     "ractip_tpu/ops/scan_pallas.py:488", "default"),
    ("q2", "ractip_tpu_torch/csrc/q2.cu", "ractip_tpu/ops/scan_pallas.py:145",
     "default"),
    ("co_inside", "ractip_tpu_torch/csrc/inside.cu",
     "ractip_tpu/ops/cofold_pallas.py:215", "default"),
    ("co_outside", "ractip_tpu_torch/csrc/outside.cu",
     "ractip_tpu/ops/cofold_pallas.py:404", "default"),
    ("duplex_sweep", "ractip_tpu_torch/csrc/duplex.cu",
     "ractip_tpu/ops/duplex_pallas.py:165", "duplex"),
]
# the kernels each path runs; the other kernels must not launch there
PATHS = {"default": {"inside", "outside", "q2", "co_inside", "co_outside"},
         "duplex": {"inside", "outside", "q2", "duplex_sweep"},
         "single": {"inside", "outside", "q2", "co_inside", "co_outside",
                    "duplex_sweep"},
         "contrafold": {"inside", "outside", "q2", "co_inside", "co_outside",
                        "duplex_sweep"}}
PEAK_FLOPS = 67e12        # FP32 without tensor cores, H100 SXM
PEAK_BYTES = 3.35e12      # HBM3, H100 SXM
MAXLOOP = 30


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
        t0 = time.perf_counter()
        try:
            return fn(self, *a)
        except Exception as e:  # a phase that raises fails the run
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
            return None
        finally:
            say(f"   ({name}: {time.perf_counter() - t0:.1f} s)")


def diff(a, b, floor=0.0):
    """(max abs, max rel, non-finite count of a, of b) of a against b.

    NaN and the infinities must sit at the same positions in both: one
    position where they do not makes both differences infinite, so a NaN
    cannot hide inside a max().  The maxima are taken where both are finite;
    the relative one where b != 0, of the difference beyond `floor` (an
    absolute slack, as |a - b| <= rtol |b| + floor), and a nonzero a where
    b == 0 makes it infinite."""
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
    over = (d - floor).clamp(min=0)
    rel = (over[nz] / b.abs()[nz]).max().item() if bool(nz.any()) else 0.0
    if bool((a[~nz].abs() > 1e-30).any()):
        rel = inf
    return d.max().item(), rel, *counts


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes / 3.35 TB/s and operations
    / 67 TFLOP/s."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fold_ops(ns, contractions: int) -> float:
    """Operations of an inside or outside column scan (K1, K2, K4, K5) over
    instances of lengths ns: per cell (i, j) of span d = j - i >= 4 the
    generic interior loops that fit inside it (u1 + u2 <= min(30, d - 6)),
    the bulges of size >= 2 on either side, the seven shifted loop terms,
    and `contractions` dot products over the span (2 operations a term)."""
    import numpy as np
    total = 0.0
    for n in ns:
        d = np.arange(4, int(n))
        cells = int(n) - d
        s = np.clip(np.minimum(MAXLOOP, d - 6), 0, None)
        gen = s * (s - 1) // 2
        bul = 2 * np.clip(np.minimum(MAXLOOP, d - 5) - 1, 0, None)
        total += float(np.sum(cells * (2 * (gen + bul + 7)
                                       + 2 * contractions * d)))
    return total


def duplex_ops(n1s, n2s) -> float:
    """Operations of one direction of the duplex sweep (K6) over instances
    with chain regions n1 x n2: per cell the generic-loop terms whose window
    cell lies inside the region (row distance u1 + 1 <= t rows swept,
    column shift u2 + 1 inside n2), the bulges likewise, the seven shifted
    terms, and 8 more (mismatch, tau, start, the ring products, scaling)."""
    import numpy as np
    total = 0.0
    for n1, n2 in set(zip(map(int, n1s), map(int, n2s))):
        t = np.arange(n1)[:, None]
        room = n2 - 2 - np.arange(n2)[None, :]   # column shifts left
        gen = sum(np.clip(np.minimum(MAXLOOP - u1, room), 0, None)
                  * (t >= u1 + 1) for u1 in range(1, MAXLOOP))
        b1 = np.clip(np.minimum(MAXLOOP, t - 1) - 1, 0, None) * (room >= 0)
        b2 = (t >= 1) * np.clip(np.minimum(MAXLOOP, room) - 1, 0, None)
        cell = 2 * (gen + b1 + b2 + 7 * (t >= 1)) + 8
        count = sum(1 for a, b in zip(n1s, n2s) if (a, b) == (n1, n2))
        total += count * float(cell.sum())
    return total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() by CUDA events, after one warm-up call;
    each call's outputs are dropped before the next, so the allocator
    reuses their memory as the pipeline's calls do."""
    def calls():
        for _ in range(reps):
            fn()
    fn()
    return timed_once(calls)[1] / reps


def timed_once(fn):
    """(fn()'s result, its milliseconds by CUDA events): the plain versions,
    slow enough that one cold call is their time, are timed on the call
    that the comparison uses."""
    import torch
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


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
             "outside_kernelILb1": "co_outside", "q2_kernel": "q2",
             "duplex_sweep_kernel": "duplex_sweep"}
    for mangled, v in sorted(regs.items()):
        short = next((s for k, s in names.items() if k in mangled), mangled)
        # the scans' variants: <placement bits, threads a row>; K6's:
        # <lanes a column group, columns a group, rings in shared memory>
        m = re.search(r"_kernelILb[01]ELi(\d+)ELi(\d+)E", mangled)
        d = re.search(r"duplex_sweep_kernelILi(\d+)ELi(\d+)ELb([01])E",
                      mangled)
        var = (f"<smem {m.group(1)}, T {m.group(2)}>" if m else
               f"<G {d.group(1)}, J {d.group(2)}, ring smem {d.group(3)}>"
               if d else "")
        say(f"  ptxas {short}{var}: {v.get('regs')} registers, "
            f"{v.get('spill', 0)} bytes spilled")
    run.record["build"] = dict(seconds=secs, ptxas=regs)
    _cuda.lib()
    run.check("build", path.exists(), f"nvcc built {path.name} in "
              f"{secs:.1f} s")
    # blocks an SM of the variants launched at the main shapes (threads,
    # shared memory and registers together)
    occ = {}
    for label, B, L, co in (("fold", FOLD_B, FOLD_L, False),
                            ("cofold", CO_B, CO_L1 + CO_L2, True)):
        occ[label] = dict(B=B, L=L, **_cuda.occupancy(L, co, B))
        o = occ[label]
        say(f"  blocks an SM at {label} B={B} L={L}: inside {o['inside']} "
            f"(T {o['inside_T']}), outside {o['outside']} "
            f"(T {o['outside_T']})")
    run.record["build"]["blocks_per_sm"] = occ


def _shuffled_pairs(B):
    from ractip_tpu_torch.evaluate.corpus import record
    from ractip_tpu_torch.pipeline.shuffle import shuffle_batch
    a, b = record("CopA.fa").seq, record("CopT.fa").seq
    return list(zip(shuffle_batch(a, B, 11), shuffle_batch(b, B, 12)))


def _encode(pairs, L1, L2, dev):
    import numpy as np
    import torch
    from ractip_tpu_torch.ops.seq import encode
    S1 = torch.as_tensor(np.stack([encode(a, L1) for a, _ in pairs]),
                         device=dev).long()
    S2 = torch.as_tensor(np.stack([encode(b, L2) for _, b in pairs]),
                         device=dev).long()
    n1 = torch.tensor([len(a) for a, _ in pairs], device=dev)
    n2 = torch.tensor([len(b) for _, b in pairs], device=dev)
    return S1, S2, n1, n2


def _long_cofold_pairs():
    """Random pairs (seeded) past the kernels' shared-memory sizes: Lc = 512
    (one pair shorter than its buckets, one filling them) and Lc = 1024,
    where K4 and K5 keep their column rings in device memory."""
    import numpy as np
    rng = np.random.default_rng(13)
    rs = lambda k: "".join(rng.choice(list("ACGU"), k))
    return [([(rs(200), rs(270)), (rs(224), rs(288))], 224, 288),
            ([(rs(480), rs(500)), (rs(512), rs(512))], 512, 512)]


def phase_kernels(run: Run):
    import numpy as np
    import torch
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs, record
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.constraints import cofold_allow, fold_allow
    from ractip_tpu_torch.ops.factors import co_factors, fold_factors
    from ractip_tpu_torch.ops.seq import bucket_length, encode
    from ractip_tpu_torch.params.boltz import sig_tables
    from ractip_tpu_torch.params.tables import get_default_params

    dev = torch.device("cuda")
    tt = ts.as_tables(get_default_params(), dev)
    res = {}

    def rec(name, shape, kfn, pfn, tol_rel, tol_abs, probs=lambda o: [],
            ops=0.0, inputs=(), region_bytes=None, floor=0.0, note=None):
        """Hold the kernel call kfn() against its plain version pfn() on the
        same inputs, and a second kernel launch against the first (it must
        be bit-identical: a race would show here).  probs(outputs) gives the
        pair probabilities the outputs lead to; ops and the input tensors
        give the bound, or region_bytes(outputs) the bytes where the kernel
        reads only each instance's region (then the whole-bucket bound is
        kept beside it).  floor: the absolute slack of the comparison
        (diff); note: more to record and print.  Returns kfn()'s outputs."""
        tup = lambda o: o if isinstance(o, tuple) else (o,)
        outs_p, plain_ms = timed_once(pfn)
        outs_k, outs_p, again = tup(kfn()), tup(outs_p), tup(kfn())
        same = all(torch.equal(a, b) for a, b in zip(outs_k, again))
        worst_rel, worst_abs, nonfin = 0.0, 0.0, [0, 0]
        for a, b in zip(outs_k, outs_p):
            ab, rl, nk, np_ = diff(a, b, floor)
            worst_rel, worst_abs = max(worst_rel, rl), max(worst_abs, ab)
            nonfin = [nonfin[0] + nk, nonfin[1] + np_]
        pab, pnonfin = 0.0, 0
        for a, b in zip(probs(outs_k), probs(outs_p)):
            ab, _, nk, np_ = diff(a, b)
            pab, pnonfin = max(pab, ab), pnonfin + nk + np_
        ms = cuda_ms(kfn, 5)
        whole = nbytes(*inputs, *outs_k)
        nb = whole if region_bytes is None else region_bytes(outs_k)
        bms, by = bound(ops, nb)
        extra = {} if region_bytes is None else dict(
            bound_bucket_ms=bound(ops, whole)[0], bytes_bucket=whole)
        # the probabilities leave the DP for the LP: they must be finite
        ok = (worst_rel <= tol_rel and pab <= tol_abs and pnonfin == 0
              and same)
        note = note or {}
        run.check("kernels", ok, f"{name} {shape}: max rel {worst_rel:.3e} "
                  f"(tol {tol_rel:g}"
                  + (f", beyond {floor:g} absolute" if floor else "")
                  + f"), max abs {worst_abs:.3e}, non-finite "
                  f"kernel/plain {nonfin[0]}/{nonfin[1]}, probs max abs "
                  f"{pab:.3e} (tol {tol_abs:g}), probs non-finite {pnonfin},"
                  f" relaunch bit-identical {same}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})"
                  + "".join(f", {k} {v}" for k, v in note.items()))
        res.setdefault(name, []).append(dict(
            shape=shape, max_rel=worst_rel, max_abs=worst_abs,
            nonfinite_kernel=nonfin[0], nonfinite_plain=nonfin[1],
            prob_max_abs=pab, prob_nonfinite=pnonfin, relaunch_same=same,
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ops=ops,
            bytes=nb, floor=floor, **note, **extra))
        return outs_k

    # ---- fold: K1, K3, K2 at the main path's shape; K1, K2 at the corpus
    # shapes, at L = 192 and 256 (rings in shared memory, qm in device
    # memory; two and four threads a row), at L = 1024 and at a small sigma
    def q2_case(shape, qbe, sig, n32, tol_rel, tol_abs):
        """K3 against its plain version; its bytes count the rows i < n of
        qbe (q2 is 1 past n whatever qbe holds), the whole bucket beside."""
        ns, L = n32.tolist(), qbe.shape[-1]
        return rec("q2", shape, lambda: ts.q2(qbe, sig, n32),
                   lambda: ts.q2_plain(qbe, sig, n32), tol_rel, tol_abs,
                   ops=float(sum(2 * m * L for m in ns)),
                   inputs=(qbe, sig, n32),
                   region_bytes=lambda o: 4 * L * sum(ns) + nbytes(
                       sig, n32, *o))[0]

    def fold_case(seqs, L, tol_rel, tol_abs, des=0.0, label=None,
                  allow=None, mask=None):
        """allow: a -c pair mask [B, L, L] (numpy), named mask."""
        S = torch.as_tensor(np.stack([encode(x, L) for x in seqs]),
                            device=dev).long()
        n = torch.tensor([len(x) for x in seqs], device=dev)
        if allow is not None:
            allow = torch.as_tensor(allow, device=dev)
        # the per-instance scale energies the pipeline's adaptive loop picks
        es = ts.batch_fold(tt, S, n, dev, allow=allow)["es"] + des
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = fold_factors(tt, S, n, sig, allow)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows)
        shape = [len(seqs), L] + [x for x in (label, mask) if x]
        ns = n.tolist()
        cells = 4 * sum(m * m for m in ns)    # one float per cell of n x n
        # the bytes K1 and K2 must move: the factors (and K2's resident
        # tables qm, qm1) inside each instance's n x n region, the rest whole
        small = (w2k, bulge_k, sig, pows, n)
        occ = _cuda.occupancy(L, False, len(seqs))
        qm1_c, qb_c, qm_c, _, q1 = rec(
            "inside", shape, lambda: ts.inside(*args, n=n),
            lambda: ts.inside_plain(*args), tol_rel, tol_abs,
            ops=fold_ops(ns, 2), inputs=args + (n,),
            region_bytes=lambda o: F.shape[0] * cells + nbytes(*small, *o),
            note=dict(threads_a_row=occ["inside_T"]))
        if label:
            pad = torch.arange(L, device=dev)[None, :, None] >= n[:, None,
                                                                 None]
            sub = int(((qm_c > 0) & (qm_c < torch.finfo(torch.float32).tiny)
                       & pad).sum())
            run.check("kernels", sub > 0, f"inside {shape}: {sub} subnormal "
                      "qm cells in the padding (the fill's fallback ran)")
        qb = qb_c.transpose(1, 2)
        qbe = (qb * ff.fe).contiguous()
        n32 = n.to(torch.int32)
        q2v = q2_case(shape, qbe, sig, n32, tol_rel, tol_abs)
        zn = q1.gather(1, (n - 1)[:, None])[:, 0]
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        qmN = qm_c.transpose(1, 2).contiguous()
        oargs = (F, qmN, qm1_c, q1pad, q2v, w2k, bulge_k, sig, pows)
        # the small-sigma batch: its ob reaches deep subnormals in the swept
        # region (to 7e-45), where the order of a sum moves a cell by more
        # than any relative gate; it is held as the GPU tests hold every
        # table, to the gate beyond 1e-30 absolute.  Its zn underflows, so
        # it has no pair probabilities (the pipeline's adaptive es keeps zn
        # a normal float)
        rec("outside", shape, lambda: ts.outside(*oargs, n=n),
            lambda: ts.outside_plain(*oargs), tol_rel, tol_abs,
            (lambda o: []) if label else
            (lambda o: [ts.pair_probs(qb, o[0].transpose(1, 2), zn)]),
            ops=fold_ops(ns, 2), inputs=oargs + (n,),
            region_bytes=lambda o: (F.shape[0] + 2) * cells + nbytes(
                q1pad, q2v, *small, *o),
            floor=1e-30 if label else 0.0,
            note=dict(threads_a_row=occ["outside_T"]))

    main = [x for pair in zip(*_shuffled_pairs(FOLD_B // 2)) for x in pair]
    fold_case(main, FOLD_L, TOL_STATE, TOL_PROB)
    corpus = [(fa1.seq, fa2.seq) for _, fa1, fa2 in corpus_pairs()]
    L1 = max(bucket_length(len(a)) for a, _ in corpus)
    L2 = max(bucket_length(len(b)) for _, b in corpus)
    fold_case([a for a, _ in corpus], L1, TOL_STATE, TOL_PROB)
    fold_case([b for _, b in corpus], L2, TOL_STATE, TOL_PROB)
    rng = np.random.default_rng(17)
    acgu = list("ACGU")
    fold_case(["".join(rng.choice(acgu, k)) for k in FOLD_LONG],
              max(FOLD_LONG), TOL_STATE_288, TOL_PROB_288)
    # the wave choice gives K1 two threads a row at B = 512, four at B = 8
    rng = np.random.default_rng(19)
    for L in FOLD_MID:
        for B in (FOLD_B, 8):
            fold_case(["".join(rng.choice(acgu, k))
                       for k in rng.integers(L - 40, L + 1, B)], L,
                      *((TOL_STATE, TOL_PROB) if L <= 192
                        else (TOL_STATE_288, TOL_PROB_288)))
    # a small sigma: the padding's qm leaves the normal floats, so K1 fills
    # it by the plain version's scan and contraction
    fold_case(main[:8], FOLD_L, TOL_STATE, TOL_PROB, des=SMALL_SIGMA_DES,
              label=f"es+{SMALL_SIGMA_DES:g}")
    # K3 on arbitrary qbe: full random matrices with n < L, so the lower
    # triangle and the padding are nonzero (a small scale, one that
    # saturates at the clamp, and L = 2048, where not even one tile of rows
    # fits shared memory and K3 reads them from device memory)
    rng = np.random.default_rng(23)
    for B, L, scale in ((8, FOLD_L, 0.03), (8, FOLD_L, 1.0), (2, 2048, 0.03)):
        qbe = torch.as_tensor(rng.random((B, L, L)) * scale,
                              dtype=torch.float32, device=dev)
        q2_case([B, L, f"random x {scale:g}"], qbe,
                torch.as_tensor(rng.uniform(0.5, 1.5, B), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(rng.integers(L // 2, L, B), dtype=torch.int32,
                                device=dev),
                *((TOL_STATE, TOL_PROB) if L <= 192
                  else (TOL_STATE_288, TOL_PROB_288)))

    # ---- cofold: K4, K5 at the main path's shape, the cut at both edges,
    # the corpus shape and two long shapes (past the shared-memory sizes)
    def cofold_case(pairs, L1, L2, tol_rel, tol_abs, allow=None, mask=None):
        """allow: a -c pair mask [B, Lc, Lc] (numpy), named mask."""
        S1, S2, n1, n2 = _encode(pairs, L1, L2, dev)
        B = S1.shape[0]
        S = tc._pack_concat(S1, S2, n1)
        n, cut = n1 + n2, n1
        if allow is not None:
            allow = torch.as_tensor(allow, device=dev)
        es = tc.batch_cofold(tt, S1, S2, n1, n2, dev, allow=allow)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = co_factors(tt, S, n, cut, sig, allow)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows, cut)
        shape = [B, L1 + L2] + ([mask] if mask else [])
        ns = n.tolist()
        cells = 4 * sum(m * m for m in ns)    # one float per cell of n x n
        # the bytes K4 and K5 must move: the factors (and K5's resident
        # tables) inside each instance's n x n region, the rest whole
        small = (w2k, bulge_k, sig, pows, cut, n)
        qm1_c, qb_c, qm_c, qx_c, q1 = rec(
            "co_inside", shape, lambda: tc.co_inside(*args, n=n),
            lambda: ts.inside_plain(*args), tol_rel, tol_abs,
            ops=fold_ops(ns, 2), inputs=args + (n,),
            region_bytes=lambda o: F.shape[0] * cells + nbytes(*small, *o))
        qb = qb_c.transpose(1, 2)
        zn = q1.gather(1, (n - 1)[:, None])[:, 0]
        q2v = q2_case(shape, (qb * ff.fe).contiguous(), sig,
                      n.to(torch.int32), tol_rel, tol_abs)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        qx = qx_c.transpose(1, 2).contiguous()
        qxA, qBpref = tc.exterior_vectors(qx, cut)
        oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, qx, qxA,
                 qBpref, q1pad, q2v, w2k, bulge_k, sig, pows, cut)
        rec("co_outside", shape, lambda: tc.co_outside(*oargs, n=n),
            lambda: tc.co_outside_plain(*oargs), tol_rel, tol_abs,
            lambda o: [tc.cross_block(ts.pair_probs(qb, o[0].transpose(1, 2),
                                                    zn), n1, n2, L1, L2)],
            ops=fold_ops(ns, 3), inputs=oargs + (n,),
            region_bytes=lambda o: (F.shape[0] + 3) * cells + nbytes(
                qxA, qBpref, q1pad, q2v, *small, *o))

    cofold_case([(a[:CO_CUT], b) for a, b in _shuffled_pairs(CO_B)],
                CO_L1, CO_L2, TOL_STATE, TOL_PROB)
    # cut = 1 and cut = n - 1 (a one-nucleotide strand on either side)
    a, b = _shuffled_pairs(1)[0]
    cofold_case([(a[:1], b), (a[:CO_CUT], b[:1]), (a[:1], b[:1]),
                 (a[:CO_CUT], b)], CO_L1, CO_L2, TOL_STATE, TOL_PROB)
    cofold_case(corpus, L1, L2, TOL_STATE_288, TOL_PROB_288)
    for pairs, LL1, LL2 in _long_cofold_pairs():
        cofold_case(pairs, LL1, LL2, TOL_STATE_288, TOL_PROB_288)

    # ---- the single-pair path's inputs: B = 1, -c masks in the factors
    # (CopA x CopT with the golden's constraint strings, and CopA banned
    # whole: every factor 0, the open chain alone)
    a, b = record("CopA.fa").seq, record("CopT.fa").seq
    c1, c2 = json.loads(GOLDEN_SINGLE.read_text())["constraints"]["CopA-CopT"]
    La, Lb = bucket_length(len(a)), bucket_length(len(b))
    for s, c, L in ((a, c1, La), (b, c2, Lb), (a, "x" * len(a), La)):
        fold_case([s], L, TOL_STATE, TOL_PROB,
                  allow=fold_allow(c, len(s), L)[None],
                  mask="-c banned" if set(c) == {"x"} else "-c")
    for cc1 in (c1, "x" * len(a)):
        cofold_case([(a, b)], La, Lb, TOL_STATE, TOL_PROB,
                    allow=cofold_allow(cc1, c2, len(a), len(b),
                                       La + Lb)[None],
                    mask="-c banned" if set(cc1) == {"x"} else "-c")

    # ---- duplex sweeps (K6): the main path, the corpus, a long target
    # (the launcher's picks), then every variant at the corpus shape
    duplex_case(run, res, tt, _shuffled_pairs(DUPLEX_B), DUPLEX_L, DUPLEX_L)
    duplex_case(run, res, tt, corpus, L1, L2)
    rng = np.random.default_rng(7)
    long = [("".join(rng.choice(acgu, 40)), "".join(rng.choice(acgu, 1990))),
            ("".join(rng.choice(acgu, 64)), "".join(rng.choice(acgu, 2048)))]
    duplex_case(run, res, tt, long, 64, 2048)
    duplex_case(run, res, tt, corpus, L1, L2, _cuda.DUPLEX_VARIANTS)
    # the single-pair path's --duplex: one pair a launch
    duplex_case(run, res, tt, _shuffled_pairs(1), DUPLEX_L, DUPLEX_L)
    run.record["kernels"] = res
    torch.cuda.synchronize()


def duplex_case(run: Run, res: dict, tt, pairs, L1, L2, variants=(None,)):
    """K6 at one shape: both directions in one launch against the plain
    sweeps, in the log domain (log M + lsc; -inf where M = 0, which must be
    the same cells), a relaunch bit-identical to the first launch, then the
    posteriors of both against each other.  Each of variants = (lanes,
    rings in shared memory, columns a group) names a kernel variant, None
    the launcher's pick; the plain sweeps run once for all of them."""
    import torch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import duplex as td
    dev = tt.device
    S1, S2, n1, n2 = _encode(pairs, L1, L2, dev)
    B = S1.shape[0]
    ffw = td.duplex_factors_fw(tt, S1, S2, n1, n2)
    fbk = td.duplex_factors_bk(tt, S1, S2, n1, n2)
    kin = td._sweep_inputs(tt, ffw, fbk, n1, n2)
    pfn = lambda: (td.sweep_plain(ffw, tt, False), td.sweep_plain(fbk, tt,
                                                                   True))
    ((Mf, lf), (Mb, lb)), plain_ms = timed_once(pfn)
    Mp, lp = torch.stack([Mf, Mb]), torch.stack([lf, lb])
    pp = td.posteriors(Mf, lf, Mb, lb, ffw.close)
    ops = 2 * duplex_ops(n1.tolist(), n2.tolist())
    lg = lambda M, l: M.double().log() + l.double()[..., None]
    for variant in variants:
        kfn = lambda: _cuda.launch_duplex_sweep(*kin, variant)
        var = _cuda.duplex_variant(L2, B, variant)
        Mk, lk = kfn()
        Mk2, lk2 = kfn()
        same = torch.equal(Mk, Mk2) and torch.equal(lk, lk2)
        dab, _, nk, np_ = diff(lg(Mk, lk), lg(Mp, lp))
        nonneg = bool((Mk >= 0).all()) and bool((Mp >= 0).all())
        pk = td.posteriors(Mk[0], lk[0], Mk[1], lk[1], ffw.close)
        prab, _, prk, prp = diff(pk.pr, pp.pr)
        zab, _, zk, zp = diff(pk.log_zd, pp.log_zd)
        z_ok = zab <= TOL_DUPLEX_LOGZ[1] + TOL_DUPLEX_LOGZ[0] * float(
            pp.log_zd.abs().max())
        ms = cuda_ms(kfn, 5)
        # the factors inside the chain regions (the kernel reads nothing
        # past them), the other inputs and the outputs whole
        nb = (2 * 11 * 4 * int((n1 * n2).sum()) + nbytes(*kin[1:], Mk, lk))
        bms, by = bound(ops, nb)
        ok = (dab <= TOL_DUPLEX_LOG and nonneg and same
              and prab <= TOL_DUPLEX_PR and prk + prp + zk + zp == 0
              and z_ok)
        shape = [B, L1, L2] + ([] if variant is None else ["forced"])
        run.check("kernels", ok, f"duplex_sweep {shape}: log-domain max abs "
                  f"{dab:.3e} (tol {TOL_DUPLEX_LOG:g}), zero cells "
                  f"kernel/plain {nk}/{np_}, pr max abs {prab:.3e} (tol "
                  f"{TOL_DUPLEX_PR:g}), log_zd max abs {zab:.3e} (rtol "
                  f"{TOL_DUPLEX_LOGZ[0]:g}, atol {TOL_DUPLEX_LOGZ[1]:g}), "
                  f"non-finite pr/log_zd {prk + prp}/{zk + zp}, relaunch "
                  f"bit-identical {same}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}); lanes "
                  f"{var['lanes']}, columns {var['columns']}, rings in "
                  f"{'shared' if var['ring_in_shared'] else 'device'} "
                  f"memory, {var['blocks_per_sm']} blocks an SM")
        res.setdefault("duplex_sweep", []).append(dict(
            shape=shape, max_abs=dab, zero_cells_kernel=nk,
            zero_cells_plain=np_, pr_max_abs=prab, log_zd_max_abs=zab,
            relaunch_same=same, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, ops=ops, bytes=nb, **var))


def _options(model: str, **kw):
    from ractip_tpu_torch.pipeline.options import Options
    return Options(use_pf_duplex=model == "duplex", **kw)


def phase_corpus(run: Run, timer_cls, model: str, golden: Path):
    import numpy as np
    import torch
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.batched import predict_batch
    gold = json.loads(golden.read_text())["corpus"]["pairs"]
    recs = list(corpus_pairs())
    pairs = [(fa1.seq, fa2.seq) for _, fa1, fa2 in recs]
    timer = timer_cls("cuda")
    t0 = time.perf_counter()
    res = predict_batch(get_default_params(), pairs, _options(model),
                        timer=timer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"  {model} corpus wall {wall:.2f} s, stages "
        f"{json.dumps(timer.report())}")
    tag = f"{model} corpus"
    rows = []
    for (name, _, _), r1, r2, obj in zip(recs, res.r1, res.r2, res.objective):
        g = next(x for x in gold if x["name"] == name)
        same = (r1, r2) == (g["r1"], g["r2"])
        dobj = abs(float(obj) - g["objective"])
        if same:
            run.check(tag, dobj <= 1e-4, f"{name}: brackets identical, "
                      f"objective {obj:.6f} (golden {g['objective']:.6f})")
        else:
            run.check(tag, dobj <= 1e-4, f"{name}: brackets differ, "
                      f"objective {obj:.6f} vs golden {g['objective']:.6f} "
                      f"(|d|={dobj:.2e}): alternative optimum")
            say(f"    port   {r1} / {r2}\n    golden {g['r1']} / {g['r2']}")
        rows.append(dict(name=name, same=same, objective=float(obj),
                         golden=g["objective"], r1=r1, r2=r2))
    run.check(tag, float(np.max(res.violation)) < 0.5,
              "all decoded structures feasible")
    run.record[tag] = dict(wall=wall, stages=timer.report(), pairs=rows)


def _zstat(x0, xs) -> float:
    """(x0 - mean) / sd over the decoys, as zscore_batch computes it."""
    import numpy as np
    m, v = float(np.mean(xs)), float(np.var(xs))
    return (x0 - m) / np.sqrt(v) if v > 0 else float("inf")


def _zscore_full(run: Run, timer_cls, model: str, band: bool, golds):
    """CopA x CopT against 1000 seeded decoys at chunk 256; its first n
    decoys against the golden's seeded n-decoy run, for each of golds."""
    import numpy as np
    import torch
    from ractip_tpu_torch.evaluate.corpus import record
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.batched import zscore_batch
    tag = f"{model} zscore"
    before = dict(_cuda.LAUNCHES)
    timer = timer_cls("cuda")
    t0 = time.perf_counter()
    z, zs, st = zscore_batch(record("CopA.fa"), record("CopT.fa"),
                             _options(model, zscore=12, num_shuffling=1000,
                                      seed=1), get_default_params(),
                             chunk=256, timer=timer, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = timer.report()
    launches = {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()
                if v > before.get(k, 0)}
    say(f"  {model}, 1000 decoys: z={z:.4f} zs={zs:.4f} e={st['e']:.2f} "
        f"es={st['es']:.2f}; wall {wall:.2f} s, "
        f"{1000 / wall:.2f} decoy pipelines/s")
    say(f"  stages (s): {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    say(f"  kernel launches in this z-score: {json.dumps(launches)}")
    # the first n seeded decoys are those of an n-decoy run (the seeded
    # shuffles of a longer run begin with those of a shorter one, and the
    # first chunk holds them): held to the JAX golden's n-decoy run
    parity = {}
    for gold in golds:
        n = gold["num_shuffling"]
        zn = _zstat(st["e"], st["decoy_e"][:n])
        zsn = _zstat(st["es"], st["decoy_es"][:n])
        same = int(np.sum(np.abs(np.asarray(st["decoy_e"][:n])
                                 - np.asarray(gold["decoy_e"])) < TOL_DECOY_E))
        run.check(tag, same == n and abs(zn - gold["z"]) <= TOL_Z
                  and abs(zsn - gold["zs"]) <= TOL_Z,
                  f"first {n} decoys against the JAX golden's seeded "
                  f"{n}-decoy run: {same}/{n} decoy energies identical "
                  f"(within {TOL_DECOY_E:g}), z {zn:.4f} vs "
                  f"{gold['z']:.4f}, zs {zsn:.4f} vs {gold['zs']:.4f} (tol "
                  f"{TOL_Z:g})")
        parity.update({f"z{n}": zn, f"zs{n}": zsn, f"same{n}": same})
    if band:
        run.check(tag, abs(z - Z_TPU) <= Z_BAND and abs(zs - ZS_TPU) <= Z_BAND,
                  f"z {z:.3f} within {Z_BAND} of {Z_TPU} and zs {zs:.3f} "
                  f"within {Z_BAND} of {ZS_TPU} (unseeded TPU run: sanity "
                  "band)")
    run.check(tag, bool(np.isfinite(z) and np.isfinite(zs)),
              f"z {z:.4f} and zs {zs:.4f} finite")
    run.check(tag, float(np.max(st["violation"])) < 0.5,
              "all decoy structures feasible")
    return dict(z=z, zs=zs, e=st["e"], es=st["es"], wall=wall,
                rate=1000 / wall, stages=stages, launches=launches, **parity)


def phase_zscore(run: Run, timer_cls, model: str):
    from ractip_tpu_torch import native
    nat = native.available()
    run.check(f"{model} zscore", nat, f"native uShuffle available: {nat}")
    # no TPU run of the duplex z-score exists: its parity is the golden's
    golds = [golden_zscore(model, n) for n in GOLD_DECOYS]
    assert all(g["seed"] == 1 for g in golds)
    run.record[f"{model} zscore"] = _zscore_full(
        run, timer_cls, model, band=model == "default", golds=golds)


def golden_zscore(model: str, decoys: int) -> dict:
    """The JAX golden's seeded z-score with this many decoys: the default
    model's file keys them "zscore" (64) and "zscore_<n>", the duplex
    model's "zscore" -> "<n>"."""
    if model == "duplex":
        return json.loads(GOLDEN_DUPLEX.read_text())["zscore"][str(decoys)]
    gold = json.loads(GOLDEN.read_text())
    return gold["zscore" if decoys == 64 else f"zscore_{decoys}"]


def _single_case(e: dict):
    """One golden entry through the port's CLI routing (cli.run_pair) on
    the card: (r1, r2, objective, energies or None, zscore or None)."""
    from ractip_tpu_torch import cli
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs
    from ractip_tpu_torch.io.fasta import Fasta
    fa1, fa2 = next((a, b) for name, a, b in corpus_pairs()
                    if name == e["pair"])
    cut, cstr = e.get("cut"), e["cstr"] or ("", "")
    fa1 = Fasta(fa1.name, fa1.seq[:cut], cstr[0])
    fa2 = Fasta(fa2.name, fa2.seq[:cut], cstr[1])
    flags = [str(ROOT / f) if f in (e["par"], e["rip"]) else f
             for f in e["flags"]]
    args = cli.build_parser().parse_args(["a", "b"] + flags)
    r1, r2, obj, ee, z = cli.run_pair(args, fa1, fa2)
    en = None if ee is None else [ee[k] for k in
                                  ("e1", "e2", "e3", "e1s", "e2s")]
    return r1, r2, obj, en, z


def phase_single(run: Run):
    """The single-pair exact path on the golden's cases a-h and j."""
    import numpy as np
    gold = json.loads(GOLDEN_SINGLE.read_text())["cases"]
    secs, rows = {}, []
    for case in "abcdefghj":
        t0 = time.perf_counter()
        for e in gold[case]:
            tag = f"{case} {e['pair']} {' '.join(e['flags'])}"
            try:
                got, err = _single_case(e), None
            except Exception as ex:   # held to the JAX package's exception
                got, err = None, [type(ex).__name__, str(ex)]
            if e.get("error") or err:
                want = e.get("error") and [e["error"], e["message"]]
                run.check("single", err == want,
                          f"{tag}: raises {err} (JAX package: {want})")
                rows.append(dict(case=case, pair=e["pair"], error=err))
                continue
            r1, r2, obj, en, zs = got
            same = (r1, r2) == (e["r1"], e["r2"])
            dobj = abs(obj - e["objective"])
            de = (0.0 if e["energies"] is None else
                  float(np.max(np.abs(np.subtract(en, e["energies"])))))
            dz = (0.0 if "zscore" not in e else
                  float(np.max(np.abs(np.subtract(zs, e["zscore"])))))
            run.check("single", same and dobj <= TOL_OBJ
                      and de <= TOL_ENERGY and dz <= TOL_SINGLE_Z,
                      f"{tag}: brackets {'identical' if same else 'DIFFER'}"
                      f", objective |d| {dobj:.2e} (tol {TOL_OBJ:g}), "
                      f"energies max |d| {de:.2e} (tol {TOL_ENERGY:g})"
                      + (f", z/zs max |d| {dz:.2e} (tol {TOL_SINGLE_Z:g})"
                         if "zscore" in e else ""))
            if not same:
                say(f"    port   {r1} / {r2}\n    golden {e['r1']} / "
                    f"{e['r2']}")
            rows.append(dict(case=case, pair=e["pair"], same=same,
                             dobj=dobj, de=de, dz=dz))
        secs[case] = time.perf_counter() - t0
        say(f"  case {case}: {len(gold[case])} runs, {secs[case]:.2f} s")
    run.record["single"] = dict(seconds=secs, cases=rows)


def _top_diff(m, top) -> float:
    """Max |port - golden| at the golden's largest entries [[i, j, p]]."""
    import numpy as np
    m = np.asarray(m)
    return float(max(abs(m[i, j] - p) for i, j, p in top))


def _cf_args(flags):
    from ractip_tpu_torch import cli
    return cli.build_parser().parse_args(["a", "b"] + flags)


def _cf_crf(run: Run, gold: dict, pairs: dict) -> dict:
    """The CRF of every corpus strand at full length on the card: log Z,
    pu and the 64 largest pair probabilities against the golden; the
    seconds of the forward pass alone and of forward and backward."""
    import torch
    from ractip_tpu_torch.ops.contrafold import (cf_base_pair_probs,
                                                 cf_logz, cf_unpaired_probs)
    from ractip_tpu_torch.ops.seq import encode
    secs = {}
    for e in gold["corpus"]:
        if e["flags"] != ["--contrafold", "-e"]:
            continue
        for k, (g, fa) in enumerate(zip(e["strands"], pairs[e["pair"]])):
            S, n = encode(fa.seq, g["L"]), len(fa.seq)
            tag = f"{e['pair']} strand {k + 1}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = float(cf_logz(S, n, device="cuda"))
            t1 = time.perf_counter()
            bpp = cf_base_pair_probs(S, n, device="cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pu = cf_unpaired_probs(bpp).cpu().numpy()
            dz = abs(z - g["logz"]) / abs(g["logz"])
            dp = max(_top_diff(bpp.cpu().numpy(), g["bpp_top"]),
                     float(abs(pu - g["pu"]).max()))
            run.check("contrafold", dz <= TOL_CF_LOGZ and dp <= TOL_CF_PROB,
                      f"CRF {tag} n={n} L={g['L']}: log Z rel "
                      f"{dz:.1e} (tol {TOL_CF_LOGZ:g}), pu and top-64 pair "
                      f"probabilities max |d| {dp:.1e} (tol {TOL_CF_PROB:g})"
                      f"; {t1 - t0:.3f} s forward, {t2 - t1:.3f} s forward"
                      f" and backward")
            secs[tag] = dict(n=n, L=g["L"], forward=t1 - t0,
                             posteriors=t2 - t1)
    return secs


def _cf_cases(run: Run, gold: dict, pairs: dict) -> tuple[dict, list]:
    """The golden's --contrafold, --contrafold --duplex and --contraduplex
    cases through cli.run_pair; the seconds of each run's posteriors (CRF
    and hybridization) and of the whole run.  Returns the --contrafold
    brackets by pair and the rows."""
    import numpy as np
    import torch
    from ractip_tpu_torch import cli
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.ractip import Posteriors
    brackets, rows = {}, []
    for e in gold["corpus"]:
        fa1, fa2 = pairs[e["pair"]]
        tag = f"{e['pair']} {' '.join(e['flags'])}"
        args = _cf_args(e["flags"])
        acc = cli.options_from_args(args).solver_cfg().accessibility
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = Posteriors(get_default_params(), fa1.seq, fa2.seq, args.max_w,
                          acc, use_pf_duplex=args.duplex,
                          use_contrafold=args.contrafold,
                          use_contraduplex=args.contraduplex, device="cuda")
        t1 = time.perf_counter()
        r1, r2, obj, ee, _ = cli.run_pair(args, fa1, fa2)
        t2 = time.perf_counter()
        en = [ee[k] for k in ("e1", "e2", "e3", "e1s", "e2s")]
        same = (r1, r2) == (e["r1"], e["r2"])
        dobj = abs(obj - e["objective"])
        de = float(np.max(np.abs(np.subtract(en, e["energies"]))))
        dh = (_top_diff(post.hp, e["hp_top"]) if args.contraduplex
              else 0.0)
        tol = TOL_OBJ + (0.0 if args.contraduplex else
                         args.alpha * TOL_HP_REL * e["r1"].count("["))
        run.check("contrafold", same and dobj <= tol
                  and de <= TOL_ENERGY and dh <= TOL_CF_PROB,
                  f"{tag}: brackets {'identical' if same else 'DIFFER'}, "
                  f"objective |d| {dobj:.2e} (tol {tol:g}), energies "
                  f"max |d| {de:.2e} (tol {TOL_ENERGY:g})"
                  + (f", duplex engine top-64 |d| {dh:.1e} (tol "
                     f"{TOL_CF_PROB:g})" if args.contraduplex else "")
                  + f"; posteriors {t1 - t0:.3f} s, run {t2 - t1:.3f} s")
        if not same:
            say(f"    port   {r1} / {r2}\n    golden {e['r1']} / {e['r2']}")
        if e["flags"] == ["--contrafold", "-e"]:
            brackets[e["pair"]] = (r1, r2)
        rows.append(dict(pair=e["pair"], flags=e["flags"], same=same,
                         dobj=dobj, de=de, dh=dh, posteriors=t1 - t0,
                         run=t2 - t1))
    for e in gold["zscores"]:
        t0 = time.perf_counter()
        r1, r2, obj, ee, zs = cli.run_pair(_cf_args(e["flags"]),
                                           *pairs[e["pair"]])
        # zs is infinite where no decoy hybridizes (its variance is 0)
        dz = max(0.0 if a == b else abs(a - b)
                 for a, b in zip(zs, e["zscore"]))
        run.check("contrafold", (r1, r2) == (e["r1"], e["r2"])
                  and dz <= TOL_SINGLE_Z,
                  f"{e['pair']} {' '.join(e['flags'])}: z {zs[0]:.6f} zs "
                  f"{zs[1]:.6f} (golden {e['zscore'][0]:.6f} "
                  f"{e['zscore'][1]:.6f}, tol {TOL_SINGLE_Z:g}); "
                  f"{time.perf_counter() - t0:.2f} s")
    return brackets, rows


class _CofoldCounts:
    """A stage timer that records the K4 launches of each "cofold" stage:
    one entry per chunk of predict_batch that ran."""

    def __init__(self):
        self.k4: list[int] = []

    def __call__(self, name):
        import contextlib
        from ractip_tpu_torch.ops import _cuda

        @contextlib.contextmanager
        def cm():
            before = _cuda.LAUNCHES["co_inside"]
            yield self
            if name == "cofold":
                self.k4.append(_cuda.LAUNCHES["co_inside"] - before)
        return cm()


def _cf_resume(run: Run) -> dict:
    """A 64-decoy batched z-score at chunk 16 into a checkpoint directory;
    again after two chunk files are deleted; again at another chunk size."""
    import shutil
    import numpy as np
    from ractip_tpu_torch.evaluate.corpus import record
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.batched import zscore_batch
    from ractip_tpu_torch.pipeline.options import Options
    d = OUT / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    fa1, fa2 = record("CopA.fa"), record("CopT.fa")
    opts = Options(zscore=12, num_shuffling=CKPT_DECOYS, seed=1)

    def sweep(chunk):
        counts = _CofoldCounts()
        t0 = time.perf_counter()
        z, zs, st = zscore_batch(fa1, fa2, opts, get_default_params(),
                                 chunk=chunk, iters=CKPT_ITERS,
                                 ckpt_dir=str(d), timer=counts,
                                 device="cuda")
        fp = json.loads((d / "MANIFEST.json").read_text())["fingerprint"]
        return z, zs, st, counts.k4, fp, time.perf_counter() - t0

    z0, zs0, st0, k0, fp0, s0 = sweep(CKPT_CHUNK)
    n = CKPT_DECOYS // CKPT_CHUNK
    files = sorted(p.name for p in d.glob("chunk_*.npz"))
    kept = {i: (d / f"chunk_{i:06d}.npz").stat().st_mtime_ns
            for i in (0, 2)}
    for i in (1, 3):
        (d / f"chunk_{i:06d}.npz").unlink()
    z1, zs1, st1, k1, fp1, s1 = sweep(CKPT_CHUNK)
    same = (z1 == z0 and zs1 == zs0
            and np.array_equal(st1["decoy_e"], st0["decoy_e"])
            and np.array_equal(st1["decoy_es"], st0["decoy_es"])
            and st1["decoy_r1"] == st0["decoy_r1"]
            and st1["decoy_r2"] == st0["decoy_r2"])
    untouched = all((d / f"chunk_{i:06d}.npz").stat().st_mtime_ns == t
                    for i, t in kept.items())
    run.check("contrafold", len(files) == n and len(k0) == n + 1
              and same and fp1 == fp0 and untouched
              and k1 == [k0[0], k0[2], k0[4]],
              f"checkpoint resume: {len(files)} chunk files of {n}; after "
              f"chunks 1 and 3 were deleted, z {z1:.6f} zs {zs1:.6f} (the "
              f"uninterrupted run's {z0:.6f} {zs0:.6f}; every decoy energy "
              f"and bracket equal: {same}), cofold runs with K4 launches "
              f"{k1} (the real pair's and chunks 1 and 3's of {k0}), chunks"
              f" 0 and 2 untouched: {untouched}; {s0:.2f} s, {s1:.2f} s")
    z2, zs2, _, k2, fp2, s2 = sweep(2 * CKPT_CHUNK)
    run.check("contrafold", fp2 != fp0 and len(k2) == n // 2 + 1,
              f"chunk {2 * CKPT_CHUNK}: a fresh sweep (fingerprint {fp2} "
              f"for {fp0}, {len(k2) - 1} chunks ran of {n // 2}), z {z2:.6f}"
              f" zs {zs2:.6f}; {s2:.2f} s")
    shutil.rmtree(d, ignore_errors=True)
    return dict(z=z0, zs=zs0, k4=[k0, k1, k2], seconds=[s0, s1, s2])


def _cf_fmeasure(run: Run, brackets: dict) -> dict:
    """Pooled F-measure of the port's corpus brackets, default model and
    --contrafold, against that of the golden brackets."""
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs, evaluate_corpus
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline.batched import predict_batch
    names = {(a.seq, b.seq): name for name, a, b in corpus_pairs()}
    default = run.record.get("default corpus", {}).get("pairs")
    if default:
        port = {p["name"]: (p["r1"], p["r2"]) for p in default}
    else:   # phase 4 did not run: the corpus batch here
        res = predict_batch(get_default_params(), list(names), device="cuda")
        port = {names[k]: (a, b) for k, a, b in zip(names, res.r1, res.r2)}
    gold_default = {p["name"]: (p["r1"], p["r2"]) for p in
                    json.loads(GOLDEN.read_text())["corpus"]["pairs"]}
    gold_cf = {e["pair"]: (e["r1"], e["r2"]) for e in
               json.loads(GOLDEN_CF.read_text())["corpus"]
               if e["flags"] == ["--contrafold", "-e"]}
    out = {}
    for model, got, want in (("default", port, gold_default),
                             ("--contrafold", brackets, gold_cf)):
        f = [evaluate_corpus(lambda a, b, t=t: t[names[(a.seq, b.seq)]])
             ["pooled"] for t in (got, want)]
        run.check("contrafold", f[0] == f[1],
                  f"pooled F-measure, {model}: " + ", ".join(
                      f"{k} {v[2]:.4f}" for k, v in f[0].items())
                  + " (golden brackets: " + ", ".join(
                      f"{k} {v[2]:.4f}" for k, v in f[1].items()) + ")")
        out[model] = f[0]
    return out


def phase_contrafold(run: Run):
    """The CONTRAfold model, the checkpoint resume and the corpus
    F-measure (phase 8)."""
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs
    gold = json.loads(GOLDEN_CF.read_text())
    pairs = {name: (a, b) for name, a, b in corpus_pairs()}
    rec = {}
    t0 = time.perf_counter()
    rec["crf_seconds"] = _cf_crf(run, gold, pairs)
    t1 = time.perf_counter()
    brackets, rec["cases"] = _cf_cases(run, gold, pairs)
    t2 = time.perf_counter()
    rec["resume"] = _cf_resume(run)
    t3 = time.perf_counter()
    rec["fmeasure"] = _cf_fmeasure(run, brackets)
    rec["seconds"] = dict(crf=t1 - t0, cases=t2 - t1, resume=t3 - t2,
                          fmeasure=time.perf_counter() - t3)
    secs = {k: round(v, 2) for k, v in rec["seconds"].items()}
    say(f"  seconds: {json.dumps(secs)}")
    run.record["contrafold"] = rec


def count_path(run: Run, window: str, path: str, launches: dict,
               plain: dict) -> None:
    """The path's kernels launched, the others not, no plain version on a
    CUDA tensor."""
    for name, *_ in KERNELS:
        n = launches.get(name, 0)
        want = name in PATHS[path]
        run.check("counts", (n > 0) == want,
                  f"{window}: {name} {n} launches (expected "
                  f"{'> 0' if want else '0'})")
    run.check("counts", not any(plain.values()),
              f"{window}: plain versions on CUDA tensors: {plain}")


def main() -> int:
    import argparse
    phases = {"kernels", "corpus", "zscore", "duplex", "single",
              "contrafold"}
    ap = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    ap.add_argument("--only", default=",".join(sorted(phases)),
                    help="comma list of phases after the build: "
                         + ", ".join(sorted(phases)))
    only = set(ap.parse_args().only.split(","))
    if not only <= phases:
        bail(f"unknown phases {sorted(only - phases)}")
    full = only == phases
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
    for g in (GOLDEN, GOLDEN_DUPLEX, GOLDEN_SINGLE, GOLDEN_CF):
        if not g.exists():
            bail(f"missing {g.relative_to(ROOT)}")
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.utils.timing import StageTimer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = Run()
    run.phase("1 device", phase_device)
    run.phase("2 build", phase_build)
    counts = {}   # window -> (path, launches, plain versions on CUDA)

    def counted(window: str, path: str, phases) -> None:
        """Run the phases with the counts set to 0 just before them and
        read just after them."""
        _cuda.reset_counts()
        for args in phases:
            run.phase(*args)
        counts[window] = (path, dict(_cuda.LAUNCHES),
                          dict(_cuda.PLAIN_ON_CUDA))

    if not run.failures:
        if "kernels" in only:
            run.phase("3 kernels vs plain", phase_kernels)
        for model, corpus, zscore, pc, pz in (
                ("default", "corpus" in only, "zscore" in only, 4, 5),
                ("duplex", "duplex" in only, "duplex" in only, 6, 6)):
            golden = GOLDEN if model == "default" else GOLDEN_DUPLEX
            main = []
            if corpus:
                main.append((f"{pc} {model} corpus", phase_corpus,
                             StageTimer, model, golden))
            if zscore:
                main.append((f"{pz} {model} zscore", phase_zscore,
                             StageTimer, model))
            if main:
                counted(model, model, main)
        if "single" in only:
            counted("single", "single", [("7 single pair", phase_single)])
        if "contrafold" in only:
            counted("contrafold", "contrafold",
                    [("8 contrafold", phase_contrafold)])
        if counts:
            say("== 9 launch counts")
            for window, (path, launches, plain) in counts.items():
                count_path(run, window, path, launches, plain)
        run.record["launches"] = {k: v[1] for k, v in counts.items()}
        kern = run.record.get("kernels", {})
        rows = []
        for name, src, rep, path in KERNELS:
            main_shape = (kern.get(name) or [{}])[0]
            rows.append(dict(
                name=name, route="cuda", source=src, replaces=rep,
                launches=counts.get(path, (None, {}))[1].get(name, 0),
                max_abs_err=main_shape.get("max_abs"),
                ms=main_shape.get("ms"), plain_ms=main_shape.get("plain_ms"),
                bound_ms=main_shape.get("bound_ms"),
                bound_by=main_shape.get("bound_by"), library_ms=None))
        run.record["kernel_rows"] = rows
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "ractip_tpu"))
    run.check("imports", not bad, f"neither jax nor the JAX package "
              f"ractip_tpu was imported: {bad or 'none'}")
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
