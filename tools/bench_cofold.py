#!/usr/bin/env python3
"""Time the cofold kernels K4 (co_inside) and K5 (co_outside) of one or
more copies of the port on one GPU, each against its plain version.

    python3 tools/bench_cofold.py [--trees DIR,DIR,...] [--shapes main,corpus]
                                  [--reps 5] [--rounds 2]

Each DIR is a directory holding a ractip_tpu_torch package (default: the
repository root).  Every tree runs in a process of its own, which builds
that tree's kernels with nvcc and times them with CUDA events on inputs made
from fixed seeds; with --rounds 2 the trees run in the order A B ... B A, so
two versions are compared inside one call on one card.  Shapes: main (B=256,
s1 = 70 nt of shuffled CopA, s2 = shuffled CopT, buckets 96 + 96), corpus
(the bundled 8 pairs, Lc = 288), edges (B=4, Lc = 192, the cut at 1 and
at n - 1), long (B=2, Lc = 512, random pairs of
200 + 270 and 224 + 288 nt), xlong (B=2, Lc = 1024, 480 + 500 and
512 + 512 nt).  One JSON line per tree and shape; the summary goes to
chiprun_out/bench_cofold.json.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _pairs(shape: str):
    import numpy as np
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs, record
    from ractip_tpu_torch.ops.seq import bucket_length
    from ractip_tpu_torch.pipeline.shuffle import shuffle_batch
    if shape == "main":
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        pairs = list(zip(shuffle_batch(a, 256, 11), shuffle_batch(b, 256, 12)))
        return [(x[:70], y) for x, y in pairs], 96, 96
    if shape == "edges":     # cut = 1 and cut = n - 1
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        return [(a[:1], b), (a[:70], b[:1]), (a[:1], b[:1]), (a[:70], b)], \
            96, 96
    if shape == "corpus":
        pairs = [(f1.seq, f2.seq) for _, f1, f2 in corpus_pairs()]
        return (pairs, max(bucket_length(len(x)) for x, _ in pairs),
                max(bucket_length(len(y)) for _, y in pairs))
    rng = np.random.default_rng(13)
    rs = lambda k: "".join(rng.choice(list("ACGU"), k))
    if shape == "long":
        return [(rs(200), rs(270)), (rs(224), rs(288))], 224, 288
    if shape == "xlong":
        return [(rs(480), rs(500)), (rs(512), rs(512))], 512, 512
    raise ValueError(shape)


def one(tree: Path, shapes, reps: int, device: str) -> list[dict]:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import ractip_tpu_torch
    assert Path(ractip_tpu_torch.__file__).resolve().parent.parent == tree
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.factors import co_factors
    from ractip_tpu_torch.ops.seq import encode
    from ractip_tpu_torch.params.boltz import sig_tables
    from ractip_tpu_torch.params.tables import get_default_params
    dev = torch.device(device)
    if dev.type == "cuda":
        _cuda.build(force=True)
    tt = ts.as_tables(get_default_params(), dev)
    takes_n = "n" in inspect.signature(tc.co_inside).parameters
    out = []

    def ms(fn):
        fn()
        if dev.type == "cpu":      # rehearsal: the plain versions' wall time
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def rel(a, b):
        a, b = a.double(), b.double()
        if not torch.equal(a.isfinite(), b.isfinite()):
            return float("inf")
        d = (a - b).abs()[b.isfinite()]
        nz = b.abs()[b.isfinite()] > 0
        bad = bool((d[~nz] > 1e-30).any())
        return float("inf") if bad else float((d[nz] / b.abs()[b.isfinite()][
            nz]).max()) if bool(nz.any()) else 0.0

    for shape in shapes:
        pairs, L1, L2 = _pairs(shape)
        t = lambda v: torch.as_tensor(np.asarray(v), device=dev)
        S1 = t(np.stack([encode(a, L1) for a, _ in pairs])).long()
        S2 = t(np.stack([encode(b, L2) for _, b in pairs])).long()
        n1, n2 = t([len(a) for a, _ in pairs]), t([len(b) for _, b in pairs])
        S = tc._pack_concat(S1, S2, n1)
        n, cut = n1 + n2, n1
        es = tc.batch_cofold(tt, S1, S2, n1, n2, dev)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = co_factors(tt, S, n, cut, sig)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows, cut)
        kw = dict(n=n) if takes_n else {}
        kin = lambda: tc.co_inside(*args, **kw)
        ins_k, ins_p = kin(), ts.inside_plain(*args)
        qm1_c, qb_c, qm_c, qx_c, q1 = ins_p
        qb = qb_c.transpose(1, 2)
        q2v = ts.q2((qb * ff.fe).contiguous(), sig, n)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        qx = qx_c.transpose(1, 2).contiguous()
        qxA, qBpref = tc.exterior_vectors(qx, cut)
        oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, qx, qxA, qBpref,
                 q1pad, q2v, w2k, bulge_k, sig, pows, cut)
        kout = lambda: tc.co_outside(*oargs, **kw)
        ob_k, ob_p = kout(), tc.co_outside_plain(*oargs)
        same = (all(torch.equal(a, b) for a, b in zip(ins_k, kin()))
                and torch.equal(ob_k, kout()))
        rec = dict(tree=str(tree), shape=shape, B=len(pairs), Lc=L1 + L2,
                   n_mean=float(n.float().mean()), es_sum=float(es.sum()),
                   takes_n=takes_n, ins_rel=max(rel(a, b) for a, b in
                                                zip(ins_k, ins_p)),
                   ob_rel=rel(ob_k, ob_p), relaunch_same=same,
                   co_inside_ms=ms(kin), co_outside_ms=ms(kout))
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del ins_k, ins_p, ob_k, ob_p, F
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", default=str(ROOT))
    ap.add_argument("--shapes", default="main")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a tree may take before it is killed")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal with the plain versions")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    shapes = a.shapes.split(",")
    if a.one:
        one(Path(a.one).resolve(), shapes, a.reps, a.device)
        return 0
    trees = [str(Path(t).resolve()) for t in a.trees.split(",")]
    order = trees if a.rounds == 1 else trees + trees[::-1]
    smi = "cpu rehearsal" if a.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    recs, rc = [], 0
    for tree in order:
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, __file__, "--one", tree,
                                "--shapes", a.shapes, "--reps", str(a.reps),
                                "--device", a.device], capture_output=True,
                               text=True, cwd=tree, timeout=a.timeout)
            out, err, code = p.stdout, p.stderr, p.returncode
        except subprocess.TimeoutExpired as e:
            out, err, code = e.stdout or "", e.stderr or "", "timeout"
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        recs += [json.loads(ln) for ln in lines]
        print("\n".join(lines), flush=True)
        if code != 0:
            rc = 1
            print(f"{tree}: exit {code}\n{err[-4000:]}", flush=True)
        print(f"# {tree}: {time.perf_counter() - t0:.1f} s", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_cofold.json").write_text(json.dumps(
        dict(nvidia_smi=smi, records=recs), indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
