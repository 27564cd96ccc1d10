#!/usr/bin/env python3
"""Time the DP kernels K1 (inside), K2 (outside), K3 (q2), K4 (co_inside),
K5 (co_outside) and K6 (duplex_sweep) of one or more copies of the port on
one GPU, each against its plain version.

    python3 tools/bench_scan.py [--trees DIR,DIR,...] [--shapes fold,main]
                                [--reps 5] [--rounds 2]

Each DIR is a directory holding a ractip_tpu_torch package (default: the
repository root).  Every tree runs in a process of its own, which builds
that tree's kernels with nvcc and times them with CUDA events on inputs made
from fixed seeds; with --rounds 2 the trees run in the order A B ... B A, so
two versions are compared inside one call on one card.

Fold shapes (K1, K2; the scale energies the adaptive loop picks):
  fold         B=512, L=96: 256 shuffled CopA and 256 shuffled CopT (70 nt),
               the main path's fold (foldone: its first instance alone);
  fold64       B=16, L=64: random sequences of 40-64 nt (a short run, as
               for compute-sanitizer);
  fold128      B=8, L=128: the bundled corpus's first strands;
  fold160      B=8, L=160: its second strands;
  foldxlong    B=2, L=1024: random sequences of 1000 and 1024 nt (rings and
               tables in device memory).
Cofold shapes (K4, K5): main (B=256, s1 = 70 nt of shuffled CopA, s2 =
shuffled CopT, buckets 96 + 96; mainone: its first pair alone), edges (B=4, Lc = 192, the cut at 1 and at
n - 1), corpus (the bundled 8 pairs, Lc = 288), long (B=2, Lc = 512, random
pairs of 200 + 270 and 224 + 288 nt), xlong (B=2, Lc = 1024, 480 + 500 and
512 + 512 nt).
fold192, fold256 (B=512) and fold192x8, fold256x8 (B=8): random sequences
of L-40..L nt, as chip_smoke.py's phase 3 draws them (qm in device memory).
K3 shapes: q2-<fold or cofold shape> (q2 on the qbe the plain inside scan
gives for that shape: q2-fold is the fold's B=512, L=96, q2-main the main
cofold's B=256, Lc=192), and q2-random (B=8, L=96) and q2-random2048 (B=2,
L=2048: the rows too wide for shared memory): full random qbe with n < L,
lower triangle and padding nonzero.
A shape's first instance alone (foldone, mainone, duplexone) gives a
kernel's chain floor on this card: one instance's rows, each step waiting
on the one before, with nothing else sharing the SM.
K6 shapes (both sweeps in one launch, the launcher's pick): duplex (B=256,
shuffled CopA x CopT, 96 x 96: the --duplex main path; duplexone: its
first pair alone), duplexcorpus (the
bundled 8 pairs, 128 x 160), duplexlong (B=2, random 40 x 1990 and
64 x 2048 nt, 64 x 2048: rings in device memory).

A tree whose wrappers take no lengths n runs without them.  One JSON line
per tree and shape (times, max relative difference of whole tables against
the plain version, a relaunch bit-identical or not, and the kernels' blocks
an SM where the tree reports them); the summary goes to
chiprun_out/bench_scan.json.
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
FOLD_SHAPES = ("fold", "foldone", "fold64", "fold128", "fold160",
               "foldxlong", "fold192", "fold256", "fold192x8", "fold256x8")
DUPLEX_SHAPES = ("duplex", "duplexone", "duplexcorpus", "duplexlong")


def _rand(rng, k):
    return "".join(rng.choice(list("ACGU"), k))


def _fold_seqs(shape: str):
    """(sequences, bucket L) of a fold shape."""
    import numpy as np
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs, record
    from ractip_tpu_torch.pipeline.shuffle import shuffle_batch
    if shape in ("fold", "foldone"):
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        seqs = shuffle_batch(a, 256, 11) + shuffle_batch(b, 256, 12)
        return seqs[:1 if shape == "foldone" else None], 96
    if shape in ("fold128", "fold160"):
        k = 0 if shape == "fold128" else 1
        return [(f1.seq, f2.seq)[k] for _, f1, f2 in corpus_pairs()], \
            int(shape[4:])
    if shape.startswith(("fold192", "fold256")):
        L, B = int(shape[4:7]), 8 if shape.endswith("x8") else 512
        rng = np.random.default_rng(19)
        return [_rand(rng, int(k)) for k in rng.integers(L - 40, L + 1, B)], L
    rng = np.random.default_rng(17)
    if shape == "fold64":
        return [_rand(rng, int(k)) for k in rng.integers(40, 65, 16)], 64
    return [_rand(rng, 1000), _rand(rng, 1024)], 1024


def _pairs(shape: str):
    import numpy as np
    from ractip_tpu_torch.evaluate.corpus import corpus_pairs, record
    from ractip_tpu_torch.ops.seq import bucket_length
    from ractip_tpu_torch.pipeline.shuffle import shuffle_batch
    if shape in ("main", "mainone"):
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        pairs = list(zip(shuffle_batch(a, 256, 11), shuffle_batch(b, 256, 12)))
        pairs = pairs[:1 if shape == "mainone" else None]
        return [(x[:70], y) for x, y in pairs], 96, 96
    if shape == "edges":     # cut = 1 and cut = n - 1
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        return [(a[:1], b), (a[:70], b[:1]), (a[:1], b[:1]), (a[:70], b)], \
            96, 96
    if shape == "corpus":
        pairs = [(f1.seq, f2.seq) for _, f1, f2 in corpus_pairs()]
        return (pairs, max(bucket_length(len(x)) for x, _ in pairs),
                max(bucket_length(len(y)) for _, y in pairs))
    if shape in ("duplex", "duplexone"):
        a, b = record("CopA.fa").seq, record("CopT.fa").seq
        pairs = list(zip(shuffle_batch(a, 256, 11), shuffle_batch(b, 256, 12)))
        return pairs[:1 if shape == "duplexone" else None], 96, 96
    if shape == "duplexcorpus":
        return _pairs("corpus")
    if shape == "duplexlong":
        rng = np.random.default_rng(7)
        return [(_rand(rng, 40), _rand(rng, 1990)),
                (_rand(rng, 64), _rand(rng, 2048))], 64, 2048
    rng = np.random.default_rng(13)
    rs = lambda k: _rand(rng, k)
    if shape == "long":
        return [(rs(200), rs(270)), (rs(224), rs(288))], 224, 288
    if shape == "xlong":
        return [(rs(480), rs(500)), (rs(512), rs(512))], 512, 512
    raise ValueError(shape)


def rel(a, b) -> float:
    """Max relative difference of a against b; infinite where the finite
    cells differ or a is nonzero where b is 0."""
    import torch
    a, b = a.double(), b.double()
    if not torch.equal(a.isfinite(), b.isfinite()):
        return float("inf")
    fin = b.isfinite()
    d, bb = (a - b).abs()[fin], b.abs()[fin]
    nz = bb > 0
    if bool((d[~nz] > 1e-30).any()):
        return float("inf")
    return float((d[nz] / bb[nz]).max()) if bool(nz.any()) else 0.0


def one(tree: Path, shapes, reps: int, device: str) -> list[dict]:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import ractip_tpu_torch
    assert Path(ractip_tpu_torch.__file__).resolve().parent.parent == tree
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.factors import co_factors, fold_factors
    from ractip_tpu_torch.ops.seq import encode
    from ractip_tpu_torch.params.boltz import sig_tables
    from ractip_tpu_torch.params.tables import get_default_params
    dev = torch.device(device)
    if dev.type == "cuda":
        _cuda.build(force=True)
        # the plain sweeps' conv1d in full float32, as chip_smoke.py runs it
        torch.backends.cudnn.allow_tf32 = False
    tt = ts.as_tables(get_default_params(), dev)
    out = []
    t = lambda v: torch.as_tensor(np.asarray(v), device=dev)

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

    def occupancy(L, cofold, B):
        """Blocks an SM of the inside and outside variants the launchers
        pick for B instances at L, where the tree reports them."""
        if dev.type != "cuda" or not hasattr(_cuda, "occupancy"):
            return None
        return _cuda.occupancy(L, cofold, B)

    def fold(shape):
        seqs, L = _fold_seqs(shape)
        S = t(np.stack([encode(s, L) for s in seqs])).long()
        n = t([len(s) for s in seqs])
        takes_n = "n" in inspect.signature(ts.inside).parameters
        kw = dict(n=n) if takes_n else {}
        es = ts.batch_fold(tt, S, n, dev)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = fold_factors(tt, S, n, sig)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows)
        kin = lambda: ts.inside(*args, **kw)
        ins_k, ins_p = kin(), ts.inside_plain(*args)
        qm1_c, qb_c, qm_c, _, q1 = ins_p
        qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
        q2v = ts.q2(qbe, sig, n)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, q1pad, q2v,
                 w2k, bulge_k, sig, pows)
        kout = lambda: ts.outside(*oargs, **kw)
        ob_k, ob_p = kout(), ts.outside_plain(*oargs)
        same = (all(torch.equal(a, b) for a, b in zip(ins_k, kin()))
                and torch.equal(ob_k, kout()))
        return dict(B=len(seqs), L=L, n_mean=float(n.float().mean()),
                    es_sum=float(es.sum()), takes_n=takes_n,
                    ins_rel=max(rel(a, b) for a, b in zip(ins_k, ins_p)),
                    ob_rel=rel(ob_k, ob_p), relaunch_same=same,
                    inside_ms=ms(kin), outside_ms=ms(kout),
                    blocks_per_sm=occupancy(L, False, len(seqs)))

    def cofold(shape):
        pairs, L1, L2 = _pairs(shape)
        S1 = t(np.stack([encode(a, L1) for a, _ in pairs])).long()
        S2 = t(np.stack([encode(b, L2) for _, b in pairs])).long()
        n1, n2 = t([len(a) for a, _ in pairs]), t([len(b) for _, b in pairs])
        S = tc._pack_concat(S1, S2, n1)
        n, cut = n1 + n2, n1
        takes_n = "n" in inspect.signature(tc.co_inside).parameters
        kw = dict(n=n) if takes_n else {}
        es = tc.batch_cofold(tt, S1, S2, n1, n2, dev)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = co_factors(tt, S, n, cut, sig)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows, cut)
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
        return dict(B=len(pairs), Lc=L1 + L2, n_mean=float(n.float().mean()),
                    es_sum=float(es.sum()), takes_n=takes_n,
                    ins_rel=max(rel(a, b) for a, b in zip(ins_k, ins_p)),
                    ob_rel=rel(ob_k, ob_p), relaunch_same=same,
                    co_inside_ms=ms(kin), co_outside_ms=ms(kout),
                    blocks_per_sm=occupancy(L1 + L2, True, len(pairs)))

    def q2(shape):
        """K3 on the qbe the plain inside scan gives for a fold or cofold
        shape (q2-<shape>), or on full random qbe (q2-random)."""
        base = shape[3:]
        if base.startswith("random"):
            B, L = (2, 2048) if base == "random2048" else (8, 96)
            rng = np.random.default_rng(23)
            qbe = t(rng.random((B, L, L)) * 0.03).float()
            sig = t(rng.uniform(0.5, 1.5, B)).float()
            n = t(rng.integers(L // 2, L, B))
        elif base in FOLD_SHAPES:
            seqs, L = _fold_seqs(base)
            S = t(np.stack([encode(x, L) for x in seqs])).long()
            n = t([len(x) for x in seqs])
            es = ts.batch_fold(tt, S, n, dev)["es"]
            sig = torch.exp(-es / tt.scalar(tt.bt.kt))
            ff = fold_factors(tt, S, n, sig)
            cut = None
        else:
            pairs, L1, L2 = _pairs(base)
            S1 = t(np.stack([encode(a, L1) for a, _ in pairs])).long()
            S2 = t(np.stack([encode(b, L2) for _, b in pairs])).long()
            n1 = t([len(a) for a, _ in pairs])
            n2 = t([len(b) for _, b in pairs])
            S = tc._pack_concat(S1, S2, n1)
            n, cut = n1 + n2, n1
            es = tc.batch_cofold(tt, S1, S2, n1, n2, dev)["es"]
            sig = torch.exp(-es / tt.scalar(tt.bt.kt))
            ff = co_factors(tt, S, n, cut, sig)
        if not base.startswith("random"):
            w2k, bulge_k, pows = sig_tables(tt, sig)
            args = (ts.stack_cols(ff), w2k, bulge_k, sig, pows) + (
                () if cut is None else (cut,))
            qb_c = ts.inside_plain(*args)[1]
            qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
        n32 = n.to(torch.int32)
        kfn = lambda: ts.q2(qbe, sig, n32)
        k = kfn()
        p = ts.q2_plain(qbe, sig, n32)
        return dict(B=qbe.shape[0], L=qbe.shape[-1],
                    n_mean=float(n.float().mean()), q2_rel=rel(k, p),
                    q2_max_abs=float((k.double() - p.double()).abs().max()),
                    relaunch_same=torch.equal(k, kfn()), q2_ms=ms(kfn))

    def duplex(shape):
        """K6, both sweeps in one launch (the launcher's pick), against the
        plain sweeps in the log domain (the same zero cells)."""
        from ractip_tpu_torch.ops import duplex as td
        pairs, L1, L2 = _pairs(shape)
        S1 = t(np.stack([encode(a, L1) for a, _ in pairs])).long()
        S2 = t(np.stack([encode(b, L2) for _, b in pairs])).long()
        n1, n2 = t([len(a) for a, _ in pairs]), t([len(b) for _, b in pairs])
        ffw = td.duplex_factors_fw(tt, S1, S2, n1, n2)
        fbk = td.duplex_factors_bk(tt, S1, S2, n1, n2)
        kfn = lambda: td.sweep(tt, ffw, fbk, n1, n2)
        k, again = kfn(), kfn()
        p = (td.sweep_plain(ffw, tt, False), td.sweep_plain(fbk, tt, True))
        worst, zeros = 0.0, True
        for (Mk, lk), (Mp, lp) in zip(k, p):
            zeros &= torch.equal(Mk > 0, Mp > 0)
            pos = Mp > 0
            lg = lambda M, lsc: (M.double().log()
                                 + lsc.double()[..., None])[pos]
            worst = max(worst, float((lg(Mk, lk) - lg(Mp, lp)).abs().max()))
        same = all(torch.equal(x, y) for a, b in zip(k, again)
                   for x, y in zip(a, b))
        var = (_cuda.duplex_variant(L2, len(pairs))
               if dev.type == "cuda" and hasattr(_cuda, "duplex_variant")
               else None)
        return dict(B=len(pairs), L1=L1, L2=L2, log_max_abs=worst,
                    zero_cells_same=zeros, relaunch_same=same,
                    duplex_ms=ms(kfn), variant=var)

    for shape in shapes:
        fn = (fold if shape in FOLD_SHAPES else q2 if shape.startswith("q2-")
              else duplex if shape in DUPLEX_SHAPES else cofold)
        rec = dict(tree=str(tree), shape=shape, **fn(shape))
        print(json.dumps(rec), flush=True)
        out.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", default=str(ROOT))
    ap.add_argument("--shapes", default="fold,main")
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
    (out / "bench_scan.json").write_text(json.dumps(
        dict(nvidia_smi=smi, records=recs), indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
