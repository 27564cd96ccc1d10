#!/usr/bin/env python
"""Write tests/data/torch_port_golden_contrafold.json from the JAX package on the CPU.

The golden file of the CONTRAfold model (--contrafold, --contraduplex), the
checkpoint fingerprint and the sequential CONTRAfold z-score, which the
PyTorch port must reproduce on the CPU (tests/test_torch_contrafold.py,
tests/test_torch_checkpoint.py) and on the GPU (chip_smoke.py, phase
`contrafold`).  Every JAX run has x64 on (JAX_ENABLE_X64=1): the CRF
functions ask for float64 (ractip_tpu/ops/contrafold.py:331,346), which JAX
honours only then; the cofold and duplex posteriors stay float32 as the JAX
package computes them.

  a  strands: cf_logz, cf_base_pair_probs (the nonzero entries, i < j) and
     cf_unpaired_probs of seeded random strands padded to a bucket (n < L),
     in both models (complementary, noncomplementary);
  b  duplexes: cd_logz and cd_hybrid_probs (the nonzero entries) of two
     seeded random pairs, padded;
  c  corpus: each corpus pair through the JAX single-pair path
     (Posteriors + solve_pair + solve_ss, as ractip_tpu/pipeline/ractip.py::
     predict runs them) under `--contrafold -e` (all 8 pairs),
     `--contrafold --duplex -e`, `--contraduplex -e` (two pairs each),
     `--contrafold --min-w 1 -e` (two pairs) and `--contraduplex --min-w 1
     -e` (one pair): at the default --min-w 5 the accessibility constraint
     reads windows of width 5-15, which the CRF's width-1 proxy leaves at
     0, so no corpus pair hybridizes; --min-w 1 turns accessibility off:
     brackets, objective, energies e1 e2 e3 e1s e2s, and each strand's CRF
     logZ, pu (column 1 of the accessibility array, the width-1 proxy) and
     its 64 largest pair probabilities with their indices, and the 64
     largest hybridization probabilities;
  d  zscores: `--contrafold --zscore 12 --num-shuffling 10 --seed 11` on
     Tar-Tarstar, predict's sequential z-score (each decoy in a child; no
     decoy hybridizes, so zs is infinite), and the same with --min-w 1;
  e  fingerprint: the checkpoint fingerprint of one small predict_batch
     call (two corpus pairs, chunk 1, iters 200, with energies), read from
     the MANIFEST.json the JAX package writes into its checkpoint directory.

Each JAX run goes to a child process of its own, up to --jobs at a time
(this jaxlib's XLA:CPU compile path fails after a few compiles in one
process, tests/conftest.py).  The JAX package's cd_hybrid_probs runs eagerly
on the CPU (ractip_tpu/ops/contraduplex.py:150-158), at several seconds a
row, so (b) and the --contraduplex cases take minutes each.

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_contrafold_golden.py
        [--parts a,b,c,d,e]   (recompute only these; the others are kept)
        [--jobs N]            (child processes at a time, default 5)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_port_golden_contrafold.json")
STRANDS = (("complementary", 9, 16, 1), ("complementary", 27, 32, 2),
           ("complementary", 60, 64, 3), ("noncomplementary", 20, 32, 4),
           ("noncomplementary", 45, 64, 5))        # model, n, L, seed
DUPLEXES = ((20, 24, 24, 32, 6), (40, 48, 48, 56, 7))  # n1 L1 n2 L2 seed
DUPLEX_PAIRS = ("CopA-CopT", "R1inv-R2inv")
CONTRADUPLEX_PAIRS = ("Tar-Tarstar", "R1inv-R2inv")
# accessibility off: the hybridizing cases
MINW_PAIRS = ("CopA-CopT", "R1inv-R2inv")
ZSCORE_PAIR = "Tar-Tarstar"
ZSCORE_FLAGS = (["--contrafold", "--zscore", "12", "--num-shuffling", "10",
                 "--seed", "11"],
                ["--contrafold", "--min-w", "1", "--zscore", "12",
                 "--num-shuffling", "10", "--seed", "11"])
FP_PAIRS = ("Tar-Tarstar", "R1inv-R2inv")
FP_CALL = dict(chunk=1, iters=200, want_energy=True, exact_gap_tol=1e-4)
TOP = 64
ALL_PARTS = "abcde"


def seeded(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGU"), n))


def _nonzero(m) -> list:
    m = np.asarray(m, np.float64)
    i, j = np.nonzero(m)
    return [[int(a), int(b), float(m[a, b])] for a, b in zip(i, j)]


def _top(m, k: int = TOP) -> list:
    m = np.asarray(m, np.float64)
    flat = np.argsort(-m, axis=None, kind="stable")[:k]
    i, j = np.unravel_index(flat, m.shape)
    return [[int(a), int(b), float(m[a, b])] for a, b in zip(i, j)]


def _strand(model, n, L, seed):
    from ractip_tpu.ops.contrafold import (cf_base_pair_probs, cf_logz,
                                           cf_unpaired_probs)
    from ractip_tpu.ops.seq import encode
    seq = seeded(n, seed)
    S = encode(seq, L)
    bpp = cf_base_pair_probs(S, n, model)
    return dict(model=model, n=n, L=L, seed=seed, seq=seq,
                logz=float(cf_logz(S, n, model)), bpp=_nonzero(bpp),
                pu=np.asarray(cf_unpaired_probs(bpp), np.float64).tolist())


def _duplex(n1, L1, n2, L2, seed):
    from ractip_tpu.ops.contraduplex import cd_hybrid_probs, cd_logz
    from ractip_tpu.ops.seq import encode
    s1, s2 = seeded(n1, seed), seeded(n2, seed + 100)
    S1, S2 = encode(s1, L1), encode(s2, L2)
    return dict(n1=n1, L1=L1, n2=n2, L2=L2, seed=seed, seq1=s1, seq2=s2,
                logz=float(cd_logz(S1, S2, n1, n2)),
                hp=_nonzero(cd_hybrid_probs(S1, S2, n1, n2)))


def _pair(name):
    from ractip_tpu.evaluate.corpus import corpus_pairs
    return next((a, b) for n, a, b in corpus_pairs() if n == name)


def _opts(flags):
    from ractip_tpu.cli import build_parser, options_from_args
    return options_from_args(build_parser().parse_args(["a", "b"] + flags))


def _corpus(pair, flags):
    """predict's body (ractip_tpu/pipeline/ractip.py:292-303) on one
    Posteriors, so the CRF (and the eager duplex CRF) runs once."""
    from ractip_tpu.ops.contrafold import cf_logz
    from ractip_tpu.ops.seq import encode
    from ractip_tpu.params.tables import get_default_params
    from ractip_tpu.pipeline.ractip import Posteriors, solve_pair, solve_ss
    fa1, fa2 = _pair(pair)
    opts = _opts(flags)
    cfg = opts.solver_cfg()
    params = get_default_params()
    t0 = time.perf_counter()
    post = Posteriors(params, fa1.seq, fa2.seq, opts.max_w, cfg.accessibility,
                      use_pf_duplex=opts.use_pf_duplex,
                      use_contrafold=opts.use_contrafold,
                      use_contraduplex=opts.use_contraduplex)
    t_post = time.perf_counter() - t0
    r1, r2, obj, (e1, e2, e3), post = solve_pair(params, fa1, fa2, opts,
                                                 post=post, want_energy=True)
    _, _, e1s = solve_ss(params, fa1.seq, opts, post.bpp1, L=post.L1,
                         want_energy=True)
    _, _, e2s = solve_ss(params, fa2.seq, opts, post.bpp2, L=post.L2,
                         want_energy=True)
    strands = []
    for fa, bpp, pu, L in ((fa1, post.bpp1, post.pu1, post.L1),
                           (fa2, post.bpp2, post.pu2, post.L2)):
        strands.append(dict(
            L=L, logz=float(cf_logz(encode(fa.seq, L), len(fa.seq))),
            pu=None if pu is None else np.asarray(pu[:, 1],
                                                   np.float64).tolist(),
            bpp_top=_top(bpp)))
    return dict(pair=pair, flags=flags, r1=r1, r2=r2, objective=float(obj),
                energies=[float(x) for x in (e1, e2, e3, e1s, e2s)],
                strands=strands, hp_top=_top(post.hp),
                seconds_posteriors=t_post,
                seconds=time.perf_counter() - t0)


def _decoy(t1, t2, flags):
    """One decoy of predict's z-score loop (ractip.py:305-316): (ee, ees)."""
    from ractip_tpu.io.fasta import Fasta
    from ractip_tpu.params.tables import get_default_params
    from ractip_tpu.pipeline.ractip import solve_pair, solve_ss
    opts = _opts(flags)
    params = get_default_params()
    _, _, _, (ee1, ee2, ee3), spost = solve_pair(
        params, Fasta("s1", t1), Fasta("s2", t2), opts, want_energy=True)
    _, _, ee1s = solve_ss(params, t1, opts, spost.bpp1, L=spost.L1,
                          want_energy=True)
    _, _, ee2s = solve_ss(params, t2, opts, spost.bpp2, L=spost.L2,
                          want_energy=True)
    ee = ee1 + ee2 + ee3
    return [float(ee), float(ee - ee1s - ee2s)]


def _fingerprint():
    from ractip_tpu.params.tables import get_default_params
    from ractip_tpu.pipeline.batched import predict_batch
    from ractip_tpu.pipeline.ractip import Options
    pairs = [(a.seq, b.seq) for a, b in map(_pair, FP_PAIRS)]
    with tempfile.TemporaryDirectory() as d:
        res = predict_batch(get_default_params(), pairs, Options(),
                            ckpt_dir=d, **FP_CALL)
        with open(os.path.join(d, "MANIFEST.json")) as fh:
            manifest = json.load(fh)
        files = sorted(os.listdir(d))
    return dict(pairs=[list(p) for p in pairs], flags=[], **FP_CALL,
                fingerprint=manifest["fingerprint"], manifest=manifest,
                files=files, r1=list(res.r1), r2=list(res.r2))


CHILD = {"strand": _strand, "duplex": _duplex, "corpus": _corpus,
         "decoy": _decoy, "fingerprint": _fingerprint}


def _spawn(jobs, specs):
    """Run each (kind, kwargs) in a child process, jobs at a time, and
    return their results in order."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")

    def one(spec):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", json.dumps(spec)],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=7200)
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: exit {proc.returncode}\n"
                               + proc.stderr[-3000:])
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  {spec[0]} {json.dumps(spec[1])[:80]}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out
    with ThreadPoolExecutor(jobs) as ex:
        return list(ex.map(one, specs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default=ALL_PARTS)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        kind, kw = json.loads(args.child)
        print(json.dumps(CHILD[kind](**kw)))
        return 0
    parts = args.parts.replace(",", "")

    import jax
    from ractip_tpu import native
    from ractip_tpu.evaluate.corpus import corpus_pairs
    from ractip_tpu.pipeline.shuffle import dinuc_shuffle
    gold = {"generator": "tools/make_torch_contrafold_golden.py",
            "jax_backend": jax.default_backend(), "jax_enable_x64": True,
            "native_shuffle": bool(native.available())}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            gold.update({k: v for k, v in json.load(fh).items()
                         if k not in gold})

    # every part's children go to one pool, the slowest first
    specs, slots = [], []

    def add(part, key, spec):
        if part in parts:
            specs.append(spec)
            slots.append((part, key))

    names = [name for name, _, _ in corpus_pairs()]
    for n1, L1, n2, L2, seed in DUPLEXES:
        add("b", "duplexes", ("duplex", dict(n1=n1, L1=L1, n2=n2, L2=L2,
                                             seed=seed)))
    add("e", "fingerprint", ("fingerprint", {}))
    for flags, pairs in ((["--contraduplex", "-e"], CONTRADUPLEX_PAIRS),
                         (["--contrafold", "-e"], names),
                         (["--contrafold", "--duplex", "-e"], DUPLEX_PAIRS),
                         (["--contrafold", "--min-w", "1", "-e"], MINW_PAIRS),
                         (["--contraduplex", "--min-w", "1", "-e"],
                          MINW_PAIRS[1:])):
        for name in pairs:
            add("c", "corpus", ("corpus", dict(pair=name, flags=flags)))
    for m, n, L, seed in STRANDS:
        add("a", "strands", ("strand", dict(model=m, n=n, L=L, seed=seed)))
    fa1, fa2 = _pair(ZSCORE_PAIR)
    decoys = {}
    for k, flags in enumerate(ZSCORE_FLAGS):
        zopts = _opts(flags)
        rng = np.random.default_rng(zopts.seed)
        decoys[k] = [(dinuc_shuffle(fa1.seq, rng), dinuc_shuffle(fa2.seq, rng))
                     for _ in range(zopts.num_shuffling)]
        add("d", ("zscore", k), ("corpus", dict(pair=ZSCORE_PAIR,
                                                flags=flags)))
        for t1, t2 in decoys[k]:
            add("d", ("decoys", k), ("decoy", dict(t1=t1, t2=t2,
                                                   flags=flags)))

    t0 = time.perf_counter()
    got = _spawn(args.jobs, specs)
    fresh: dict = {}
    for (part, key), out in zip(slots, got):
        fresh.setdefault(key, []).append(out)
    gold.update({k: v for k, v in fresh.items() if isinstance(k, str)
                 and k != "fingerprint"})
    if "fingerprint" in fresh:
        gold["fingerprint"] = fresh["fingerprint"][0]
    if "d" in parts:
        gold["zscores"] = []
    for k in range(len(ZSCORE_FLAGS)):
        if ("zscore", k) not in fresh:
            continue
        # predict's z statistics (ractip.py:317-324) over the decoys
        e = fresh["zscore", k][0]
        e1, e2, e3, e1s, e2s = e["energies"]
        ev = e1 + e2 + e3
        es = ev - e1s - e2s
        acc, acc2 = np.zeros(2), np.zeros(2)
        for ee, ees in fresh["decoys", k]:
            acc += (ee, ee * ee)
            acc2 += (ees, ees * ees)
        num = len(decoys[k])
        m, m2 = acc / num
        v = max(m2 - m * m, 0.0)
        ms, ms2 = acc2 / num
        vs = max(ms2 - ms * ms, 0.0)
        e["zscore"] = [float((ev - m) / np.sqrt(v) if v else np.inf),
                       float((es - ms) / np.sqrt(vs) if vs else np.inf)]
        e["decoys"] = [list(d) for d in decoys[k]]
        e["decoy_energies"] = fresh["decoys", k]
        gold["zscores"].append(e)
    gold["seconds"] = time.perf_counter() - t0
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(gold, fh, indent=None, separators=(",", ":"))
        fh.write("\n")
    os.replace(tmp, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
          f"{gold['seconds']:.0f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
