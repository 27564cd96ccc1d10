#!/usr/bin/env python
"""Write tests/data/torch_port_golden_contrafold_decode.json from the JAX package.

The golden file of the CONTRAfold decoding and max-margin functions
(ractip_tpu/ops/contrafold.py: the max semiring, the `allow` mask and the
helix-length grammar of _cf_logz, cf_viterbi, cf_mea, cf_stochastic_traceback,
cf_loss_augmented_viterbi, cf_margin), which the PyTorch port must reproduce
on the CPU (tests/test_torch_contrafold.py) and on the GPU (chip_smoke.py,
phase `rest`).  Every JAX run has x64 on (JAX_ENABLE_X64=1): the CRF
functions ask for float64, which JAX honours only then.

  a  viterbi: cf_viterbi (score, mapping) of the 16 corpus strands, each
     padded to its bucket, and cf_mea of their cf_base_pair_probs at
     gamma 6 and gamma 1;
  b  allow: cf_logz, the 64 largest cf_base_pair_probs and cf_viterbi of 4
     corpus strands under a seeded random `allow` mask (stored packed);
  c  helix: cf_logz, the 64 largest cf_base_pair_probs and cf_viterbi under
     seeded helix-length and isolated-pair weights (the recipe of
     tests/test_contrafold.py::_helix_weights, stored) of 4 corpus strands,
     ompA (n=137, L=160), the longest, among them;
  d  loss: cf_loss_augmented_viterbi (augmented score, score, mapping) and
     cf_margin of 4 corpus strands against their curated structures (the
     "()" pairs of seqdata/RNA-RNAdata.zip), at fp = fn = 1 and 0.7;
  e  samples: 200 cf_stochastic_traceback samples (seed 42) of 2 corpus
     strands.

Each strand's JAX run goes to a child process of its own, up to --jobs at a
time (this jaxlib's XLA:CPU compile path fails after a few compiles in one
process, tests/conftest.py).

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_decode_golden.py
        [--parts a,b,c,d,e]   (recompute only these; the others are kept)
        [--jobs N]            (child processes at a time, default 5)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_golden_contrafold_decode.json")
# strands are named (corpus pair, 1 or 2)
ALLOW = ((("R1inv-R2inv", 1), 21), (("DIS-DIS", 1), 22),
         (("IncRNA54-RepZ", 1), 23), (("CopA-CopT", 2), 24))  # strand, seed
ALLOW_P = 0.6             # share of allowed (i, j) cells before symmetry
HELIX = ((("Tar-Tarstar", 1), 7), (("DIS-DIS", 1), 11),
         (("RyhB-SodB", 1), 13), (("MicA-ompA", 2), 17))
LOSS = (("Tar-Tarstar", 1), ("R1inv-R2inv", 2), ("DIS-DIS", 1),
        ("IncRNA54-RepZ", 1))
LOSS_WEIGHTS = ((1.0, 1.0), (0.7, 0.7))             # fp, fn
SAMPLES = (("R1inv-R2inv", 1), ("DIS-DIS", 1))
NUM_SAMPLES, SAMPLE_SEED = 200, 42
TOP = 64
ALL_PARTS = "abcde"


def strand(pair: str, k: int) -> str:
    from ractip_tpu.evaluate.corpus import corpus_pairs
    fa = next((a, b) for n, a, b in corpus_pairs() if n == pair)[k - 1]
    return fa.seq


def true_mapping(pair: str, k: int) -> list:
    """The curated structure's "()" pairs of one strand as a mapping."""
    from ractip_tpu.evaluate.corpus import load_answers
    br = load_answers()[pair][k - 1][2]
    mp, stack = [-1] * len(br), []
    for i, c in enumerate(br):
        if c == "(":
            stack.append(i)
        elif c == ")":
            j = stack.pop()
            mp[i], mp[j] = j, i
    return mp


def helix_weights(seed: int):
    """tests/test_contrafold.py::_helix_weights."""
    rng = np.random.default_rng(seed)
    la = rng.normal(0, 0.25, size=31)
    iso = float(rng.normal(0, 0.5))
    return la, iso


def allow_mask(L: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((L, L)) < ALLOW_P


def _top(m, k: int = TOP) -> list:
    m = np.asarray(m, np.float64)
    flat = np.argsort(-m, axis=None, kind="stable")[:k]
    i, j = np.unravel_index(flat, m.shape)
    return [[int(a), int(b), float(m[a, b])] for a, b in zip(i, j)]


def _ints(a) -> list:
    return [int(x) for x in np.asarray(a)]


def _encoded(pair, k):
    from ractip_tpu.ops.seq import bucket_length, encode
    seq = strand(pair, k)
    L = bucket_length(len(seq))
    return seq, len(seq), L, encode(seq, L)


def _viterbi(pair, k):
    from ractip_tpu.ops.contrafold import (cf_base_pair_probs, cf_mea,
                                           cf_viterbi)
    seq, n, L, S = _encoded(pair, k)
    score, mapping = cf_viterbi(S, n)
    bpp = cf_base_pair_probs(S, n)
    return dict(pair=pair, strand=k, seq=seq, n=n, L=L, score=float(score),
                mapping=_ints(mapping), mea6=_ints(cf_mea(bpp, n, 6.0)),
                mea1=_ints(cf_mea(bpp, n, 1.0)))


def _allow(pair, k, seed):
    from ractip_tpu.ops.contrafold import (cf_base_pair_probs, cf_logz,
                                           cf_viterbi)
    seq, n, L, S = _encoded(pair, k)
    al = allow_mask(L, seed)
    score, mapping = cf_viterbi(S, n, allow=al)
    return dict(pair=pair, strand=k, seq=seq, n=n, L=L, seed=seed, p=ALLOW_P,
                allow=np.packbits(al).tobytes().hex(),
                logz=float(cf_logz(S, n, allow=al)),
                bpp_top=_top(cf_base_pair_probs(S, n, allow=al)),
                score=float(score), mapping=_ints(mapping))


def _helix(pair, k, seed):
    from ractip_tpu.ops.contrafold import (cf_base_pair_probs,
                                           cf_helix_features, cf_logz,
                                           cf_viterbi)
    seq, n, L, S = _encoded(pair, k)
    la, iso = helix_weights(seed)
    h = cf_helix_features(la, iso)
    score, mapping = cf_viterbi(S, n, helix=h)
    return dict(pair=pair, strand=k, seq=seq, n=n, L=L, seed=seed,
                length_at_least=[float(x) for x in la], isolated=iso,
                logz=float(cf_logz(S, n, helix=h)),
                bpp_top=_top(cf_base_pair_probs(S, n, helix=h)),
                score=float(score), mapping=_ints(mapping))


def _loss(pair, k):
    from ractip_tpu.ops.contrafold import (cf_loss_augmented_viterbi,
                                           cf_margin)
    seq, n, L, S = _encoded(pair, k)
    mt = true_mapping(pair, k)
    runs = []
    for fp, fn in LOSS_WEIGHTS:
        aug, score, mapping = cf_loss_augmented_viterbi(S, n, mt, fp, fn)
        runs.append(dict(fp=fp, fn=fn, augmented=float(aug),
                         score=float(score), mapping=_ints(mapping),
                         margin=float(cf_margin(S, n, mt, fp, fn))))
    return dict(pair=pair, strand=k, seq=seq, n=n, L=L, true=mt, runs=runs)


def _samples(pair, k):
    from ractip_tpu.ops.contrafold import cf_stochastic_traceback
    seq, n, L, S = _encoded(pair, k)
    out = cf_stochastic_traceback(S, n, NUM_SAMPLES, seed=SAMPLE_SEED)
    return dict(pair=pair, strand=k, seq=seq, n=n, L=L, seed=SAMPLE_SEED,
                samples=[_ints(m) for m in out])


CHILD = {"viterbi": _viterbi, "allow": _allow, "helix": _helix,
         "loss": _loss, "samples": _samples}


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
        out["seconds"] = time.perf_counter() - t0
        print(f"  {spec[0]} {json.dumps(spec[1])}: {out['seconds']:.1f} s",
              flush=True)
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
    from ractip_tpu.evaluate.corpus import corpus_pairs
    gold = {"generator": "tools/make_torch_decode_golden.py",
            "jax_backend": jax.default_backend(), "jax_enable_x64": True}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            gold.update({k: v for k, v in json.load(fh).items()
                         if k not in gold})

    specs, keys = [], []

    def add(part, key, spec):
        if part in parts:
            specs.append(spec)
            keys.append(key)

    # the slowest first: the helix grammar at L=160, then the long strands
    for (pair, k), seed in reversed(HELIX):
        add("c", "helix", ("helix", dict(pair=pair, k=k, seed=seed)))
    for name, _, _ in corpus_pairs():
        for k in (1, 2):
            add("a", "viterbi", ("viterbi", dict(pair=name, k=k)))
    for (pair, k), seed in ALLOW:
        add("b", "allow", ("allow", dict(pair=pair, k=k, seed=seed)))
    for pair, k in LOSS:
        add("d", "loss", ("loss", dict(pair=pair, k=k)))
    for pair, k in SAMPLES:
        add("e", "samples", ("samples", dict(pair=pair, k=k)))

    t0 = time.perf_counter()
    got = _spawn(args.jobs, specs)
    fresh: dict = {}
    for key, out in zip(keys, got):
        fresh.setdefault(key, []).append(out)
    gold.update(fresh)
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
