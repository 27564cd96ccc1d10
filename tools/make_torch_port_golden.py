#!/usr/bin/env python
"""Write tests/data/torch_port_golden.json from the JAX package on the CPU.

The golden file holds what the PyTorch port (ractip_tpu_torch) must
reproduce on the GPU, where JAX is not available:

  * the default-option batched ``predict_batch`` brackets and objectives on
    the bundled 8-pair corpus, run as one batch padded to the largest
    buckets (the shape chip_smoke.py's corpus phase uses);
  * ``zscore_batch(CopA, CopT, Options(zscore=12, num_shuffling=N, seed=1))``
    for N = 64 (key ``zscore``) and N = 256 (key ``zscore_256``: one whole
    chunk, the first chunk of the port's 1000-decoy run): z, zs, e, es and
    the per-decoy e and es values.

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py [--out PATH]
        [--pairs NAME ...]   (restrict the corpus to the named pairs)
        [--decoys N ...] [--zscore-only]   (only these z-scores; with
        --zscore-only the file's other entries are kept as they are)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from ractip_tpu import native  # noqa: E402
from ractip_tpu.evaluate.corpus import corpus_pairs, data_dir_default  # noqa: E402
from ractip_tpu.io.fasta import load_fasta  # noqa: E402
from ractip_tpu.params.tables import get_default_params  # noqa: E402
from ractip_tpu.pipeline.batched import predict_batch, zscore_batch  # noqa: E402
from ractip_tpu.pipeline.ractip import Options  # noqa: E402

ZSCORE_DECOYS = (64, 256)
ZSCORE_SEED = 1


def zscore_key(n: int) -> str:
    return "zscore" if n == 64 else f"zscore_{n}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests", "data",
        "torch_port_golden.json"))
    ap.add_argument("--pairs", nargs="*", default=None)
    ap.add_argument("--decoys", nargs="*", type=int, default=ZSCORE_DECOYS)
    ap.add_argument("--zscore-only", action="store_true")
    args = ap.parse_args(argv)

    import jax
    params = get_default_params()
    gold = {"generator": "tools/make_torch_port_golden.py",
            "jax_backend": jax.default_backend(),
            "native_shuffle": bool(native.available())}
    if args.zscore_only:
        with open(args.out) as fh:
            gold = json.load(fh)
    else:
        _corpus(gold, params, args.pairs)
    _zscores(gold, params, args.decoys)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(gold, fh, indent=1)
        fh.write("\n")
    return 0


def _corpus(gold, params, names) -> None:
    recs = [(name, fa1, fa2) for name, fa1, fa2 in corpus_pairs()
            if names is None or name in names]
    pairs = [(fa1.seq, fa2.seq) for _, fa1, fa2 in recs]
    t0 = time.perf_counter()
    res = predict_batch(params, pairs, Options())
    gold["corpus"] = {
        "options": "Options() defaults; predict_batch defaults "
                   "(chunk=256, iters=3000, DEFAULT_BUCKETS, "
                   "exact_gap_tol=1e-4); one batch",
        "seconds": time.perf_counter() - t0,
        "pairs": [dict(name=name, seq1=fa1.seq, seq2=fa2.seq, r1=r1, r2=r2,
                       objective=float(obj))
                  for (name, fa1, fa2), r1, r2, obj in
                  zip(recs, res.r1, res.r2, res.objective)]}
    print(json.dumps(gold["corpus"], indent=1), flush=True)


def _zscores(gold, params, counts) -> None:
    d = data_dir_default()
    fa1 = load_fasta(os.path.join(d, "CopA.fa"))[0]
    fa2 = load_fasta(os.path.join(d, "CopT.fa"))[0]
    for n in counts:
        t0 = time.perf_counter()
        z, zs, st = zscore_batch(fa1, fa2, Options(
            zscore=12, num_shuffling=n, seed=ZSCORE_SEED), params)
        key = zscore_key(n)
        gold[key] = {
            "pair": "CopA-CopT", "num_shuffling": n,
            "seed": ZSCORE_SEED, "seconds": time.perf_counter() - t0,
            "z": float(z), "zs": float(zs), "e": float(st["e"]),
            "es": float(st["es"]), "brackets": list(st["brackets"]),
            "decoy_e": [float(x) for x in np.asarray(st["decoy_e"])],
            "decoy_es": [float(x) for x in np.asarray(st["decoy_es"])]}
        print(json.dumps({k: v for k, v in gold[key].items()
                          if not k.startswith("decoy")}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
