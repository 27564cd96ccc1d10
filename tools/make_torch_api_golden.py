#!/usr/bin/env python
"""Write tests/data/torch_port_golden_api.npz from the JAX package on the CPU.

The golden file holds the outputs of the JAX package's single-call DP
functions, which the port's counterparts (ractip_tpu_torch.ops.mccaskill,
ops.accessibility, ops.cofold, ops.duplex) must reproduce:

  ractip_tpu/ops/mccaskill.py      fold, log_partition, base_pair_probs
  ractip_tpu/ops/accessibility.py  accessibility (max_w 15)
  ractip_tpu/ops/cofold.py         cofold, cofold_hybrid_probs, co_factors
  ractip_tpu/ops/duplex.py         duplex, hybrid_probs (the jnp sweep)

on two seeded strands, A (bucket 32) and B (bucket 64), and one seeded pair
P (L1 = L2 = 32), in float32 with x64 off (the JAX defaults): the scale
energy adapted and pinned (scale_e = SCALE_E), a seeded `allow` mask, and
cofold_hybrid_probs and co_factors at span_loop_penalty None, 0.5 and inf.
Keys are "<case>__<field>"; the inputs are stored as "A__S", "A__n",
"A__allow", "P__S1", "P__allow" and so on.

Each case runs in a child process of its own, up to --jobs at a time: this
jaxlib's XLA:CPU compile path fails after a few compiles in one process
(tests/conftest.py), and every call compiles its DP loops anew.

Usage:  JAX_PLATFORMS=cpu python tools/make_torch_api_golden.py [--jobs 6]
        [--cases fold_A,...]   (recompute only these; the others are kept)
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
sys.path.insert(0, ROOT)
PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_api.npz")
SCALE_E = 160.0
MAX_W = 15

# case -> (function, input set, keyword arguments)
CASES = {
    "fold_A": ("fold", "A", {}),
    "fold_A_scale": ("fold", "A", {"scale_e": SCALE_E}),
    "fold_A_allow": ("fold", "A", {"allow": True}),
    "fold_B": ("fold", "B", {}),
    "logz_A": ("log_partition", "A", {}),
    "logz_B": ("log_partition", "B", {}),
    "bpp_B": ("base_pair_probs", "B", {}),
    "bpp_B_allow": ("base_pair_probs", "B", {"allow": True}),
    "acc_A": ("accessibility", "A", {}),
    "acc_A_scale_allow": ("accessibility", "A",
                          {"scale_e": SCALE_E, "allow": True}),
    "acc_B": ("accessibility", "B", {}),
    "cofold_P": ("cofold", "P", {}),
    "cofold_P_scale": ("cofold", "P", {"scale_e": SCALE_E}),
    "cofold_P_allow": ("cofold", "P", {"allow": True}),
    "hp_P": ("cofold_hybrid_probs", "P", {}),
    "hp_P_span05": ("cofold_hybrid_probs", "P", {"span_loop_penalty": 0.5}),
    "hp_P_spaninf": ("cofold_hybrid_probs", "P",
                     {"span_loop_penalty": np.inf}),
    "cofactors_P": ("co_factors", "P", {}),
    "duplex_P": ("duplex", "P", {}),
    "hyb_P": ("hybrid_probs", "P", {}),
}


def inputs() -> dict[str, np.ndarray]:
    """The seeded strands A, B, the pair P and their allow masks."""
    from ractip_tpu.ops.seq import encode
    out = {}
    for name, seed, L, n in (("A", 21, 32, 29), ("B", 22, 64, 58)):
        rng = np.random.default_rng(seed)
        out[f"{name}__S"] = encode("".join(rng.choice(list("ACGU"), n)),
                                   L).astype(np.int32)
        out[f"{name}__n"] = np.int32(n)
        out[f"{name}__allow"] = rng.random((L, L)) < 0.75
    rng = np.random.default_rng(23)
    for k, n in (("1", 27), ("2", 30)):
        out[f"P__S{k}"] = encode("".join(rng.choice(list("ACGU"), n)),
                                 32).astype(np.int32)
        out[f"P__n{k}"] = np.int32(n)
    out["P__allow"] = rng.random((64, 64)) < 0.75
    return out


def _state(prefix, st) -> dict[str, np.ndarray]:
    return {f"{prefix}{k}": np.asarray(v) for k, v in st._asdict().items()}


def run_case(case: str) -> dict[str, np.ndarray]:
    import jax.numpy as jnp
    from ractip_tpu.ops import accessibility as ja
    from ractip_tpu.ops import cofold as jc
    from ractip_tpu.ops import duplex as jd
    from ractip_tpu.ops import mccaskill as jm
    from ractip_tpu.params.boltz import get_boltz
    from ractip_tpu.params.tables import get_default_params
    params = get_default_params()
    fn, which, kw = CASES[case]
    x = {k.split("__")[1]: jnp.asarray(v) for k, v in inputs().items()
         if k.startswith(which + "__")}
    kw = dict(kw)
    if kw.pop("allow", False):
        kw["allow"] = x["allow"]
    f32 = jnp.float32
    if which in ("A", "B"):
        args = (params, x["S"], x["n"])
        if fn == "fold":
            ins, out = jm.fold(*args, f32, **kw)
            return {**_state("ins_", ins), **_state("out_", out)}
        if fn == "log_partition":
            return {"logz": np.asarray(jm.log_partition(*args, f32))}
        if fn == "base_pair_probs":
            return {"bpp": np.asarray(jm.base_pair_probs(*args, f32, **kw))}
        return {"pu": np.asarray(ja.accessibility(*args, MAX_W, f32, **kw))}
    args = (params, x["S1"], x["S2"], x["n1"], x["n2"], f32)
    if fn == "cofold":
        ins, out = jc.cofold(*args, **kw)
        return {**_state("ins_", ins), **_state("out_", out)}
    if fn == "cofold_hybrid_probs":
        return {"hp": np.asarray(jc.cofold_hybrid_probs(*args, **kw))}
    if fn == "co_factors":
        bt = get_boltz(params)
        S = jnp.where(jnp.arange(64) < x["n1"],
                      jnp.concatenate([x["S1"], jnp.zeros(32, x["S1"].dtype)]),
                      jnp.roll(jnp.concatenate(
                          [x["S2"], jnp.zeros(32, x["S2"].dtype)]), x["n1"]))
        out = {"S": np.asarray(S)}
        for tag, pen in (("none", None), ("span05", 0.5), ("spaninf", np.inf)):
            ff = jc.co_factors(bt, S, x["n1"] + x["n2"], x["n1"], f32,
                               span_loop_penalty=pen)
            out.update(_state(f"{tag}_", ff))
        return out
    if fn == "duplex":
        r = jd.duplex(*args, use_pallas=False)
        return {"pr": np.asarray(r.pr), "log_zd": np.asarray(r.log_zd)}
    return {"pr": np.asarray(jd.hybrid_probs(*args, use_pallas=False))}


def _spawn(case: str) -> tuple[str, dict, float]:
    t0 = time.time()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "PYTHONPATH": ROOT}
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "out.npz")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", case, "--out", dst], env=env,
                              capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            raise RuntimeError(f"case {case}: {proc.stderr[-3000:]}")
        with np.load(dst) as z:
            out = {k: z[k] for k in z.files}
    return case, out, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        np.savez(args.out, **run_case(args.child))
        return 0
    cases = [c for c in args.cases.split(",") if c]
    for c in cases:
        if c not in CASES:
            raise SystemExit(f"unknown case {c!r}")
    gold = {}
    if os.path.exists(PATH):
        with np.load(PATH) as z:
            gold = {k: z[k] for k in z.files
                    if k.split("__")[0] not in cases}
    gold.update(inputs())
    with ThreadPoolExecutor(args.jobs) as ex:
        for case, out, sec in ex.map(_spawn, cases):
            print(f"{case}: {sec:.1f} s", flush=True)
            gold.update({f"{case}__{k}": v for k, v in out.items()})
    np.savez_compressed(PATH, **gold)
    print(f"wrote {PATH}: {os.path.getsize(PATH)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
