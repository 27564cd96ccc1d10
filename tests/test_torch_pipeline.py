"""Port slice end to end (ractip_tpu_torch.pipeline.batched) vs the JAX package.

predict_batch on seeded random pairs must give the JAX predict_batch's
brackets exactly and its objectives within 1e-4 (the certify step makes
the final objectives exact; tests/test_batched_pallas.py's protocol).
zscore_batch with seeded decoys must give the same per-decoy energies
(which are functions of the decoded brackets) and z, zs within 1e-3.

The JAX side runs in one child process: at chunk=1 with energies on, a
single compiled JAX pipeline serves the z-score's real pair, its decoys
and both predicted pairs (one ~90 s CPU compile instead of two), and the
worker that runs this test keeps the JAX compile history the JAX tests
see (tests/conftest.py describes the jaxlib compile-path crash).
The duplex model (use_pf_duplex) is held against the JAX golden file
tests/data/torch_port_golden_duplex.json (tools/make_torch_duplex_golden.py).
The port never imports jax nor the JAX package: a subprocess runs the CPU
slices and checks."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ractip_tpu.io.fasta import Fasta
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.evaluate.corpus import record
from ractip_tpu_torch.pipeline import batched as tb
from ractip_tpu_torch.pipeline.options import Options

torch.set_num_threads(2)

BUCKETS = (32, 32, 32, 64, 64)
ITERS = 400
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DUPLEX = os.path.join(ROOT, "tests", "data",
                             "torch_port_golden_duplex.json")

_JAX_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    from ractip_tpu.io.fasta import Fasta
    from ractip_tpu.params.tables import get_default_params
    from ractip_tpu.pipeline import batched as jb
    from ractip_tpu.pipeline.ractip import Options
    a = json.loads(sys.argv[1])
    params = get_default_params()
    kw = dict(chunk=1, iters=a["iters"], buckets=tuple(a["buckets"]))
    z, zs, st = jb.zscore_batch(
        Fasta("s1", a["zpair"][0]), Fasta("s2", a["zpair"][1]),
        Options(zscore=12, num_shuffling=a["decoys"], seed=a["seed"]),
        params, **kw)
    r = jb.predict_batch(params, [tuple(p) for p in a["pairs"]], Options(),
                         want_energy=True, **kw)
    print(json.dumps(dict(
        z=float(z), zs=float(zs), brackets=list(st["brackets"]),
        decoy_e=np.asarray(st["decoy_e"]).tolist(),
        decoy_es=np.asarray(st["decoy_es"]).tolist(),
        r1=list(r.r1), r2=list(r.r2),
        objective=np.asarray(r.objective).tolist())))
""")


def _pairs(seed, k=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n1, n2 = int(rng.integers(16, 25)), int(rng.integers(16, 25))
        out.append(("".join(rng.choice(list("ACGU"), n1)),
                    "".join(rng.choice(list("ACGU"), n2))))
    return out


def test_predict_and_zscore_batch_match_jax():
    pairs, zpair = _pairs(0), _pairs(4, 1)[0]
    decoys, seed = 8, 3
    arg = json.dumps(dict(pairs=pairs, zpair=zpair, decoys=decoys, seed=seed,
                          iters=ITERS, buckets=BUCKETS))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
           "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, arg],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])

    params = get_default_params()
    got = tb.predict_batch(params, pairs, Options(), iters=ITERS,
                           buckets=BUCKETS, device="cpu")
    assert got.r1 == ref["r1"]
    assert got.r2 == ref["r2"]
    np.testing.assert_allclose(got.objective, ref["objective"], atol=1e-4)
    assert float(np.max(got.violation)) < 0.5

    z, zs, st = tb.zscore_batch(
        Fasta("s1", zpair[0]), Fasta("s2", zpair[1]),
        Options(zscore=12, num_shuffling=decoys, seed=seed), params,
        iters=ITERS, buckets=BUCKETS, device="cpu")
    assert list(st["brackets"]) == ref["brackets"]
    np.testing.assert_allclose(st["decoy_e"], ref["decoy_e"], atol=1e-9)
    np.testing.assert_allclose(st["decoy_es"], ref["decoy_es"], atol=1e-9)
    assert abs(z - ref["z"]) < 1e-3 and abs(zs - ref["zs"]) < 1e-3


def test_duplex_slice_matches_golden():
    """--duplex on the CPU: corpus pairs and the 8-decoy seeded z-score.

    The golden ran the JAX package at iters=3000; the certify step proves
    every returned structure optimal, so 200 PDHG iterations give the same
    brackets (objectives within 1e-4) and the same decoy energies."""
    with open(GOLDEN_DUPLEX) as fh:
        gold = json.load(fh)
    params = get_default_params()
    opts = Options(use_pf_duplex=True)
    gp = [p for p in gold["corpus"]["pairs"]
          if p["name"] in ("Tar-Tarstar", "R1inv-R2inv")]
    got = tb.predict_batch(params, [(p["seq1"], p["seq2"]) for p in gp],
                           opts, iters=200, device="cpu")
    assert got.r1 == [p["r1"] for p in gp]
    assert got.r2 == [p["r2"] for p in gp]
    np.testing.assert_allclose(got.objective, [p["objective"] for p in gp],
                               atol=1e-4)

    gz = gold["zscore"]["8"]
    z, zs, st = tb.zscore_batch(
        record("CopA.fa"), record("CopT.fa"),
        Options(zscore=12, num_shuffling=gz["num_shuffling"],
                seed=gz["seed"], use_pf_duplex=True), params, iters=200,
        device="cpu")
    assert list(st["brackets"]) == gz["brackets"]
    np.testing.assert_allclose(st["decoy_e"], gz["decoy_e"], atol=1e-9)
    assert abs(z - gz["z"]) < 1e-3 and abs(zs - gz["zs"]) < 1e-3


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from ractip_tpu_torch.params.tables import get_default_params
        from ractip_tpu_torch.pipeline.batched import predict_batch
        from ractip_tpu_torch.pipeline.options import Options
        import ractip_tpu_torch.cli  # noqa: F401
        import ractip_tpu_torch.io.rip  # noqa: F401
        import ractip_tpu_torch.params.vienna_par  # noqa: F401
        import ractip_tpu_torch.utils.records  # noqa: F401
        import ractip_tpu_torch.io.sstruct  # noqa: F401
        from ractip_tpu_torch.evaluate.corpus import evaluate_corpus
        from ractip_tpu_torch.ops.contraduplex import cd_logz
        from ractip_tpu_torch.ops.contrafold import cf_base_pair_probs
        from ractip_tpu_torch.utils.checkpoint import SweepCheckpoint
        from ractip_tpu_torch.io.fasta import Fasta
        from ractip_tpu_torch.pipeline.ractip import predict
        pair = [("GGGAAACCCAGCUAGC", "GCUAGCUGGGUUUCCC")]
        for opts in (Options(), Options(use_pf_duplex=True)):
            r = predict_batch(get_default_params(), pair, opts, iters=100,
                              buckets=(32, 32, 32, 64, 64), device="cpu")
            assert len(r.r1) == 1
            p = predict(Fasta("a", pair[0][0], "((((....))))[[[["),
                        Fasta("b", pair[0][1], "]]]]...x........"),
                        Options(use_constraint=True, show_energy=True,
                                use_pf_duplex=opts.use_pf_duplex),
                        device="cpu")
            assert len(p.r1) == 16
        assert cf_base_pair_probs([1, 2, 3, 4, 1, 2], 6, device="cpu").shape \
            == (6, 6)
        assert float(cd_logz([3, 3, 3], [2, 2, 2], 3, 3, device="cpu")) > 0
        assert evaluate_corpus(lambda a, b: ("." * len(a.seq),
                                             "." * len(b.seq)))["pooled"]
        assert callable(SweepCheckpoint.map_chunks)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "ractip_tpu"))
        assert not bad, bad
        print("NOJAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NOJAX_OK" in r.stdout


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.predict_batch(get_default_params(), _pairs(1, 1), Options(),
                         iters=10, buckets=BUCKETS)
    from ractip_tpu_torch.io.fasta import Fasta as TFasta
    from ractip_tpu_torch.pipeline.ractip import predict
    a, b = _pairs(1, 1)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        predict(TFasta("a", a), TFasta("b", b))
    from ractip_tpu_torch.ops.contraduplex import cd_hybrid_probs
    from ractip_tpu_torch.ops.contrafold import cf_base_pair_probs
    from ractip_tpu_torch.pipeline.options import Options as TOptions
    for call in (lambda: cf_base_pair_probs([1, 2, 3, 4], 4),
                 lambda: cd_hybrid_probs([1, 2], [3, 4], 2, 2),
                 lambda: predict(TFasta("a", a), TFasta("b", b),
                                 TOptions(use_contrafold=True))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
