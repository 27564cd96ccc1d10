"""Port fold (ractip_tpu_torch.ops.scan) vs the JAX Pallas fold.

The same seeded batch runs through the port's plain versions of K1-K3 and
through ractip_tpu.ops.scan_pallas in interpret mode.  Tolerances are the
JAX package's own kernel-vs-jnp ones (tests/test_scan_pallas.py): inside
states rtol 2e-5, posteriors and outer weights rtol 5e-5 / atol 1e-12.

Each test's JAX half runs in a child process (JAX on the CPU with x64, as
tests/conftest.py sets it up), so the compile history of the worker that
runs it cannot reach the jaxlib compile-path crash that tests/conftest.py
describes; tests/test_torch_pipeline.py does the same."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from ractip_tpu_torch.ops import scan as ts
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.boltz import get_boltz, tables_to_torch
from ractip_tpu_torch.params.tables import get_default_params

torch.set_num_threads(2)

L = 32
B = 8
SCALE_E0 = ts.SCALE_E0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_REFERENCE = textwrap.dedent("""
    import sys
    import jax.numpy as jnp
    import numpy as np
    from ractip_tpu.ops import scan_pallas as sp
    from ractip_tpu.params.boltz import get_boltz
    from ractip_tpu.params.tables import get_default_params
    what, src, dst = sys.argv[1:]
    a = dict(np.load(src))
    params = get_default_params()
    if what == "inside":
        ref, _, _ = sp.batch_inside(
            get_boltz(params), jnp.asarray(a["S"]), jnp.asarray(a["n"]),
            jnp.asarray(a["es"]), b_blk=len(a["n"]), interpret=True)
        out = {k: np.asarray(getattr(ref, k))
               for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn", "sat")}
    elif what == "fold":
        ref = sp.batch_fold(params, jnp.asarray(a["S"]), jnp.asarray(a["n"]),
                            b_blk=len(a["n"]), interpret=True,
                            es0=float(a["es0"]))
        out = {k: np.asarray(ref[k]) for k in ("es", "bpp", "ob")}
    else:
        out = {"q2": np.asarray(sp.q2_pallas(
            jnp.asarray(a["qbe"]), jnp.asarray(a["sig"])[:, None],
            jnp.asarray(a["n"])[:, None], a["qbe"].shape[-1],
            len(a["n"]), len(a["n"]), interpret=True))}
    np.savez(dst, **out)
""")


def _jax(what, tmp_path, **inputs):
    """The JAX package's result for `what` on inputs, from a child process."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
           "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, what,
                           str(src), str(dst)], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


def _batch(seed, B=B, L=L, nmin=12):
    rng = np.random.default_rng(seed)
    ns = rng.integers(nmin, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns]).astype(np.int32)
    return S, ns


def test_batch_inside_matches_pallas(tmp_path):
    S, n = _batch(0)
    es = np.full(B, SCALE_E0, np.float32)
    ref = _jax("inside", tmp_path, S=S, n=n, es=es)
    tt = tables_to_torch(get_boltz(get_default_params()), "cpu")
    got, _, _ = ts.batch_inside(tt, torch.from_numpy(S).long(),
                                torch.from_numpy(n).long(),
                                torch.from_numpy(es))
    for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=2e-5,
                                   atol=1e-30, err_msg=k)
    np.testing.assert_array_equal(got["sat"].numpy(), ref["sat"])


def test_batch_fold_matches_pallas(tmp_path):
    S, n = _batch(1)
    ref = _jax("fold", tmp_path, S=S, n=n, es0=SCALE_E0)
    got = ts.batch_fold(get_default_params(), S, n, device="cpu")
    np.testing.assert_allclose(got["es"].numpy(), ref["es"], rtol=1e-6)
    np.testing.assert_allclose(got["bpp"].numpy(), ref["bpp"], rtol=5e-5,
                               atol=1e-12)
    np.testing.assert_allclose(got["ob"].numpy(), ref["ob"], rtol=5e-5,
                               atol=1e-25)
    assert float(got["bpp"].max()) <= 1.0 + 1e-4
    assert float(got["bpp"].min()) >= 0.0


def test_batch_fold_rescales_like_pallas(tmp_path):
    """A start energy far from range drives the adaptive loop; the port must
    land on the same per-instance scale energies as the JAX loop."""
    S, n = _batch(2, B=4)
    ref = _jax("fold", tmp_path, S=S, n=n, es0=400.0)
    got = ts.batch_fold(get_default_params(), S, n, device="cpu", es0=400.0)
    np.testing.assert_allclose(got["es"].numpy(), ref["es"], rtol=1e-5)
    np.testing.assert_allclose(got["bpp"].numpy(), ref["bpp"], rtol=5e-5,
                               atol=1e-12)


def test_q2_plain_matches_pallas(tmp_path):
    rng = np.random.default_rng(3)
    qbe = np.triu(rng.uniform(0, 2, (4, L, L)), 4).astype(np.float32)
    sig = rng.uniform(0.6, 0.9, 4).astype(np.float32)
    n = np.array([L, 20, 13, 31], np.int32)
    ref = _jax("q2", tmp_path, qbe=qbe, sig=sig, n=n)
    got = ts.q2(torch.from_numpy(qbe), torch.from_numpy(sig),
                torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), ref["q2"], rtol=2e-6)
