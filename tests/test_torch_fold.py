"""Port fold (ractip_tpu_torch.ops.scan) vs the JAX Pallas fold.

The same seeded batch runs through the port's plain versions of K1-K3 and
through ractip_tpu.ops.scan_pallas in interpret mode.  Tolerances are the
JAX package's own kernel-vs-jnp ones (tests/test_scan_pallas.py): inside
states rtol 2e-5, posteriors and outer weights rtol 5e-5 / atol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.ops import mccaskill as mc
from ractip_tpu.ops import scan_pallas as sp
from ractip_tpu.ops.seq import encode
from ractip_tpu.params.boltz import get_boltz
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.ops import scan as ts
from ractip_tpu_torch.params.boltz import tables_to_torch

torch.set_num_threads(2)

L = 32
B = 8


def _batch(seed, B=B, L=L, nmin=12):
    rng = np.random.default_rng(seed)
    ns = rng.integers(nmin, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns]).astype(np.int32)
    return S, ns


@pytest.fixture(scope="module")
def params():
    return get_default_params()


def test_batch_inside_matches_pallas(params):
    S, n = _batch(0)
    bt = get_boltz(params)
    es = np.full(B, mc.SCALE_E0, np.float32)
    ref, _, _ = sp.batch_inside(bt, jnp.asarray(S), jnp.asarray(n),
                                jnp.asarray(es), b_blk=8, interpret=True)
    tt = tables_to_torch(bt, "cpu")
    got, _, _ = ts.batch_inside(tt, torch.from_numpy(S).long(),
                                torch.from_numpy(n).long(),
                                torch.from_numpy(es))
    for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(ref, k)),
                                   rtol=2e-5, atol=1e-30, err_msg=k)
    np.testing.assert_array_equal(got["sat"].numpy(), np.asarray(ref.sat))


def test_batch_fold_matches_pallas(params):
    S, n = _batch(1)
    ref = sp.batch_fold(params, jnp.asarray(S), jnp.asarray(n), b_blk=8,
                        interpret=True)
    got = ts.batch_fold(params, S, n, device="cpu")
    np.testing.assert_allclose(got["es"].numpy(), np.asarray(ref["es"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["bpp"].numpy(), np.asarray(ref["bpp"]),
                               rtol=5e-5, atol=1e-12)
    np.testing.assert_allclose(got["ob"].numpy(), np.asarray(ref["ob"]),
                               rtol=5e-5, atol=1e-25)
    assert float(got["bpp"].max()) <= 1.0 + 1e-4
    assert float(got["bpp"].min()) >= 0.0


def test_batch_fold_rescales_like_pallas(params):
    """A start energy far from range drives the adaptive loop; the port must
    land on the same per-instance scale energies as the JAX loop."""
    S, n = _batch(2, B=4)
    ref = sp.batch_fold(params, jnp.asarray(S), jnp.asarray(n), b_blk=4,
                        interpret=True, es0=400.0)
    got = ts.batch_fold(params, S, n, device="cpu", es0=400.0)
    np.testing.assert_allclose(got["es"].numpy(), np.asarray(ref["es"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["bpp"].numpy(), np.asarray(ref["bpp"]),
                               rtol=5e-5, atol=1e-12)


def test_q2_plain_matches_pallas():
    rng = np.random.default_rng(3)
    qbe = np.triu(rng.uniform(0, 2, (4, L, L)), 4).astype(np.float32)
    sig = rng.uniform(0.6, 0.9, 4).astype(np.float32)
    n = np.array([L, 20, 13, 31], np.int32)
    ref = sp.q2_pallas(jnp.asarray(qbe), jnp.asarray(sig)[:, None],
                       jnp.asarray(n)[:, None], L, 4, 4, interpret=True)
    got = ts.q2(torch.from_numpy(qbe), torch.from_numpy(sig),
                torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)
