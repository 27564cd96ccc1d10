"""Port factor matrices (ractip_tpu_torch.ops.factors) vs the JAX package.

The same seeded batch goes through the port's gather form and the JAX
package's bilinear form (ops/factors_mm.py), which is exact against its
own gather form; every field must agree to rtol 1e-6 (f32 rounding of the
sigma powers and table products), without and with a -c pair mask
(`allow`, seeded random, a whole banned row and column included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.ops.factors_mm import co_factors_mm, fold_factors_mm
from ractip_tpu.ops.seq import encode
from ractip_tpu.params.boltz import get_boltz
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.ops.factors import co_factors, fold_factors
from ractip_tpu_torch.params.boltz import tables_to_torch

torch.set_num_threads(2)

L = 32
B = 4


def _batch(seed, L=L, B=B, nmin=12):
    rng = np.random.default_rng(seed)
    ns = rng.integers(nmin, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns]).astype(np.int32)
    sig = np.exp(-rng.uniform(150.0, 220.0, B) / get_boltz(
        get_default_params()).kt).astype(np.float32)
    return S, ns, sig


def _allow(seed, S):
    """Seeded random symmetric pair masks [B, L, L], one base banned whole."""
    rng = np.random.default_rng(seed)
    B, L = S.shape
    a = rng.random((B, L, L)) < 0.7
    a = a & a.transpose(0, 2, 1)
    a[:, 3, :] = a[:, :, 3] = False
    return a


def _check(got, ref):
    assert got._fields == ref._fields
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


@pytest.fixture(scope="module")
def bt():
    return get_boltz(get_default_params())


def test_fold_factors_match_factors_mm(bt):
    S, n, sig = _batch(0)
    ref = jax.vmap(lambda s, m, sg: fold_factors_mm(bt, s, m, sg))(
        jnp.asarray(S), jnp.asarray(n), jnp.asarray(sig, jnp.float32))
    tt = tables_to_torch(bt, "cpu", torch.float32)
    got = fold_factors(tt, torch.from_numpy(S), torch.from_numpy(n),
                       torch.from_numpy(sig))
    _check(got, ref)
    al = _allow(10, S)
    ref = jax.vmap(lambda s, m, sg, a: fold_factors_mm(bt, s, m, sg, a))(
        jnp.asarray(S), jnp.asarray(n), jnp.asarray(sig, jnp.float32),
        jnp.asarray(al))
    got = fold_factors(tt, torch.from_numpy(S), torch.from_numpy(n),
                       torch.from_numpy(sig), torch.from_numpy(al))
    _check(got, ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_co_factors_match_co_factors_mm(bt, seed):
    S, n, sig = _batch(seed)
    cut = np.maximum(n // 2, 1).astype(np.int32)
    ref = jax.vmap(lambda s, m, c, sg: co_factors_mm(bt, s, m, c, sg))(
        jnp.asarray(S), jnp.asarray(n), jnp.asarray(cut),
        jnp.asarray(sig, jnp.float32))
    tt = tables_to_torch(bt, "cpu", torch.float32)
    got = co_factors(tt, torch.from_numpy(S), torch.from_numpy(n),
                     torch.from_numpy(cut), torch.from_numpy(sig))
    _check(got, ref)
    al = _allow(10 + seed, S)
    ref = jax.vmap(lambda s, m, c, sg, a: co_factors_mm(bt, s, m, c, sg, a))(
        jnp.asarray(S), jnp.asarray(n), jnp.asarray(cut),
        jnp.asarray(sig, jnp.float32), jnp.asarray(al))
    got = co_factors(tt, torch.from_numpy(S), torch.from_numpy(n),
                     torch.from_numpy(cut), torch.from_numpy(sig),
                     torch.from_numpy(al))
    _check(got, ref)
