"""Port cofold (ractip_tpu_torch.ops.cofold) vs the JAX Pallas cofold.

The same seeded two-strand batch runs through the port's plain versions of
K4/K5 (and K3) and through ractip_tpu.ops.cofold_pallas in interpret mode.
Tolerances are the JAX package's own (tests/test_cofold_pallas.py): inside
states rtol 3e-5, bpp and hp rtol 1e-4 / atol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.ops import cofold_pallas as cp
from ractip_tpu.ops import mccaskill as mc
from ractip_tpu.ops.seq import encode
from ractip_tpu.params.boltz import get_boltz
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.ops import cofold as tc
from ractip_tpu_torch.params.boltz import tables_to_torch

torch.set_num_threads(2)

L1 = L2 = 16
B = 4


def _batch(seed, B=B, nmin=8):
    rng = np.random.default_rng(seed)
    n1 = rng.integers(nmin, L1 + 1, B).astype(np.int32)
    n2 = rng.integers(nmin, L2 + 1, B).astype(np.int32)
    S1 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L1)
                   for m in n1]).astype(np.int32)
    S2 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L2)
                   for m in n2]).astype(np.int32)
    return S1, S2, n1, n2


@pytest.fixture(scope="module")
def params():
    return get_default_params()


def test_pack_concat_matches_jax():
    S1, S2, n1, _ = _batch(5)
    ref = cp._pack_concat(jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(n1))
    got = tc._pack_concat(torch.from_numpy(S1).long(),
                          torch.from_numpy(S2).long(),
                          torch.from_numpy(n1).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_co_inside_matches_pallas(params):
    S1, S2, n1, n2 = _batch(0)
    bt = get_boltz(params)
    es = np.full(B, mc.SCALE_E0, np.float32)
    S = cp._pack_concat(jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(n1))
    ref, _, _, _ = cp._co_inside_once(
        bt, S, jnp.asarray(n1 + n2), jnp.asarray(n1), jnp.asarray(es), 4,
        True, None, emit_state=True)
    tt = tables_to_torch(bt, "cpu")
    St = torch.from_numpy(np.array(S)).long()
    n1t = torch.from_numpy(n1).long()
    got, _, _ = tc._co_inside_once(tt, St, n1t + torch.from_numpy(n2).long(),
                                   n1t, torch.from_numpy(es))
    for k in ("qb", "qm", "qm1", "qx", "q1", "q2", "zn"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(getattr(ref, k)),
                                   rtol=3e-5, atol=1e-30, err_msg=k)


def test_batch_cofold_bpp_hp_matches_pallas(params):
    """Random per-instance cuts (n1 differs across the batch)."""
    S1, S2, n1, n2 = _batch(1)
    assert len(set(n1.tolist())) > 1
    ref = cp.batch_cofold(params, jnp.asarray(S1), jnp.asarray(S2),
                          jnp.asarray(n1), jnp.asarray(n2), b_blk=4,
                          interpret=True)
    got = tc.batch_cofold(params, S1, S2, n1, n2, device="cpu")
    np.testing.assert_allclose(got["es"].numpy(), np.asarray(ref["es"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["bpp"].numpy(), np.asarray(ref["bpp"]),
                               rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(got["hp"].numpy(), np.asarray(ref["hp"]),
                               rtol=1e-4, atol=1e-10)
