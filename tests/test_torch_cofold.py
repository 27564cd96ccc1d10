"""Port cofold (ractip_tpu_torch.ops.cofold) vs the JAX Pallas cofold.

The same seeded two-strand batch runs through the port's plain versions of
K4/K5 (and K3) and through ractip_tpu.ops.cofold_pallas in interpret mode.
Tolerances are the JAX package's own (tests/test_cofold_pallas.py): inside
states rtol 3e-5, bpp and hp rtol 1e-4 / atol 1e-10.  The JAX half is read
from tests/data/torch_port_golden_cofold.npz (tools/
make_torch_test_golden.py), once the seeded inputs are seen to equal the
stored ones; _pack_concat is compared live.

The single-pair calls cofold (scale_e adapted and pinned, under an allow
mask) and cofold_hybrid_probs (span_loop_penalty None, 0.5 and inf) are
held against the JAX package's jnp cofold (ractip_tpu/ops/cofold.py) in
tests/data/torch_port_golden_api.npz (tools/make_torch_api_golden.py) at
the jnp-vs-Pallas tolerances of tests/test_scan_pallas.py (inside tables
rtol 2e-5, probabilities rtol 5e-5 / atol 1e-12); co_factors at each
penalty to rtol 1e-6 (one float32 rounding of a table product), and
span_loop_penalty=None leaves every factor bit for bit as it was."""

import os

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
from ractip_tpu_torch.ops.factors import co_factors
from ractip_tpu_torch.ops.scan import as_tables
from ractip_tpu_torch.params.boltz import tables_to_torch

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLD = np.load(os.path.join(DATA, "torch_port_golden_cofold.npz"))
API = np.load(os.path.join(DATA, "torch_port_golden_api.npz"))

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


def _same_inputs(tag, **inputs):
    for k, v in inputs.items():
        np.testing.assert_array_equal(v, GOLD[f"{tag}_{k}"], err_msg=k)


def test_co_inside_matches_pallas(params):
    S1, S2, n1, n2 = _batch(0)
    bt = get_boltz(params)
    es = np.full(B, mc.SCALE_E0, np.float32)
    St = tc._pack_concat(torch.from_numpy(S1).long(),
                         torch.from_numpy(S2).long(),
                         torch.from_numpy(n1).long())
    _same_inputs("inside", S1=S1, S2=S2, n1=n1, n2=n2, es=es, S=St.numpy())
    tt = tables_to_torch(bt, "cpu")
    n1t = torch.from_numpy(n1).long()
    got, _, _ = tc._co_inside_once(tt, St, n1t + torch.from_numpy(n2).long(),
                                   n1t, torch.from_numpy(es))
    for k in ("qb", "qm", "qm1", "qx", "q1", "q2", "zn"):
        np.testing.assert_allclose(got[k].numpy(), GOLD[f"inside_{k}"],
                                   rtol=3e-5, atol=1e-30, err_msg=k)
    _api_co_factors()


def _api_co_factors():
    tt = as_tables(get_default_params(), "cpu")
    n1, n2 = int(API["P__n1"]), int(API["P__n2"])
    S = torch.as_tensor(API["cofactors_P__S"]).long()[None]
    n, cut = torch.tensor([n1 + n2]), torch.tensor([n1])
    sig = torch.tensor([tt.bt.sigma], dtype=torch.float32)
    base = co_factors(tt, S, n, cut, sig)
    spans = (torch.arange(64)[:, None] < n1) & (n1 <= torch.arange(64)[None])
    scaled = ("pstk", "p11", "p21a", "p21b", "p22", "pb15", "pb13", "tau",
              "mout")
    for tag, pen in (("none", None), ("span05", 0.5), ("spaninf", np.inf)):
        ff = co_factors(tt, S, n, cut, sig, span_loop_penalty=pen)
        for k in ff._fields:
            got, was = getattr(ff, k)[0], getattr(base, k)[0]
            np.testing.assert_allclose(got.numpy(),
                                       API[f"cofactors_P__{tag}_{k}"],
                                       rtol=1e-6, atol=0, err_msg=(tag, k))
            same = ~spans if (pen is not None and k in scaled) \
                else torch.ones_like(spans)
            assert torch.equal(got[same], was[same]), (tag, k)
            if pen == np.inf and k in scaled:
                assert not got[spans].any(), k


def test_batch_cofold_bpp_hp_matches_pallas(params):
    """Random per-instance cuts (n1 differs across the batch)."""
    S1, S2, n1, n2 = _batch(1)
    assert len(set(n1.tolist())) > 1
    _same_inputs("cofold", S1=S1, S2=S2, n1=n1, n2=n2)
    got = tc.batch_cofold(params, S1, S2, n1, n2, device="cpu")
    np.testing.assert_allclose(got["es"].numpy(), GOLD["cofold_es"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["bpp"].numpy(), GOLD["cofold_bpp"],
                               rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(got["hp"].numpy(), GOLD["cofold_hp"],
                               rtol=1e-4, atol=1e-10)

    pair = [API[k] for k in ("P__S1", "P__S2", "P__n1", "P__n2")]
    for case, kw in (("cofold_P", {}), ("cofold_P_scale", {"scale_e": 160.0}),
                     ("cofold_P_allow", {"allow": API["P__allow"]})):
        ins, out = tc.cofold(params, *pair, device="cpu", **kw)
        for k in ("qb", "qm", "qm1", "qx", "q1", "q2", "zn"):
            np.testing.assert_allclose(getattr(ins, k).numpy(),
                                       API[f"{case}__ins_{k}"], rtol=2e-5,
                                       atol=1e-30, err_msg=f"{case} {k}")
        np.testing.assert_allclose(out.bpp.numpy(), API[f"{case}__out_bpp"],
                                   rtol=5e-5, atol=1e-12, err_msg=case)
    for case, pen in (("hp_P", None), ("hp_P_span05", 0.5),
                      ("hp_P_spaninf", np.inf)):
        hp = tc.cofold_hybrid_probs(params, *pair, span_loop_penalty=pen,
                                    device="cpu")
        assert hp.shape == (32, 32)
        np.testing.assert_allclose(hp.numpy(), API[f"{case}__hp"], rtol=5e-5,
                                   atol=1e-12, err_msg=case)
