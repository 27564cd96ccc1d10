"""Port fold (ractip_tpu_torch.ops.scan, ops.mccaskill) vs the JAX fold.

The same seeded batch runs through the port's plain versions of K1-K3 and
through ractip_tpu.ops.scan_pallas in interpret mode.  Tolerances are the
JAX package's own kernel-vs-jnp ones (tests/test_scan_pallas.py): inside
states rtol 2e-5, posteriors and outer weights rtol 5e-5 / atol 1e-12.

The JAX half of each comparison is read from
tests/data/torch_port_golden_fold.npz (tools/make_torch_test_golden.py,
the same seeded inputs and calls, stored beside their outputs); each test
first asserts that its own seeded inputs equal the stored ones.  The
single-strand calls fold, log_partition and base_pair_probs are held
against the JAX package's (ractip_tpu/ops/mccaskill.py) in
tests/data/torch_port_golden_api.npz (tools/make_torch_api_golden.py)."""

import os

import numpy as np
import torch

from ractip_tpu_torch.ops import mccaskill as tm
from ractip_tpu_torch.ops import scan as ts
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.boltz import get_boltz, tables_to_torch
from ractip_tpu_torch.params.tables import get_default_params

torch.set_num_threads(2)

L = 32
B = 8
SCALE_E0 = ts.SCALE_E0
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLD = dict(np.load(os.path.join(DATA, "torch_port_golden_fold.npz")))
API = dict(np.load(os.path.join(DATA, "torch_port_golden_api.npz")))


def _jax(tag, **inputs):
    """The JAX package's outputs of `tag` on inputs, from the golden file,
    once the inputs are seen to equal the stored ones."""
    for k, v in inputs.items():
        np.testing.assert_array_equal(v, GOLD[f"{tag}_{k}"], err_msg=k)
    return {k[len(tag) + 1:]: v for k, v in GOLD.items()
            if k.startswith(tag + "_")}


def _batch(seed, B=B, L=L, nmin=12):
    rng = np.random.default_rng(seed)
    ns = rng.integers(nmin, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns]).astype(np.int32)
    return S, ns


def test_batch_inside_matches_pallas():
    S, n = _batch(0)
    es = np.full(B, SCALE_E0, np.float32)
    ref = _jax("inside", S=S, n=n, es=es)
    tt = tables_to_torch(get_boltz(get_default_params()), "cpu")
    got, _, _ = ts.batch_inside(tt, torch.from_numpy(S).long(),
                                torch.from_numpy(n).long(),
                                torch.from_numpy(es))
    for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=2e-5,
                                   atol=1e-30, err_msg=k)
    np.testing.assert_array_equal(got["sat"].numpy(), ref["sat"])


def test_batch_fold_matches_pallas():
    S, n = _batch(1)
    ref = _jax("fold", S=S, n=n, es0=SCALE_E0)
    got = ts.batch_fold(get_default_params(), S, n, device="cpu")
    np.testing.assert_allclose(got["es"].numpy(), ref["es"], rtol=1e-6)
    np.testing.assert_allclose(got["bpp"].numpy(), ref["bpp"], rtol=5e-5,
                               atol=1e-12)
    np.testing.assert_allclose(got["ob"].numpy(), ref["ob"], rtol=5e-5,
                               atol=1e-25)
    assert float(got["bpp"].max()) <= 1.0 + 1e-4
    assert float(got["bpp"].min()) >= 0.0
    _api_single_strand_calls()


def test_batch_fold_rescales_like_pallas():
    """A start energy far from range drives the adaptive loop; the port must
    land on the same per-instance scale energies as the JAX loop."""
    S, n = _batch(2, B=4)
    ref = _jax("rescale", S=S, n=n, es0=400.0)
    got = ts.batch_fold(get_default_params(), S, n, device="cpu", es0=400.0)
    np.testing.assert_allclose(got["es"].numpy(), ref["es"], rtol=1e-5)
    np.testing.assert_allclose(got["bpp"].numpy(), ref["bpp"], rtol=5e-5,
                               atol=1e-12)


def test_q2_plain_matches_pallas():
    rng = np.random.default_rng(3)
    qbe = np.triu(rng.uniform(0, 2, (4, L, L)), 4).astype(np.float32)
    sig = rng.uniform(0.6, 0.9, 4).astype(np.float32)
    n = np.array([L, 20, 13, 31], np.int32)
    ref = _jax("q2", qbe=qbe, sig=sig, n=n)
    got = ts.q2(torch.from_numpy(qbe), torch.from_numpy(sig),
                torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), ref["q2"], rtol=2e-6)


def _strand(name):
    return API[f"{name}__S"], int(API[f"{name}__n"])


def _api_single_strand_calls():
    """fold (adapted, scale_e pinned, under an allow mask), log_partition
    and base_pair_probs on strands of 32 and 64 bases against the JAX
    package's (jnp, float32), at the jnp-vs-Pallas tolerances above;
    ln Z to atol 2e-5 (zn's rtol 2e-5)."""
    params = get_default_params()
    for case, name, kw in (("fold_A", "A", {}),
                           ("fold_A_scale", "A", {"scale_e": 160.0}),
                           ("fold_A_allow", "A", {"allow": API["A__allow"]}),
                           ("fold_B", "B", {})):
        ins, out = tm.fold(params, *_strand(name), device="cpu", **kw)
        for k in ("qb", "qm", "qm1", "qm2", "q1", "q2", "zn"):
            np.testing.assert_allclose(getattr(ins, k).numpy(),
                                       API[f"{case}__ins_{k}"], rtol=2e-5,
                                       atol=1e-30, err_msg=f"{case} {k}")
        assert bool(ins.sat) == bool(API[f"{case}__ins_sat"])
        np.testing.assert_allclose(out.bpp.numpy(), API[f"{case}__out_bpp"],
                                   rtol=5e-5, atol=1e-12, err_msg=case)
        np.testing.assert_allclose(out.ob.numpy(), API[f"{case}__out_ob"],
                                   rtol=5e-5, atol=1e-25, err_msg=case)
    for name in ("A", "B"):
        got = tm.log_partition(params, *_strand(name), device="cpu")
        assert got.shape == ()
        assert abs(float(got) - float(API[f"logz_{name}__logz"])) <= 2e-5
    for case, kw in (("bpp_B", {}), ("bpp_B_allow",
                                     {"allow": API["B__allow"]})):
        got = tm.base_pair_probs(params, *_strand("B"), device="cpu", **kw)
        np.testing.assert_allclose(got.numpy(), API[f"{case}__bpp"],
                                   rtol=5e-5, atol=1e-12, err_msg=case)
