"""Port accessibility (ractip_tpu_torch.ops.accessibility) vs the JAX package.

pu from the port's batch_fold tables is held against the JAX unpaired_probs
driven by the JAX Pallas batch_fold (interpret mode), to rtol 1e-4 / atol
1e-8 (tests/test_scan_pallas.py's tolerance); the JAX half is read from
tests/data/torch_port_golden_accessibility.npz (tools/
make_torch_test_golden.py), once the seeded inputs are seen to equal the
stored ones.  The single-strand call accessibility (scale_e adapted and
pinned, under an allow mask) is held at the same tolerance against the JAX
package's in tests/data/torch_port_golden_api.npz.  An f64 case pins the DIS
knife edge: up([10,22], w=13) = 0.0037724019032320, the value the f64
constrained-ensemble cross-check measured (tests/test_dis_golden.py)."""

import os

import numpy as np
import pytest
import torch

from ractip_tpu.evaluate.corpus import data_dir_default
from ractip_tpu.io.fasta import load_fasta
from ractip_tpu.ops.seq import bucket_length, encode
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.ops.accessibility import accessibility, unpaired_probs
from ractip_tpu_torch.ops.scan import as_tables, batch_fold

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def params():
    return get_default_params()


def test_unpaired_probs_match_jax(params):
    L, B, max_w = 32, 4, 15
    rng = np.random.default_rng(3)
    n = rng.integers(20, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                  for m in n]).astype(np.int32)
    gold = np.load(os.path.join(DATA, "torch_port_golden_accessibility.npz"))
    np.testing.assert_array_equal(S, gold["S"])
    np.testing.assert_array_equal(n, gold["n"])
    assert max_w == int(gold["max_w"])
    r = batch_fold(params, S, n, device="cpu")
    tt = as_tables(params, "cpu")
    pu = unpaired_probs(tt, r["ff"], r["ins"], r["ob"],
                        torch.from_numpy(n).long(), max_w, r["sig"])
    assert pu.shape == (B, L, max_w + 1)
    np.testing.assert_allclose(pu.numpy(), gold["pu"], rtol=1e-4, atol=1e-8)

    api = np.load(os.path.join(DATA, "torch_port_golden_api.npz"))
    for case, name, kw in (("acc_A", "A", {}),
                           ("acc_A_scale_allow", "A",
                            {"scale_e": 160.0, "allow": api["A__allow"]}),
                           ("acc_B", "B", {})):
        got = accessibility(params, api[f"{name}__S"], int(api[f"{name}__n"]),
                            max_w, device="cpu", **kw)
        assert got.shape == (len(api[f"{name}__S"]), max_w + 1)
        np.testing.assert_allclose(got.numpy(), api[f"{case}__pu"], rtol=1e-4,
                                   atol=1e-8, err_msg=case)


def test_dis_knife_edge_f64(params):
    fa = load_fasta(data_dir_default() + "/DIS.fa")[0]
    m = len(fa.seq)
    S = encode(fa.seq, bucket_length(m))[None].astype(np.int32)
    n = np.array([m], np.int32)
    r = batch_fold(params, S, n, device="cpu", dtype=torch.float64)
    tt = as_tables(params, "cpu", torch.float64)
    pu = unpaired_probs(tt, r["ff"], r["ins"], r["ob"],
                        torch.from_numpy(n).long(), 15, r["sig"])
    assert pu.dtype == torch.float64
    assert float(pu[0, 10, 13]) == pytest.approx(0.0037724019032320,
                                                 rel=1e-9)
