"""Port accessibility (ractip_tpu_torch.ops.accessibility) vs the JAX package.

pu from the port's batch_fold tables is held against the JAX unpaired_probs
driven by the JAX Pallas batch_fold (interpret mode), to rtol 1e-4 / atol
1e-8 (tests/test_scan_pallas.py's tolerance).  An f64 case pins the DIS
knife edge: up([10,22], w=13) = 0.0037724019032320, the value the f64
constrained-ensemble cross-check measured (tests/test_dis_golden.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.evaluate.corpus import data_dir_default
from ractip_tpu.io.fasta import load_fasta
from ractip_tpu.ops import mccaskill as mc
from ractip_tpu.ops import scan_pallas as sp
from ractip_tpu.ops.accessibility import unpaired_probs as jax_unpaired
from ractip_tpu.ops.seq import bucket_length, encode
from ractip_tpu.params.boltz import get_boltz
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.ops.accessibility import unpaired_probs
from ractip_tpu_torch.ops.scan import as_tables, batch_fold

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return get_default_params()


def test_unpaired_probs_match_jax(params):
    L, B, max_w = 32, 4, 15
    rng = np.random.default_rng(3)
    n = rng.integers(20, L + 1, B).astype(np.int32)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                  for m in n]).astype(np.int32)
    bt = get_boltz(params)
    res = sp.batch_fold(params, jnp.asarray(S), jnp.asarray(n), b_blk=4,
                        interpret=True)
    ref = jax.vmap(lambda ff, ins, ob, sig, m: jax_unpaired(
        ff, bt, ins, mc.OutsideState(ob=ob, bpp=ob), m, max_w, jnp.float32,
        sig))(res["ff"], res["ins"], res["ob"], res["sig"], jnp.asarray(n))
    r = batch_fold(params, S, n, device="cpu")
    tt = as_tables(params, "cpu")
    pu = unpaired_probs(tt, r["ff"], r["ins"], r["ob"],
                        torch.from_numpy(n).long(), max_w, r["sig"])
    assert pu.shape == (B, L, max_w + 1)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-8)


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
