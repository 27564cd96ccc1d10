"""Port duplex model (ractip_tpu_torch.ops.duplex) vs the JAX package.

The same encoded inputs go through ractip_tpu.ops.duplex and the port on
the CPU, where the port's K6 wrapper runs its plain version.  Tolerances
are the JAX package's own Pallas-vs-jnp gates (tests/test_duplex_pallas.py):
the sweeps in the log domain to atol 5e-4 with identical support, pr atol
2e-5, log_zd rtol 1e-5; the factors are exact in f32; float64 runs hold
log_zd to rtol 1e-10 (tests/test_duplex.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.ops import duplex as jd
from ractip_tpu.ops.duplex_pallas import sweep_pallas
from ractip_tpu.ops.seq import encode
from ractip_tpu.params.boltz import get_boltz
from ractip_tpu.params.tables import get_default_params
from ractip_tpu_torch.evaluate.corpus import record
from ractip_tpu_torch.ops import duplex as td
from ractip_tpu_torch.ops.scan import as_tables

torch.set_num_threads(2)

S1_STR = "CUCGGCUUGCUGAGGUGCACACAGCAAGAGGCGAG"
S2_STR = "GGAUACUCACGACGCGGUUCA"


def _batch(L1, L2, B=2, seed=0):
    """B pairs: the JAX tests' pair, then seeded random pairs of shorter
    lengths (padded where L1, L2 exceed them)."""
    rng = np.random.default_rng(seed)
    s1, s2 = [S1_STR[:L1]], [S2_STR[:L2]]
    for _ in range(B - 1):
        s1.append("".join(rng.choice(list("ACGU"), int(rng.integers(
            min(L1, 20), min(L1, len(S1_STR)) + 1)))))
        s2.append("".join(rng.choice(list("ACGU"), int(rng.integers(
            min(L2, 12), min(L2, len(S2_STR)) + 1)))))
    S1 = np.stack([encode(s, L1) for s in s1])
    S2 = np.stack([encode(s, L2) for s in s2])
    return S1, S2, np.array([len(s) for s in s1]), np.array([len(s) for s in s2])


def _port(S1, S2, n1, n2, dtype=torch.float32):
    tt = as_tables(get_default_params(), "cpu", dtype)
    t = lambda a: torch.as_tensor(np.asarray(a))
    return tt, (t(S1), t(S2), t(n1), t(n2))


def _log_close(M0, l0, M1, l1):
    """Unscaled log values equal to atol 5e-4 where nonzero, same support."""
    M0, M1 = np.asarray(M0, np.float64), np.asarray(M1, np.float64)
    assert ((M0 > 0) == (M1 > 0)).all()
    pos = M0 > 0
    lg = lambda M, l: (np.log(np.where(pos, M, 1.0))
                       + np.asarray(l, np.float64)[:, None])[pos]
    np.testing.assert_allclose(lg(M1, l1), lg(M0, l0), rtol=0, atol=5e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_duplex_factors_match_jax(padded):
    L1, L2 = (48, 32) if padded else (len(S1_STR), len(S2_STR))
    S1, S2, n1, n2 = _batch(L1, L2)
    bt = get_boltz(get_default_params())
    tt, args = _port(S1, S2, n1, n2)
    for port_fn, jax_fn in ((td.duplex_factors_fw, jd.duplex_factors_fw),
                            (td.duplex_factors_bk, jd.duplex_factors_bk)):
        got = port_fn(tt, *args)
        for b in range(len(n1)):
            ref = jax_fn(bt, jnp.asarray(S1[b]), jnp.asarray(S2[b]),
                         int(n1[b]), int(n2[b]), jnp.float32)
            for name in td.DuplexFactors._fields:
                a = getattr(got, name)[b].numpy()
                r = np.asarray(getattr(ref, name))
                assert a.dtype == r.dtype == np.float32
                np.testing.assert_array_equal(a, r, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_sweep_plain_matches_jax(reverse):
    S1, S2, n1, n2 = _batch(48, 32, B=2)
    bt = get_boltz(get_default_params())
    tt, args = _port(S1, S2, n1, n2)
    mk_t = td.duplex_factors_bk if reverse else td.duplex_factors_fw
    mk_j = jd.duplex_factors_bk if reverse else jd.duplex_factors_fw
    M, lsc = td.sweep_plain(mk_t(tt, *args), tt, reverse)
    for b in range(2):
        ff = mk_j(bt, jnp.asarray(S1[b]), jnp.asarray(S2[b]), int(n1[b]),
                  int(n2[b]), jnp.float32)
        M0, l0 = jd._sweep(ff, bt, jnp.float32, reverse)
        _log_close(M0, l0, M[b].numpy(), lsc[b].numpy())


def test_sweep_plain_matches_pallas_interpret():
    S1, S2, n1, n2 = _batch(48, 32, B=1)
    bt = get_boltz(get_default_params())
    tt, args = _port(S1, S2, n1, n2)
    ff = jd.duplex_factors_bk(bt, jnp.asarray(S1[0]), jnp.asarray(S2[0]),
                              int(n1[0]), int(n2[0]), jnp.float32)
    M0, l0 = sweep_pallas(ff, bt, jnp.float32, reverse=True, interpret=True)
    _, (M1, l1) = td.sweep(tt, td.duplex_factors_fw(tt, *args),
                           td.duplex_factors_bk(tt, *args), *args[2:])
    _log_close(M0, l0, M1[0].numpy(), l1[0].numpy())


def test_batch_duplex_matches_vmap():
    S1, S2, n1, n2 = _batch(48, 32, B=3, seed=1)
    params = get_default_params()
    ref = jax.vmap(lambda a, b, m1, m2: jd.duplex(
        params, a, b, m1, m2, jnp.float32, use_pallas=False))(
        jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(n1, jnp.int32),
        jnp.asarray(n2, jnp.int32))
    tt, args = _port(S1, S2, n1, n2)
    got = td.batch_duplex(tt, *args)
    assert got.pr.dtype == torch.float32
    np.testing.assert_allclose(got.pr.numpy(), np.asarray(ref.pr), atol=2e-5)
    np.testing.assert_allclose(got.log_zd.numpy(), np.asarray(ref.log_zd),
                               rtol=1e-5, atol=1e-4)


def test_dis_dis_kissing_region():
    s = record("DIS.fa").seq
    L = 64
    tt, args = _port(encode(s, L)[None], encode(s, L)[None], [len(s)],
                     [len(s)])
    r = td.batch_duplex(tt, *args)
    assert float(r.log_zd[0]) == pytest.approx(41.1, abs=0.05)
    pr = r.pr[0].numpy()
    i, j = np.unravel_index(np.argmax(pr), pr.shape)
    k = s.find("GCACAC")            # the self-complementary kissing loop
    assert k <= i < k + 6 and k <= j < k + 6 and pr[i, j] > 0.99, (i, j)
    np.testing.assert_allclose(pr, pr.T, atol=2e-5)   # a self-duplex


def test_float64_matches_jax():
    S1, S2, n1, n2 = _batch(len(S1_STR), len(S2_STR), B=1)
    ref = jd.duplex(get_default_params(), jnp.asarray(S1[0]),
                    jnp.asarray(S2[0]), jnp.int32(n1[0]), jnp.int32(n2[0]),
                    dtype=jnp.float64, use_pallas=False)
    tt, args = _port(S1, S2, n1, n2, torch.float64)
    got = td.batch_duplex(tt, *args)
    assert got.pr.dtype == torch.float64
    np.testing.assert_allclose(float(got.log_zd[0]), float(ref.log_zd),
                               rtol=1e-10)
    np.testing.assert_allclose(got.pr[0].numpy(), np.asarray(ref.pr),
                               atol=1e-12, rtol=1e-8)


def test_padding_invariance():
    s1, s2 = "GGGAAACCC", "GGGUUUCCC"
    n = [len(s1)], [len(s2)]
    tt, a0 = _port(encode(s1)[None], encode(s2)[None], *n, torch.float64)
    _, a1 = _port(encode(s1, 16)[None], encode(s2, 16)[None], *n,
                  torch.float64)
    r0, r1 = td.batch_duplex(tt, *a0), td.batch_duplex(tt, *a1)
    np.testing.assert_allclose(r1.pr[0, :len(s1), :len(s2)].numpy(),
                               r0.pr[0].numpy(), atol=1e-12)
    assert float(r1.pr[0, len(s1):].abs().sum()) == 0.0
    assert float(r1.pr[0, :, len(s2):].abs().sum()) == 0.0
    np.testing.assert_allclose(r1.log_zd.numpy(), r0.log_zd.numpy(),
                               rtol=1e-12)
