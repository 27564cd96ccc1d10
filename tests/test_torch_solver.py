"""Port solver (ractip_tpu_torch.solver) vs the JAX package's solver.

On the same posteriors (made by the port's CPU slice from seeded pairs and
handed to both packages as numpy arrays): the top-K candidate sets of
build_problem_device must be equal (slot order may differ on ties; the
buckets are large enough that no block overflows, since at an overflowing
bucket a near-tie of the f32 region scores decides the last slots), the
PDHG LP objective and dual bound must agree to atol 1e-3 (f32 drift over
the iterations), and the HiGHS certify step to 1e-6.  The port's
branch-and-bound (solver/bnb.py, its node LPs on the CPU here) must reach
the HiGHS optimum within 1e-4 on the same posteriors' problems without
accessibility (a configuration of the JAX package's tests/test_milp.py;
with accessibility on, its dive fixes the fractional region variables one
LP at a time, ~1 minute a problem on this CPU, so the card holds that case:
chip_smoke.py, phase `rest`), through solve_joint, exact_solve and the
batched path's exact fallback under RACTIP_TPU_EXACT_BACKEND=bnb; the
variable selects the backend as the JAX package's does (auto: HiGHS where
scipy imports; another value raises its ValueError).

The JAX half of every test is read from
tests/data/torch_port_golden_solver.npz (tools/make_torch_test_golden.py:
the JAX package on the same posteriors, stored beside them); the fixture
first asserts that the seeded sequences equal the stored ones and the
posteriors the stored ones to rtol 1e-6 (the port's own CPU slice made
both).
"""

import os
import re

import numpy as np
import pytest
import torch

from ractip_tpu_torch.ops.accessibility import unpaired_probs
from ractip_tpu_torch.ops.cofold import batch_cofold
from ractip_tpu_torch.ops.scan import as_tables, batch_fold
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline import batched
from ractip_tpu_torch.solver import bnb as tbnb
from ractip_tpu_torch.solver import device as tdev
from ractip_tpu_torch.solver import joint_lp as tlp
from ractip_tpu_torch.solver import milp as tmilp
from ractip_tpu_torch.solver.candidates import SolverConfig

torch.set_num_threads(2)

L = 32
B = 2
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_golden_solver.npz")
BUCKETS = (32, 32, 32, 256, 256)


@pytest.fixture(scope="module")
def seeded():
    """The seeded sequences S1, S2 and the port's CPU posteriors bpp1,
    bpp2, hp, pu1, pu2, n1, n2 of them."""
    rng = np.random.default_rng(5)
    n1 = rng.integers(20, L + 1, B)
    n2 = rng.integers(20, L + 1, B)
    S1 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                   for m in n1])
    S2 = np.stack([encode("".join(rng.choice(list("ACGU"), m)), L)
                   for m in n2])
    params = get_default_params()
    tt = as_tables(params, "cpu")
    r1 = batch_fold(tt, S1, n1, "cpu")
    r2 = batch_fold(tt, S2, n2, "cpu")
    n1t, n2t = torch.as_tensor(n1), torch.as_tensor(n2)
    pu1 = unpaired_probs(tt, r1["ff"], r1["ins"], r1["ob"], n1t, 15, r1["sig"])
    pu2 = unpaired_probs(tt, r2["ff"], r2["ins"], r2["ob"], n2t, 15, r2["sig"])
    hp = batch_cofold(tt, S1, S2, n1, n2, "cpu")["hp"]
    return [S1, S2] + [t.numpy().astype(np.float32) for t in
                       (r1["bpp"], r2["bpp"], hp, pu1, pu2)] + [
        n1.astype(np.int32), n2.astype(np.int32)]


@pytest.fixture(scope="module")
def jax_ref(seeded):
    """The JAX package's problems (p_<field>), PDHG objective and bound at
    400 iterations, and certify (objective, bound) of each instance, from
    the golden file, once its inputs are seen to equal this run's."""
    gold = dict(np.load(GOLDEN))
    np.testing.assert_array_equal(seeded[0], gold["S1"])
    np.testing.assert_array_equal(seeded[1], gold["S2"])
    np.testing.assert_array_equal(gold["buckets"], BUCKETS)
    assert int(gold["iters"]) == 400
    for k, a in enumerate(seeded[2:]):
        np.testing.assert_allclose(a, gold[f"post{k}"], rtol=1e-6, atol=0)
    return gold


@pytest.fixture(scope="module")
def posteriors(seeded):
    return seeded[2:]


def _problem(post, cfg=SolverConfig()):
    return cfg, tdev.build_problem_device(*[torch.as_tensor(a) for a in post],
                                          cfg, BUCKETS)


def _cands(idx_a, idx_b, coef, mask):
    return {(int(a), int(b)): round(float(c), 5)
            for a, b, c, m in zip(idx_a, idx_b, coef, mask) if m > 0}


def test_candidate_sets_match_jax(posteriors, jax_ref):
    _, tp = _problem(posteriors)
    assert float(tp.vm.sum(1).max()) < BUCKETS[3]
    for b in range(B):
        for blk in (("xi", "xj", "xc", "xm"), ("yi", "yj", "yc", "ym"),
                    ("zi", "zj", "zc", "zm"), ("vp", "vq", "vc", "vm"),
                    ("wp", "wq", "wc", "wm")):
            got = _cands(*[getattr(tp, f)[b].numpy() for f in blk])
            ref = _cands(*[jax_ref[f"p_{f}"][b] for f in blk])
            assert got == ref, blk


def test_pdhg_objective_and_bound_match_jax(posteriors, jax_ref):
    cfg, tp = _problem(posteriors)
    u, _, bound = tlp.pdhg_solve(tp, cfg, L, L, iters=400)
    obj = tlp._dot(tlp.coefs(tp), u)
    np.testing.assert_allclose(obj.numpy(), jax_ref["obj"], atol=1e-3)
    np.testing.assert_allclose(bound.numpy(), jax_ref["bound"], atol=1e-3)


def test_certify_or_solve_matches_jax(posteriors, jax_ref, monkeypatch):
    cfg, tp = _problem(posteriors)
    for b in range(B):
        p = type(tp)(*[t[b].numpy() for t in tp])
        _, obj, bound, _ = tmilp.certify_or_solve(p, cfg, L, L, -1.0, 1e-4)
        jobj, jbound = jax_ref["cert"][b]
        assert obj == pytest.approx(jobj, abs=1e-6)
        assert bound == pytest.approx(jbound, abs=1e-6)

    cfg, tp = _problem(posteriors, SolverConfig(min_w=0, max_w=0))
    probs = [type(tp)(*[t[b].numpy() for t in tp]) for b in range(B)]
    exact = [tmilp.solve_joint_milp(p, cfg, L, L)[1] for p in probs]
    kw = dict(iters=500, device="cpu")
    for b, (p, want) in enumerate(zip(probs, exact)):
        u, obj, _, nodes = tbnb.solve_joint(p, cfg, L, L, node_iters=100,
                                            **kw)
        assert obj == pytest.approx(want, abs=1e-4) and nodes >= 1
        one = type(tp)(*[t[b:b + 1] for t in tp])
        assert float(tlp.check_feasible(
            one, cfg, L, L, tuple(torch.as_tensor(t)[None] for t in u))) < 0.5
    monkeypatch.delenv("RACTIP_TPU_EXACT_BACKEND", raising=False)
    assert tmilp._backend() == "milp"
    monkeypatch.setenv("RACTIP_TPU_EXACT_BACKEND", "milp")
    assert tmilp.exact_solve(probs[0], cfg, L, L, **kw)[1] == exact[0]
    monkeypatch.setenv("RACTIP_TPU_EXACT_BACKEND", "bnb")
    assert tmilp.exact_solve(probs[0], cfg, L, L, **kw)[1] == \
        pytest.approx(exact[0], abs=1e-4)
    # the batched path's fallback: a zero solution under a loose bound
    zeros = tuple(torch.zeros_like(m) for m in (tp.xm, tp.ym, tp.zm, tp.vm,
                                                tp.wm))
    out = batched._to_host(dict(prob=tp, u=zeros, obj=torch.zeros(B),
                                bound=torch.full((B,), 10.0),
                                mv=torch.ones(B)))
    out = batched._exact_fallback(out, cfg, L, L, 1e-4, 500, "cpu")
    np.testing.assert_allclose(out["obj"], exact, atol=1e-4)
    assert not out["mv"].any() and (out["bound"] < 10.0).all()
    monkeypatch.setenv("RACTIP_TPU_EXACT_BACKEND", "foo")
    with pytest.raises(ValueError, match=re.escape(
            "RACTIP_TPU_EXACT_BACKEND='foo' (expected auto|milp|bnb)")):
        tmilp.exact_solve(probs[0], cfg, L, L, **kw)
