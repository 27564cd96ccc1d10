"""Port solver (ractip_tpu_torch.solver) vs the JAX package's solver.

On the same posteriors (made by the port's CPU slice from seeded pairs and
handed to both packages as numpy arrays): the top-K candidate sets of
build_problem_device must be equal (slot order may differ on ties; the
buckets are large enough that no block overflows, since at an overflowing
bucket a near-tie of the f32 region scores decides the last slots), the
PDHG LP objective and dual bound must agree to atol 1e-3 (f32 drift over
the iterations), and the HiGHS certify step to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ractip_tpu.ops.seq import encode
from ractip_tpu.params.tables import get_default_params
from ractip_tpu.solver import device as jdev
from ractip_tpu.solver import joint_lp as jlp
from ractip_tpu.solver import milp as jmilp
from ractip_tpu.solver.candidates import JointProblem as JProblem
from ractip_tpu.solver.candidates import SolverConfig as JConfig
from ractip_tpu_torch.ops.accessibility import unpaired_probs
from ractip_tpu_torch.ops.cofold import batch_cofold
from ractip_tpu_torch.ops.scan import as_tables, batch_fold
from ractip_tpu_torch.solver import device as tdev
from ractip_tpu_torch.solver import joint_lp as tlp
from ractip_tpu_torch.solver import milp as tmilp
from ractip_tpu_torch.solver.candidates import SolverConfig

torch.set_num_threads(2)

L = 32
B = 2
BUCKETS = (32, 32, 32, 256, 256)


@pytest.fixture(scope="module")
def posteriors():
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
    return [t.numpy().astype(np.float32) for t in
            (r1["bpp"], r2["bpp"], hp, pu1, pu2)] + [n1.astype(np.int32),
                                                     n2.astype(np.int32)]


def _problems(post):
    cfg = SolverConfig()
    jcfg = JConfig()
    tp = tdev.build_problem_device(*[torch.as_tensor(a) for a in post], cfg,
                                   BUCKETS)
    jp = jax.vmap(lambda a, b, h, p1, p2, m1, m2: jdev.build_problem_device(
        a, b, h, p1, p2, m1, m2, jcfg, BUCKETS))(*[jnp.asarray(a)
                                                   for a in post])
    return cfg, jcfg, tp, jp


def _cands(idx_a, idx_b, coef, mask):
    return {(int(a), int(b)): round(float(c), 5)
            for a, b, c, m in zip(idx_a, idx_b, coef, mask) if m > 0}


def test_candidate_sets_match_jax(posteriors):
    _, _, tp, jp = _problems(posteriors)
    assert float(tp.vm.sum(1).max()) < BUCKETS[3]
    for b in range(B):
        for blk in (("xi", "xj", "xc", "xm"), ("yi", "yj", "yc", "ym"),
                    ("zi", "zj", "zc", "zm"), ("vp", "vq", "vc", "vm"),
                    ("wp", "wq", "wc", "wm")):
            got = _cands(*[getattr(tp, f)[b].numpy() for f in blk])
            ref = _cands(*[np.asarray(getattr(jp, f))[b] for f in blk])
            assert got == ref, blk


def test_pdhg_objective_and_bound_match_jax(posteriors):
    cfg, jcfg, tp, jp = _problems(posteriors)
    u, _, bound = tlp.pdhg_solve(tp, cfg, L, L, iters=400)
    obj = tlp._dot(tlp.coefs(tp), u)

    def one(p):
        uj, _, bj = jlp.pdhg_solve(p, jcfg, L, L, iters=400)
        return jlp.primal_objective(p, uj), bj

    jobj, jbound = jax.vmap(one)(jp)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), atol=1e-3)
    np.testing.assert_allclose(bound.numpy(), np.asarray(jbound), atol=1e-3)


def test_certify_or_solve_matches_jax(posteriors):
    cfg, jcfg, tp, jp = _problems(posteriors)
    for b in range(B):
        p = type(tp)(*[t[b].numpy() for t in tp])
        q = JProblem(*[np.asarray(t)[b] for t in jp])
        _, obj, bound, _ = tmilp.certify_or_solve(p, cfg, L, L, -1.0, 1e-4)
        _, jobj, jbound, _ = jmilp.certify_or_solve(q, jcfg, L, L, -1.0,
                                                    1e-4)
        assert obj == pytest.approx(jobj, abs=1e-6)
        assert bound == pytest.approx(jbound, abs=1e-6)
