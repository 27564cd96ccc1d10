"""Port solver (ractip_tpu_torch.solver) vs the JAX package's solver.

On the same posteriors (made by the port's CPU slice from seeded pairs and
handed to both packages as numpy arrays): the top-K candidate sets of
build_problem_device must be equal (slot order may differ on ties; the
buckets are large enough that no block overflows, since at an overflowing
bucket a near-tie of the f32 region scores decides the last slots), the
PDHG LP objective and dual bound must agree to atol 1e-3 (f32 drift over
the iterations), and the HiGHS certify step to 1e-6.

The JAX half of every test runs in one child process (JAX on the CPU with
x64, as tests/conftest.py sets it up), so the compile history of the
worker that runs these tests cannot reach the jaxlib compile-path crash
that tests/conftest.py describes; tests/test_torch_fold.py does the same."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ractip_tpu_torch.ops.accessibility import unpaired_probs
from ractip_tpu_torch.ops.cofold import batch_cofold
from ractip_tpu_torch.ops.scan import as_tables, batch_fold
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.solver import device as tdev
from ractip_tpu_torch.solver import joint_lp as tlp
from ractip_tpu_torch.solver import milp as tmilp
from ractip_tpu_torch.solver.candidates import SolverConfig

torch.set_num_threads(2)

L = 32
B = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


_JAX_REFERENCE = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ractip_tpu.solver import device as jdev
    from ractip_tpu.solver import joint_lp as jlp
    from ractip_tpu.solver import milp as jmilp
    from ractip_tpu.solver.candidates import JointProblem, SolverConfig
    src, dst, L, iters = sys.argv[1:]
    L, iters = int(L), int(iters)
    a = np.load(src)
    post = [a[f"post{k}"] for k in range(7)]
    buckets = tuple(int(b) for b in a["buckets"])
    jcfg = SolverConfig()
    jp = jax.vmap(lambda a, b, h, p1, p2, m1, m2: jdev.build_problem_device(
        a, b, h, p1, p2, m1, m2, jcfg, buckets))(*[jnp.asarray(x)
                                                   for x in post])

    def one(p):
        uj, _, bj = jlp.pdhg_solve(p, jcfg, L, L, iters=iters)
        return jlp.primal_objective(p, uj), bj

    jobj, jbound = jax.vmap(one)(jp)
    cert = []
    for b in range(len(post[5])):
        q = JointProblem(*[np.asarray(t)[b] for t in jp])
        _, obj, bound, _ = jmilp.certify_or_solve(q, jcfg, L, L, -1.0, 1e-4)
        cert.append((obj, bound))
    np.savez(dst, obj=np.asarray(jobj), bound=np.asarray(jbound),
             cert=np.asarray(cert, np.float64),
             **{f"p_{f}": np.asarray(getattr(jp, f)) for f in jp._fields})
""")


@pytest.fixture(scope="module")
def jax_ref(posteriors, tmp_path_factory):
    """The JAX package's problems (p_<field>), PDHG objective and bound at
    400 iterations, and certify (objective, bound) of each instance, from a
    child process."""
    tmp = tmp_path_factory.mktemp("jax_solver")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, buckets=np.asarray(BUCKETS),
             **{f"post{k}": a for k, a in enumerate(posteriors)})
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
           "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(src),
                           str(dst), str(L), "400"], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


def _problem(post):
    cfg = SolverConfig()
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


def test_certify_or_solve_matches_jax(posteriors, jax_ref):
    cfg, tp = _problem(posteriors)
    for b in range(B):
        p = type(tp)(*[t[b].numpy() for t in tp])
        _, obj, bound, _ = tmilp.certify_or_solve(p, cfg, L, L, -1.0, 1e-4)
        jobj, jbound = jax_ref["cert"][b]
        assert obj == pytest.approx(jobj, abs=1e-6)
        assert bound == pytest.approx(jbound, abs=1e-6)
