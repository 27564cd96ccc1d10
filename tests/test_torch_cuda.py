"""Hand-written CUDA kernels (K1-K6) against their plain PyTorch versions.

These need a CUDA GPU and nvcc; without a GPU the whole module skips at
collection (every worker sees the same: no CUDA).  Run on the GPU
with:  python -m pytest -m gpu --noconftest tests/test_torch_cuda.py
(--noconftest skips tests/conftest.py, which imports jax; this file does not.)
Tolerances: inside states and ob rtol 1e-4 (f32 summation order; 1e-3 at
L > 192 and Lc = 1024, the gate of the Lc = 288 corpus shape; every
comparison also allows 1e-30 absolute), pair probabilities atol
1e-5; K3's q2 rtol 1e-4; the duplex sweeps (K6) in the log domain to atol
5e-4 with identical support, as the JAX package gates its Pallas sweep."""

import numpy as np
import pytest
import torch

from ractip_tpu_torch.ops import _cuda
from ractip_tpu_torch.ops import cofold as tc
from ractip_tpu_torch.ops import constraints as tcn
from ractip_tpu_torch.ops import duplex as td
from ractip_tpu_torch.ops import scan as ts
from ractip_tpu_torch.ops.factors import co_factors, fold_factors
from ractip_tpu_torch.ops.seq import encode
from ractip_tpu_torch.params.boltz import sig_tables
from ractip_tpu_torch.params.tables import get_default_params

pytestmark = pytest.mark.gpu
if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)",
                allow_module_level=True)


@pytest.fixture(scope="module")
def dev():
    _cuda.lib()
    return torch.device("cuda")


def _seqs(seed, B, L, nmin):
    rng = np.random.default_rng(seed)
    ns = rng.integers(nmin, L + 1, B)
    S = np.stack([encode("".join(rng.choice(list("ACGU"), n)), L)
                  for n in ns])
    return S, ns


def _close(a, b, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    assert torch.all((a - b).abs() <= rtol * b.abs() + 1e-30), \
        float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def test_fold_kernels_match_plain(dev):
    """K1, K3, K2 over whole buckets, then K1, K3 and K2 given the lengths:
    n < L (L = 64), a small sigma (es + 500: the padding's qm leaves the
    normal floats, L = 96), L = 192 and L = 256 at B = 512 and B = 8 (qm in
    device memory; K1 at two and four threads a row) and L = 1024 (rings and
    qm in device memory); K3 also on full random qbe with n < L (lower
    triangle and padding nonzero; small, saturating at the clamp, and at
    L = 2048, where K3 reads the rows from device memory); then K1, K3 and
    K2 at B = 1 with -c masks in the factors (a partial mask, and every
    pair banned: all-zero factors).
    Whole tables, padding included: the same non-finite cells, values
    within the tolerance, a relaunch bit-identical."""
    tt = ts.as_tables(get_default_params(), dev)
    S, n = _seqs(0, 16, 64, 40)
    S, n = torch.as_tensor(S, device=dev), torch.as_tensor(n, device=dev)
    sig = torch.exp(-torch.full((16,), ts.SCALE_E0, device=dev)
                    / tt.scalar(tt.bt.kt))
    ff = fold_factors(tt, S, n, sig)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    args = (F, w2k, bulge_k, sig, pows)
    for k, p in zip(ts.inside(*args), ts.inside_plain(*args)):
        _close(k, p, 1e-4)
    qm1_c, qb_c, qm_c, _, q1 = ts.inside(*args)
    qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
    n32 = n.to(torch.int32)
    q2k = ts.q2(qbe, sig, n32)
    _close(q2k, ts.q2_plain(qbe, sig, n32), 1e-4)
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1).contiguous()
    oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, q1pad, q2k, w2k,
             bulge_k, sig, pows)
    _close(ts.outside(*oargs), ts.outside_plain(*oargs), 1e-4)
    rng = np.random.default_rng(23)
    for B, L, scale, rtol in ((8, 96, 0.03, 1e-4), (8, 96, 1.0, 1e-4),
                              (2, 2048, 0.03, 1e-3)):
        qbe = torch.as_tensor(rng.random((B, L, L)) * scale,
                              dtype=torch.float32, device=dev)
        sg = torch.as_tensor(rng.uniform(0.5, 1.5, B), dtype=torch.float32,
                             device=dev)
        nr = torch.as_tensor(rng.integers(L // 2, L, B), dtype=torch.int32,
                             device=dev)
        _same((ts.q2(qbe, sg, nr),), (ts.q2(qbe, sg, nr),),
              (ts.q2_plain(qbe, sg, nr),), rtol)
    rng = np.random.default_rng(9)
    _fold_length_aware(dev, tt, rng, 64, n.tolist(), 0.0, 1e-4)
    _fold_length_aware(dev, tt, rng, 96, [70, 70, 48, 90], 500.0, 1e-4)
    _fold_length_aware(dev, tt, rng, 1024, [1000], 0.0, 1e-3)
    rng = np.random.default_rng(19)
    for L, rtol in ((192, 1e-4), (256, 1e-3)):
        for B in (512, 8):
            _fold_length_aware(dev, tt, rng, L,
                               rng.integers(L - 40, L + 1, B).tolist(), 0.0,
                               rtol)
    for cstr, L in (("((((....))))..xx<..>..((((((......))))))|.x" * 2, 96),
                    ("x" * 50, 64)):
        n = len(cstr) - 8 * (L == 96)
        _fold_length_aware(dev, tt, rng, L, [n], 0.0, 1e-4,
                           tcn.fold_allow(cstr, n, L)[None])


def _same(k, k2, p, rtol):
    """Whole tables: a relaunch bit-identical, the same non-finite cells,
    values within rtol."""
    for a, a2, b in zip(k, k2, p):
        assert torch.equal(a, a2)
        assert torch.equal(a.isfinite(), b.isfinite())
        fin = b.isfinite()
        _close(a[fin], b[fin], rtol)


def _fold_length_aware(dev, tt, rng, L, ns, des, rtol, allow=None):
    S = torch.as_tensor(np.stack([encode("".join(rng.choice(list("ACGU"), m)),
                                         L) for m in ns]), device=dev).long()
    n = torch.tensor(ns, device=dev)
    sig = torch.exp(-torch.full((len(ns),), ts.SCALE_E0 + des, device=dev)
                    / tt.scalar(tt.bt.kt))
    if allow is not None:
        allow = torch.as_tensor(allow, device=dev)
    ff = fold_factors(tt, S, n, sig, allow)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    args = (F, w2k, bulge_k, sig, pows)
    kout = ts.inside(*args, n=n)
    _same(kout, ts.inside(*args, n=n), ts.inside_plain(*args), rtol)
    qm1_c, qb_c, qm_c, _, q1 = kout
    if des:
        pad = torch.arange(L, device=dev)[None, :, None] >= n[:, None, None]
        assert bool(((qm_c > 0) & (qm_c < torch.finfo(torch.float32).tiny)
                     & pad).any())
    qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
    n32 = n.to(torch.int32)
    q2v = ts.q2(qbe, sig, n32)
    _same((q2v,), (ts.q2(qbe, sig, n32),), (ts.q2_plain(qbe, sig, n32),),
          rtol)
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1).contiguous()
    oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, q1pad, q2v, w2k,
             bulge_k, sig, pows)
    _same((ts.outside(*oargs, n=n),), (ts.outside(*oargs, n=n),),
          (ts.outside_plain(*oargs),), rtol)


def test_cofold_kernels_match_plain(dev):
    tt = ts.as_tables(get_default_params(), dev)
    S1, n1 = _seqs(1, 8, 32, 20)
    S2, n2 = _seqs(2, 8, 32, 20)
    t = lambda a: torch.as_tensor(a, device=dev)
    S1, S2, n1, n2 = t(S1), t(S2), t(n1), t(n2)
    S = tc._pack_concat(S1, S2, n1)
    n, cut = n1 + n2, n1
    sig = torch.exp(-torch.full((8,), ts.SCALE_E0, device=dev)
                    / tt.scalar(tt.bt.kt))
    ff = co_factors(tt, S, n, cut, sig)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    args = (F, w2k, bulge_k, sig, pows, cut)
    kout = tc.co_inside(*args)
    for k, p in zip(kout, ts.inside_plain(*args)):
        _close(k, p, 1e-4)
    qm1_c, qb_c, qm_c, qx_c, q1 = kout
    q2v = ts.q2((qb_c.transpose(1, 2) * ff.fe).contiguous(), sig, n)
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1).contiguous()
    qx = qx_c.transpose(1, 2).contiguous()
    qxA, qBpref = tc.exterior_vectors(qx, cut)
    oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, qx, qxA, qBpref,
             q1pad, q2v, w2k, bulge_k, sig, pows, cut)
    _close(tc.co_outside(*oargs), tc.co_outside_plain(*oargs), 1e-4)


def test_cofold_kernels_length_aware_match_plain(dev):
    """K4 and K5 given the lengths: n < L, the cut at both edges (cut = 1,
    cut = n - 1), at Lc = 1024 (column rings in device memory), and at
    B = 1 with -c masks in the concatenation's factors (strand-2 base j at
    n1 + j; a partial mask, and strand 1 banned whole).  Whole tables,
    padding included: the same non-finite cells, values within the
    tolerance, a relaunch bit-identical."""
    _length_aware_case(dev, 24, [1, 20, 24, 13, 1], [17, 1, 24, 9, 1], 1e-4)
    _length_aware_case(dev, 512, [480], [500], 1e-3)
    s1 = ".[[[[[[...((((....))))x..." * 3
    s2 = "..(((...)))..]]]]]]..<..>..|" * 2
    for c1 in (s1[:70], "x" * 70):
        _length_aware_case(dev, 96, [70], [56], 1e-4, (c1, s2))


def _length_aware_case(dev, L1, N1, N2, rtol, cstr=None):
    L2 = L1
    rng = np.random.default_rng(8)
    rs = lambda k: "".join(rng.choice(list("ACGU"), k))
    t = lambda a: torch.as_tensor(np.stack(a), device=dev)
    S1 = t([encode(rs(m), L1) for m in N1]).long()
    S2 = t([encode(rs(m), L2) for m in N2]).long()
    n1, n2 = torch.tensor(N1, device=dev), torch.tensor(N2, device=dev)
    tt = ts.as_tables(get_default_params(), dev)
    S = tc._pack_concat(S1, S2, n1)
    n, cut = n1 + n2, n1
    sig = torch.exp(-torch.full((len(N1),), ts.SCALE_E0, device=dev)
                    / tt.scalar(tt.bt.kt))
    allow = None if cstr is None else torch.as_tensor(tcn.cofold_allow(
        cstr[0], cstr[1], N1[0], N2[0], L1 + L2)[None], device=dev)
    ff = co_factors(tt, S, n, cut, sig, allow)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    args = (F, w2k, bulge_k, sig, pows, cut)

    kout = tc.co_inside(*args, n=n)
    _same(kout, tc.co_inside(*args, n=n), ts.inside_plain(*args), rtol)
    qm1_c, qb_c, qm_c, qx_c, q1 = kout
    q2v = ts.q2((qb_c.transpose(1, 2) * ff.fe).contiguous(), sig, n)
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1).contiguous()
    qx = qx_c.transpose(1, 2).contiguous()
    qxA, qBpref = tc.exterior_vectors(qx, cut)
    oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c, qx, qxA, qBpref,
             q1pad, q2v, w2k, bulge_k, sig, pows, cut)
    _same((tc.co_outside(*oargs, n=n),), (tc.co_outside(*oargs, n=n),),
          (tc.co_outside_plain(*oargs),), rtol)


def test_batch_fold_cuda_matches_cpu(dev):
    S, n = _seqs(3, 8, 64, 30)
    params = get_default_params()
    before = dict(_cuda.LAUNCHES)
    g = ts.batch_fold(params, S, n, device=dev)
    c = ts.batch_fold(params, S, n, device="cpu")
    assert _cuda.LAUNCHES["inside"] > before.get("inside", 0)
    assert _cuda.LAUNCHES["outside"] > before.get("outside", 0)
    np.testing.assert_allclose(g["bpp"].cpu().numpy(), c["bpp"].numpy(),
                               atol=1e-5)


def test_kernel_wrappers_reject_float64(dev):
    F = torch.zeros(15, 1, 32, 32, dtype=torch.float64, device=dev)
    z = torch.zeros(1, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ts.inside(F, z, z, z, z)


@pytest.mark.parametrize("shape", [(4, 48, 32), (2, 64, 2048)])
def test_duplex_sweep_kernel_matches_plain(dev, shape):
    """Both directions in one launch, the launcher's pick (L2 = 2048 puts
    the rings in device memory); at the small shape also every variant
    (_cuda.DUPLEX_VARIANTS: 1, 2, 4, 8 lanes a column group and 2 or 4
    columns a group with the rings in shared memory; 1 or 2 lanes of 2
    columns with them in device memory), each relaunch bit-identical."""
    B, L1, L2 = shape
    tt = ts.as_tables(get_default_params(), dev)
    S1, n1 = _seqs(4, B, L1, L1 // 2)
    S2, n2 = _seqs(5, B, L2, L2 // 2)
    t = lambda a: torch.as_tensor(a, device=dev)
    args = (t(S1), t(S2), t(n1), t(n2))
    ffw, fbk = td.duplex_factors_fw(tt, *args), td.duplex_factors_bk(tt, *args)
    before = _cuda.LAUNCHES["duplex_sweep"]
    kern = td.sweep(tt, ffw, fbk, args[2], args[3])
    assert _cuda.LAUNCHES["duplex_sweep"] == before + 1
    plain = [td.sweep_plain(ff, tt, rev)
             for ff, rev in ((ffw, False), (fbk, True))]
    kin = td._sweep_inputs(tt, ffw, fbk, args[2], args[3])
    runs = [kern]
    if L2 <= 1024:
        for v in _cuda.DUPLEX_VARIANTS:
            M, lsc = _cuda.launch_duplex_sweep(*kin, v)
            M2, lsc2 = _cuda.launch_duplex_sweep(*kin, v)
            assert torch.equal(M, M2) and torch.equal(lsc, lsc2), v
            runs.append(((M[0], lsc[0]), (M[1], lsc[1])))
    for run in runs:
        for (Mk, lk), (Mp, lp) in zip(run, plain):
            Mk, Mp = Mk.double().cpu(), Mp.double().cpu()
            assert torch.equal(Mk > 0, Mp > 0)
            pos = Mp > 0
            lg = lambda M, l: (torch.where(pos, M, torch.ones_like(M)).log()
                               + l.double().cpu()[:, :, None])[pos]
            assert float((lg(Mk, lk) - lg(Mp, lp)).abs().max()) <= 5e-4


def test_duplex_wrapper_rejects_float64(dev):
    tt = ts.as_tables(get_default_params(), dev, torch.float64)
    S, n = _seqs(6, 1, 32, 20)
    args = (torch.as_tensor(S, device=dev), torch.as_tensor(S, device=dev),
            torch.as_tensor(n, device=dev), torch.as_tensor(n, device=dev))
    ff = td.duplex_factors_fw(tt, *args)
    with pytest.raises(TypeError):
        td.sweep(tt, ff, ff, args[2], args[3])
