#!/usr/bin/env python3
"""Run the DP kernels' CUDA sources (K1/K4 inside.cu, K2/K5 outside.cu, K3
q2.cu, K6 duplex.cu) on the CPU and hold them against their plain PyTorch
versions.

    python3 tools/cuda_emu/emulate.py fold L [dES]      # K1, K2 at bucket L
    python3 tools/cuda_emu/emulate.py cofold L1 [B] [dES]  # K4, K5, Lc = 2 L1
    python3 tools/cuda_emu/emulate.py q2 L [B]          # K3 at bucket L
    python3 tools/cuda_emu/emulate.py duplex L1 L2 [B]  # K6, every variant
    python3 tools/cuda_emu/emulate.py masked L          # K1-K5 at B = 1, -c

For a machine without nvcc or a GPU: g++ compiles the sources against
tools/cuda_emu/cuda_runtime.h (one std::thread per CUDA thread, barriers
for __syncthreads and for the lanes each shuffle names, shared memory a
NaN-filled heap buffer) with AddressSanitizer, and the port's launchers
call the result through ctypes on CPU tensors.  A shuffle whose lanes do
not all arrive hangs, a lane outside its mask aborts, and an out-of-bounds
access stops the run with ASan's report.  It shows logic and indexing
faults; it says nothing of speed, of the compiler's code for the card, or
of faults only the card's memory model shows.  The fold batch holds
lengths n < L (and one n = L), given to the kernels; the cofold batch holds
the cut at both edges.  dES raises every scale energy (small sigma: the
subnormal padding path); the fold runs its batch at the default scale and
then at dES (default 500: at L = 96 the padding's qm leaves the normal
floats while the swept cells stay normal).  The q2 mode holds K3 at
lengths n < L on qbe from a fold and on full random matrices (nonzero lower
triangle and padding; one small, one that saturates at the clamp).  The
duplex mode runs each K6 variant (1, 2, 4 and 8 lanes a column group and 2 or 4
columns a group with the rings in shared memory; 1 or 2 lanes of 2 columns
with them in device memory) on pairs with n1 < L1 and n2 < L2
(and one filling both), both directions in one launch, in the log domain
with the same zero cells.  The masked mode runs K1, K3, K2 on one strand
and K4, K5 on one pair (Lc = 2 L) at B = 1 with -c masks in the factors,
the single-pair path's inputs: a partial mask, and every pair banned
(all-zero factors; the open chain alone).  Not modelled: the card's memory model and
timing, cp.async (a plain copy here), and clusters or TMA (the kernels use
neither).  The build goes to tools/cuda_emu/build/.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
BUILD = HERE / "build"


def build() -> Path:
    """Translate the launches (<<<...>>> -> emu::launch) and compile."""
    BUILD.mkdir(exist_ok=True)
    csrc = ROOT / "ractip_tpu_torch" / "csrc"
    srcs = []
    for name in ("inside", "outside", "q2", "duplex"):
        src = (csrc / f"{name}.cu").read_text()
        src = src.replace("extern __shared__ float sh[];",
                          "float* sh = emu::g_sh;")
        src = re.sub(r"([\w.]+(?:<[^<>;]*>)?)<<<([^>]*)>>>\((.*?)\);",
                     lambda m: "emu::launch(%s, [&]() { %s(%s); });" % (
                         m.group(2), m.group(1), m.group(3)), src, flags=re.S)
        out = BUILD / f"{name}.cpp"
        out.write_text(src)
        srcs.append(str(out))
    lib = BUILD / "libemu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-g", "-fPIC", "-shared",
                    "-fsanitize=address", "-w", f"-I{HERE}", f"-I{csrc}",
                    *srcs, "-o", str(lib), "-lpthread"], check=True)
    return lib


def main() -> int:
    if "LD_PRELOAD" not in os.environ:    # ASan must be loaded first
        asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                              capture_output=True, text=True).stdout.strip()
        lib = build()
        env = dict(os.environ, LD_PRELOAD=asan,
                   ASAN_OPTIONS="detect_leaks=0", EMU_LIB=str(lib))
        return subprocess.run([sys.executable, __file__, *sys.argv[1:]],
                              env=env).returncode
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.factors import co_factors, fold_factors
    from ractip_tpu_torch.ops.seq import encode
    from ractip_tpu_torch.params.boltz import sig_tables
    from ractip_tpu_torch.params.tables import get_default_params

    lib = ctypes.CDLL(os.environ["EMU_LIB"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rt_inside.argtypes = [P] * 13 + [I, I, I, P]
    lib.rt_outside.argtypes = [P] * 17 + [I, I, I, P]
    for f in (lib.rt_inside, lib.rt_outside):
        f.restype = I
    lib.rt_inside_mode.argtypes = [I]
    lib.rt_outside_mode.argtypes = [I, I, I]
    lib.rt_q2.argtypes = [P] * 4 + [I, I, P]
    lib.rt_duplex_sweep.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.rt_duplex_scratch.argtypes = [I, I, I]
    lib.rt_duplex_scratch.restype = ctypes.c_longlong
    for f in (lib.rt_duplex_lanes, lib.rt_duplex_columns,
              lib.rt_duplex_occupancy):
        f.argtypes = [I, I, I]
    for f in (lib.rt_inside_mode, lib.rt_outside_mode, lib.rt_q2,
              lib.rt_duplex_sweep, lib.rt_duplex_lanes,
              lib.rt_duplex_columns, lib.rt_duplex_occupancy):
        f.restype = I
    # the launchers, on CPU tensors
    _cuda._lib, _cuda._stream = lib, lambda: None
    _cuda._expect = lambda *a, **k: None
    torch.set_num_threads(2)

    def rel(a, b):
        a, b = a.double(), b.double()
        if not torch.equal(a.isfinite(), b.isfinite()):
            return float("inf")
        nz = b != 0
        if bool((a[~nz].abs() > 1e-30).any()):
            return float("inf")
        d = (a - b).abs()
        return float((d[nz] / b.abs()[nz]).max()) if bool(nz.any()) else 0.0

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    tt = ts.as_tables(get_default_params(), "cpu")
    rng = np.random.default_rng(1)
    rs = lambda k: "".join(rng.choice(list("ACGU"), k))
    enc = lambda ls, L: torch.as_tensor(np.stack([encode(rs(m), L)
                                                  for m in ls])).long()
    a = sys.argv[1:]
    if a[0] == "q2":
        return emulate_q2(tt, enc, rel, timed, int(a[1]),
                          int(a[2]) if len(a) > 2 else 4)
    if a[0] == "duplex":
        return emulate_duplex(tt, enc, timed, int(a[1]), int(a[2]),
                              int(a[3]) if len(a) > 3 else 3)
    if a[0] == "masked":
        return emulate_masked(tt, enc, rel, int(a[1]))
    if a[0] == "fold":
        L = int(a[1])
        ns = [L, L - 7, L // 2]
        S, n = enc(ns, L), torch.tensor(ns)
        n32 = n.to(torch.int32)
        for des in (0.0, float(a[2]) if len(a) > 2 else 500.0):
            es = torch.full((3,), ts.SCALE_E0 + des)
            sig = torch.exp(-es / tt.scalar(tt.bt.kt))
            ff = fold_factors(tt, S, n, sig)
            F = ts.stack_cols(ff)
            w2k, bulge_k, pows = sig_tables(tt, sig)
            args = (F, w2k, bulge_k, sig, pows)
            k, s = timed(lambda: _cuda.launch_inside(*args, n=n32))
            p = ts.inside_plain(*args)
            qm_c = p[2]
            sub = int(((qm_c > 0) & (qm_c < 1.1754944e-38)).sum())
            print(f"dES {des:g}: K1 max rel "
                  f"{max(rel(x, y) for x, y in zip(k, p)):.3e} ({s:.1f} s; "
                  f"{sub} subnormal qm cells)", flush=True)
            qm1_c, qb_c, qm_c, _, q1 = p
            qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
            q2v = ts.q2_plain(qbe, sig, n32)
            q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1)
            oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c,
                     q1pad.contiguous(), q2v, w2k, bulge_k, sig, pows)
            o, s = timed(lambda: _cuda.launch_outside(*oargs, n=n32))
            print(f"dES {des:g}: K2 max rel "
                  f"{rel(o, ts.outside_plain(*oargs)):.3e} ({s:.1f} s)",
                  flush=True)
        return 0
    L1 = int(a[1])
    B = int(a[2]) if len(a) > 2 else 5
    N1 = [1, L1 - 3, L1, 5, 1][:B]           # cut = 1, a full s1
    N2 = [L1 - 5, 1, L1, 9, 1][:B]           # cut = n - 1, a full bucket
    S1, S2 = enc(N1, L1), enc(N2, L1)
    n1, n2 = torch.tensor(N1), torch.tensor(N2)
    es = tc.batch_cofold(tt, S1, S2, n1, n2, "cpu")["es"]
    es = es + (float(a[3]) if len(a) > 3 else 0.0)
    S = tc._pack_concat(S1, S2, n1)
    n, cut = n1 + n2, n1
    sig = torch.exp(-es / tt.scalar(tt.bt.kt))
    ff = co_factors(tt, S, n, cut, sig)
    F = ts.stack_cols(ff)
    w2k, bulge_k, pows = sig_tables(tt, sig)
    c32, n32 = cut.to(torch.int32), n.to(torch.int32)
    args = (F, w2k, bulge_k, sig, pows)
    k, s = timed(lambda: _cuda.launch_inside(*args, c32, n32))
    p = ts.inside_plain(*args, cut)
    print(f"K4 max rel {max(rel(x, y) for x, y in zip(k, p)):.3e} "
          f"({s:.1f} s)", flush=True)
    qm1_c, qb_c, qm_c, qx_c, q1 = p
    q2v = ts.q2((qb_c.transpose(1, 2) * ff.fe).contiguous(), sig, n)
    q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                      1).contiguous()
    qx = qx_c.transpose(1, 2).contiguous()
    qxA, qBpref = tc.exterior_vectors(qx, cut)
    qmN = qm_c.transpose(1, 2).contiguous()
    o, s = timed(lambda: _cuda.launch_outside(
        F, qmN, qm1_c, q1pad, q2v, w2k, bulge_k, sig, pows, c32, qx, qxA,
        qBpref, n32))
    po = tc.co_outside_plain(F, qmN, qm1_c, qx, qxA, qBpref, q1pad, q2v, w2k,
                             bulge_k, sig, pows, cut)
    print(f"K5 max rel {rel(o, po):.3e} ({s:.1f} s)", flush=True)
    return 0


def emulate_q2(tt, enc, rel, timed, L, B):
    """K3 at bucket L: qbe of a fold at lengths n < L (up to L = 256), then
    full random matrices (lower triangle and padding nonzero), small and
    saturating; past L = 256 the random ones alone (L = 1024: the rows in
    shared memory one tile a pass; L = 2048: read from device memory)."""
    import numpy as np
    import torch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.factors import fold_factors
    from ractip_tpu_torch.params.boltz import sig_tables
    cases = []
    if L <= 256:
        ns = [L, L - 7, L // 2, 1, 33][:B]
        S, n = enc(ns, L), torch.tensor(ns)
        sig = torch.exp(-torch.full((len(ns),), ts.SCALE_E0)
                        / tt.scalar(tt.bt.kt))
        ff = fold_factors(tt, S, n, sig)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        qb_c = ts.inside_plain(ts.stack_cols(ff), w2k, bulge_k, sig, pows)[1]
        cases.append(("fold", (qb_c.transpose(1, 2) * ff.fe).contiguous(),
                      sig, n.to(torch.int32)))
    rng = np.random.default_rng(3)
    for label, hi in (("random", 0.03), ("random, saturating", 1.0)):
        qbe = torch.as_tensor(rng.random((2, L, L)) * hi, dtype=torch.float32)
        cases.append((label, qbe, torch.tensor([0.9, 1.1]),
                      torch.tensor([L - 5, L // 3], dtype=torch.int32)))
    for label, qbe, sg, nn in cases:
        k, s = timed(lambda: _cuda.launch_q2(qbe, sg, nn))
        print(f"K3 {label} {list(qbe.shape)}: max rel "
              f"{rel(k, ts.q2_plain(qbe, sg, nn)):.3e} ({s:.1f} s)",
              flush=True)
    return 0


def emulate_duplex(tt, enc, timed, L1, L2, B):
    """Every K6 variant on pairs with n1 < L1, n2 < L2 (one filling both),
    in the log domain, with the same zero cells and a relaunch identical."""
    import torch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import duplex as td
    N1 = [L1 - 3, L1, L1 // 2][:B]
    N2 = [L2 - 5, L2, L2 // 3][:B]
    S1, S2 = enc(N1, L1), enc(N2, L2)
    n1, n2 = torch.tensor(N1), torch.tensor(N2)
    ffw = td.duplex_factors_fw(tt, S1, S2, n1, n2)
    fbk = td.duplex_factors_bk(tt, S1, S2, n1, n2)
    kin = td._sweep_inputs(tt, ffw, fbk, n1, n2)
    (Mf, lf), (Mb, lb) = (td.sweep_plain(ffw, tt, False),
                          td.sweep_plain(fbk, tt, True))
    Mp, lp = torch.stack([Mf, Mb]), torch.stack([lf, lb])
    lg = lambda M, l: M.double().log() + l.double()[..., None]
    picked = _cuda.duplex_variant(L2, B)
    print(f"K6 launcher's pick at L2={L2}, B={B}: {picked}", flush=True)
    ok = True
    for v in _cuda.DUPLEX_VARIANTS:
        lanes, shared, cols = v
        (Mk, lk), s = timed(lambda: _cuda.launch_duplex_sweep(*kin, v))
        Mk2, lk2 = _cuda.launch_duplex_sweep(*kin, v)
        same = torch.equal(Mk, Mk2) and torch.equal(lk, lk2)
        zeros = torch.equal(Mk > 0, Mp > 0)
        pos = Mp > 0
        d = float((lg(Mk, lk) - lg(Mp, lp))[pos].abs().max())
        ok &= zeros and same and d <= 5e-4
        print(f"K6 lanes {lanes}, columns {cols}, rings in "
              f"{'shared' if shared else 'device'} memory: log-domain "
              f"max abs {d:.3e} (tol 5e-4), zero cells same {zeros}, "
              f"relaunch identical {same} ({s:.1f} s)", flush=True)
    return 0 if ok else 1



def emulate_masked(tt, enc, rel, L):
    import torch
    from ractip_tpu_torch.ops import _cuda
    from ractip_tpu_torch.ops import cofold as tc
    from ractip_tpu_torch.ops import scan as ts
    from ractip_tpu_torch.ops.constraints import cofold_allow, fold_allow
    from ractip_tpu_torch.params.boltz import sig_tables
    from ractip_tpu_torch.ops.factors import co_factors, fold_factors
    n1, n2 = L - 9, L - 20
    c1 = (".[[[[[...((((....))))x..<..>" * L)[:n1]
    c2 = ("..(((...)))..]]]]]...|.." * L)[:n2]
    S1, S2 = enc([n1], L), enc([n2], L)
    N1, N2 = torch.tensor([n1]), torch.tensor([n2])
    for label, s1 in (("partial", c1), ("banned", "x" * n1)):
        allow = torch.as_tensor(fold_allow(s1, n1, L)[None])
        es = ts.batch_fold(tt, S1, N1, "cpu", allow=allow)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        ff = fold_factors(tt, S1, N1, sig, allow)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows)
        n32 = N1.to(torch.int32)
        k, p = _cuda.launch_inside(*args, n=n32), ts.inside_plain(*args)
        qm1_c, qb_c, qm_c, _, q1 = p
        qbe = (qb_c.transpose(1, 2) * ff.fe).contiguous()
        q2k, q2v = _cuda.launch_q2(qbe, sig, n32), ts.q2_plain(qbe, sig, n32)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]], 1)
        oargs = (F, qm_c.transpose(1, 2).contiguous(), qm1_c,
                 q1pad.contiguous(), q2v, w2k, bulge_k, sig, pows)
        o = _cuda.launch_outside(*oargs, n=n32)
        print(f"{label} fold L={L} n={n1}: K1 max rel "
              f"{max(rel(x, y) for x, y in zip(k, p)):.3e}, K3 max rel "
              f"{rel(q2k, q2v):.3e}, K2 max rel "
              f"{rel(o, ts.outside_plain(*oargs)):.3e}", flush=True)
        alc = torch.as_tensor(cofold_allow(s1, c2, n1, n2, 2 * L)[None])
        es = tc.batch_cofold(tt, S1, S2, N1, N2, "cpu", allow=alc)["es"]
        sig = torch.exp(-es / tt.scalar(tt.bt.kt))
        S, n, cut = tc._pack_concat(S1, S2, N1), N1 + N2, N1
        ff = co_factors(tt, S, n, cut, sig, alc)
        F = ts.stack_cols(ff)
        w2k, bulge_k, pows = sig_tables(tt, sig)
        args = (F, w2k, bulge_k, sig, pows)
        c32, n32 = cut.to(torch.int32), n.to(torch.int32)
        k, p = _cuda.launch_inside(*args, c32, n32), ts.inside_plain(*args,
                                                                     cut)
        qm1_c, qb_c, qm_c, qx_c, q1 = p
        q2v = ts.q2_plain((qb_c.transpose(1, 2) * ff.fe).contiguous(), sig, n)
        q1pad = torch.cat([torch.ones_like(q1[:, :1]), q1[:, :-1]],
                          1).contiguous()
        qx = qx_c.transpose(1, 2).contiguous()
        qxA, qBpref = tc.exterior_vectors(qx, cut)
        qmN = qm_c.transpose(1, 2).contiguous()
        o = _cuda.launch_outside(F, qmN, qm1_c, q1pad, q2v, w2k, bulge_k, sig,
                                 pows, c32, qx, qxA, qBpref, n32)
        po = tc.co_outside_plain(F, qmN, qm1_c, qx, qxA, qBpref, q1pad, q2v,
                                 w2k, bulge_k, sig, pows, cut)
        print(f"{label} cofold Lc={2 * L} n={n1}+{n2}: K4 max rel "
              f"{max(rel(x, y) for x, y in zip(k, p)):.3e}, K5 max rel "
              f"{rel(o, po):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
