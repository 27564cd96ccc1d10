"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every ``csrc/*.cu`` for sm_90a, one process per
source, all started together, and links them into
``csrc/build/libractip_kernels.so`` (a plain C interface, loaded with
ctypes; rebuilt when a source is newer).  Each C entry point launches on
PyTorch's current stream, allocates nothing, and returns
``cudaGetLastError()``; the launchers below raise if it is not 0.

LAUNCHES counts kernel launches per kernel name; PLAIN_ON_CUDA counts calls
of the plain PyTorch versions on CUDA tensors (only comparisons make them).
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..params.boltz import POW2, W

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
LIB_PATH = BUILD_DIR / "libractip_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

RING_ROWS = 68             # the scans' column rings: 2 x 32 window + 4 raw
RING_S, OM_S = 1, 2        # placement bits of rt_*_mode: in shared memory

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_ON_CUDA: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None
BUILD_LOG = {"seconds": None, "ptxas": ""}


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_ON_CUDA.clear()


def note_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every source."""
    srcs = sorted(CSRC.glob("*.cu"))
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if (not force and LIB_PATH.exists() and all(
            LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in deps)):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", str(o),
                                                     str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        _, err = p.communicate()
        logs.append(err)
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode}):\n{err}")
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}"
    if not failed:
        r = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
                           + [str(o) for o in objs], capture_output=True,
                           text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = "".join(logs)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            dll.rt_inside.argtypes = [P] * 7 + [P] * 6 + [I, I, I, P]
            dll.rt_outside.argtypes = [P] * 17 + [I, I, I, P]
            dll.rt_inside_mode.argtypes = [I]
            occ = (dll.rt_inside_occupancy, dll.rt_outside_mode,
                   dll.rt_outside_occupancy, dll.rt_inside_threads,
                   dll.rt_outside_threads)
            for f in occ:
                f.argtypes = [I, I, I]
            for f in (dll.rt_inside_mode, *occ):
                f.restype = I
            dll.rt_q2.argtypes = [P] * 4 + [I, I, P]
            dll.rt_duplex_sweep.argtypes = [P] * 8 + [I] * 4 + [P]
            dll.rt_duplex_scratch.argtypes = [I, I, I]
            dll.rt_duplex_scratch.restype = ctypes.c_longlong
            for f in (dll.rt_duplex_lanes, dll.rt_duplex_columns,
                      dll.rt_duplex_occupancy):
                f.argtypes = [I, I, I]
                f.restype = I
            for f in (dll.rt_inside, dll.rt_outside, dll.rt_q2,
                      dll.rt_duplex_sweep):
                f.restype = I
            _lib = dll
        return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _expect(t, shape, dtype=torch.float32) -> None:
    """Raise unless t is a contiguous CUDA tensor of this shape and dtype."""
    if not t.is_cuda:
        raise ValueError("CUDA kernel given a tensor that is not on CUDA")
    if t.dtype != dtype:
        raise TypeError(f"CUDA kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"CUDA kernel takes shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("CUDA kernels take contiguous tensors")


def _check_common(F, w2k, bulge_k, sig, pows, cut, n=None):
    """Shapes shared by the scans; returns (B, L, n): the lengths n default
    to the whole bucket."""
    NF, B, L, _ = F.shape
    if L > 1024:
        raise ValueError(f"one thread per row: L={L} exceeds 1024")
    _expect(F, (15 + (cut is not None), B, L, L))
    _expect(w2k, (B, W, W))
    _expect(bulge_k, (B, W))
    _expect(sig, (B,))
    _expect(pows, (B, POW2))
    if cut is not None:
        _expect(cut, (B,), torch.int32)
    if n is None:
        n = torch.full((B,), L, dtype=torch.int32, device=F.device)
    _expect(n, (B,), torch.int32)
    return B, L, n


def _run(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch_inside(F, w2k, bulge_k, sig, pows, cut=None, n=None):
    """K1 (cut None) / K4: returns (qm1_c, qb_c, qm_c, qm2_c or qx_c, q1).
    The lengths n [B] int32 (None: the whole bucket): the kernel sweeps each
    instance's n columns and fills the padding after the sweep."""
    B, L, n = _check_common(F, w2k, bulge_k, sig, pows, cut, n)
    e = lambda *s: torch.empty(*s, dtype=torch.float32, device=F.device)
    qm1, qb, qm, aux, q1 = e(B, L, L), e(B, L, L), e(B, L, L), e(B, L, L), \
        e(B, L)
    name = "inside" if cut is None else "co_inside"
    dll = lib()
    # the column rings in shared memory where they fit, else device memory
    ring = None
    if not dll.rt_inside_mode(L) & RING_S:
        ring = torch.empty(B, RING_ROWS, L, dtype=torch.float32,
                           device=F.device)
    _run(name, dll.rt_inside, _ptr(F), _ptr(w2k), _ptr(bulge_k), _ptr(sig),
         _ptr(pows), _ptr(cut), _ptr(n), _ptr(qm1), _ptr(qb), _ptr(qm),
         _ptr(aux), _ptr(q1), _ptr(ring), B, L, int(cut is not None),
         _stream())
    return qm1, qb, qm, aux, q1


def launch_outside(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig, pows,
                   cut=None, qxN=None, qxA=None, qBpref=None, n=None):
    """K2 (cut None) / K5: returns ob_c.  The lengths n [B] int32 (None:
    the whole bucket): the kernel sweeps each instance's n columns."""
    B, L, n = _check_common(F, w2k, bulge_k, sig, pows, cut, n)
    for t in (qmN, qm1_c) + ((qxN,) if cut is not None else ()):
        _expect(t, (B, L, L))
    for t in (q1pad,) + ((qxA, qBpref) if cut is not None else ()):
        _expect(t, (B, L))
    _expect(q2, (B, L + 1))
    ob = torch.empty(B, L, L, dtype=torch.float32, device=F.device)
    name = "outside" if cut is None else "co_outside"
    dll = lib()
    # the rings and the om table where the kernel keeps them in device
    # memory get a scratch here
    mode = dll.rt_outside_mode(L, int(cut is not None), B)
    om = ring = None
    if not mode & OM_S:
        om = torch.empty(B, L, L, dtype=torch.float32, device=F.device)
    if not mode & RING_S:
        ring = torch.empty(B, RING_ROWS, L, dtype=torch.float32,
                           device=F.device)
    _run(name, dll.rt_outside, _ptr(F), _ptr(qmN), _ptr(qm1_c),
         _ptr(q1pad), _ptr(q2), _ptr(w2k), _ptr(bulge_k), _ptr(sig),
         _ptr(pows), _ptr(cut), _ptr(n), _ptr(qxN), _ptr(qxA), _ptr(qBpref),
         _ptr(om), _ptr(ob), _ptr(ring), B, L, int(cut is not None),
         _stream())
    return ob


def occupancy(L: int, cofold: bool, B: int) -> dict:
    """Blocks an SM of the inside and outside variants launched for B
    instances at L (by cudaOccupancyMaxActiveBlocksPerMultiprocessor:
    threads, shared memory and registers together; 0 where the runtime
    cannot say), and their threads a row (inside_T, outside_T)."""
    dll, c = lib(), int(cofold)
    return dict(inside=dll.rt_inside_occupancy(L, c, B),
                outside=dll.rt_outside_occupancy(L, c, B),
                inside_T=dll.rt_inside_threads(L, c, B),
                outside_T=dll.rt_outside_threads(L, c, B))


def launch_q2(qbe, sig, n):
    """K3: returns q2 [B, L+1]."""
    B, L, _ = qbe.shape
    _expect(qbe, (B, L, L))
    _expect(sig, (B,))
    _expect(n, (B,), torch.int32)
    q2 = torch.empty(B, L + 1, dtype=torch.float32, device=qbe.device)
    _run("q2", lib().rt_q2, _ptr(qbe), _ptr(sig), _ptr(n), _ptr(q2), B, L,
         _stream())
    return q2




# K6's variants: (lanes a column group, rings in shared memory, columns a
# group); with the rings in device memory (past L2 ~ 600) only 1 or 2 lanes
# of two columns
DUPLEX_VARIANTS = tuple((g, True, j) for g in (1, 2, 4, 8) for j in (2, 4)) \
    + ((1, False, 2), (2, False, 2))


def _duplex_force(variant) -> int:
    """The C side's code of a K6 variant (lanes, ring_in_shared, columns);
    0: the launcher's own pick."""
    if variant is None:
        return 0
    if tuple(variant) not in DUPLEX_VARIANTS:
        raise ValueError(f"K6 has no variant {variant}: {DUPLEX_VARIANTS}")
    lanes, ring_in_shared, cols = variant
    return lanes | (0 if ring_in_shared else 16) | (32 if cols == 4 else 0)


def duplex_variant(L2: int, B: int, variant=None) -> dict:
    """The K6 variant launched for B instances at L2 (or the one named by
    variant = (lanes, ring_in_shared, columns)): lanes and columns a group,
    whether its rings sit in shared memory, and blocks an SM (0 where the
    runtime cannot say)."""
    dll, f = lib(), _duplex_force(variant)
    return dict(lanes=dll.rt_duplex_lanes(L2, B, f),
                columns=dll.rt_duplex_columns(L2, B, f),
                ring_in_shared=dll.rt_duplex_scratch(L2, B, f) == 0,
                blocks_per_sm=dll.rt_duplex_occupancy(L2, B, f))


def launch_duplex_sweep(fac, w2, bk, n1, n2, variant=None):
    """K6: fac [2, 11, B, L1, L2] (the forward, then the backward factors),
    n1, n2 [B] int32 (the chain region; cells past it are written as 0)
    -> (M [2, B, L1, L2], lsc [2, B, L1]).  The rings live in shared memory
    where they fit, else in a device-memory scratch allocated here; variant
    = (lanes, ring_in_shared, columns), one of DUPLEX_VARIANTS, names one in
    place of the launcher's pick (the checks run every variant)."""
    if fac.dim() != 5:
        raise ValueError(f"duplex sweep takes [2, 11, B, L1, L2] factors, "
                         f"got {tuple(fac.shape)}")
    B, L1, L2 = fac.shape[2:]
    _expect(fac, (2, 11, B, L1, L2))
    _expect(w2, (W, W))
    _expect(bk, (W,))
    _expect(n1, (B,), torch.int32)
    _expect(n2, (B,), torch.int32)
    dll, force = lib(), _duplex_force(variant)
    ring = None
    scratch = dll.rt_duplex_scratch(L2, B, force)
    if scratch:
        ring = torch.empty(scratch, dtype=torch.float32, device=fac.device)
    M = torch.empty(2, B, L1, L2, dtype=torch.float32, device=fac.device)
    lsc = torch.empty(2, B, L1, dtype=torch.float32, device=fac.device)
    _run("duplex_sweep", dll.rt_duplex_sweep, _ptr(fac), _ptr(w2), _ptr(bk),
         _ptr(n1), _ptr(n2), _ptr(M), _ptr(lsc), _ptr(ring), B, L1, L2,
         force, _stream())
    return M, lsc
