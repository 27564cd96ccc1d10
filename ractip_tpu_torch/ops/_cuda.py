"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every ``csrc/*.cu`` for sm_90a into
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)] + [str(s) for s in srcs]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = r.stderr
    return LIB_PATH


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            dll.rt_inside.argtypes = [P] * 6 + [P] * 5 + [I, I, I, P]
            dll.rt_outside.argtypes = [P] * 15 + [I, I, I, P]
            dll.rt_q2.argtypes = [P] * 4 + [I, I, P]
            for f in (dll.rt_inside, dll.rt_outside, dll.rt_q2):
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


def _check_common(F, w2k, bulge_k, sig, pows, cut):
    """Shapes shared by the scans; returns (B, L)."""
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
    return B, L


def _run(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch_inside(F, w2k, bulge_k, sig, pows, cut=None):
    """K1 (cut None) / K4: returns (qm1_c, qb_c, qm_c, qm2_c or qx_c, q1)."""
    B, L = _check_common(F, w2k, bulge_k, sig, pows, cut)
    e = lambda *s: torch.empty(*s, dtype=torch.float32, device=F.device)
    qm1, qb, qm, aux, q1 = e(B, L, L), e(B, L, L), e(B, L, L), e(B, L, L), \
        e(B, L)
    name = "inside" if cut is None else "co_inside"
    _run(name, lib().rt_inside, _ptr(F), _ptr(w2k), _ptr(bulge_k), _ptr(sig),
         _ptr(pows), _ptr(cut), _ptr(qm1), _ptr(qb), _ptr(qm), _ptr(aux),
         _ptr(q1), B, L, int(cut is not None), _stream())
    return qm1, qb, qm, aux, q1


def launch_outside(F, qmN, qm1_c, q1pad, q2, w2k, bulge_k, sig, pows,
                   cut=None, qxN=None, qxA=None, qBpref=None):
    """K2 (cut None) / K5: returns ob_c."""
    B, L = _check_common(F, w2k, bulge_k, sig, pows, cut)
    for t in (qmN, qm1_c) + ((qxN,) if cut is not None else ()):
        _expect(t, (B, L, L))
    for t in (q1pad,) + ((qxA, qBpref) if cut is not None else ()):
        _expect(t, (B, L))
    _expect(q2, (B, L + 1))
    om = torch.empty(B, L, L, dtype=torch.float32, device=F.device)
    ob = torch.empty(B, L, L, dtype=torch.float32, device=F.device)
    name = "outside" if cut is None else "co_outside"
    _run(name, lib().rt_outside, _ptr(F), _ptr(qmN), _ptr(qm1_c),
         _ptr(q1pad), _ptr(q2), _ptr(w2k), _ptr(bulge_k), _ptr(sig),
         _ptr(pows), _ptr(cut), _ptr(qxN), _ptr(qxA), _ptr(qBpref), _ptr(om),
         _ptr(ob), B, L, int(cut is not None), _stream())
    return ob


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
