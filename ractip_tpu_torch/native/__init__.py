"""Native host runtime (C++) with ctypes bindings.

The reference's host-side components are C/C++ (shuffler
reference src/ushuffle.c, solver facade src/ip.cpp); here the performance-
relevant host loops live in `libractip_host.so`, built on demand from the
`.cc` sources in this directory with g++ into `build/` (git-ignored) and
loaded via ctypes.  A copy of the JAX package's native/ directory: the same
source gives the same decoys for the same (seq, count, seed).  Every
binding has a pure-Python fallback so the framework works without a
toolchain; `available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR / "build"
_LIB_NAME = "libractip_host.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _sources() -> list[Path]:
    return sorted(_DIR.glob("*.cc"))


def _build(lib_path: Path) -> bool:
    srcs = [str(s) for s in _sources()]
    if not srcs:
        return False
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           "-o", str(tmp)] + srcs
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        print(f"[ractip_tpu_torch.native] build failed:\n{r.stderr}", file=sys.stderr)
        return False
    os.replace(tmp, lib_path)
    return True


def _load() -> ctypes.CDLL | None:
    """Load (building if stale/missing) the host library; None on failure."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib_path = _BUILD / _LIB_NAME
        try:
            _BUILD.mkdir(exist_ok=True)
            stale = (not lib_path.exists()
                     or any(s.stat().st_mtime > lib_path.stat().st_mtime
                            for s in _sources()))
            if stale and not _build(lib_path):
                return None
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.rt_ushuffle_batch.restype = ctypes.c_int
        lib.rt_ushuffle_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def ushuffle_batch(seq: str, k: int, seed: int, count: int) -> list[str] | None:
    """`count` exact k-let-preserving shuffles of seq; None if native
    library is unavailable (caller falls back to the Python shuffler)."""
    lib = _load()
    if lib is None:
        return None
    raw = seq.encode()
    n = len(raw)
    if n == 0 or count <= 0:
        return [seq] * max(count, 0)
    out = ctypes.create_string_buffer(n * count)
    rc = lib.rt_ushuffle_batch(raw, n, k, ctypes.c_uint64(seed & (2**64 - 1)),
                               count, out)
    if rc != 0:
        return None
    buf = out.raw
    return [buf[r * n:(r + 1) * n].decode() for r in range(count)]
