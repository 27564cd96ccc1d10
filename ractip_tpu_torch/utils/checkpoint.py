"""Checkpoint / resume for long batched sweeps.

Port of ractip_tpu/utils/checkpoint.py (SweepCheckpoint :25, map_chunks
:73), same files: a sweep is a deterministic list of work chunks; each
completed chunk is written as `chunk_{i:06d}.npz` (numpy arrays, unicode
bracket arrays included, never tensors) beside a JSON manifest,
MANIFEST.json, that names the workload's fingerprint and the finished
chunks.  On resume, chunks whose files exist are loaded and the others run.
Every file is written atomically (a temporary file, then a rename), so a
killed run never leaves a half-written chunk or manifest behind.

As in the JAX package, a directory that holds another workload's
manifest (another fingerprint) raises ValueError, and a manifest that
cannot be read raises json.JSONDecodeError: neither starts the sweep
afresh, so a mistyped directory never loses a finished sweep's files.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


class SweepCheckpoint:
    """Chunk-granular checkpoint store under one directory."""

    def __init__(self, directory: str, fingerprint: str = ""):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory, "MANIFEST.json")
        self.manifest = {"fingerprint": fingerprint, "chunks": {}}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                old = json.load(f)
            if fingerprint and old.get("fingerprint") not in ("", fingerprint):
                raise ValueError(
                    f"checkpoint dir {directory} belongs to a different "
                    f"workload (fingerprint {old.get('fingerprint')!r} != "
                    f"{fingerprint!r})")
            self.manifest = old
            self.manifest["fingerprint"] = fingerprint

    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.dir, f"chunk_{i:06d}.npz")

    def has(self, i: int) -> bool:
        return str(i) in self.manifest["chunks"] \
            and os.path.exists(self._chunk_path(i))

    def load(self, i: int) -> dict[str, np.ndarray]:
        with np.load(self._chunk_path(i), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def _write(self, path: str, mode: str, write) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, mode) as f:
                write(f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def save(self, i: int, arrays: dict[str, np.ndarray]):
        """Atomic write of one chunk, then of the manifest."""
        path = self._chunk_path(i)
        self._write(path, "wb", lambda f: np.savez(
            f, **{k: np.asarray(v) for k, v in arrays.items()}))
        self.manifest["chunks"][str(i)] = os.path.basename(path)
        self._write(self.manifest_path, "w",
                    lambda f: json.dump(self.manifest, f))

    def map_chunks(self, n_chunks: int, run_chunk):
        """run_chunk(i) -> dict[str, array] for chunks not yet done; returns
        the full ordered list of chunk dicts (stored + fresh)."""
        out = []
        for i in range(n_chunks):
            if self.has(i):
                out.append(self.load(i))
            else:
                res = run_chunk(i)
                self.save(i, res)
                out.append(res)
        return out
