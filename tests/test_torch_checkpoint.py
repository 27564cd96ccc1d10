"""The port's checkpoint / resume of batched sweeps (utils/checkpoint.py,
pipeline/batched.py::sweep_fingerprint and predict_batch's ckpt_dir).

SweepCheckpoint.map_chunks with a counting stub: the JAX package's files
(MANIFEST.json, chunk_%06d.npz) with the same contents; a resume after two
missing chunks runs those two only and returns what an uninterrupted sweep
returns; a corrupted manifest and a changed fingerprint start the sweep
fresh.  predict_batch with a checkpoint directory (its chunks stubbed, so
no DP or LP runs) writes the manifest and files that the JAX package wrote
for the same call (tests/data/torch_port_golden_contrafold.json,
"fingerprint", from tools/make_torch_contrafold_golden.py), and resumes
after a deleted chunk by running that chunk only; another energy table or
chunk size gives another fingerprint.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from ractip_tpu.utils.checkpoint import SweepCheckpoint as JaxCheckpoint
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline import batched
from ractip_tpu_torch.pipeline.options import Options
from ractip_tpu_torch.utils.checkpoint import SweepCheckpoint

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data",
                       "torch_port_golden_contrafold.json")) as _fh:
    FP = json.load(_fh)["fingerprint"]


class Stub:
    """A sweep's chunk function that counts its calls: numpy arrays, the
    bracket strings as a unicode array, as predict_batch's chunks hold."""

    def __init__(self):
        self.ran = []

    def __call__(self, i):
        self.ran.append(i)
        return dict(obj=np.arange(3.0) + i, r1=np.asarray([f"((.{i}))"] * 3))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


def _files(d):
    return sorted(os.listdir(d))


def test_sweep_checkpoint_resume(tmp_path, monkeypatch):
    port, ref = tmp_path / "port", tmp_path / "jax"
    stub, jstub = Stub(), Stub()
    full = SweepCheckpoint(str(port), "fp1").map_chunks(4, stub)
    jfull = JaxCheckpoint(str(ref), "fp1").map_chunks(4, jstub)
    assert stub.ran == jstub.ran == [0, 1, 2, 3]
    _same(full, jfull)
    assert _files(port) == _files(ref) == [
        "MANIFEST.json"] + [f"chunk_{i:06d}.npz" for i in range(4)]
    assert ((port / "MANIFEST.json").read_text()
            == (ref / "MANIFEST.json").read_text())
    for i in range(4):
        _same([SweepCheckpoint(str(port), "fp1").load(i)],
              [JaxCheckpoint(str(ref), "fp1").load(i)])

    # resume after two missing chunks: those two run, the rest load
    for i in (1, 3):
        os.unlink(port / f"chunk_{i:06d}.npz")
    stub.ran = []
    _same(SweepCheckpoint(str(port), "fp1").map_chunks(4, stub), full)
    assert stub.ran == [1, 3]
    stub.ran = []
    SweepCheckpoint(str(port), "fp1").map_chunks(4, stub)
    assert stub.ran == []
    # a corrupted manifest, then another fingerprint: a fresh sweep
    (port / "MANIFEST.json").write_text('{"fingerprint": "fp1", "chun')
    _same(SweepCheckpoint(str(port), "fp1").map_chunks(4, stub), full)
    assert stub.ran == [0, 1, 2, 3]
    stub.ran = []
    SweepCheckpoint(str(port), "fp2").map_chunks(4, stub)
    assert stub.ran == [0, 1, 2, 3]
    assert json.loads((port / "MANIFEST.json").read_text())[
        "fingerprint"] == "fp2"

    # predict_batch: the JAX package's fingerprint and files for the same
    # call; a deleted chunk re-runs alone
    params = get_default_params()
    pairs = [tuple(p) for p in FP["pairs"]]
    kw = dict(chunk=FP["chunk"], iters=FP["iters"],
              want_energy=FP["want_energy"],
              exact_gap_tol=FP["exact_gap_tol"])
    fp = batched.sweep_fingerprint(params, pairs, Options(),
                                   buckets=batched.DEFAULT_BUCKETS, **kw)
    assert fp == FP["fingerprint"]
    hp = params.hairpin.copy()
    hp[5] += 1
    for other in (batched.sweep_fingerprint(
            dataclasses.replace(params, hairpin=hp), pairs, Options(),
            buckets=batched.DEFAULT_BUCKETS, **kw),
                  batched.sweep_fingerprint(
            params, pairs, Options(), buckets=batched.DEFAULT_BUCKETS,
            **dict(kw, chunk=2))):
        assert other != fp
    ran = []

    def stub(tt, params, pairs, *a, **k):
        ran.append(pairs)
        B = len(pairs)
        obj = np.array([len(x) + 0.5 * len(y) for x, y in pairs])
        return dict(r1=np.asarray(["." * len(x) for x, _ in pairs]),
                    r2=np.asarray(["." * len(y) for _, y in pairs]),
                    obj=obj, bound=obj + 1, mv=np.zeros(B),
                    overflow=np.zeros((B, 5), np.int32),
                    energies=np.outer(obj, np.arange(5.0)))
    monkeypatch.setattr(batched, "_run_chunk", stub)
    d = tmp_path / "sweep"
    res = batched.predict_batch(params, pairs, ckpt_dir=str(d),
                                device="cpu", **kw)
    assert len(ran) == len(pairs) == len(FP["files"]) - 1
    manifest = json.loads((d / "MANIFEST.json").read_text())
    assert manifest == FP["manifest"] and _files(d) == FP["files"]
    os.unlink(d / "chunk_000001.npz")
    ran.clear()
    again = batched.predict_batch(params, pairs, ckpt_dir=str(d),
                                  device="cpu", **kw)
    assert ran == [pairs[1:]]
    assert (again.r1, again.r2) == (res.r1, res.r2)
    for k in ("energies", "objective", "bound", "overflow"):
        np.testing.assert_array_equal(getattr(again, k), getattr(res, k))
