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

The same sweeps sharded over a mesh (parallel/mesh.py) of a gloo process
group of 2 CPU ranks and of 1, each rank a child process (rows of every
chunk stubbed, so no DP or LP runs): predict_batch's and zscore_batch's
results equal the unsharded ones (z and zs within 1e-4, the card's gate:
the mean and variance come from a float32 all-reduce), each rank ran only its
contiguous share of each chunk padded to a multiple of the ranks, a
sharded sweep resumes an unsharded one's chunks (and the other way), and
sharded_mean_var equals numpy's mean and variance.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ractip_tpu.utils.checkpoint import SweepCheckpoint as JaxCheckpoint
from ractip_tpu_torch.evaluate.corpus import record
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


# the rows of a chunk, stubbed: results made from the sequences, every row
# it ran recorded in RAN
ROWS_STUB = textwrap.dedent("""
    import numpy as np
    RAN = []

    def h(s, m):      # differs between shuffles of one sequence
        return sum(i * ord(c) for i, c in enumerate(s)) % m

    def rows_stub(tt, params, pairs, *a):
        RAN.extend(tuple(p) for p in pairs)
        e = np.array([[h(x, 97) / 10.0, h(y, 89) / 10.0,
                       -len(x) - 0.1 * h(x + y, 13), 0.5, 0.25 * h(y, 3)]
                      for x, y in pairs])
        B = len(pairs)
        return dict(r1=np.asarray(["." * len(x) for x, _ in pairs]),
                    r2=np.asarray(["." * len(y) for _, y in pairs]),
                    obj=e[:, 0] + e[:, 1], bound=e[:, 0] + e[:, 1] + 1,
                    mv=np.zeros(B), overflow=np.zeros((B, 5), np.int32),
                    energies=e)
""")
RANK = ROWS_STUB + textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from ractip_tpu_torch.evaluate.corpus import record
    from ractip_tpu_torch.parallel.distributed import init_distributed
    from ractip_tpu_torch.parallel.mesh import scenario_mesh, sharded_mean_var
    from ractip_tpu_torch.params.tables import get_default_params
    from ractip_tpu_torch.pipeline import batched
    from ractip_tpu_torch.pipeline.options import Options
    address, world, rank, out, ckpt, pairs = sys.argv[1:]
    init_distributed(address, int(world), int(rank), backend="gloo")
    mesh = scenario_mesh()
    batched._run_rows = rows_stub
    params = get_default_params()
    pairs = [tuple(p) for p in json.loads(pairs)]
    got = {}
    res = batched.predict_batch(params, pairs, chunk=3, mesh=mesh,
                                want_energy=True, device="cpu")
    got["predict"] = [res.r1, res.r2, res.objective.tolist(),
                      res.energies.tolist(), RAN[:]]
    RAN.clear()
    z, zs, _ = batched.zscore_batch(
        record("Tar.fa"), record("Tarstar.fa"),
        Options(zscore=12, num_shuffling=10, seed=1), params, chunk=4,
        mesh=mesh, device="cpu")
    got["zscore"] = [z, zs, RAN[:]]
    RAN.clear()
    res = batched.predict_batch(params, pairs, chunk=3, mesh=mesh,
                                ckpt_dir=ckpt, want_energy=True, device="cpu")
    got["resume"] = [res.objective.tolist(), RAN[:]]
    x = np.random.default_rng(3).normal(size=12).astype(np.float32)
    valid = (np.arange(12) < 11).astype(np.float32)
    got["mean_var"] = [float(t) for t in sharded_mean_var(x, mesh, valid)]
    dist.destroy_process_group()
    with open(out, "w") as fh:
        json.dump(got, fh)
""")


def _shares(starts_ends, world):
    """Each rank's rows of each chunk: padded to a multiple of world by
    repeating the last row, then contiguous shares."""
    out = [[] for _ in range(world)]
    for rows in starts_ends:
        rows = rows + rows[-1:] * (-len(rows) % world)
        per = len(rows) // world
        for r in range(world):
            out[r] += rows[r * per:(r + 1) * per]
    return out


def _sharded_matches(tmp_path, monkeypatch):
    """predict_batch / zscore_batch over 1 and 2 gloo ranks against the
    unsharded calls, the rows stubbed."""
    from ractip_tpu_torch.entry import free_address
    from ractip_tpu_torch.pipeline.options import Options
    ns = {}
    exec(ROWS_STUB, ns)
    monkeypatch.setattr(batched, "_run_rows", ns["rows_stub"])
    RAN = ns["RAN"]
    params = get_default_params()
    pairs = [(f"GGAC{'A' * k}GUCC", f"CG{'U' * (k % 4)}AG") for k in range(7)]
    kw = dict(chunk=3, want_energy=True, device="cpu")
    ref = batched.predict_batch(params, pairs, **kw)
    z, zs, _ = batched.zscore_batch(
        record("Tar.fa"), record("Tarstar.fa"),
        Options(zscore=12, num_shuffling=10, seed=1), params, chunk=4,
        device="cpu")
    real, decoys = RAN[len(pairs)], RAN[len(pairs) + 1:]
    # an unsharded sweep into each rank count's directory, chunk 1 deleted
    dirs = {w: tmp_path / f"mesh{w}" for w in (1, 2)}
    batched.predict_batch(params, pairs, ckpt_dir=str(dirs[1]), **kw)
    shutil.copytree(dirs[1], dirs[2])
    for d in dirs.values():
        os.unlink(d / "chunk_000001.npz")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = {}
    for w in (1, 2):
        address = free_address()
        for r in range(w):
            out = tmp_path / f"rank{w}_{r}.json"
            procs[w, r] = (out, subprocess.Popen(
                [sys.executable, "-c", RANK, address, str(w), str(r),
                 str(out), str(dirs[w]), json.dumps(pairs)], env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    try:
        for (w, r), (out, p) in procs.items():
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, (w, r, err[-3000:])
    finally:
        for _, p in procs.values():
            p.kill()
    chunks = lambda n, c: [list(range(s, min(n, s + c)))
                           for s in range(0, n, c)]
    for (w, r), (out, _) in procs.items():
        got = json.loads(out.read_text())
        r1, r2, obj, energies, ran = got["predict"]
        assert (r1, r2) == (ref.r1, ref.r2)
        np.testing.assert_array_equal(obj, ref.objective)
        np.testing.assert_array_equal(energies, ref.energies)
        assert [tuple(p) for p in ran] == [
            pairs[i] for i in _shares(chunks(7, 3), w)[r]]
        gz, gzs, ran = got["zscore"]
        assert gz == pytest.approx(z, abs=1e-4)
        assert gzs == pytest.approx(zs, abs=1e-4)
        assert [tuple(p) for p in ran] == [real] + [
            decoys[i] for i in _shares(chunks(10, 4), w)[r]]
        obj, ran = got["resume"]
        np.testing.assert_array_equal(obj, ref.objective)
        assert [tuple(p) for p in ran] == [
            pairs[i] for i in _shares([[3, 4, 5]], w)[r]]
        x = np.random.default_rng(3).normal(size=12).astype(np.float32)[:11]
        np.testing.assert_allclose(got["mean_var"], [x.mean(), x.var()],
                                   rtol=1e-5, atol=1e-6)
    # the sharded sweep rewrote chunk 1: an unsharded resume runs only
    # the chunk deleted now
    os.unlink(dirs[2] / "chunk_000002.npz")
    RAN.clear()
    res = batched.predict_batch(params, pairs, ckpt_dir=str(dirs[2]), **kw)
    assert RAN == [pairs[6]]
    np.testing.assert_array_equal(res.energies, ref.energies)


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
    monkeypatch.undo()
    _sharded_matches(tmp_path, monkeypatch)
