"""The port's checkpoint / resume of batched sweeps (utils/checkpoint.py,
pipeline/batched.py::sweep_fingerprint and predict_batch's ckpt_dir).

SweepCheckpoint.map_chunks with a counting stub: the JAX package's files
(MANIFEST.json, chunk_%06d.npz) with the same contents; a resume after two
missing chunks runs those two only and returns what an uninterrupted sweep
returns; a corrupted manifest raises json.JSONDecodeError and a changed
fingerprint ValueError with the JAX package's message, and neither touches
the directory's files.  predict_batch with a checkpoint directory (its chunks stubbed, so
no DP or LP runs) writes the manifest and files that the JAX package wrote
for the same call (tests/data/torch_port_golden_contrafold.json,
"fingerprint", from tools/make_torch_contrafold_golden.py), and resumes
after a deleted chunk by running that chunk only; another energy table or
chunk size gives another fingerprint.

The same sweeps sharded over a mesh (parallel/mesh.py) of a gloo process
group of 2 CPU ranks and of 1, each rank a child process that meets the
others in a rendezvous file (rows of every chunk stubbed, so no DP or LP
runs): predict_batch's and zscore_batch's results equal the unsharded ones
(z and zs within 1e-4, the card's gate: the mean and variance come from a
float32 all-reduce), each rank ran only its contiguous share of each chunk
padded to a multiple of the ranks, a sharded sweep resumes an unsharded
one's chunks (and the other way), sharded_mean_var equals numpy's mean and
variance, and predict_device over the mesh (3 pairs, real DPs and 20 LP
iterations) gives every rank the unsharded call's objectives and bounds
(atol 1e-4: a share is another batch size).

The result records (utils/records.py) round-trip through write_records
and read_records field by field and line by line as the JAX package's;
StageTimer counts the entries of each stage and its sync returns what it
is given; profile_trace writes a trace of one CPU batch_fold at L=32.
"""

import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from ractip_tpu.utils.checkpoint import SweepCheckpoint as JaxCheckpoint
from ractip_tpu.utils.records import PairRecord as JaxRecord
from ractip_tpu.utils.records import read_records as jax_read_records
from ractip_tpu_torch.evaluate.corpus import record
from ractip_tpu_torch.params.tables import get_default_params
from ractip_tpu_torch.pipeline import batched
from ractip_tpu_torch.pipeline.options import Options
from ractip_tpu_torch.ops.scan import batch_fold
from ractip_tpu_torch.utils import (PairRecord, StageTimer, profile_trace,
                                    read_records, write_records)
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
# it ran recorded in RAN; and predict_device's seeded rows
ROWS_STUB = textwrap.dedent("""
    import numpy as np
    RAN = []

    def h(s, m):      # differs between shuffles of one sequence
        return sum(i * ord(c) for i, c in enumerate(s)) % m

    DEVICE_BUCKETS = (16, 16, 16, 32, 32)

    def device_rows():      # S1, n1, S2, n2 of 3 seeded pairs at L = 16
        rng = np.random.default_rng(7)
        S = rng.integers(1, 5, size=(2, 3, 16))
        n = np.array([[16, 13, 15], [14, 16, 12]])
        S[np.arange(16)[None, None] >= n[:, :, None]] = 0
        return S[0], n[0], S[1], n[1]

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
    out_d = batched.predict_device(params, *device_rows(), Options()
                                   .solver_cfg(), buckets=DEVICE_BUCKETS,
                                   iters=20, mesh=mesh, device="cpu")
    got["device"] = [out_d["obj"].tolist(), out_d["bound"].tolist(),
                     list(out_d["prob"].xm.shape)]
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
    from ractip_tpu_torch.pipeline.options import Options
    ns = {}
    exec(ROWS_STUB, ns)
    params = get_default_params()
    ref_d = batched.predict_device(params, *ns["device_rows"](), Options()
                                   .solver_cfg(), buckets=ns["DEVICE_BUCKETS"],
                                   iters=20, device="cpu")
    monkeypatch.setattr(batched, "_run_rows", ns["rows_stub"])
    RAN = ns["RAN"]
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
        address = f"file://{tmp_path / f'rendezvous{w}'}"
        for r in range(w):
            out = tmp_path / f"rank{w}_{r}.json"
            procs[w, r] = (out, subprocess.Popen(
                [sys.executable, "-c", RANK, address, str(w), str(r),
                 str(out), str(dirs[w]), json.dumps(pairs)], env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    try:
        for (w, r), (out, p) in procs.items():
            _, err = p.communicate(timeout=60)
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
        obj, bound, xm_shape = got["device"]
        np.testing.assert_allclose(obj, ref_d["obj"].numpy(), atol=1e-4)
        np.testing.assert_allclose(bound, ref_d["bound"].numpy(), atol=1e-4)
        assert xm_shape == list(ref_d["prob"].xm.shape)
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


def _records_timer_trace(tmp_path):
    """The whole PairRecord through write_records / read_records, against
    the JAX package's lines and reader; StageTimer's counts and sync; a
    profile_trace of one CPU batch_fold, written in a few seconds."""
    full = ("a", "b", "GGAC", "GUCC", "((((", "))))", -3.5, -3.25, 0.0,
            dict(e1=-1.0, e2=-2.0, e3=-3.0, e1s=-0.5, e2s=-0.25),
            (-1.5, -0.75), dict(fold=0.5), dict(f=0.9),
            dict(note="x", k=[1, 2]))
    recs = [PairRecord(*full), PairRecord(*full[:6], objective=1.0)]
    path = tmp_path / "records.jsonl"
    write_records(str(path), recs[:1])
    write_records(str(path), recs[1:], append=True)
    back = read_records(str(path))
    assert back == recs and back[0].zscore == (-1.5, -0.75)
    assert [r.to_json() for r in back] == [JaxRecord(*full).to_json(),
                                           JaxRecord(*full[:6],
                                                     objective=1.0).to_json()]
    assert [dataclasses.asdict(r) for r in jax_read_records(str(path))] == [
        dataclasses.asdict(r) for r in recs]
    assert '"bound"' not in path.read_text().splitlines()[1]

    timer = StageTimer()
    x = dict(a=(torch.ones(2), [np.zeros(1), 3]))
    for _ in range(2):
        with timer("outer"):
            with timer("inner"):
                assert timer.sync(x) is x
    assert timer.counts == {"outer": 2, "inner": 2}
    assert set(timer.report()) == {"outer", "inner"}
    assert repr(timer).startswith("StageTimer(outer=")

    t0 = time.perf_counter()
    S = np.random.default_rng(0).integers(1, 5, size=(1, 32))
    with profile_trace(str(tmp_path / "trace")):
        batch_fold(get_default_params(), S, np.array([30]), "cpu")
    seconds = time.perf_counter() - t0
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1 and seconds < 60, (traces, seconds)
    with open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::einsum" in names


def test_sweep_checkpoint_resume(tmp_path, monkeypatch):
    _records_timer_trace(tmp_path)
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
    # another fingerprint, then a corrupted manifest: both raise as the JAX
    # package does, and the directory's files stay as they were
    files = {f: (port / f).read_bytes() for f in _files(port)}
    msgs = []
    for cls in (SweepCheckpoint, JaxCheckpoint):
        with pytest.raises(ValueError) as e:
            cls(str(port), "fp2")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "different workload" in msgs[0]
    (port / "MANIFEST.json").write_text('{"fingerprint": "fp1", "chun')
    for cls in (SweepCheckpoint, JaxCheckpoint):
        with pytest.raises(json.JSONDecodeError):
            cls(str(port), "fp1")
    (port / "MANIFEST.json").write_bytes(files["MANIFEST.json"])
    assert {f: (port / f).read_bytes() for f in _files(port)} == files
    SweepCheckpoint(str(port), "fp1").map_chunks(4, stub)
    assert stub.ran == []

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
