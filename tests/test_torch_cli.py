"""Port CLI (ractip_tpu_torch.cli): every flag of the JAX CLI runs.

A single pair runs through the single-pair exact path (pipeline/ractip.py)
on the CPU and must give the JAX package's brackets recorded in the golden
files (Tar-Tarstar; the default model in tests/data/torch_port_golden.json,
--duplex in tests/data/torch_port_golden_duplex.json).  -c (constraint
strings in the FASTA files), -r, -P and --acc-max run through cli.main and
must give the brackets and energies of the JAX package's single-pair path
recorded in tests/data/torch_port_golden_single.json
(tools/make_torch_single_golden.py).  --contrafold z-scores take the
sequential path with the JAX CLI's note on stderr, --contraduplex reaches
the CRF duplex engine, --ckpt-dir reaches the batched z-score, and --mesh
asks parallel/distributed.py::init_distributed for a process group first
and, with none launched, runs the unsharded z-score (mesh None)."""

import json
import os
import re

import pytest
import torch

from ractip_tpu_torch import cli
from ractip_tpu_torch.evaluate.corpus import data_dir_default, record

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
TAR = [os.path.join(data_dir_default(), f) for f in ("Tar.fa", "Tarstar.fa")]


def _tar_golden(name):
    with open(os.path.join(DATA, name)) as fh:
        return next(p for p in json.load(fh)["corpus"]["pairs"]
                    if p["name"] == "Tar-Tarstar")


def test_single_pair_matches_golden(capsys):
    assert cli.main(TAR + ["--device", "cpu", "-e"]) == 0
    out = capsys.readouterr().out.splitlines()
    gold = _tar_golden("torch_port_golden.json")
    assert out[2] == gold["r1"] and out[5] == gold["r2"]
    assert out[6].startswith("(E: JS= ")


def test_duplex_single_pair_matches_golden(capsys):
    assert cli.main(TAR + ["--duplex", "--device", "cpu", "-e"]) == 0
    out = capsys.readouterr().out.splitlines()
    gold = _tar_golden("torch_port_golden_duplex.json")
    assert out[2] == gold["r1"] and out[5] == gold["r2"]
    assert out[6].startswith("(E: JS= ")


def _single(case, flags):
    with open(os.path.join(DATA, "torch_port_golden_single.json")) as fh:
        return next(e for e in json.load(fh)["cases"][case]
                    if e["pair"] == "Tar-Tarstar" and e["flags"] == flags)


@pytest.mark.parametrize("case,flags", [
    ("b", ["-e", "-c"]),
    ("f", ["-r", os.path.join("tests", "data", "rip_Tar-Tarstar.txt")]),
    ("g", ["-e", "-P", os.path.join("tests", "data", "single.par")]),
    ("e", ["-e", "--acc-max", "-b", "0.1"])])
def test_ported_flags_match_golden(case, flags, tmp_path, capsys,
                                   monkeypatch):
    """Each flag through cli.main against the JAX single-pair golden: the
    brackets, and with -e the energy line's numbers within 1e-6 kcal/mol of
    the golden's energies (beyond the 6 digits %g prints)."""
    gold = _single(case, flags)
    fastas = TAR
    if gold["cstr"]:
        fastas = []
        for fa, cstr in zip(map(record, ("Tar.fa", "Tarstar.fa")),
                            gold["cstr"]):
            path = tmp_path / f"{len(fastas)}.fa"
            path.write_text(f">{fa.name}\n{fa.seq}\n{cstr}\n")
            fastas.append(str(path))
    monkeypatch.chdir(ROOT)
    assert cli.main(fastas + flags + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[2] == gold["r1"] and out[5] == gold["r2"]
    if "-e" in flags:
        e1, e2, e3, e1s, e2s = gold["energies"]
        want = [e1 + e2 + e3, e1, e2, e3, e1s + e2s, e1s, e2s]
        line = out[6].replace("JS=", "").replace("S1+S2=", "")
        got = [float(x) for x in re.findall(r"[-+]?\d+(?:\.\d+)?"
                                            r"(?:e[-+]?\d+)?", line)]
        assert out[6].startswith("(E: JS= ") and len(got) == len(want)
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-6 + 5e-6 * abs(w), (out[6], want)


@pytest.mark.parametrize("flags", [
    ["--contrafold", "--zscore", "12", "--num-shuffling", "2", "--seed", "3"],
    ["--contraduplex"],
    ["--zscore", "12", "--ckpt-dir", "DIR"],
    ["--zscore", "12", "--mesh"]])
def test_slice_flags_route(flags, tmp_path, capsys, monkeypatch):
    """Each flag a slice ports reaches what the JAX CLI routes it to."""
    from ractip_tpu_torch.pipeline import ractip
    calls = []

    def no_batch(*a, **k):
        raise AssertionError("took the batched z-score path")
    if "--zscore" in flags and "--contrafold" not in flags:
        flags = [str(tmp_path) if f == "DIR" else f for f in flags]

        def stub(fa1, fa2, opts, params, **kw):
            calls.append(kw["ckpt_dir"] or kw["mesh"])
            return -1.5, -0.5, dict(brackets=("." * 16, "." * 16), e=0.0,
                                    es=0.0)

        def init(**kw):
            calls.append(kw)
            return False
        monkeypatch.setattr(cli, "zscore_batch", stub)
        monkeypatch.setattr(cli, "init_distributed", init)
    else:
        monkeypatch.setattr(cli, "zscore_batch", no_batch)
        real = ractip.cd_hybrid_probs

        def recorded(*a, **k):
            calls.append("cd_hybrid_probs")
            return real(*a, **k)
        monkeypatch.setattr(ractip, "cd_hybrid_probs", recorded)
    fastas = TAR
    if "--contrafold" in flags:     # the pair cut short: 3 sequential runs
        fastas = []
        for fa in map(record, ("Tar.fa", "Tarstar.fa")):
            path = tmp_path / f"{len(fastas)}.fa"
            path.write_text(f">{fa.name}\n{fa.seq[:12]}\n")
            fastas.append(str(path))
    assert cli.main(fastas + flags + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    if "--contrafold" in flags:
        assert ("-c/--contrafold not supported on the batched z-score path; "
                "falling back to the sequential path") in err
        assert out.splitlines()[-1].startswith("z-score: ")
    elif "--contraduplex" in flags:
        assert calls == ["cd_hybrid_probs"] and len(out.splitlines()) == 6
    else:
        # --mesh is the default: no process group launched, no mesh
        want = str(tmp_path) if "--ckpt-dir" in flags else None
        assert calls == [dict(backend="gloo"), want]
        assert out.splitlines()[-1] == "z-score: -1.5, -0.5"
