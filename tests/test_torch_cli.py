"""Port CLI (ractip_tpu_torch.cli): the slices' flags run, the others refuse.

A single pair runs through predict_batch at B=1 on the CPU and must give
the JAX package's brackets recorded in the golden files (Tar-Tarstar; the
default model in tests/data/torch_port_golden.json, --duplex in
tests/data/torch_port_golden_duplex.json).  Every reference flag outside
the slices exits non-zero naming its ROADMAP item."""

import functools
import json
import os

import pytest
import torch

from ractip_tpu_torch import cli
from ractip_tpu_torch.evaluate.corpus import data_dir_default

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
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


def test_duplex_single_pair_matches_golden(capsys, monkeypatch):
    # 200 PDHG iterations in place of 3000: the certify step proves the
    # structure optimal either way, and the test runs in a fifth of the time
    monkeypatch.setattr(cli, "predict_batch",
                        functools.partial(cli.predict_batch, iters=200))
    assert cli.main(TAR + ["--duplex", "--device", "cpu", "-e"]) == 0
    out = capsys.readouterr().out.splitlines()
    gold = _tar_golden("torch_port_golden_duplex.json")
    assert out[2] == gold["r1"] and out[5] == gold["r2"]
    assert out[6].startswith("(E: JS= ")


@pytest.mark.parametrize("flag", [
    ["-c"], ["--contrafold"], ["-r", "x.rip"],
    ["-P", "x.par"], ["--acc-max"], ["--mesh"], ["--ckpt-dir", "d"]])
def test_flags_outside_the_slice_refuse(flag, capsys):
    assert cli.main(TAR + flag + ["--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md" in err
