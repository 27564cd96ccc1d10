"""Port CLI (ractip_tpu_torch.cli): the slice's flags run, the others refuse.

A single pair runs through predict_batch at B=1 on the CPU and must give
the JAX package's default-option brackets recorded in the golden file
(tests/data/torch_port_golden.json, Tar-Tarstar).  Every reference flag
outside the slice exits non-zero naming its ROADMAP item."""

import json
import os

import pytest
import torch

from ractip_tpu.evaluate.corpus import data_dir_default
from ractip_tpu_torch import cli

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.json")
TAR = [os.path.join(data_dir_default(), f) for f in ("Tar.fa", "Tarstar.fa")]


def test_single_pair_matches_golden(capsys):
    assert cli.main(TAR + ["--device", "cpu", "-e"]) == 0
    out = capsys.readouterr().out.splitlines()
    with open(GOLDEN) as fh:
        gold = next(p for p in json.load(fh)["corpus"]["pairs"]
                    if p["name"] == "Tar-Tarstar")
    assert out[2] == gold["r1"] and out[5] == gold["r2"]
    assert out[6].startswith("(E: JS= ")


@pytest.mark.parametrize("flag", [
    ["-c"], ["--duplex"], ["--contrafold"], ["-r", "x.rip"],
    ["-P", "x.par"], ["--acc-max"], ["--mesh"], ["--ckpt-dir", "d"]])
def test_flags_outside_the_slice_refuse(flag, capsys):
    assert cli.main(TAR + flag + ["--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md" in err
