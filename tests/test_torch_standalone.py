"""The port's own copies of the framework-free modules against the JAX package.

ractip_tpu_torch carries copies of the constants, energy parameters,
Boltzmann tables, sequence encoding, energy evaluation, FASTA reading, the
decoy shuffler and the corpus, so that it imports nothing of ractip_tpu.
Each copy must give the JAX package's results: parameters and encodings
exactly, Boltzmann tables to rtol 1e-15, energies exactly, decoys as the
same strings for the same seed (native and Python shufflers both), and the
same corpus records."""

import dataclasses
import json
import os

import numpy as np
import pytest

from ractip_tpu import native as j_native
from ractip_tpu.evaluate import corpus as j_corpus
from ractip_tpu.ops import eos as j_eos
from ractip_tpu.ops import seq as j_seq
from ractip_tpu.params import boltz as j_boltz
from ractip_tpu.params import tables as j_tables
from ractip_tpu.pipeline import shuffle as j_shuffle
from ractip_tpu_torch import native as t_native
from ractip_tpu_torch.evaluate import corpus as t_corpus
from ractip_tpu_torch.ops import eos as t_eos
from ractip_tpu_torch.ops import seq as t_seq
from ractip_tpu_torch.params import boltz as t_boltz
from ractip_tpu_torch.params import tables as t_tables
from ractip_tpu_torch.pipeline import shuffle as t_shuffle

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.json")


def _same(a, b, rtol=0.0):
    if isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and rtol:
        assert a == pytest.approx(b, rel=rtol, abs=0)
    else:
        assert a == b


@pytest.mark.parametrize("what", ["params", "boltz"])
def test_parameter_tables_match(what):
    jp, tp = j_tables.get_default_params(), t_tables.get_default_params()
    if what == "params":
        j, t, rtol = jp, tp, 0.0
    else:
        j, t, rtol = j_boltz.get_boltz(jp), t_boltz.get_boltz(tp), 1e-15
    names = [f.name for f in dataclasses.fields(j)]
    assert names == [f.name for f in dataclasses.fields(t)]
    for name in names:
        _same(getattr(t, name), getattr(j, name), rtol)


def test_encode_and_bucket_length_match():
    rng = np.random.default_rng(0)
    for n in rng.integers(1, 300, 40):
        s = "".join(rng.choice(list("ACGUTNacgu"), int(n)))
        L = t_seq.bucket_length(int(n))
        assert L == j_seq.bucket_length(int(n))
        np.testing.assert_array_equal(t_seq.encode(s, L), j_seq.encode(s, L))
        np.testing.assert_array_equal(t_seq.encode(s), j_seq.encode(s))


def test_energies_of_golden_brackets_match():
    with open(GOLDEN) as fh:
        pairs = json.load(fh)["corpus"]["pairs"]
    jp, tp = j_tables.get_default_params(), t_tables.get_default_params()
    for p in pairs:
        Sa, Sb = t_seq.encode(p["seq1"]), t_seq.encode(p["seq2"])
        for S, r in ((Sa, p["r1"]), (Sb, p["r2"])):
            assert t_eos.parse_pairs(r) == j_eos.parse_pairs(r)
            assert (t_eos.structure_energy(tp, S, t_eos.parse_pairs(r))
                    == j_eos.structure_energy(jp, S, j_eos.parse_pairs(r)))
        assert (t_eos.duplex_structure_energy(tp, Sa, Sb, p["r1"], p["r2"])
                == j_eos.duplex_structure_energy(jp, Sa, Sb, p["r1"],
                                                 p["r2"]))


@pytest.mark.parametrize("prefer_native", [True, False])
def test_shuffle_batch_matches(prefer_native):
    if prefer_native:
        assert t_native.available() and j_native.available()
    seq = "AUGGCUACGUAGCUAGCUAGGCUAUUCGAUCGGAUCGAUUAGC"
    for seed in (1, 12345):
        got = t_shuffle.shuffle_batch(seq, 16, seed,
                                      prefer_native=prefer_native)
        assert got == j_shuffle.shuffle_batch(seq, 16, seed,
                                              prefer_native=prefer_native)
        for s in got:
            assert (j_shuffle.klet_counts(s, 2)
                    == j_shuffle.klet_counts(seq, 2))


def test_corpus_records_match():
    got = list(t_corpus.corpus_pairs())
    ref = list(j_corpus.corpus_pairs())
    assert [n for n, _, _ in got] == [n for n, _, _ in ref]
    for (_, a1, a2), (_, b1, b2) in zip(got, ref):
        assert (a1.name, a1.seq, a2.name, a2.seq) == (b1.name, b1.seq,
                                                      b2.name, b2.seq)
    assert t_corpus.PAIRS == j_corpus.PAIRS
    if "RACTIP_TPU_DATA_DIR" not in os.environ:   # the port's own copy
        assert os.path.basename(t_corpus.data_dir_default()) == "seqdata"
