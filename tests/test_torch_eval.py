"""The port's accuracy evaluation against the JAX package's.

ractip_tpu_torch carries copies of io/sstruct.py and evaluate/fmeasure.py
and the answer-reading half of evaluate/corpus.py (load_answers,
evaluate_corpus).  The JAX package's versions import no JAX, so both run
here on the same inputs and must give the same results: every corpus answer
parsed, written and read back in each structure format; the F-measure of
every answer against itself and against the JAX package's predicted
brackets; and evaluate_corpus with the same stub predict_fn (the answers,
and the JAX golden's corpus brackets) giving equal dicts.
"""

import dataclasses
import json
import os

from ractip_tpu.evaluate import corpus as j_corpus
from ractip_tpu.evaluate import fmeasure as j_fm
from ractip_tpu.io import sstruct as j_ss
from ractip_tpu_torch.evaluate import corpus as t_corpus
from ractip_tpu_torch.evaluate import fmeasure as t_fm
from ractip_tpu_torch.io import sstruct as t_ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(fn, *args):
    """fn(module) for the JAX package's module and the port's: the same
    result, or the same exception and message."""
    out = []
    for mod in args:
        try:
            out.append(("ok", fn(mod)))
        except Exception as ex:   # both must raise alike
            out.append((type(ex).__name__, str(ex)))
    assert out[0] == out[1], out
    return out[1]


def _fields(s):
    return dataclasses.astuple(s) if dataclasses.is_dataclass(s) else s


def test_eval_matches_jax(tmp_path):
    answers = _both(lambda m: m.load_answers(), j_corpus, t_corpus)[1]
    assert sorted(answers) == sorted(n for n, *_ in t_corpus.PAIRS)
    with open(os.path.join(ROOT, "tests", "data",
                           "torch_port_golden.json")) as fh:
        golden = {p["name"]: (p["r1"], p["r2"])
                  for p in json.load(fh)["corpus"]["pairs"]}

    for name, ((n1, s1, b1), (n2, s2, b2)) in answers.items():
        # sstruct: the joint structure (its '[]' pairs span the two
        # strands), each strand's '()' pairs, and each strand alone, whose
        # unmatched '[' must raise alike
        inner = lambda b: "".join(c if c in "()." else "." for c in b)
        for seq, par, nm in ((s1 + s2, b1 + b2, name), (s1, inner(b1), n1),
                             (s2, inner(b2), n2), (s1, b1, n1)):
            st = _both(lambda m: _fields(m.Structure.from_parens(seq, par,
                                                                 nm)),
                       j_ss, t_ss)[1]
            if not isinstance(st, tuple):
                continue
            for write in ("to_parens", "to_bpseq", "to_fasta",
                          "has_pseudoknot"):
                _both(lambda m: getattr(m.Structure.from_parens(seq, par, nm),
                                        write)(), j_ss, t_ss)
            for kind, text in (
                    ("bpseq", t_ss.Structure(*st).to_bpseq()),
                    ("fasta", t_ss.Structure(*st).to_fasta()),
                    ("raw", f"{seq}\n{t_ss.Structure(*st).to_parens()}\n")):
                path = tmp_path / f"{name}.{kind}"
                path.write_text(text)
                got = _both(lambda m: [_fields(x)[1:]
                                       for x in m.load_structure(path)],
                            j_ss, t_ss)[1]
                assert got == [st[1:]], (name, kind)
        # fmeasure: the answer against itself and against the JAX
        # package's prediction (tests/data/torch_port_golden.json)
        for r1, r2 in ((b1, b2), golden[name]):
            _both(lambda m: m.evaluate(m.PairSets.from_brackets(b1, b2),
                                       m.PairSets.from_brackets(r1, r2)),
                  j_fm, t_fm)
            _both(lambda m: sorted(m.paren_pairs(r1 + r2, "[", "]")),
                  j_fm, t_fm)

    by_seq = lambda table: lambda fa1, fa2: table[(fa1.seq, fa2.seq)]
    recs = {name: (fa1.seq, fa2.seq)
            for name, fa1, fa2 in t_corpus.corpus_pairs()}
    for table in ({recs[n]: (a[0][2], a[1][2]) for n, a in answers.items()},
                  {recs[n]: golden[n] for n in answers}):
        got = _both(lambda m: m.evaluate_corpus(by_seq(table)), j_corpus,
                    t_corpus)[1]
        assert set(got["per_pair"]) == set(answers)
    assert got["pooled"]["all"][2] < 1.0
