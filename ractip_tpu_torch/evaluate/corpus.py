"""Benchmark-corpus evaluation: the 8 curated interacting pairs.

Copy of ractip_tpu/evaluate/corpus.py (data_dir_default, PAIRS,
load_answers, corpus_pairs, evaluate_corpus), plus record(), the first
record of one bundled FASTA file.  The reference ships 15 sequences
(data/*.fa) and curated joint-structure answers (examples/RNA-RNAdata.zip,
2-row format converted by conv.rb); accuracy is sensitivity / PPV / F over
external, internal and all pairs (utils/eval.rb).  The sequences and the
answers are bundled with the port (ractip_tpu_torch/seqdata/, see
PROVENANCE.md there); set RACTIP_TPU_DATA_DIR (or pass data_dir, zip_path)
to use another copy.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path

from ..io.fasta import Fasta, load_fasta, load_pair
from .fmeasure import PairSets, convert_answer, evaluate


def data_dir_default() -> str:
    """Bundled corpus directory, overridable via RACTIP_TPU_DATA_DIR."""
    env = os.environ.get("RACTIP_TPU_DATA_DIR")
    return env if env else str(Path(__file__).resolve().parent.parent
                               / "seqdata")


def record(filename: str) -> Fasta:
    """First record of a bundled FASTA file (e.g. "CopA.fa")."""
    return load_fasta(os.path.join(data_dir_default(), filename))[0]


PAIRS = [
    ("CopA-CopT", "CopA.fa", "CopT.fa", "RNA-RNAdata/CopA-CopTanswer.txt"),
    ("DIS-DIS", "DIS.fa", "DIS.fa", "RNA-RNAdata/DIS-DISanswer.txt"),
    ("IncRNA54-RepZ", "IncRNA54.fa", "RepZ.fa",
     "RNA-RNAdata/IncRNA54-RepZanswer.txt"),
    ("MicA-ompA", "MicA.fa", "ompA.fa", "RNA-RNAdata/MicA-ompAanswer.txt"),
    ("OxyS-fhlA", "OxyS.fa", "fhlA.fa", "RNA-RNAdata/OxyS-fhlAanswer.txt"),
    ("R1inv-R2inv", "R1inv.fa", "R2inv.fa",
     "RNA-RNAdata/R1inv-R2invAnswer.txt"),
    ("RyhB-SodB", "RyhB.fa", "SodB.fa", "RNA-RNAdata/RyhB-SodBanswer.txt"),
    ("Tar-Tarstar", "Tar.fa", "Tarstar.fa",
     "RNA-RNAdata/Tar-TarstarAnswer.txt"),
]


def load_answers(zip_path: str | None = None) -> dict:
    """pair name -> (rec1, rec2) with rec = (name, seq, brackets)."""
    if zip_path is None:
        zip_path = os.path.join(data_dir_default(), "RNA-RNAdata.zip")
    out = {}
    with zipfile.ZipFile(zip_path) as z:
        for name, _f1, _f2, ans in PAIRS:
            text = z.read(ans).decode()
            recs = convert_answer(text)
            out[name] = (recs[0], recs[1])
    return out


def corpus_pairs(data_dir: str | None = None):
    """Yield (name, Fasta1, Fasta2) for the 8 benchmark pairs."""
    if data_dir is None:
        data_dir = data_dir_default()
    for name, f1, f2, _ans in PAIRS:
        fa1, fa2 = load_pair(os.path.join(data_dir, f1),
                             os.path.join(data_dir, f2))
        yield name, fa1, fa2


def evaluate_corpus(predict_fn, data_dir: str | None = None,
                    zip_path: str | None = None) -> dict:
    """predict_fn(fa1, fa2) -> (r1, r2).  Returns per-pair + pooled metrics.

    Pooling sums TP/answer/result counts over pairs before computing
    sensitivity/PPV/F (micro average), mirroring how eval.rb is applied
    per-file and aggregated in the papers.
    """
    answers = load_answers(zip_path)
    per_pair = {}
    tot = {k: [0, 0, 0] for k in ("external", "internal", "all")}
    for name, fa1, fa2 in corpus_pairs(data_dir):
        (n1, s1, b1), (n2, s2, b2) = answers[name]
        r1, r2 = predict_fn(fa1, fa2)
        ans = PairSets.from_brackets(b1, b2)
        res = PairSets.from_brackets(r1, r2)
        per_pair[name] = evaluate(ans, res)
        ex_tp = len(ans.external & res.external)
        in_tp = (len(ans.internal1 & res.internal1)
                 + len(ans.internal2 & res.internal2))
        for key, tp, na, nr in (
                ("external", ex_tp, len(ans.external), len(res.external)),
                ("internal", in_tp,
                 len(ans.internal1) + len(ans.internal2),
                 len(res.internal1) + len(res.internal2))):
            tot[key][0] += tp
            tot[key][1] += na
            tot[key][2] += nr
        tot["all"][0] += ex_tp + in_tp
        tot["all"][1] += (len(ans.external) + len(ans.internal1)
                          + len(ans.internal2))
        tot["all"][2] += (len(res.external) + len(res.internal1)
                          + len(res.internal2))

    def acc(tp, na, nr):
        sen = tp / na if na else 0.0
        ppv = tp / nr if nr else 0.0
        f = 2 * sen * ppv / (sen + ppv) if sen + ppv else 0.0
        return sen, ppv, f

    pooled = {k: acc(*v) for k, v in tot.items()}
    return {"per_pair": per_pair, "pooled": pooled}
