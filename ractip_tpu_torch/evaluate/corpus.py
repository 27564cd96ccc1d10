"""The 8 curated interacting pairs of the benchmark corpus.

Copy of ractip_tpu/evaluate/corpus.py (data_dir_default, PAIRS,
corpus_pairs) without the accuracy evaluation, plus record(), the first
record of one bundled FASTA file.  The sequences are bundled
with the port (ractip_tpu_torch/seqdata/, see PROVENANCE.md there); set
RACTIP_TPU_DATA_DIR (or pass data_dir) to use another copy.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..io.fasta import Fasta, load_fasta, load_pair


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


def corpus_pairs(data_dir: str | None = None):
    """Yield (name, Fasta1, Fasta2) for the 8 benchmark pairs."""
    if data_dir is None:
        data_dir = data_dir_default()
    for name, f1, f2, _ans in PAIRS:
        fa1, fa2 = load_pair(os.path.join(data_dir, f1),
                             os.path.join(data_dir, f2))
        yield name, fa1, fa2
