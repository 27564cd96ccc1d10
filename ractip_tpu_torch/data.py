"""Bundled inputs, read through the JAX package's framework-free modules.

The 8-pair benchmark corpus, single FASTA records of the bundled data, the
sequence encoding and bucketing, the default BL* energy parameters and the
decoy shuffler (whose native C++ build gives the seeded decoys both
packages share).
"""

from __future__ import annotations

import os

from ractip_tpu import native
from ractip_tpu.evaluate.corpus import corpus_pairs, data_dir_default
from ractip_tpu.io.fasta import Fasta, load_fasta
from ractip_tpu.ops.seq import bucket_length, encode
from ractip_tpu.params.tables import get_default_params
from ractip_tpu.pipeline.shuffle import shuffle_batch

__all__ = ["bucket_length", "corpus_pairs", "encode", "get_default_params",
           "native_shuffle", "record", "shuffle_batch"]


def record(filename: str) -> Fasta:
    """First record of a bundled FASTA file (e.g. "CopA.fa")."""
    return load_fasta(os.path.join(data_dir_default(), filename))[0]


def native_shuffle() -> bool:
    """Whether the native uShuffle library built (the seeded decoys of the
    JAX golden file come from it)."""
    return native.available()
