"""Structured per-pair result records (the CLI's --records).

The part of ractip_tpu/utils/records.py that the port's CLI writes, kept
in the port so that it imports nothing of the JAX package; the JAX
module's reader and its fields for the batched LP's bound, violation and
accuracy metrics have no writer here.

The reference reports results on stdout only (reference src/ractip.cpp:
1607-1622, :1667-1669).  Here a prediction can also be captured as a
record -- sequences, brackets, objective, energies, z-scores, per-stage
timings -- and appended to a JSONL file for downstream aggregation.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class PairRecord:
    name1: str
    name2: str
    seq1: str
    seq2: str
    r1: str
    r2: str
    objective: float | None = None
    energies: dict[str, float] | None = None   # e1 e2 e3 e1s e2s (kcal/mol)
    zscore: tuple[float, float] | None = None
    timings: dict[str, float] | None = None    # StageTimer.report()

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps({k: v for k, v in d.items() if v is not None})


def write_records(path: str, records: list[PairRecord], append: bool = False):
    with open(path, "a" if append else "w") as f:
        for r in records:
            f.write(r.to_json() + "\n")
