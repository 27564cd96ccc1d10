"""Structured per-pair result records (the CLI's --records).

Port of ractip_tpu/utils/records.py, whole: the same fields in the same
order (so a positional PairRecord(...) means the same in both packages),
the same JSON lines, and the reader.

The reference reports results on stdout only (reference src/ractip.cpp:
1607-1622, :1667-1669) and leaves accuracy metrics to an external Ruby
script (utils/eval.rb).  Here every prediction can be captured as a
structured record -- sequences, brackets, objective, certified LP bound,
constraint violation, energies, z-scores, per-stage timings, F-measure
against an answer -- and streamed to JSONL for downstream aggregation.
Fields that are None are left out of a line.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class PairRecord:
    name1: str
    name2: str
    seq1: str
    seq2: str
    r1: str
    r2: str
    objective: float | None = None
    bound: float | None = None          # certified LP upper bound
    violation: float | None = None      # constraint violation of the rounding
    energies: dict[str, float] | None = None   # e1 e2 e3 e1s e2s (kcal/mol)
    zscore: tuple[float, float] | None = None
    timings: dict[str, float] | None = None    # StageTimer.report()
    metrics: dict[str, Any] | None = None      # evaluate.fmeasure output
    extra: dict[str, Any] | None = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps({k: v for k, v in d.items() if v is not None})

    @classmethod
    def from_json(cls, line: str) -> "PairRecord":
        d = json.loads(line)
        if d.get("zscore") is not None:
            d["zscore"] = tuple(d["zscore"])
        return cls(**d)


def write_records(path: str, records: list[PairRecord], append: bool = False):
    with open(path, "a" if append else "w") as f:
        for r in records:
            f.write(r.to_json() + "\n")


def read_records(path: str) -> list[PairRecord]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(PairRecord.from_json(line))
    return out
