"""FASTA + constraint-string I/O.

Semantics of the reference parser (reference src/fa.cpp:36-83): records start
at '>' headers; a line whose characters come from the class "()[].?xle " is a
*constraint string* appended to the record's structure, any other line is
sequence (keeping only the leading alphabetic run).  The constraint string,
when present, must match the sequence length.
"""

from __future__ import annotations

import dataclasses

_STR_CHARS = set("()[].?xle ")


@dataclasses.dataclass
class Fasta:
    name: str
    seq: str
    str_: str = ""


def parse_fasta(text: str) -> list[Fasta]:
    records: list[Fasta] = []
    name, seq, str_ = None, [], []
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                records.append(Fasta(name, "".join(seq), "".join(str_)))
            name, seq, str_ = line[1:], [], []
            continue
        if not line:
            continue
        if line[0] not in _STR_CHARS:
            run = []
            for ch in line:
                if not ch.isalpha():
                    break
                run.append(ch)
            seq.append("".join(run))
        else:
            run = []
            for ch in line:
                if ch not in _STR_CHARS:
                    break
                run.append(ch)
            str_.append("".join(run))
    if name is not None:
        records.append(Fasta(name, "".join(seq), "".join(str_)))
    for r in records:
        if r.str_ and len(r.str_) != len(r.seq):
            raise ValueError(
                f"{r.name}: constraint length {len(r.str_)} != "
                f"sequence length {len(r.seq)}")
    return records


def load_fasta(path: str) -> list[Fasta]:
    with open(path) as fh:
        return parse_fasta(fh.read())


def load_pair(path1: str, path2: str | None) -> tuple[Fasta, Fasta]:
    """Two files -> first record of each; one file -> its first two records
    (reference src/ractip.cpp:1571-1592)."""
    if path2 is not None:
        l1, l2 = load_fasta(path1), load_fasta(path2)
        if not l1:
            raise ValueError(f"{path1}: Format error")
        if not l2:
            raise ValueError(f"{path2}: Format error")
        return l1[0], l2[0]
    l1 = load_fasta(path1)
    if len(l1) < 2:
        raise ValueError(f"{path1}: Format error")
    return l1[0], l1[1]
