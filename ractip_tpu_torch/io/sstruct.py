"""Structure I/O: FASTA / RAW / BPSEQ with auto-detection, parens<->mapping.

A copy of ractip_tpu/io/sstruct.py, kept in the port so that it imports
nothing of the JAX package.

Capability parity with the reference's SStruct component (reference
src/contrafold/SStruct.cpp:47-69 auto format detection, parens/mapping
conversion, pseudoknot check, BPSEQ and parens writers,
src/contrafold/SStruct.hpp:76-88), redesigned as plain Python dataclasses:
structures are 0-based pair mappings with -1 = unpaired and -2 = unknown
(the reference uses 1-based with 0/UNKNOWN sentinels).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

UNPAIRED = -1
UNKNOWN = -2

_OPEN = "([{<"
_CLOSE = ")]}>"


@dataclasses.dataclass
class Structure:
    name: str
    seq: str
    mapping: list[int]  # mapping[i] = j if (i, j) paired, else UNPAIRED/UNKNOWN

    # ---- conversions -------------------------------------------------
    @classmethod
    def from_parens(cls, seq: str, parens: str, name: str = "") -> "Structure":
        if len(seq) != len(parens):
            raise ValueError("sequence/structure length mismatch")
        mapping = [UNPAIRED] * len(seq)
        stacks: dict[str, list[int]] = {c: [] for c in _OPEN}
        for i, ch in enumerate(parens):
            if ch in _OPEN:
                stacks[ch].append(i)
            elif ch in _CLOSE:
                st = stacks[_OPEN[_CLOSE.index(ch)]]
                if not st:
                    raise ValueError(f"unbalanced '{ch}' at {i}")
                j = st.pop()
                mapping[j], mapping[i] = i, j
            elif ch == "?":
                mapping[i] = UNKNOWN
            elif ch not in ".xle ":
                raise ValueError(f"bad structure char {ch!r}")
        for c, st in stacks.items():
            if st:
                raise ValueError(f"unbalanced '{c}'")
        return cls(name=name, seq=seq, mapping=mapping)

    def to_parens(self) -> str:
        """Dot-bracket string; nested pairs get '()', crossing pairs escalate
        through '[]{}<>' (pages of pseudoknot order)."""
        out = ["."] * len(self.mapping)
        pairs = sorted((i, j) for i, j in enumerate(self.mapping)
                       if j > i)
        pages: list[list[tuple[int, int]]] = []
        for (i, j) in pairs:
            for d, page in enumerate(pages):
                if all(not (a < i < b < j or i < a < j < b) for a, b in page):
                    page.append((i, j))
                    break
            else:
                if len(pages) >= len(_OPEN):
                    raise ValueError("pseudoknot order exceeds bracket alphabet")
                pages.append([(i, j)])
        for d, page in enumerate(pages):
            for (i, j) in page:
                out[i], out[j] = _OPEN[d], _CLOSE[d]
        for i, j in enumerate(self.mapping):
            if j == UNKNOWN:
                out[i] = "?"
        return "".join(out)

    def has_pseudoknot(self) -> bool:
        pairs = [(i, j) for i, j in enumerate(self.mapping) if j > i]
        return any(a < i < b < j or i < a < j < b
                   for i, j in pairs for a, b in pairs)

    # ---- writers -----------------------------------------------------
    def to_bpseq(self) -> str:
        lines = []
        for i, (c, j) in enumerate(zip(self.seq, self.mapping)):
            lines.append(f"{i + 1} {c} {j + 1 if j >= 0 else 0}")
        return "\n".join(lines) + "\n"

    def to_fasta(self, with_struct: bool = True) -> str:
        s = f">{self.name}\n{self.seq}\n"
        if with_struct:
            s += self.to_parens() + "\n"
        return s


# ---- parsers ----------------------------------------------------------
def parse_bpseq(text: str, name: str = "") -> Structure:
    seq, mapping = [], []
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 3:
            raise ValueError(f"BPSEQ line {ln}: expected 3 fields")
        idx, base, partner = int(parts[0]), parts[1], int(parts[2])
        if idx != len(seq) + 1:
            raise ValueError(f"BPSEQ line {ln}: indices must be 1..n in order")
        seq.append(base)
        mapping.append(partner - 1 if partner > 0 else UNPAIRED)
    # symmetry check
    for i, j in enumerate(mapping):
        if j >= 0 and (j >= len(mapping) or mapping[j] != i):
            raise ValueError(f"BPSEQ: asymmetric pair ({i + 1}, {j + 1})")
    return Structure(name=name, seq="".join(seq), mapping=mapping)


def parse_raw(text: str, name: str = "") -> Structure:
    """RAW format: first non-empty line sequence, optional second line parens."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty RAW input")
    seq = lines[0]
    if len(lines) > 1:
        return Structure.from_parens(seq, lines[1], name)
    return Structure(name=name, seq=seq, mapping=[UNKNOWN] * len(seq))


def parse_fasta_struct(text: str) -> list[Structure]:
    """FASTA where a bracket line after the sequence is its structure."""
    out: list[Structure] = []
    name, seq, struct = None, "", ""
    struct_chars = set("()[]{}<>.?xle ")

    def flush():
        if name is None:
            return
        if struct:
            out.append(Structure.from_parens(seq, struct, name))
        else:
            out.append(Structure(name=name, seq=seq,
                                 mapping=[UNKNOWN] * len(seq)))

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            flush()
            name, seq, struct = line[1:].strip(), "", ""
        elif set(line) <= struct_chars and seq:
            struct += line
        else:
            seq += line
    flush()
    return out


def load_structure(path: str | Path) -> list[Structure]:
    """Auto-detect FASTA ('>' first), BPSEQ (3-column integer rows), or RAW
    (reference SStruct.cpp:47-69)."""
    text = Path(path).read_text()
    stripped = text.lstrip()
    if stripped.startswith(">"):
        return parse_fasta_struct(text)
    first = stripped.splitlines()[0].split() if stripped else []
    if len(first) == 3 and first[0].isdigit():
        return [parse_bpseq(text, name=Path(path).stem)]
    return [parse_raw(text, name=Path(path).stem)]
