"""Accuracy evaluation: sensitivity / PPV / F-measure over predicted pairs.

A copy of ractip_tpu/evaluate/fmeasure.py, kept in the port so that it imports
nothing of the JAX package.

Python equivalent of the reference's Ruby scorer (reference utils/eval.rb:
31-54): external pairs are parsed from '[]' over the *concatenation* of the
two bracket strings, internal pairs from '()' per sequence; each of
(external, internal, all) gets sensitivity = TP/answer, PPV = TP/predicted,
F = harmonic mean.  Also includes the 2-row answer-format converter of
reference examples/conv.rb.
"""

from __future__ import annotations

import dataclasses


def paren_pairs(s: str, open_ch: str, close_ch: str) -> set[tuple[int, int]]:
    st, out = [], set()
    for i, ch in enumerate(s):
        if ch == open_ch:
            st.append(i)
        elif ch == close_ch:
            if not st:
                raise ValueError("unbalanced brackets")
            out.add((st.pop(), i))
    return out


@dataclasses.dataclass
class PairSets:
    external: set
    internal1: set
    internal2: set

    @classmethod
    def from_brackets(cls, r1: str, r2: str) -> "PairSets":
        return cls(external=paren_pairs(r1 + r2, "[", "]"),
                   internal1=paren_pairs(r1, "(", ")"),
                   internal2=paren_pairs(r2, "(", ")"))


def _acc(tp: int, n_ans: int, n_res: int):
    sen = tp / n_ans if n_ans else 0.0
    ppv = tp / n_res if n_res else 0.0
    f = 2 * ppv * sen / (ppv + sen) if ppv + sen else 0.0
    return sen, ppv, f


def evaluate(answer: PairSets, result: PairSets) -> dict:
    """{'external'|'internal'|'all': (sensitivity, PPV, F)}."""
    ex_tp = len(answer.external & result.external)
    in_tp = (len(answer.internal1 & result.internal1)
             + len(answer.internal2 & result.internal2))
    ex_ans = len(answer.external)
    ex_res = len(result.external)
    in_ans = len(answer.internal1) + len(answer.internal2)
    in_res = len(result.internal1) + len(result.internal2)
    return {
        "external": _acc(ex_tp, ex_ans, ex_res),
        "internal": _acc(in_tp, in_ans, in_res),
        "all": _acc(ex_tp + in_tp, ex_ans + in_ans, ex_res + in_res),
    }


def convert_answer(text: str) -> list[tuple[str, str, str]]:
    """Convert the 2-row answer format of examples/RNA-RNAdata.zip
    (internal-bracket row + external-bracket row per sequence) into
    (name, seq, single-line brackets) records (reference examples/conv.rb)."""
    lines = text.splitlines()
    out = []
    for base in (0, 6):
        t = lines[base: base + 5]
        internal = t[2].replace(" ", "").replace("\t", "")
        external = t[4].replace(" ", "").replace("\t", "")
        merged = "".join(
            ic if ic != "." else (ec if ec != "." else ".")
            for ic, ec in zip(internal, external))
        seq = t[3].replace("5'-", "").replace("-3'", "")
        out.append((t[0], seq, merged))
    return out
