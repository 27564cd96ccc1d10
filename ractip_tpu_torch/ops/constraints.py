"""Constraint strings -> partition-function hard-constraint masks.

A copy of ractip_tpu/ops/constraints.py (numpy only), kept in the port so
that it imports nothing of the JAX package.

The reference passes FASTA constraint strings (reference src/fa.cpp:36-83
attaches a line of "()[].?xle " characters to a sequence) into ViennaRNA's
constrained partition functions when -c/--use-constraint is set:

  * single-sequence pf_fold: '[' / ']' / 'e' are rewritten to 'x' (the
    interaction site must stay unpaired intra-molecularly) and the rest of the
    string is forwarded verbatim (reference src/ractip.cpp:270-290);
  * co_pf_fold over s1+s2: '[' in s1 becomes '(' and ']' in s2 becomes ')'
    (the annotated interaction site must pair across the cut) while
    intra-structure characters '(' ')' 'l' 'x' become 'x'
    (reference src/ractip.cpp:403-444).

This module reduces those Vienna dot-bracket constraint alphabets to a single
TPU-friendly representation: a boolean "allow" matrix over pair positions that
ops.mccaskill / ops.cofold / ops.accessibility fold into their Boltzmann
factor matrices (any structure containing a banned pair gets weight zero).

Character semantics implemented (Vienna hard-constraint alphabet):
  'x'      position may not pair (row/column banned)
  '(' ')'  matched brackets: the two positions may only pair with each other
  '('      unmatched: the position may only pair downstream
  ')'      unmatched: the position may only pair upstream
  '<' '>'  same directional restriction as unmatched '(' / ')'
  '|'      "must pair": kept as a no-op at the pf level -- a pure pair-mask
           cannot force pairing; Vienna 1.8's pf constraint handling has the
           same pairing-restriction-only character
  '.' '?'  no constraint (everything else is ignored, like Vienna)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "allow_from_db", "fold_allow", "cofold_allow",
    "fold_constraint_string", "cofold_constraint_string",
]


def _matched(c: str) -> dict[int, int]:
    """Stack-match '(' with ')'.  Unmatched brackets keep directional meaning."""
    stack: list[int] = []
    out: dict[int, int] = {}
    for i, ch in enumerate(c):
        if ch == "(":
            stack.append(i)
        elif ch == ")" and stack:
            j = stack.pop()
            out[j] = i
            out[i] = j
    return out

def allow_from_db(c: str, L: int) -> np.ndarray:
    """Bool [L, L] pair mask from a Vienna dot-bracket constraint string.

    Positions >= len(c) (including bucket padding) are unconstrained; the mask
    is symmetric so callers may use either triangle convention.
    """
    allow = np.ones((L, L), bool)
    mate = _matched(c)
    for i, ch in enumerate(c[:L]):
        if ch == "x":
            allow[i, :] = False
            allow[:, i] = False
        elif ch in "(<" :
            if i in mate:
                j = mate[i]
                allow[i, :] = False
                allow[:, i] = False
                allow[j, :] = False
                allow[:, j] = False
                allow[i, j] = allow[j, i] = True
                # Vienna additionally forbids every pair crossing the forced
                # span (make_ptypes / 2.x hard constraints zero ptype for
                # (k,l) with k<i<=l<=j or i<=k<=j<l); without this the
                # constrained ensemble admits pseudoknot-like crossings the
                # reference's pf never counts.
                jc = min(j, L - 1)
                if i < L:
                    allow[:i, i:jc + 1] = False
                    allow[i:jc + 1, :i] = False
                    allow[i:jc + 1, jc + 1:] = False
                    allow[jc + 1:, i:jc + 1] = False
                    allow[i, j] = allow[j, i] = True
            else:
                # paired downstream: ban (k < i, i)
                allow[:i, i] = False
                allow[i, :i] = False
        elif ch in ")>":
            if i in mate:
                pass  # handled from the '(' side
            else:
                allow[i, i + 1:] = False
                allow[i + 1:, i] = False
    return allow


def fold_constraint_string(str_: str, n: int) -> str:
    """The reference's rnafold() rewrite: '['/']'/'e' -> 'x', rest verbatim
    (reference src/ractip.cpp:270-290)."""
    out = []
    for ch in str_[:n]:
        out.append("x" if ch in "[]e" else ch)
    return "".join(out)


def cofold_constraint_string(str1: str, str2: str, n1: int, n2: int) -> str:
    """The reference's rnaduplex() rewrite over the concatenation
    (reference src/ractip.cpp:410-436)."""
    c = ["."] * (n1 + n2)
    for i, ch in enumerate(str1[:n1]):
        if ch == "[":
            c[i] = "("
        elif ch in "()lx":
            c[i] = "x"
    for i, ch in enumerate(str2[:n2]):
        if ch == "]":
            c[n1 + i] = ")"
        elif ch in "()lx":
            c[n1 + i] = "x"
    return "".join(c)


def fold_allow(str_: str | None, n: int, L: int) -> np.ndarray | None:
    """Single-sequence pf mask for -c (None when there is no constraint)."""
    if not str_:
        return None
    return allow_from_db(fold_constraint_string(str_, n), L)


def cofold_allow(str1: str | None, str2: str | None, n1: int, n2: int,
                 L: int) -> np.ndarray | None:
    """Concatenation pf mask for -c.  Strand-2 base j sits at concat position
    n1 + j (ops.cofold packs the strands contiguously before padding)."""
    if not str1 and not str2:
        return None
    return allow_from_db(
        cofold_constraint_string(str1 or "", str2 or "", n1, n2), L)
