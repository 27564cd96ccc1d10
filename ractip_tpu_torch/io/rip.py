"""Import posterior probabilities from the RIP program's output tables.

A copy of ractip_tpu/io/rip.py (numpy only), kept in the port so that it
imports nothing of the JAX package.

Equivalent of the reference's hidden --rip path (reference src/ractip.cpp:
461-514): sections headed "Table R:" (bp of sequence 1), "Table S:" (bp of
sequence 2) and "Table I:" (hybridization) hold `i j p` rows with 1-based
indices; sequence-2 indices are stored reversed (RIP numbers the second
strand 3'->5', reference :503 and :506), so S entries map to
(L2-j+1, L2-i+1) and I entries to (i, L2-j+1).  Returned matrices are
0-based dense [n, n] / [n1, n2].
"""

from __future__ import annotations

import numpy as np


def load_rip(path: str, n1: int, n2: int):
    """Returns (bp1 [n1,n1], bp2 [n2,n2], hp [n1,n2]) float32 matrices."""
    bp1 = np.zeros((n1, n1), np.float32)
    bp2 = np.zeros((n2, n2), np.float32)
    hp = np.zeros((n1, n2), np.float32)
    state = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("Table R:"):
                state = "R"
            elif line.startswith("Table S:"):
                state = "S"
            elif line.startswith("Table I:"):
                state = "I"
            elif state and line[:1].isdigit():
                si, sj, sp = line.split()[:3]
                i, j, p = int(si), int(sj), float(sp)
                if state == "R":
                    bp1[i - 1, j - 1] = p
                elif state == "S":
                    bp2[n2 - j, n2 - i] = p
                else:
                    hp[i - 1, n2 - j] = p
            else:
                state = None
    return bp1, bp2, hp
