"""Sequence encoding and padding/batching utilities.

Encoding: 0 = pad/unknown, 1=A, 2=C, 3=G, 4=U (constants.BASES).  All DP code
operates on fixed-shape int arrays with an explicit length, so batches of
unequal-length sequences pad to a bucket length (static shapes).
"""

from __future__ import annotations

import numpy as np

from ..constants import BASES, PAIR_TYPE

_ENC = np.zeros(256, dtype=np.int32)
for _i, _c in enumerate(BASES):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i
_ENC[ord("T")] = 4
_ENC[ord("t")] = 4

_PAIR_TYPE_NP = np.array(PAIR_TYPE, dtype=np.int32)


def encode(seq: str, length: int | None = None) -> np.ndarray:
    """Encode an RNA string to int32 codes, optionally right-padded with 0."""
    a = _ENC[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if length is not None:
        if len(a) > length:
            raise ValueError(f"sequence length {len(a)} exceeds bucket {length}")
        a = np.pad(a, (0, length - len(a)))
    return a


def decode(codes: np.ndarray) -> str:
    return "".join(BASES[c] for c in codes if c != 0)


def pair_type_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pair type (0..6) of 5' bases a against 3' bases b (numpy)."""
    return _PAIR_TYPE_NP[a, b]


def pair_type_matrix(s: np.ndarray) -> np.ndarray:
    """ptype[i, j] = type of pair (i, j), i the 5' partner.  [L, L] int32."""
    return _PAIR_TYPE_NP[s[:, None], s[None, :]]


def bucket_length(n: int, multiple: int = 32, minimum: int = 32) -> int:
    """Round a sequence length up to a device-friendly bucket."""
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)
