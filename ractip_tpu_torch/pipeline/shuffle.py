"""Exact k-let-preserving sequence shuffling (uShuffle algorithm).

Reimplements the Euler-path shuffle of the reference (reference
src/ushuffle.c:80-270): build the (k-1)-let transition multigraph, draw a
uniform random arborescence rooted at the final vertex (Wilson's
loop-erased random walks), order each vertex's out-edges randomly with the
arborescence edge last, and walk the Euler path from the first vertex.  The
result preserves every k-let count exactly (for k=2: all dinucleotide counts,
hence the z-score null model of reference src/ractip.cpp:1638-1643).

Host-side: shuffling is sequential pointer-chasing over tiny strings and
feeds the batched device pipeline as plain input data.  The hot path (thousands
of z-score decoys) runs in the native C++ host library
(native/ushuffle.cc) via `shuffle_batch`; this module is the
reference implementation and fallback.
"""

from __future__ import annotations

import numpy as np

from .. import native


def shuffle_batch(seq: str, count: int, seed: int, k: int = 2,
                  prefer_native: bool = True) -> list[str]:
    """`count` independent exact k-let-preserving shuffles of seq.

    Uses the native C++ shuffler when available (deterministic in (seed, r));
    otherwise falls back to the Python implementation below seeded from the
    same seed.  Both preserve every k-let count exactly.
    """
    if prefer_native:
        out = native.ushuffle_batch(seq, k, seed, count)
        if out is not None:
            return out
    rng = np.random.default_rng(seed)
    return [dinuc_shuffle(seq, rng, k) for _ in range(count)]


def dinuc_shuffle(seq: str, rng: np.random.Generator, k: int = 2) -> str:
    n = len(seq)
    if k >= n or k <= 1:
        # degenerate cases: uShuffle k<=1 is a plain permutation; k>=n is identity
        if k <= 1:
            arr = list(seq)
            rng.shuffle(arr)
            return "".join(arr)
        return seq

    lets = [seq[i: i + k - 1] for i in range(n - k + 2)]
    verts = sorted(set(lets))
    vid = {v: i for i, v in enumerate(verts)}
    nv = len(verts)
    path = [vid[v] for v in lets]            # vertex walk of length n-k+2
    root = path[-1]

    # multigraph out-edges
    out: list[list[int]] = [[] for _ in range(nv)]
    for a, b in zip(path[:-1], path[1:]):
        out[a].append(b)

    # Wilson's algorithm: random arborescence oriented toward the root.
    # next_v[v] = successor of v on its tree path to root.
    next_v = np.full(nv, -1, np.int64)
    in_tree = np.zeros(nv, bool)
    in_tree[root] = True
    succ = [sorted(set(o)) for o in out]     # distinct successors
    weights = []
    for v in range(nv):
        cnt = {u: 0 for u in succ[v]}
        for u in out[v]:
            cnt[u] += 1
        tot = len(out[v])
        weights.append(np.array([cnt[u] / tot for u in succ[v]])
                       if tot else None)
    for v0 in range(nv):
        if in_tree[v0]:
            continue
        v = v0
        while not in_tree[v]:                # random walk with loop erasure
            j = rng.choice(len(succ[v]), p=weights[v])
            next_v[v] = succ[v][j]
            v = int(next_v[v])
        v = v0
        while not in_tree[v]:
            in_tree[v] = True
            v = int(next_v[v])

    # shuffle out-edge order; the arborescence edge goes last (guarantees an
    # Eulerian walk that consumes every edge)
    for v in range(nv):
        edges = out[v]
        rng.shuffle(edges)
        if v != root and edges:
            t = int(next_v[v])
            idx = max(i for i, u in enumerate(edges) if u == t)
            edges[idx], edges[-1] = edges[-1], edges[idx]

    # Euler walk from the first vertex
    pos = [0] * nv
    walk = [path[0]]
    v = path[0]
    for _ in range(len(path) - 1):
        u = out[v][pos[v]]
        pos[v] += 1
        walk.append(u)
        v = u

    pieces = [verts[walk[0]]]
    for u in walk[1:]:
        pieces.append(verts[u][-1] if k > 2 else verts[u])
    return "".join(pieces)[:n] if k > 2 else "".join(pieces)


def klet_counts(seq: str, k: int) -> dict:
    c: dict = {}
    for i in range(len(seq) - k + 1):
        w = seq[i: i + k]
        c[w] = c.get(w, 0) + 1
    return c
