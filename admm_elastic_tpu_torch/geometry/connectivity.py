"""Mesh connectivity: unique edges, across-edge adjacency, bend hinges.

Counterpart of `admm_elastic_tpu/geometry/connectivity.py`, numpy path
only (the JAX package's optional ctypes helpers are not ported). Hinge
extraction follows the reference C++ solver: for every face f
and each of its three edges, if a neighboring face exists across that edge,
emit the 4-vertex hinge in Volino ordering (wing0, wing1, shared_a,
shared_b) and deduplicate by the sorted vertex set.
"""

from __future__ import annotations

import numpy as np


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges of a triangle mesh, (E,2) int32, each
    oriented as its first occurrence in face order."""
    f = np.asarray(faces, dtype=np.int64)
    # interleave per face so the order follows the per-face loop
    e = np.concatenate(
        [f[:, [0, 1]][:, None, :], f[:, [0, 2]][:, None, :],
         f[:, [1, 2]][:, None, :]],
        axis=1,
    ).reshape(-1, 2)
    key = np.sort(e, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return e[np.sort(first)].astype(np.int32)


def across_edge(faces: np.ndarray) -> np.ndarray:
    """For each face f and corner c, index of the face sharing the edge
    opposite corner c, or -1."""
    f = np.asarray(faces, dtype=np.int64)
    F = f.shape[0]
    # edge opposite corner c is (v[(c+1)%3], v[(c+2)%3])
    edges = np.stack(
        [
            np.sort(f[:, [1, 2]], axis=1),
            np.sort(f[:, [2, 0]], axis=1),
            np.sort(f[:, [0, 1]], axis=1),
        ],
        axis=1,
    ).reshape(-1, 2)  # (F*3, 2), row f*3+c
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    se = edges[order]
    match = np.all(se[:-1] == se[1:], axis=1)
    out = np.full(F * 3, -1, dtype=np.int64)
    a, b = order[:-1][match], order[1:][match]
    out[a] = b // 3
    out[b] = a // 3
    return out.reshape(F, 3).astype(np.int32)


def extract_hinges(faces: np.ndarray) -> np.ndarray:
    """Bend hinges in Volino ordering: rows (x0, x1, x2, x3) int32 where
    x0/x1 are the wing vertices and x2/x3 the shared edge, deduplicated.
    For face f, corners are checked in order 0,1,2; hinge = (p_c,
    unique_vert(neighbor), p_{c+2 mod 3}, p_{c+1 mod 3})."""
    f = np.asarray(faces, dtype=np.int64)
    adj = across_edge(faces).astype(np.int64)
    hinges = []
    seen: set[tuple[int, int, int, int]] = set()
    for fi in range(f.shape[0]):
        p = f[fi]
        for c in range(3):
            nf = adj[fi, c]
            if nf < 0:
                continue
            shared = {p[(c + 1) % 3], p[(c + 2) % 3]}
            other = [v for v in f[nf] if v not in shared]
            if len(other) != 1:
                continue  # degenerate neighbor
            hv = (int(p[c]), int(other[0]), int(p[(c + 2) % 3]),
                  int(p[(c + 1) % 3]))
            key = tuple(sorted(hv))
            if key in seen:
                continue
            seen.add(key)
            hinges.append(hv)
    if not hinges:
        return np.zeros((0, 4), dtype=np.int32)
    return np.asarray(hinges, dtype=np.int32)
