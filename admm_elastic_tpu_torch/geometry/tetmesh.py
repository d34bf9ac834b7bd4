"""Tetrahedral mesh container (numpy, host side).

Counterpart of `admm_elastic_tpu/geometry/tetmesh.py`; only the `TetMesh`
class is ported so far. Loaders and surface extraction come with the
scene layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TetMesh:
    """Vertices (n,3) float64 and tets (T,4) int32."""

    vertices: np.ndarray
    tets: np.ndarray
    faces: np.ndarray | None = None  # boundary surface triangles, (F,3) int32

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_tets(self) -> int:
        return int(self.tets.shape[0])

    def apply_xform(self, M: np.ndarray) -> "TetMesh":
        """Apply a 4x4 homogeneous transform to the vertices (in place)."""
        v = self.vertices
        vh = v @ M[:3, :3].T + M[:3, 3]
        self.vertices = vh
        return self

    def save(self, prefix: str) -> None:
        """Write .node/.ele files (0-indexed)."""
        with open(prefix + ".node", "w") as f:
            f.write(f"{self.n_vertices} 3 0 0\n")
            for i, p in enumerate(self.vertices):
                f.write(f"{i} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        with open(prefix + ".ele", "w") as f:
            f.write(f"{self.n_tets} 4 0\n")
            for i, t in enumerate(self.tets):
                f.write(f"{i} {t[0]} {t[1]} {t[2]} {t[3]}\n")
