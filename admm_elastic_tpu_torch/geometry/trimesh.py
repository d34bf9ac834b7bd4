"""Triangle mesh container (numpy, host side).

Counterpart of `admm_elastic_tpu/geometry/trimesh.py`; only the `TriMesh`
record is ported so far. The OBJ/PLY loaders and vertex normals come with
the scene layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TriMesh:
    """Vertices (n,3) float64, faces (F,3) int32."""

    vertices: np.ndarray
    faces: np.ndarray

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])
