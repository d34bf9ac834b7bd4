"""Procedural mesh builders (numpy, host side).

Counterpart of `admm_elastic_tpu/geometry/primitives.py`; only
`make_beam_tets` (the 100k-tet benchmark mesh) and `make_plane_grid` (the
cloth100k sheet) are ported so far.
"""

from __future__ import annotations

import numpy as np

from .tetmesh import TetMesh
from .trimesh import TriMesh


def make_beam_tets(nx: int, ny: int, nz: int, size: float = 1.0) -> TetMesh:
    """Regular (nx,ny,nz)-cell hexahedral beam split into 5 tets per cell.

    (nx*ny*nz*5 tets; used to generate the 100k-tet benchmark mesh.)
    Alternating cell parity keeps shared faces conforming.
    """
    gx, gy, gz = nx + 1, ny + 1, nz + 1
    xs = np.linspace(0.0, size * nx, gx)
    ys = np.linspace(0.0, size * ny, gy)
    zs = np.linspace(0.0, size * nz, gz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * gy + j) * gz + k

    # 5-tet decompositions for even/odd parity cells
    even = [(0, 1, 2, 5), (0, 2, 3, 7), (0, 5, 7, 4), (2, 7, 5, 6), (0, 2, 5, 7)]
    odd = [(1, 3, 0, 4), (1, 6, 2, 3), (1, 4, 6, 5), (3, 6, 4, 7), (1, 3, 4, 6)]

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [
                    vid(i, j, k),
                    vid(i + 1, j, k),
                    vid(i + 1, j + 1, k),
                    vid(i, j + 1, k),
                    vid(i, j, k + 1),
                    vid(i + 1, j, k + 1),
                    vid(i + 1, j + 1, k + 1),
                    vid(i, j + 1, k + 1),
                ]
                pattern = even if (i + j + k) % 2 == 0 else odd
                for t in pattern:
                    tets.append((c[t[0]], c[t[1]], c[t[2]], c[t[3]]))
    return TetMesh(verts.astype(np.float64), np.asarray(tets, dtype=np.int32))


def make_plane_grid(nx: int, ny: int, size: float = 1.0) -> TriMesh:
    """Regular (nx,ny)-quad cloth plane without center vertices: grid
    vertices only, each quad split into two triangles along a consistent
    diagonal, spanning [-size, size]^2 at z=0. The vertex set is a regular
    grid, so A_hat collapses onto constant diagonals."""
    gx, gy = nx + 1, ny + 1
    xs = np.linspace(-size, size, gx)
    ys = np.linspace(-size, size, gy)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(gx * gy)], axis=1)

    def vid(i, j):
        return i * gy + j

    faces = []
    for i in range(nx):
        for j in range(ny):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return TriMesh(
        vertices=verts, faces=np.asarray(faces, dtype=np.int32)
    )
