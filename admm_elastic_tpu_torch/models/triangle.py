"""Triangle (cloth) strain constraints (reference TriangleForce.cpp).

Selector: 2 row-groups per triangle. The rest-state 2D basis B (3,2) maps
world positions to the 3x2 deformation gradient F = X_def @ B; coeff[e,r,c]
= B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

The port keeps the kernel-backed force's per-element quantities in plane
layout, unpadded: u and z are (6, E) with plane 2a+b holding F_{a,b}; the
selector coefficients are (6, E) with plane 3b+k holding coeff[e,b,k].
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ForceBatch

_D3 = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def build_tri_basis(x: np.ndarray, faces: np.ndarray):
    """Per-triangle B (E,3,2) and rest area (E,)
    (LimitedTriangleStrain::initialize, TriangleForce.cpp:29-63)."""
    f = np.asarray(faces, dtype=np.int64)
    v = np.asarray(x, dtype=np.float64)
    x1, x2, x3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e12 = x2 - x1
    e13 = x3 - x1
    n1 = e12 / np.linalg.norm(e12, axis=1, keepdims=True)
    t = e13 - np.einsum("ij,ij->i", e13, n1)[:, None] * n1
    n2 = t / np.linalg.norm(t, axis=1, keepdims=True)
    # Xg = basis^T @ edges (2x2): rest edges in the orthonormal tangent frame
    Xg = np.stack(
        [
            np.stack([np.einsum("ij,ij->i", n1, e12),
                      np.einsum("ij,ij->i", n1, e13)], 1),
            np.stack([np.einsum("ij,ij->i", n2, e12),
                      np.einsum("ij,ij->i", n2, e13)], 1),
        ],
        axis=1,
    )  # (E,2,2)
    B = np.einsum("ck,ekr->ecr", _D3, np.linalg.inv(Xg))  # (E,3,2)
    area = np.abs(np.linalg.det(Xg)) / 2.0
    return B, area


def _tri_selector_params(faces, B):
    return {
        "indices": np.asarray(faces, dtype=np.int32),
        "coeff": np.transpose(B, (0, 2, 1)).copy(),  # (E,2,3)
    }


def _coeff_planes(params):
    """cp[3b+k, e] = coeff[e,b,k] = B[e,k,b], (6, E) — the selector layout
    the fused local+RHS kernel consumes."""
    return np.ascontiguousarray(
        np.transpose(params["coeff"], (1, 2, 0)).reshape(6, -1)
    )


class LimitedTriangleStrain(ForceBatch):
    """Projective-dynamics triangle strain with strain limiting: project F
    to T = U2 V^T, mix with k = stiffness*area, then clamp the column norms
    of z into [limit_min, limit_max] (TriangleForce.cpp:79-113).

    backend: 'pallas' runs the element step through the hand-written
    kernel (`ops/kernels/tri_local.py`), the counterpart of the JAX
    package's Pallas route. The JAX default 'xla' (vmapped `svd3x2`) is not
    ported yet."""

    R, K = 2, 3

    def __init__(self, faces, stiffness, limit_min=0.0, limit_max=9999999.0,
                 strain_limiting=True, backend="xla"):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.stiffness = np.broadcast_to(np.asarray(stiffness, np.float64),
                                         (E,)).copy()
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64),
                                         (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64),
                                         (E,)).copy()
        self.strain_limiting = bool(strain_limiting)
        if backend == "xla":
            raise NotImplementedError(
                "LimitedTriangleStrain(backend='xla') needs ops/svd.py "
                "(svd3x2), which is not ported yet (ROADMAP A: the "
                "backend='xla' routes); use backend='pallas'"
            )
        if backend != "pallas":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(area)
        params["w2"] = params["weight"] ** 2
        params["k"] = self.stiffness * area
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        params["coeff_p"] = _coeff_planes(params)
        return params, {}

    def dual_init(self):
        return np.zeros((6, self.n_elements))

    supports_fused_local_rhs = True

    def fused_local_rhs(self, params, x, u, state):
        """One kernel for the per-iteration element pipeline: gathered
        positions in; z, u' and the flat D^T W^2 (z-u') rows (E*3, 3)
        out."""
        from ..ops.kernels.tri_local import tri_local_step_fused

        E = params["indices"].shape[0]
        # xg[3k+a, e] = x[face[e,k], a]
        xg = x[params["indices"]].reshape(E, 9).T.contiguous()
        z6, unew6, contrib = tri_local_step_fused(
            xg, u, params["coeff_p"], params["w2"], params["k"],
            params["limit_min"], params["limit_max"],
            limiting=self.strain_limiting,
        )
        # contrib[3k+j, e] -> row 3e+k, column j
        return z6, unew6, state, contrib.T.reshape(E * 3, 3)

    def project(self, Dx, u, params, state):
        raise NotImplementedError(
            "LimitedTriangleStrain.project needs the unfused element step "
            "(tri_local_step, ROADMAP queue B7); the port runs only the "
            "fused dia route"
        )

    def primal_piece(self, params, u_new, u_old):
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))
