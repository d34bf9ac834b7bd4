"""Triangle (cloth) strain constraints (reference TriangleForce.cpp).

Selector: 2 row-groups per triangle. The rest-state 2D basis B (3,2) maps
world positions to the 3x2 deformation gradient F = X_def @ B; coeff[e,r,c]
= B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

The port keeps the kernel-backed force's per-element quantities in plane
layout, unpadded: Dx, u and z are (6, E) with plane 2a+b holding F_{a,b};
the selector coefficients are (6, E) with plane 3b+k holding coeff[e,b,k].
The fused kernel forms Dx and the RHS rows itself (the dia route); the
unfused pipeline (the dense and cg global modes, over-relaxation) takes Dx
from `compute_Dx` and its rows from `rhs_contribution`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.tri_local import tri_local_step, tri_local_step_fused
from .base import ForceBatch, flat_rows

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
    kernels (`ops/kernels/tri_local.py`), the counterpart of the JAX
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
                "(svd3x2), which is not ported yet (ROADMAP A2 item 2a: the "
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

    def fused_local_rhs(self, params, x, u, state, with_z=False):
        """One kernel for the per-iteration element pipeline: gathered
        positions in; z, u' and the flat D^T W^2 (z-u') rows (E*3, 3) out;
        with_z, (E*3, 6) rows whose columns 3:6 are D^T W^2 z (the kernel's
        emit_z block), as rhs_contribution6."""
        E = params["indices"].shape[0]
        # xg[3k+a, e] = x[face[e,k], a]
        xg = x[params["indices"]].reshape(E, 9).T.contiguous()
        z6, unew6, *rows = tri_local_step_fused(
            xg, u, params["coeff_p"], params["w2"], params["k"],
            params["limit_min"], params["limit_max"],
            limiting=self.strain_limiting, emit_z=with_z,
        )
        return z6, unew6, state, flat_rows(rows)

    def compute_Dx(self, params, x):
        """Dx planes (6, E): plane 2a+b = sum_k coeff[e,b,k] x[face[e,k], a]."""
        E = params["indices"].shape[0]
        verts = x[params["indices"]]  # (E,K,3)
        return torch.einsum("ebk,eka->abe", params["coeff"],
                            verts).reshape(6, E).contiguous()

    def rhs_contribution(self, params, z, u):
        """Rows of D^T W^2 (z - u) from planes: (E*3, 3)."""
        E = params["indices"].shape[0]
        y3 = (z - u).reshape(3, 2, E)  # [j,r,e]
        c = torch.einsum("erk,e,jre->ekj", params["coeff"], params["w2"], y3)
        return c.reshape(-1, 3)

    def project_with_dual(self, Dx, u, params, state):
        """The unfused element step from Dx planes: (z6, u6', state)."""
        z6, unew6 = tri_local_step(Dx, u, params["w2"], params["k"],
                                   params["limit_min"], params["limit_max"],
                                   limiting=self.strain_limiting)
        return z6, unew6, state

    def project(self, Dx, u, params, state):
        """Plane-layout z (and state); the System calls project_with_dual."""
        z, _, st = self.project_with_dual(Dx, u, params, state)
        return z, st

    def primal_piece(self, params, u_new, u_old):
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))
