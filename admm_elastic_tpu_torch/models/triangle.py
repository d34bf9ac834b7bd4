"""Triangle (cloth) constraints (reference TriangleForce.cpp): strain with
strain limiting, the Fung skin model and area preservation.

Selector: 2 row-groups per triangle. The rest-state 2D basis B (3,2) maps
world positions to the 3x2 deformation gradient F = X_def @ B; coeff[e,r,c]
= B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

LimitedTriangleStrain has two backends, as in the JAX package. The
default 'xla' runs the JAX package's element math in plain PyTorch on
batched tensors (`ops/svd.svd3x2`) in the canonical (E,R,3) layout of
`models/base.py`, with JAX's params. 'pallas' runs the hand-written
kernels and keeps the per-element quantities in plane layout, unpadded:
Dx, u and z are (6, E) with plane 2a+b holding F_{a,b}; the selector
coefficients are (6, E) with plane 3b+k holding coeff[e,b,k]. The fused
kernel forms Dx and the RHS rows itself (the dia route); the unfused
pipeline (the dense and cg global modes, over-relaxation) takes Dx from
`compute_Dx` and its rows from `rhs_contribution`. FungTriangle and
TriArea are canonical-layout plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.tri_local import tri_local_step, tri_local_step_fused
from ..ops.newton import newton_minimize
from ..ops.segment import flat_rows
from ..ops.svd import _matmul, svd3x2
from .base import ForceBatch
from .tet import _F_of, _mix, _reconstruct, _rows_of, check_backend

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
    XML types `lineartrianglestrain` / `trianglestrain`.

    backend: 'xla' (the default: vmapped `svd3x2` in plain PyTorch,
    canonical layout) or 'pallas' (the hand-written kernels of
    `ops/kernels/tri_local.py`)."""

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
        self.backend = check_backend(backend)

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(area)
        params["k"] = self.stiffness * area
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        if self.backend == "pallas":
            params["w2"] = params["weight"] ** 2
            params["coeff_p"] = _coeff_planes(params)
        return params, {}

    def dual_init(self):
        if self.backend == "xla":
            return super().dual_init()
        return np.zeros((6, self.n_elements))

    @property
    def supports_fused_local_rhs(self) -> bool:
        return self.backend == "pallas"

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
        """Dx: (E,2,3) rows on 'xla'; on 'pallas' planes (6, E), plane
        2a+b = sum_k coeff[e,b,k] x[face[e,k], a]."""
        if self.backend == "xla":
            return super().compute_Dx(params, x)
        E = params["indices"].shape[0]
        verts = x[params["indices"]]  # (E,K,3)
        return torch.einsum("ebk,eka->abe", params["coeff"],
                            verts).reshape(6, E).contiguous()

    def rhs_contribution(self, params, z, u):
        """Rows of D^T W^2 (z - u): (E*3, 3)."""
        if self.backend == "xla":
            return super().rhs_contribution(params, z, u)
        E = params["indices"].shape[0]
        y3 = (z - u).reshape(3, 2, E)  # [j,r,e]
        c = torch.einsum("erk,e,jre->ekj", params["coeff"], params["w2"], y3)
        return c.reshape(-1, 3)

    def project_with_dual(self, Dx, u, params, state):
        """The element step from Dx: (z, u', state); on 'pallas' the
        unfused kernel from Dx planes."""
        if self.backend == "xla":
            return super().project_with_dual(Dx, u, params, state)
        z6, unew6 = tri_local_step(Dx, u, params["w2"], params["k"],
                                   params["limit_min"], params["limit_max"],
                                   limiting=self.strain_limiting)
        return z6, unew6, state

    def project(self, Dx, u, params, state):
        """z (and state): canonical rows on 'xla', planes on 'pallas'
        (whose System calls project_with_dual)."""
        if self.backend == "pallas":
            z, _, st = self.project_with_dual(Dx, u, params, state)
            return z, st
        F = _F_of(Dx + u)  # (E,3,2)
        U, _, V = svd3x2(F)
        T = _matmul(U, V.transpose(1, 2))  # U2 @ V^T, (E,3,2)
        zF = _mix(params, T, F)
        if self.strain_limiting:
            # column norms of z, clamped into [limit_min, limit_max]
            # (TriangleForce.cpp:100-107; scale uses max(l, 1e-6))
            l = torch.sqrt(torch.sum(zF * zF, dim=1))  # (E,2)
            lmin = params["limit_min"][:, None]
            lmax = params["limit_max"][:, None]
            safe_l = torch.clamp_min(l, 1e-6)
            scale = torch.where(l < lmin, lmin / safe_l,
                                torch.where(l > lmax, lmax / safe_l, 1.0))
            zF = zF * scale[:, None, :]
        return _rows_of(zF), state

    def primal_piece(self, params, u_new, u_old):
        if self.backend == "xla":
            return super().primal_piece(params, u_new, u_old)
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))


def fung_energy(sigma2, mu, b):
    """Fung exponential skin energy on 2 in-plane singular values with
    incompressibility sigma3 = 1/(sigma1*sigma2) (TriangleForce.cpp:120-144):
    mu/(2b) * (exp(b*(I1-3)) - 1). sigma2 (..., 2); mu broadcasts against
    sigma2[..., 0]."""
    s3 = 1.0 / (sigma2[..., 0] * sigma2[..., 1])
    I1 = sigma2[..., 0] ** 2 + sigma2[..., 1] ** 2 + s3 * s3
    return mu / (2.0 * b) * (torch.exp(b * (I1 - 3.0)) - 1.0)


def _fung_objective(sig, mu, k, s0):
    """One element's Fung prox objective (b = 1)."""
    return fung_energy(sig, mu, 1.0) + 0.5 * k * torch.sum((sig - s0) ** 2,
                                                           dim=-1)


class FungTriangle(ForceBatch):
    """Fung skin model: SVD -> minimize prox over 2 singular values ->
    z = U diag(sigma*) V^T (TriangleForce.cpp:164-248). b = 1, k = mu
    (TriangleForce.hpp:48, TriangleForce.cpp:195-198). L-BFGS (10 iters)
    replaced by the batched Newton, its derivatives by torch.func, as the
    JAX package's by jax.grad / jacfwd."""

    R, K = 2, 3
    SIGMA_FLOOR = 1e-8

    def __init__(self, faces, mu, limit_min=0.0, limit_max=9999999.0, max_iters=10):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (E,)).copy()
        self.limit_min = limit_min
        self.limit_max = limit_max
        self.max_iters = int(max_iters)

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.mu) * np.sqrt(area)
        params["mu"] = self.mu
        params["k"] = self.mu  # TriangleForce.cpp:195
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = svd3x2(F)
        sigma_star = newton_minimize(
            _fung_objective, s, self.max_iters, floor=self.SIGMA_FLOOR,
            params=(params["mu"], params["k"], s))
        return _rows_of(_reconstruct(U, sigma_star, V)), state


class TriArea(ForceBatch):
    """Triangle area preservation: fixed-point clamp of sigma1*sigma2 into
    [limit_min, limit_max] (TriangleForce.cpp:251-295). API-only in the
    reference (not reachable from XML)."""

    R, K = 2, 3

    def __init__(self, faces, stiffness, iters=4, limit_min=1.0, limit_max=1.0):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.stiffness = np.broadcast_to(np.asarray(stiffness, np.float64), (E,)).copy()
        self.iters = int(iters)
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64), (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64), (E,)).copy()

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(area)
        params["k"] = self.stiffness * area
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s0, V = svd3x2(F)
        lmin, lmax = params["limit_min"], params["limit_max"]
        S, d = s0, torch.zeros_like(s0)
        for _ in range(self.iters):
            v = S[:, 0] * S[:, 1]
            f = v - torch.minimum(torch.maximum(v, lmin), lmax)
            g = torch.stack([S[:, 1], S[:, 0]], dim=1)
            gg = torch.sum(g * g, dim=1)
            gd = torch.sum(g * d, dim=1)
            d = -((f - gd) / torch.where(gg > 0, gg, 1.0))[:, None] * g
            S = s0 + d
        return _rows_of(_mix(params, _reconstruct(U, S, V), F)), state
