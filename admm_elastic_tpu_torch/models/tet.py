"""Tetrahedral hyperelastic constraints (reference TetForce.cpp).

Selector: each tet contributes 3 row-groups; the deformation gradient is
F = X_def @ B with B = D4 @ inv(rest edge matrix) (4x3). coeff[e,r,c] =
B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

The port keeps the per-element quantities of a kernel-backed force in
plane layout, unpadded: u and z are (9, E) with plane 3a+b holding
F_{a,b}; the warm start sigma is (3, E); the selector coefficients are
(12, E) with plane 4b+k holding coeff[e,b,k].
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ForceBatch

_D4 = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)


def build_tet_basis(x: np.ndarray, tets: np.ndarray):
    """Per-tet B (E,4,3) and volume (E,) from rest positions
    (helper::init_tet_force, TetForce.cpp:28-57)."""
    t = np.asarray(tets, dtype=np.int64)
    v = np.asarray(x, dtype=np.float64)
    v0, v1, v2, v3 = (v[t[:, i]] for i in range(4))
    edges = np.stack([v1 - v0, v2 - v0, v3 - v0], axis=2)  # (E,3,3) columns
    det = np.linalg.det(edges)
    bad = np.flatnonzero(np.abs(det) < 1e-300)
    if bad.size:
        raise ValueError(
            f"degenerate (zero-volume) rest tet(s) at indices {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}: cannot build rest basis"
        )
    edges_inv = np.linalg.inv(edges)
    B = np.einsum("ck,ekr->ecr", _D4, edges_inv)  # (E,4,3)
    volume = np.abs(np.einsum("ij,ij->i", v0 - v3, np.cross(v1 - v3, v2 - v3))) / 6.0
    return B, volume


def _tet_selector_params(tets, B):
    """coeff[e,r,c] = B[e,c,r] -> (E,3,4)."""
    return {
        "indices": np.asarray(tets, dtype=np.int32),
        "coeff": np.transpose(B, (0, 2, 1)).copy(),
    }


def _coeff_planes(params):
    """cp[4b+k, e] = coeff[e,b,k] = B[e,k,b], (12, E) — the selector layout
    the fused local+RHS kernel consumes."""
    return np.ascontiguousarray(
        np.transpose(params["coeff"], (1, 2, 0)).reshape(12, -1)
    )


class HyperElasticTet(ForceBatch):
    """General hyperelastic tet: oriented SVD -> minimize the proximal
    objective over the 3 singular values -> z = U diag(sigma*) V^T.

    model: 'nh' | 'stvk'. k = min(mu, lambda); w = sqrt(k * volume).
    backend: 'pallas' runs the element step through the hand-written kernel
    (`ops/kernels/nh_local.py`), the counterpart of the JAX package's Pallas
    route. The JAX default 'xla' (vmapped SVD + Newton, ops/svd.py and
    ops/newton.py) is not ported yet.
    """

    R, K = 3, 4
    SIGMA_FLOOR = 1e-8

    def __init__(self, tets, mu, lam, max_iters=10, model="nh", backend="xla"):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        E = len(self.tets)
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (E,)).copy()
        self.lam = np.broadcast_to(np.asarray(lam, np.float64), (E,)).copy()
        self.max_iters = int(max_iters)
        if model not in ("nh", "stvk"):
            raise ValueError(f"unknown hyperelastic model {model!r}")
        self.model = model
        if backend == "xla":
            raise NotImplementedError(
                "HyperElasticTet(backend='xla') needs ops/svd.py and "
                "ops/newton.py, which are not ported yet (ROADMAP A: the "
                "backend='xla' tet route); use backend='pallas'"
            )
        if backend != "pallas":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        k = np.minimum(self.mu, self.lam)
        params["weight"] = np.sqrt(k) * np.sqrt(vol)
        params["w2"] = params["weight"] ** 2
        params["k"] = k
        params["mu"] = self.mu
        params["lam"] = self.lam
        params["coeff_p"] = _coeff_planes(params)
        # warm start persists across steps (TetForce.hpp:145 last_prox_result)
        state = {"sigma": np.ones((3, self.n_elements))}
        return params, state

    def dual_init(self):
        return np.zeros((9, self.n_elements))

    supports_fused_local_rhs = True

    def fused_local_rhs(self, params, x, u, state):
        """One kernel for the per-iteration element pipeline: gathered
        positions in; z, u', warm start and the flat D^T W^2 (z-u') rows
        (E*4, 3) out."""
        from ..ops.kernels.nh_local import nh_local_step_fused

        E = params["indices"].shape[0]
        # xg[3k+a, e] = x[tet[e,k], a]
        xg = x[params["indices"]].reshape(E, 12).T.contiguous()
        z9, unew9, warm_new, contrib = nh_local_step_fused(
            xg, u, state["sigma"], params["coeff_p"], params["mu"],
            params["lam"], params["k"], params["w2"],
            iters=self.max_iters, model=self.model,
        )
        # contrib[3k+j, e] -> row 4e+k, column j
        flat = contrib.T.reshape(E * 4, 3)
        return z9, unew9, {**state, "sigma": warm_new}, flat

    def project(self, Dx, u, params, state):
        raise NotImplementedError(
            "HyperElasticTet.project needs the unfused element step "
            "(nh_local_step, ROADMAP queue B); the port runs only the fused "
            "dia route"
        )

    def primal_piece(self, params, u_new, u_old):
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))
