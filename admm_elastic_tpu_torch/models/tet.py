"""Tetrahedral strain constraints (reference TetForce.cpp): the
hyperelastic tet (NeoHookean / StVK) and the corotational (ARAP) tet.

Selector: each tet contributes 3 row-groups; the deformation gradient is
F = X_def @ B with B = D4 @ inv(rest edge matrix) (4x3). coeff[e,r,c] =
B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

The port keeps the per-element quantities of a kernel-backed force in
plane layout, unpadded: Dx, u and z are (9, E) with plane 3a+b holding
F_{a,b}; the warm start sigma is (3, E); the selector coefficients are
(12, E) with plane 4b+k holding coeff[e,b,k]. The fused kernels gather
the positions and form Dx and the RHS rows themselves (the dia/ell
route); the unfused pipeline (the dense and cg global modes,
over-relaxation) takes Dx from `compute_Dx` and its rows from
`rhs_contribution`. Both take output buffers (`fused_out_buffers`,
`project_out_buffers`), which the System hands them in turn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.nh_local import nh_local_step, nh_local_step_fused
from ..ops.kernels.tet_local import arap_local_step, arap_local_step_fused
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


class _TetPlanes(ForceBatch):
    """Plane-layout Dx/u/z of a kernel-backed tet force, unpadded (the
    JAX package's _PlaneLayoutMixin without the block padding)."""

    R, K = 3, 4

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    def dual_init(self):
        return np.zeros((9, self.n_elements))

    supports_fused_local_rhs = True

    def compute_Dx(self, params, x):
        """Dx planes (9, E): plane 3a+b = sum_k coeff[e,b,k] x[tet[e,k], a]."""
        E = params["indices"].shape[0]
        verts = x[params["indices"]]  # (E,K,3)
        return torch.einsum("ebk,eka->abe", params["coeff"],
                            verts).reshape(9, E).contiguous()

    def rhs_contribution(self, params, z, u):
        """Rows of D^T W^2 (z - u) from planes: (E*4, 3)."""
        E = params["indices"].shape[0]
        y3 = (z - u).reshape(3, 3, E)  # [a,b,e] = ycan[e,b,a]
        c = torch.einsum("erk,e,jre->ekj", params["coeff"], params["w2"], y3)
        return c.reshape(-1, 3)

    def _step_shapes(self):
        """The shapes of the element step's outputs: z9, u9'."""
        E = self.n_elements
        return (9, E), (9, E)

    def fused_out_buffers(self, x, with_z=False):
        """A new set of fused_local_rhs's outputs (the element step's,
        then the rows) of x's dtype and device, to give it as `out`."""
        return tuple(x.new_empty(s) for s in (
            *self._step_shapes(),
            (4 * self.n_elements, 6 if with_z else 3)))

    def project_out_buffers(self, x):
        """A new set of project_with_dual's outputs of x's dtype and
        device, to give it as `out`."""
        return tuple(x.new_empty(s) for s in self._step_shapes())

    def project(self, Dx, u, params, state):
        """Plane-layout z (and new state); the System calls
        project_with_dual."""
        z, _, st = self.project_with_dual(Dx, u, params, state)
        return z, st

    def primal_piece(self, params, u_new, u_old):
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))


class HyperElasticTet(_TetPlanes):
    """General hyperelastic tet: oriented SVD -> minimize the proximal
    objective over the 3 singular values -> z = U diag(sigma*) V^T.

    model: 'nh' | 'stvk'. k = min(mu, lambda); w = sqrt(k * volume).
    backend: 'pallas' runs the element step through the hand-written
    kernels (`ops/kernels/nh_local.py`), the counterpart of the JAX
    package's Pallas route. The JAX default 'xla' (vmapped SVD + Newton,
    ops/svd.py and ops/newton.py) is not ported yet.
    """

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
                "ops/newton.py, which are not ported yet (ROADMAP A2 item "
                "2a: the backend='xla' routes); use backend='pallas'"
            )
        if backend != "pallas":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend

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

    def fused_local_rhs(self, params, x, u, state, with_z=False, out=None):
        """One kernel for the per-iteration element pipeline: positions x
        (n,3) in (the kernel gathers each tet's vertices); z, u', warm start
        and the flat D^T W^2 (z-u') rows (E*4, 3) out; with_z, (E*4, 6)
        rows whose columns 3:6 are D^T W^2 z (the kernel's emit_z mode),
        as rhs_contribution6. `out`: a set of `fused_out_buffers` to write
        in place of new tensors."""
        z9, unew9, warm_new, rows = nh_local_step_fused(
            x, params["indices"], u, state["sigma"], params["coeff_p"],
            params["mu"], params["lam"], params["k"], params["w2"],
            iters=self.max_iters, model=self.model, emit_z=with_z, out=out,
        )
        return z9, unew9, {**state, "sigma": warm_new}, rows

    def _step_shapes(self):
        """z9, u9' and the warm start."""
        return (*super()._step_shapes(), (3, self.n_elements))

    def project_with_dual(self, Dx, u, params, state, out=None):
        """The unfused element step from Dx planes: (z9, u9', state with
        the new warm start). `out`: a set of `project_out_buffers` to write
        in place of new tensors."""
        z9, unew9, warm_new = nh_local_step(
            Dx, u, state["sigma"], params["mu"], params["lam"], params["k"],
            iters=self.max_iters, model=self.model, out=out)
        return z9, unew9, {**state, "sigma": warm_new}


class LinearTetStrain(_TetPlanes):
    """Corotational/ARAP tet: project F to the closest rotation and mix
    with k = stiffness * volume (TetForce.cpp:112-153); the constraint of
    projective dynamics.

    backend: 'pallas' runs the element step through the hand-written
    kernels (`ops/kernels/tet_local.py`). The JAX default 'xla' (vmapped
    ops/svd.polar_project) is not ported yet."""

    def __init__(self, tets, stiffness, weight_scale=1.0, backend="xla"):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (len(self.tets),)
        ).copy()
        self.weight_scale = weight_scale  # parsed but unused, like the reference
        if backend == "xla":
            raise NotImplementedError(
                "LinearTetStrain(backend='xla') needs ops/svd.polar_project, "
                "which is not ported yet (ROADMAP A2 item 2a: the "
                "backend='xla' routes); use backend='pallas'"
            )
        if backend != "pallas":
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(vol)
        params["w2"] = params["weight"] ** 2
        params["k"] = self.stiffness * vol
        params["coeff_p"] = _coeff_planes(params)
        return params, {}

    def fused_local_rhs(self, params, x, u, state, with_z=False, out=None):
        """One kernel for the per-iteration element pipeline: positions x
        (n,3) in (the kernel gathers each tet's vertices); z, u' and the
        flat D^T W^2 (z-u') rows (E*4, 3) out (with_z: (E*4, 6), as
        HyperElasticTet's). `out`: a set of `fused_out_buffers` to write
        in place of new tensors."""
        z9, unew9, rows = arap_local_step_fused(
            x, params["indices"], u, params["coeff_p"], params["w2"],
            params["k"], emit_z=with_z, out=out)
        return z9, unew9, state, rows

    def project_with_dual(self, Dx, u, params, state, out=None):
        """The unfused element step from Dx planes: (z9, u9', state).
        `out`: a set of `project_out_buffers` to write in place of new
        tensors."""
        z9, unew9 = arap_local_step(Dx, u, params["w2"], params["k"],
                                    out=out)
        return z9, unew9, state
