"""Tetrahedral strain constraints (reference TetForce.cpp): the
hyperelastic tet (NeoHookean / StVK), the corotational (ARAP) tet and
volume preservation.

Selector: each tet contributes 3 row-groups; the deformation gradient is
F = X_def @ B with B = D4 @ inv(rest edge matrix) (4x3). coeff[e,r,c] =
B[e,c,r], so the canonical (E,R,3) layout Dx[e,r,:] holds F^T rows.

Two backends, as in the JAX package. The default 'xla' runs the JAX
package's own element math in plain PyTorch on batched tensors (the SVD
of `ops/svd.py`, the Newton of `ops/newton.py`) and keeps Dx, u and z in
the canonical (E,R,3) layout of `models/base.py`, with JAX's params and
state (the warm start sigma (E,3)). 'pallas' runs the hand-written
kernels and keeps the per-element quantities in plane layout, unpadded:
Dx, u and z are (9, E) with plane 3a+b holding F_{a,b}; the warm start
sigma is (3, E); the selector coefficients are (12, E) with plane 4b+k
holding coeff[e,b,k]. The fused kernels gather the positions and form Dx
and the RHS rows themselves (the dia/ell route); the unfused pipeline
(the dense and cg global modes, over-relaxation) takes Dx from
`compute_Dx` and its rows from `rhs_contribution`. Both take output
buffers (`fused_out_buffers`, `project_out_buffers`), which the System
hands them in turn; an 'xla' force offers none.

Sign convention note: the reference reconstructs z from a *plain* SVD
(sigma >= 0, U/V possibly improper) after modifying the singular values;
the oriented SVD has proper rotations and a signed s2. The two
reconstructions are related by flipping the third modified singular value
when det F < 0 — see `_reconstruct_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.nh_local import nh_local_step, nh_local_step_fused
from ..ops.kernels.tet_local import arap_local_step, arap_local_step_fused
from ..ops.newton import newton_minimize
from ..ops.svd import _matmul, polar_project, svd3x3_oriented
from .base import ForceBatch

BACKENDS = ("xla", "pallas")

_D4 = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)


def check_backend(backend):
    """The backend, or JAX's ValueError for an unknown one."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


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


def _F_of(Dxu):
    """(E,R,C) canonical rows -> (E,C,R) deformation gradients."""
    return Dxu.transpose(1, 2)


_rows_of = _F_of


def _reconstruct(U, s, V):
    """U diag(s) V^T for (E,3,R) U, (E,R) s, (E,C,R) V, as the JAX
    package's einsum runs it: s into V, then the product."""
    return _matmul(U, (V * s[:, None, :]).transpose(1, 2))


def _reconstruct_plain(U, V, s_mod, s2_sign):
    """U_o diag(s_mod') V_o^T equal to the reference's plain-SVD
    reconstruction U_p diag(s_mod) V_p^T: flip the third entry when the
    element is inverted (plain factors absorb the reflection that the
    oriented factors put into sign(s2))."""
    flip = torch.where(s2_sign < 0, -1.0, 1.0).to(s_mod.dtype)
    s = torch.cat([s_mod[:, :2], s_mod[:, 2:] * flip[:, None]], dim=1)
    return _reconstruct(U, s, V)


def _mix(params, p, F):
    """(k p + w^2 F) / (w^2 + k): the projection p blended with F."""
    k = params["k"][:, None, None]
    w = params["weight"]
    w2 = (w * w)[:, None, None]
    return (k * p + w2 * F) / (w2 + k)


class _TetForce(ForceBatch):
    """A tet force of either backend: the canonical layout of the base
    class on 'xla'; on 'pallas', plane-layout Dx/u/z, unpadded (the JAX
    package's _PlaneLayoutMixin without the block padding), and the
    kernels' output buffers."""

    R, K = 3, 4

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    @property
    def supports_fused_local_rhs(self) -> bool:
        return self.backend == "pallas"

    def dual_init(self):
        if self.backend == "xla":
            return super().dual_init()
        return np.zeros((9, self.n_elements))

    def compute_Dx(self, params, x):
        """Dx: (E,3,3) rows on 'xla'; on 'pallas' planes (9, E), plane
        3a+b = sum_k coeff[e,b,k] x[tet[e,k], a]."""
        if self.backend == "xla":
            return super().compute_Dx(params, x)
        E = params["indices"].shape[0]
        verts = x[params["indices"]]  # (E,K,3)
        return torch.einsum("ebk,eka->abe", params["coeff"],
                            verts).reshape(9, E).contiguous()

    def rhs_contribution(self, params, z, u):
        """Rows of D^T W^2 (z - u): (E*4, 3)."""
        if self.backend == "xla":
            return super().rhs_contribution(params, z, u)
        E = params["indices"].shape[0]
        y3 = (z - u).reshape(3, 3, E)  # [a,b,e] = ycan[e,b,a]
        c = torch.einsum("erk,e,jre->ekj", params["coeff"], params["w2"], y3)
        return c.reshape(-1, 3)

    def _step_shapes(self):
        """The shapes of the element step's outputs: z9, u9'."""
        E = self.n_elements
        return (9, E), (9, E)

    @property
    def fused_out_buffers(self):
        """On 'pallas', make(x, with_z=False): a new set of
        fused_local_rhs's outputs (the element step's, then the rows) of
        x's dtype and device, to give it as `out`; None on 'xla'."""
        if self.backend == "xla":
            return None

        def make(x, with_z=False):
            return tuple(x.new_empty(s) for s in (
                *self._step_shapes(),
                (4 * self.n_elements, 6 if with_z else 3)))

        return make

    @property
    def project_out_buffers(self):
        """On 'pallas', make(x): a new set of project_with_dual's outputs
        of x's dtype and device, to give it as `out`; None on 'xla'."""
        if self.backend == "xla":
            return None
        return lambda x: tuple(x.new_empty(s) for s in self._step_shapes())

    def project(self, Dx, u, params, state):
        """z (and new state): canonical rows on 'xla', planes on 'pallas'
        (whose System calls project_with_dual)."""
        if self.backend == "xla":
            return self._project_xla(Dx, u, params, state)
        z, _, st = self.project_with_dual(Dx, u, params, state)
        return z, st

    def project_with_dual(self, Dx, u, params, state, out=None):
        """The element step from Dx: (z, u', state). On 'pallas' the
        unfused kernel from Dx planes; `out`: a set of
        `project_out_buffers` to write in place of new tensors."""
        if self.backend == "xla":
            z, st = self._project_xla(Dx, u, params, state)
            return z, u + Dx - z, st
        return self._kernel_step(Dx, u, params, state, out)

    def primal_piece(self, params, u_new, u_old):
        if self.backend == "xla":
            return super().primal_piece(params, u_new, u_old)
        du = u_new - u_old
        return torch.sum(params["w2"] * torch.sum(du * du, dim=0))


def nh_energy(sigma, mu, lam):
    """Neo-Hookean energy density on singular values (TetForce.cpp:216-225):
    0.5 mu (I1 - log I3 - 3) + (lambda/8) log(I3)^2, I3 = det(Sigma)^2.
    sigma (..., 3); mu, lam broadcast against sigma[..., 0]."""
    det = sigma[..., 0] * sigma[..., 1] * sigma[..., 2]
    I1 = torch.sum(sigma * sigma, dim=-1)
    log_I3 = 2.0 * torch.log(det)
    return 0.5 * mu * (I1 - log_I3 - 3.0) + 0.125 * lam * log_I3 * log_I3


def stvk_energy(sigma, mu, lam):
    """St. Venant-Kirchhoff on singular values (TetForce.cpp:269-278):
    mu ||E||^2 + lambda/2 tr(E)^2, E = (Sigma^2 - I)/2."""
    E = 0.5 * (sigma * sigma - 1.0)
    return mu * torch.sum(E * E, dim=-1) + 0.5 * lam * torch.sum(E, dim=-1) ** 2


def _outer_plus_diag(a, coef, diag):
    """coef a a^T + diag(diag), per element: (E,3), (E,), (E,3) -> (E,3,3)."""
    return (coef[:, None, None] * (a[:, :, None] * a[:, None, :])
            + torch.diag_embed(diag))


def nh_grad_hess(sigma, mu, lam, k, sigma0):
    """Closed-form gradient (E,3) and Hessian (E,3,3) of the NH proximal
    objective (derived from nh_energy; the reference's hand Hessian at
    TetForce.cpp:245-263 is inconsistent with its own gradient — this one
    is the true derivative, held against torch.func in the tests).
    sigma, sigma0 (E,3); mu, lam, k (E,)."""
    mu, lam_, k_ = mu[:, None], lam[:, None], k[:, None]
    inv = 1.0 / sigma
    logdet = torch.log(sigma[:, 0] * sigma[:, 1] * sigma[:, 2])[:, None]
    g = mu * (sigma - inv) + lam_ * logdet * inv + k_ * (sigma - sigma0)
    inv2 = inv * inv
    diag = mu * (1.0 + inv2) - lam_ * logdet * inv2 + k_
    return g, _outer_plus_diag(inv, lam, diag)


def stvk_grad_hess(sigma, mu, lam, k, sigma0):
    """Closed-form gradient and Hessian of the StVK proximal objective
    (gradient matches StVKProx::gradient, TetForce.cpp:289-297)."""
    mu, lam_, k_ = mu[:, None], lam[:, None], k[:, None]
    s2 = torch.sum(sigma * sigma, dim=1)[:, None]
    g = (
        mu * sigma * (sigma * sigma - 1.0)
        + 0.5 * lam_ * (s2 - 3.0) * sigma
        + k_ * (sigma - sigma0)
    )
    diag = mu * (3.0 * sigma * sigma - 1.0) + 0.5 * lam_ * (s2 - 3.0) + k_
    return g, _outer_plus_diag(sigma, lam, diag)


_MODELS = {"nh": (nh_energy, nh_grad_hess), "stvk": (stvk_energy,
                                                     stvk_grad_hess)}


class HyperElasticTet(_TetForce):
    """General hyperelastic tet: oriented SVD -> minimize the proximal
    objective over the 3 singular values -> z = U diag(sigma*) V^T
    (TetForce.cpp:303-364). The reference's per-element L-BFGS with
    More-Thuente line search is replaced by a fixed-iteration safeguarded
    Newton, as in the JAX package.

    model: 'nh' | 'stvk'. k = min(mu, lambda); w = sqrt(k * volume)
    (TetForce.cpp:306-307). backend: 'xla' (the default: ops/svd.py and
    ops/newton.py in plain PyTorch, canonical layout) or 'pallas' (the
    hand-written kernels of `ops/kernels/nh_local.py`).
    """

    SIGMA_FLOOR = 1e-8

    def __init__(self, tets, mu, lam, max_iters=10, model="nh", backend="xla"):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        E = len(self.tets)
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (E,)).copy()
        self.lam = np.broadcast_to(np.asarray(lam, np.float64), (E,)).copy()
        self.max_iters = int(max_iters)
        if model not in _MODELS:
            raise ValueError(f"unknown hyperelastic model {model!r}")
        self.model = model
        self.backend = check_backend(backend)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        k = np.minimum(self.mu, self.lam)
        params["weight"] = np.sqrt(k) * np.sqrt(vol)
        params["k"] = k
        params["mu"] = self.mu
        params["lam"] = self.lam
        # warm start persists across steps (TetForce.hpp:145 last_prox_result)
        if self.backend == "xla":
            return params, {"sigma": np.ones((self.n_elements, 3))}
        params["w2"] = params["weight"] ** 2
        params["coeff_p"] = _coeff_planes(params)
        return params, {"sigma": np.ones((3, self.n_elements))}

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

    def _kernel_step(self, Dx, u, params, state, out):
        z9, unew9, warm_new = nh_local_step(
            Dx, u, state["sigma"], params["mu"], params["lam"], params["k"],
            iters=self.max_iters, model=self.model, out=out)
        return z9, unew9, {**state, "sigma": warm_new}

    def _project_xla(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = svd3x3_oriented(F)
        # warm-start guards (TetForce.cpp:339-347): flip a negative third
        # component, ELSE bump a collapsed (all ~0) start to 1e-3 — the
        # bump only applies when the third component was non-negative
        x2 = state["sigma"]
        neg3 = x2[:, 2] < 0.0
        x2 = torch.cat([x2[:, :2], torch.abs(x2[:, 2:])], dim=1)
        collapsed = (~neg3) & torch.all(torch.abs(x2) < 1e-3, dim=1)
        x2 = torch.where(collapsed[:, None], 1e-3, x2)

        energy, grad_hess = _MODELS[self.model]

        def objective(sig, mu, lam, k, sigma0):
            return energy(sig, mu, lam) + 0.5 * k * torch.sum(
                (sig - sigma0) ** 2, dim=-1)

        sigma_star = newton_minimize(
            objective, x2, self.max_iters, floor=self.SIGMA_FLOOR,
            params=(params["mu"], params["lam"], params["k"], s),
            grad_hess_fn=grad_hess)
        # z = U diag(sigma*) V^T with the oriented factors (TetForce.cpp:357)
        zF = _reconstruct(U, sigma_star, V)
        return _rows_of(zF), {**state, "sigma": sigma_star}


class LinearTetStrain(_TetForce):
    """Corotational/ARAP tet: project F to the closest rotation and mix
    with k = stiffness * volume (TetForce.cpp:112-153); the constraint of
    projective dynamics.

    backend: 'xla' (the default: ops/svd.polar_project in plain PyTorch,
    canonical layout) or 'pallas' (the hand-written kernels of
    `ops/kernels/tet_local.py`)."""

    def __init__(self, tets, stiffness, weight_scale=1.0, backend="xla"):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (len(self.tets),)
        ).copy()
        self.weight_scale = weight_scale  # parsed but unused, like the reference
        self.backend = check_backend(backend)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(vol)
        params["k"] = self.stiffness * vol
        if self.backend == "pallas":
            params["w2"] = params["weight"] ** 2
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

    def _kernel_step(self, Dx, u, params, state, out):
        z9, unew9 = arap_local_step(Dx, u, params["w2"], params["k"],
                                    out=out)
        return z9, unew9, state

    def _project_xla(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        return _rows_of(_mix(params, polar_project(F), F)), state


class TetVolume(ForceBatch):
    """Volume preservation: fixed-point projection of singular values so
    det(Sigma) lands in [limit_min, limit_max] (TetForce.cpp:160-210).
    XML force type `volpres` (ForceBuilder.cpp:406-435). Canonical layout,
    plain PyTorch (the JAX package has no kernel for it)."""

    R, K = 3, 4
    FP_ITERS = 4  # reference uses 4 fixed-point iterations (TetForce.cpp:188)

    def __init__(self, tets, stiffness, limit_min=1.0, limit_max=1.0):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        E = len(self.tets)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (E,)
        ).copy()
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64), (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64), (E,)).copy()

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(vol)
        params["k"] = self.stiffness * vol
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = svd3x3_oriented(F)
        s2_sign = s[:, 2]
        # plain-SVD singular values are all non-negative
        s0 = torch.abs(s)
        lmin, lmax = params["limit_min"], params["limit_max"]
        S, d = s0, torch.zeros_like(s0)
        for _ in range(self.FP_ITERS):
            detS = S[:, 0] * S[:, 1] * S[:, 2]
            f = detS - torch.minimum(torch.maximum(detS, lmin), lmax)
            g = torch.stack(
                [S[:, 1] * S[:, 2], S[:, 0] * S[:, 2], S[:, 0] * S[:, 1]], dim=1
            )
            gg = torch.sum(g * g, dim=1)
            gd = torch.sum(g * d, dim=1)
            d = -((f - gd) / torch.where(gg > 0, gg, 1.0))[:, None] * g
            S = s0 + d
        # reference overwrites S[2] = -1 for inverted elements (TetForce.cpp:196)
        S = torch.where(s2_sign[:, None] < 0,
                        torch.cat([S[:, :2], -torch.ones_like(S[:, 2:])], 1), S)
        p = _reconstruct_plain(U, V, S, s2_sign)
        return _rows_of(_mix(params, p, F)), state
