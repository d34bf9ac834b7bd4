"""Corotational (ARAP) tet local step: hand-written CUDA kernels + plain
twins.

Counterpart of `admm_elastic_tpu/ops/pallas/tet_local.py`, both entries.
Per element:

    F   = Dx + u          (fused: Dx = sum_k cp * xg, selector on x)
    R   = closest proper rotation to F   (Jacobi eigensolver on F^T F +
                                          safe orthonormalization of F V)
    z   = (k R + w2 F) / (w2 + k),   u' = u + Dx - z
    contrib[3k+j] = w2 * sum_r cp[4r+k] * (z - u')[3j+r]   (fused only)
    contribz[3k+j] = w2 * sum_r cp[4r+k] * z[3j+r]          (emit_z only)

`arap_local_step_fused` takes gathered positions and emits the RHS rows
(LinearTetStrain on the dia/ell route), with `emit_z` also the rows of
w2 D^T z (the dual residual's); `arap_local_step` takes Dx (the
unfused pipeline of the dense and cg global modes and of over-relaxation).
Layout: plane-major xg12, cp12, contrib12 (12,E); dx9, u9, z9 (9,E); w2, k
(E,). No padding: E is any size.

Each wrapper launches its kernel (`csrc/tet_local.cu`) for CUDA tensors and
runs its `_reference` twin, a transcription of the Pallas kernel body op by
op, for CPU tensors. It never falls back from one to the other. The twins
are not `arap_local_step_reference` of the JAX package, which projects
through `ops/svd.polar_project`, another algorithm.
"""

from __future__ import annotations

import torch

from . import _build
from .nh_local import _svd_factors, rows_of


def _polar_rotation(f):
    """f: 9 planes of F (row-major). R = U V^T as 9 planes, row-major
    (tet_local._polar_rotation, which is nh_local._svd_columns without the
    singular values)."""
    U, V, _, _ = _svd_factors(f, torch.finfo(f[0].dtype).eps)
    return [U[0][r] * V[0][c] + U[1][r] * V[1][c] + U[2][r] * V[2][c]
            for r in range(3) for c in range(3)]


def _arap_body(dx, uu, w2, k):
    """dx and uu lists of 9 planes -> (z planes, u' planes)."""
    f = [dx[p] + uu[p] for p in range(9)]
    R = _polar_rotation(f)
    denom = 1.0 / (w2 + k)
    z = [(k * R[p] + w2 * f[p]) * denom for p in range(9)]
    return z, [uu[p] + dx[p] - z[p] for p in range(9)]


def arap_local_step_fused_reference(xg12, u9, cp12, w2, k, emit_z=False):
    """Plain PyTorch version of the fused kernel, same signature and
    outputs: (z9, u9_new, contrib12[, contribz12])."""
    xg = [xg12[p] for p in range(12)]
    cp = [cp12[p] for p in range(12)]
    dx = []
    for a in range(3):
        for b in range(3):
            acc = cp[4 * b] * xg[a]
            for kk in range(1, 4):
                acc = acc + cp[4 * b + kk] * xg[3 * kk + a]
            dx.append(acc)
    z, un = _arap_body(dx, [u9[p] for p in range(9)], w2, k)
    zu = [z[p] - un[p] for p in range(9)]
    out = (torch.stack(z), torch.stack(un),
           torch.stack(rows_of(cp, zu, 4, 3, w2)))
    if emit_z:
        out += (torch.stack(rows_of(cp, z, 4, 3, w2)),)
    return out


def arap_local_step_reference(dx9, u9, w2, k):
    """Plain PyTorch version of the unfused kernel, same signature and
    outputs: (z9, u9_new)."""
    z, un = _arap_body([dx9[p] for p in range(9)], [u9[p] for p in range(9)],
                       w2, k)
    return torch.stack(z), torch.stack(un)


def arap_local_step_fused(xg12, u9, cp12, w2, k, emit_z=False):
    """Fused ARAP local step + RHS contribution. Returns (z9, u9_new,
    contrib12), and with emit_z contribz12 after them."""
    E = _build.check_inputs(
        {"xg12": (xg12, 12), "u9": (u9, 9), "cp12": (cp12, 12)},
        {"w2": w2, "k": k})
    if xg12.device.type == "cpu":
        return arap_local_step_fused_reference(xg12, u9, cp12, w2, k,
                                               emit_z=emit_z)
    outs = (torch.empty_like(u9), torch.empty_like(u9),
            torch.empty_like(xg12),
            torch.empty_like(xg12) if emit_z else None)
    _build.launch("arap_local_step_fused", (xg12, u9, cp12, w2, k), outs, E)
    arap_local_step_fused.launches += 1
    arap_local_step_fused.residual_launches += bool(emit_z)
    return outs if emit_z else outs[:3]


arap_local_step_fused.launches = 0
#: the launches of its emit_z mode (a count within `launches`)
arap_local_step_fused.residual_launches = 0


def arap_local_step(dx9, u9, w2, k):
    """Unfused ARAP local step from Dx. Returns (z9, u9_new)."""
    E = _build.check_inputs({"dx9": (dx9, 9), "u9": (u9, 9)},
                            {"w2": w2, "k": k})
    if dx9.device.type == "cpu":
        return arap_local_step_reference(dx9, u9, w2, k)
    outs = (torch.empty_like(u9), torch.empty_like(u9))
    _build.launch("arap_local_step", (dx9, u9, w2, k), outs, E)
    arap_local_step.launches += 1
    return outs


arap_local_step.launches = 0
