"""Corotational (ARAP) tet local step: hand-written CUDA kernels + plain
twins.

Counterpart of `admm_elastic_tpu/ops/pallas/tet_local.py`, both entries.
Per element:

    F   = Dx + u          (fused: Dx = sum_k cp * x[tet[k]])
    R   = closest proper rotation to F   (Jacobi eigensolver on F^T F +
                                          safe orthonormalization of F V)
    z   = (k R + w2 F) / (w2 + k),   u' = u + Dx - z
    rows[4e+k, j]   = w2 * sum_r cp[4r+k] * (z - u')[3j+r]   (fused only)
    rows[4e+k, 3+j] = w2 * sum_r cp[4r+k] * z[3j+r]          (emit_z only)

`arap_local_step_fused` takes the positions x (n,3) and the tets (E,4),
gathers each element's vertices itself and emits the RHS rows (4E,3) in
the layout the System's incidence gather reads (LinearTetStrain on the
dia/ell route) and, with `emit_z`, (4E,6) rows whose columns 3:6 are
w2 D^T z (the dual residual's); `arap_local_step` takes Dx (the unfused
pipeline of the dense and cg global modes and of over-relaxation).
Layout: plane-major cp12 (12,E); dx9, u9, z9 (9,E); w2, k (E,). No
padding: E is any size. The Pallas kernel's own layout (gathered
positions and row planes (12,E)) is `_fused_planes`, which the JAX
comparisons call.

Each wrapper checks its constant inputs (the selector planes, w2, k, the
tets) once per force, dtype and device (`_build.ElementPlan`, which keeps
their pointers and the C entry), then only the state in one expression a
call; both take optional `out=` buffers. It launches its kernel
(`csrc/tet_local.cu`) for CUDA tensors and runs its `_reference` twin, a
transcription of the Pallas kernel body op by op, for CPU tensors. It
never falls back from one to the other. The twins are not
`arap_local_step_reference` of the JAX package, which projects through
`ops/svd.polar_project`, another algorithm.
"""

from __future__ import annotations

import torch

from ..segment import flat_rows
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


def _fused_planes(xg12, u9, cp12, w2, k, emit_z=False):
    """The fused step on gathered positions in the Pallas kernel's own
    layout: xg12 (12,E) with plane 3k+a = x[tet[e,k], a] in; (z9, u9_new,
    contrib12[, contribz12]) out, row plane 3k+j of element e the row
    4e+k's column j. The JAX comparisons call it on their inputs;
    `arap_local_step_fused_reference` gathers and lays its rows out."""
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


def arap_local_step_fused_reference(x, tets, u9, cp12, w2, k, emit_z=False):
    """Plain PyTorch version of the fused kernel, same signature and
    outputs: (z9, u9_new, rows), rows (4E,3), or (4E,6) with emit_z. It
    gathers the positions, runs `_fused_planes` and lays the rows out: the
    gather and the layout move values and change no bits."""
    E = tets.shape[0]
    z9, u9_new, *blocks = _fused_planes(
        x[tets.long()].reshape(E, 12).T, u9, cp12, w2, k, emit_z=emit_z)
    return z9, u9_new, flat_rows(blocks)


def arap_local_step_reference(dx9, u9, w2, k):
    """Plain PyTorch version of the unfused kernel, same signature and
    outputs: (z9, u9_new)."""
    z, un = _arap_body([dx9[p] for p in range(9)], [u9[p] for p in range(9)],
                       w2, k)
    return torch.stack(z), torch.stack(un)


def arap_local_step_fused(x, tets, u9, cp12, w2, k, emit_z=False, out=None):
    """Fused ARAP local step + RHS rows from the positions x (n,3) and the
    tets (E,4) (integers; the kernel reads them in int32, converted once).
    Returns (z9, u9_new, rows): rows (4E,3), row 4e+k the element's
    D^T W^2 (z - u') row for its vertex k; with emit_z (4E,6), columns 3:6
    the rows of D^T W^2 z (the other outputs are the same bits either
    way). `out`: optional buffers of those three outputs to write instead
    of new ones, none of them overlapping an input."""
    plan = _build.element_plan("arap_local_step_fused",
                               {"cp12": cp12, "w2": w2, "k": k}, tets)
    E = plan.E
    if not (x.dim() == 2 and x.shape[1] == 3 and x.shape[0] > plan.vmax
            and u9.shape == (9, E) and x.dtype is u9.dtype is plan.dtype
            and x.get_device() == u9.get_device() == plan.index
            and x.is_contiguous() and u9.is_contiguous()):
        if x.dim() == 2 and x.shape[0] <= plan.vmax:
            raise ValueError(f"x: {x.shape[0]} vertices, the tets reach "
                             f"vertex {plan.vmax}")
        plan.check_state({"x": (x, (len(x) if x.dim() else 0, 3)),
                          "u9": (u9, (9, E))})
    shapes = ((9, E), (9, E), (4 * E, 6 if emit_z else 3))
    if plan.fn is None:
        return plan.twin(out, shapes, (x, u9),
                         lambda: arap_local_step_fused_reference(
                             x, tets, u9, cp12, w2, k, emit_z=emit_z))
    outs = plan.outputs(out, shapes, (x, u9))
    _build.check(plan.fn(x.data_ptr(), plan.tets_ptr, u9.data_ptr(),
                         *plan.ptrs, *(o.data_ptr() for o in outs), E,
                         int(emit_z), _build.stream_ptr(x)),
                 "arap_local_step_fused")
    arap_local_step_fused.launches += 1
    arap_local_step_fused.residual_launches += bool(emit_z)
    return outs


arap_local_step_fused.launches = 0
#: the launches of its emit_z mode (a count within `launches`)
arap_local_step_fused.residual_launches = 0


def arap_local_step(dx9, u9, w2, k, out=None):
    """Unfused ARAP local step from Dx. Returns (z9, u9_new). `out`:
    optional buffers of those two outputs to write instead of new ones,
    none of them overlapping an input."""
    plan = _build.element_plan("arap_local_step", {"w2": w2, "k": k})
    E = plan.E
    if not (dx9.shape == u9.shape == (9, E)
            and dx9.dtype is u9.dtype is plan.dtype
            and dx9.get_device() == u9.get_device() == plan.index
            and dx9.is_contiguous() and u9.is_contiguous()):
        plan.check_state({"dx9": (dx9, (9, E)), "u9": (u9, (9, E))})
    shapes = ((9, E), (9, E))
    if plan.fn is None:
        return plan.twin(out, shapes, (dx9, u9),
                         lambda: arap_local_step_reference(dx9, u9, w2, k))
    outs = plan.outputs(out, shapes, (dx9, u9))
    _build.check(plan.fn(dx9.data_ptr(), u9.data_ptr(), *plan.ptrs,
                         *(o.data_ptr() for o in outs), E,
                         _build.stream_ptr(dx9)), "arap_local_step")
    arap_local_step.launches += 1
    return outs


arap_local_step.launches = 0
