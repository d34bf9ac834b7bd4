"""Global-step linear solver pieces.

The SPD system A = M + dt^2 D^T W^2 D never mixes xyz components, so
A = A_hat (x) I_3 with A_hat only (n,n): the solve is A_hat X = B with X, B
of shape (n,3). A_hat is assembled once on the host (numpy/scipy, the same
code as `admm_elastic_tpu/core/solver.py`); the per-iteration pieces below
are plain PyTorch. They are the references the hand-written kernel
(`ops/kernels/cg_dia.py`) is held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _assemble_A_hat_csr(n, masses, dt, force_params):
    """Host-side sparse assembly of A_hat = diag(m) + dt^2 sum_t C^T W^2 C."""
    import scipy.sparse as sp

    dt2 = dt * dt
    rows_all, cols_all, vals_all = [], [], []
    for p in force_params.values():
        C = np.asarray(p["coeff"], dtype=np.float64)
        idx = np.asarray(p["indices"], dtype=np.int64)
        w2 = np.asarray(p["weight"], dtype=np.float64) ** 2
        Me = np.einsum("erk,erl->ekl", C, C) * w2[:, None, None] * dt2
        K = idx.shape[1]
        rows_all.append(np.repeat(idx[:, :, None], K, axis=2).ravel())
        cols_all.append(np.repeat(idx[:, None, :], K, axis=1).ravel())
        vals_all.append(Me.ravel())
    if rows_all:
        A = sp.coo_matrix(
            (
                np.concatenate(vals_all),
                (np.concatenate(rows_all), np.concatenate(cols_all)),
            ),
            shape=(n, n),
        ).tocsr()
        A.sum_duplicates()
    else:
        A = sp.csr_matrix((n, n))
    A = A + sp.diags(np.asarray(masses, dtype=np.float64))
    # structural zeros are kept: the sparsity pattern follows the
    # constraint topology, not the current weights
    return A


def assemble_A_hat_dia(n, masses, dt, force_params, max_diagonals: int = 48):
    """A_hat in sparse-DIAgonal form, when the mesh permits.

    Returns (offsets tuple, dia_vals (D, n) float64, diag (n,)) or None if
    the matrix has more than max_diagonals distinct diagonals. Entries of a
    diagonal that fall outside the matrix are zero.
    """
    A = _assemble_A_hat_csr(n, masses, dt, force_params).tocoo()
    offs = np.unique(A.col - A.row)
    if len(offs) > max_diagonals:
        return None
    dia = np.zeros((len(offs), n), dtype=np.float64)
    d_idx = np.searchsorted(offs, A.col - A.row)
    np.add.at(dia, (d_idx, A.row), A.data)
    return tuple(int(o) for o in offs), dia, A.tocsr().diagonal().copy()


def assemble_transpose_incidence(n, force_params, order, pad_to: int = 8):
    """Vertex -> (element, slot) incidence in padded-ELL form, for computing
    D^T W^2 y by a gather instead of a scatter (the right-hand side).

    Contributions are laid out as the concatenation, in `order`, of each
    type's flattened (E*K, 3) per-vertex contribution rows; a zero sentinel
    row is appended at index `total`. Returns (inc_idx (n, D) int32, total).
    """
    offsets = []
    idx_all = []
    off = 0
    for name in order:
        idx = np.asarray(force_params[name]["indices"], dtype=np.int64).reshape(-1)
        idx_all.append(idx)
        offsets.append(off)
        off += idx.size
    total = off
    if total == 0:
        return np.zeros((n, 1), dtype=np.int32), 0
    verts = np.concatenate(idx_all)
    flat = np.arange(total, dtype=np.int64)
    srt = np.argsort(verts, kind="stable")
    sv = verts[srt]
    counts = np.bincount(sv, minlength=n)
    D = max(int(counts.max()), 1)
    D = -(-D // pad_to) * pad_to
    inc = np.full((n, D), total, dtype=np.int64)  # sentinel
    pos = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    inc[sv, pos] = flat[srt]
    return inc.astype(np.int32), total


def dia_apply(x: torch.Tensor, offsets, dia_vals: torch.Tensor) -> torch.Tensor:
    """A_hat @ x via diagonals: (n,3) -> (n,3). Reads past either end are 0."""
    n = x.shape[0]
    out = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        if off >= 0:
            shifted = F.pad(x[off:], (0, 0, 0, min(off, n)))
        else:
            shifted = F.pad(x[: max(n + off, 0)], (0, 0, min(-off, n), 0))
        out = out + dia_vals[d][:, None] * shifted
    return out


def transpose_gather_apply(contribs_flat: torch.Tensor,
                           inc_idx: torch.Tensor) -> torch.Tensor:
    """Sum of contribution rows per vertex: (total+1, 3), (n,D) -> (n,3).

    A gather and a reduction over a fixed axis: no atomics, so two runs are
    bitwise equal."""
    return contribs_flat[inc_idx].sum(dim=1)


def pcg_solve_fixed(A_apply, b, x0, diag, n_iters: int):
    """Jacobi-PCG with a fixed iteration count and no residual test. The
    three columns of (n,3) form one system: alpha and beta are single
    scalars over all 3n values. alpha, beta and rz stay tensors, so no
    scalar is read back to the host."""
    inv_diag = 1.0 / diag

    def dot(a, b):
        return torch.sum(a * b)

    r = b - A_apply(x0)
    z = inv_diag[:, None] * r
    p = z
    rz = dot(r, z)
    x = x0
    for _ in range(n_iters):
        Ap = A_apply(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp > 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag[:, None] * r
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
    return x, n_iters
