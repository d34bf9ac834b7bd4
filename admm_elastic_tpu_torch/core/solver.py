"""Global-step linear solver pieces.

The SPD system A = M + dt^2 D^T W^2 D never mixes xyz components, so
A = A_hat (x) I_3 with A_hat only (n,n): the solve is A_hat X = B with X, B
of shape (n,3). A_hat is assembled once on the host (numpy/scipy, the same
code as `admm_elastic_tpu/core/solver.py`): dense for the 'dense' global
mode (inverted once), in sparse-DIAgonal form where the numbering allows it
and in padded ELL form for any mesh. The 'cg' mode never assembles it:
`A_hat_apply` and `A_hat_diag` apply it element by element. The
per-iteration pieces below are plain PyTorch. They are the references the
hand-written kernels (`ops/kernels/cg_dia.py`, `cg_ell.py`, `cg_step.py`)
are held against.
"""

from __future__ import annotations

import numpy as np
import torch


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


def assemble_A_hat(n, masses, dt, force_params):
    """Dense A_hat (n,n) float64, by the sparse assembly."""
    return _assemble_A_hat_csr(n, masses, dt, force_params).toarray()


def dense_inverse(A, dtype, device) -> torch.Tensor:
    """A_hat^-1 for the 'dense' mode from the host's float64 A_hat: inverted
    once in float64 on `device` (an LU inverse: cuSOLVER on a card, LAPACK
    on the CPU, where the JAX package calls np.linalg.inv on the host), then
    cast to `dtype`. The float64 copies are freed before it returns."""
    a = torch.as_tensor(A, dtype=torch.float64, device=device)
    inv = torch.linalg.inv(a)
    del a
    return inv.to(dtype)


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


def assemble_A_hat_ell(n, masses, dt, force_params, pad_to: int = 8):
    """A_hat in padded ELL (ELLPACK) form: per-row neighbour lists, so a
    matvec is one gather and a weighted sum. Rows are padded to the widest
    row (rounded up to a multiple of `pad_to`) with zero-value
    self-references.

    Returns (idx (n,K) int32, vals (n,K) float64, diag (n,) float64).
    """
    A = _assemble_A_hat_csr(n, masses, dt, force_params)
    deg = np.diff(A.indptr)
    K = max(int(deg.max()) if n else 1, 1)
    K = -(-K // pad_to) * pad_to
    ell_idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    ell_vals = np.zeros((n, K), dtype=np.float64)
    row_of = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    ell_idx[row_of, pos] = A.indices
    ell_vals[row_of, pos] = A.data
    return ell_idx.astype(np.int32), ell_vals, A.diagonal().copy()


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
    """A_hat @ x via diagonals: (n,3) -> (n,3). Terms past either end are
    skipped, as the kernels skip them: diagonal d adds to rows lo..hi only,
    the rows i with 0 <= i + off_d < n."""
    n = x.shape[0]
    out = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            out[lo:hi] += dia_vals[d, lo:hi, None] * x[lo + off:hi + off]
    return out


def ell_apply(x: torch.Tensor, ell_idx: torch.Tensor,
              ell_vals: torch.Tensor) -> torch.Tensor:
    """A_hat @ x via ELL: (n,3) -> (n,3). One gather, then the products
    summed over the K slots of each row, in one fixed order."""
    return (ell_vals[:, :, None] * x[ell_idx]).sum(dim=1)


def transpose_gather_apply(contribs_flat: torch.Tensor,
                           inc_idx: torch.Tensor) -> torch.Tensor:
    """Sum of contribution rows per vertex: (total+1, 3), (n,D) -> (n,3).

    A gather and a reduction over a fixed axis: no atomics, so two runs are
    bitwise equal."""
    return contribs_flat[inc_idx].sum(dim=1)


def _incidence_sum(rows, inc_idx, like, width):
    """Per-vertex sums of per-(element, slot) rows, one (E*K, width) block
    per force in the incidence's order, gathered through the vertex
    incidence (`assemble_transpose_incidence`) with the zero sentinel row
    appended: a fixed-order sum, no scatter."""
    rows = [*rows, like.new_zeros((1, width))]
    return transpose_gather_apply(torch.cat(rows, dim=0), inc_idx)


def A_hat_apply(x, masses, dt2, force_params, inc_idx):
    """Matrix-free A_hat @ x, (n,3) -> (n,3): M x + dt^2 sum_f C^T W^2 C x
    element by element (the JAX package's A_hat_apply, with its segment
    sum replaced by the incidence gather). force_params: the constraint
    forces' params in the incidence's order.

    The per-element products are broadcast multiplies and sums, not
    `torch.einsum`: on a card einsum lowers them to cuBLAS batched GEMMs
    of 3x4 matrices, ~0.1 ms each for 100,000 elements on an H100."""
    rows = []
    for p in force_params.values():
        C = p["coeff"][:, :, :, None]  # (E,R,K,1)
        y = (C * x[p["indices"]][:, None]).sum(dim=2)  # (E,R,3)
        wy = (p["weight"] ** 2)[:, None, None] * y
        rows.append((C * wy[:, :, None]).sum(dim=1).reshape(-1, 3))
    return masses[:, None] * x + dt2 * _incidence_sum(rows, inc_idx, x, 3)


def A_hat_diag(masses, dt2, force_params, inc_idx):
    """The exact diagonal of A_hat, (n,): m + dt^2 sum_f sum_r w2 C_rk^2
    per vertex (the Jacobi preconditioner of the 'cg' mode)."""
    rows = [((p["weight"] ** 2)[:, None]
             * torch.sum(p["coeff"] * p["coeff"], dim=1)).reshape(-1, 1)
            for p in force_params.values()]
    return masses + dt2 * _incidence_sum(rows, inc_idx, masses, 1)[:, 0]


def pcg_solve(A_apply, b, x0, diag, tol, max_iters):
    """Jacobi-PCG on the (n,3) system until ||r|| <= tol ||b|| or
    max_iters iterations; returns (x, iterations).

    The JAX package's XLA routine, not a kernel."""
    inv_diag = 1.0 / diag
    return pcg_solve_precond(A_apply, lambda r: inv_diag[:, None] * r, b,
                             x0, tol, max_iters)


def pcg_solve_precond(A_apply, M_apply, b, x0, tol, max_iters):
    """PCG with z = M_apply(r) (Jacobi: `pcg_solve`; the general AMG's
    V-cycle: `core.amg.make_vcycle`) until ||r|| <= tol ||b|| or max_iters
    iterations; returns (x, iterations). Its loop test is data dependent,
    so in eager PyTorch it reads r.r back to the host once per iteration
    (a device synchronisation each time on a card)."""
    def dot(a, b):
        return torch.sum(a * b)

    r = b - A_apply(x0)
    z = M_apply(r)
    p = z
    rz = dot(r, z)
    tol2 = tol * tol * torch.clamp_min(dot(b, b), torch.finfo(b.dtype).tiny)
    x = x0
    it = 0
    while it < max_iters and bool(dot(r, r) > tol2):
        Ap = A_apply(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp > 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_apply(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def pcg_solve_fixed(A_apply, b, x0, diag, n_iters: int):
    """Jacobi-PCG with a fixed iteration count and no residual test. The
    three columns of (n,3) form one system: alpha and beta are single
    scalars over all 3n values. alpha, beta and rz stay tensors, so no
    scalar is read back to the host. Returns (x, n_iters)."""
    return pcg_fixed_inv(A_apply, b, x0, 1.0 / diag, n_iters), n_iters


def pcg_fixed_inv(A_apply, b, x0, inv_diag, n_iters: int, dot=None):
    """`pcg_solve_fixed` given the preconditioner's inverse diagonal (n,)
    itself, as the banded steppers store it; returns x. `dot(a, b)` sums
    a*b over all 3n values (default torch.sum; a kernel's twin passes the
    kernel's order)."""
    return pcg_fixed_precond(A_apply, b, x0, lambda r: inv_diag[:, None] * r,
                             n_iters, dot)


def pcg_fixed_precond(A_apply, b, x0, precond, n_iters: int, dot=None):
    """n_iters PCG iterations from x0 with z = precond(r) (Jacobi:
    `pcg_fixed_inv`; the multigrid V-cycle: `ops.kernels.mg`), the
    pAp > 0 and rz > 0 guards; returns x. `dot` as in `pcg_fixed_inv`."""
    if dot is None:
        def dot(a, b):
            return torch.sum(a * b)

    r = b - A_apply(x0)
    z = precond(r)
    p = z
    rz = dot(r, z)
    x = x0
    for _ in range(n_iters):
        Ap = A_apply(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp > 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
    return x
