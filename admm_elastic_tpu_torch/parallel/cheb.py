"""Dot-product-free Chebyshev global solve: spectral bounds and schedule.

Counterpart of `admm_elastic_tpu/parallel/cheb.py`, host numpy/scipy. The
Chebyshev semi-iteration on the Jacobi-preconditioned system D^{-1}A with
spectral bounds [lmin, lmax] (Saad, *Iterative Methods for Sparse Linear
Systems*, Alg. 12.1):

    theta = (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma1 = theta/delta
    z0 = D^{-1}(b - A x0);  d0 = z0/theta;  rho0 = 1/sigma1
    x_{i+1} = x_i + d_i
    z_{i+1} = z_i - D^{-1} A d_i
    rho_{i+1} = 1/(2 sigma1 - rho_i)
    d_{i+1} = (rho_{i+1} rho_i) d_i + (2 rho_{i+1}/delta) z_{i+1}

It has no inner products: the per-iteration scalars c1_i = rho_{i+1} rho_i
and c2_i = 2 rho_{i+1}/delta are computed here once, so a whole solve is
row-local work and matvecs (`ops/kernels/cheb_dia.py` runs it as one
kernel launch). The bounds come from a one-time scipy Lanczos (`eigsh`) on
the symmetrically scaled D^{-1/2} A D^{-1/2}, which has D^{-1}A's
spectrum, from a fixed start vector so that two builds of one system get
the same schedule (the reference's fault class C6); margins widen the
interval, which slows convergence but never makes it diverge.

The operator comes in the port's own forms, in the System's vertex
numbering: diagonals (n_dia, n) at vertex offsets (`dia_operator_bounds`)
or ELL rows (n, K) (`ell_operator_bounds`). The port has no pad lanes, so
every row is a vertex. The JAX module's uell slot and fold planes are TPU
layout and have no counterpart.
"""

from __future__ import annotations

import numpy as np


def dia_operator_bounds(dia_vals, offs, margin=0.05):
    """Spectral bounds of the Jacobi-preconditioned sparse-diagonal
    operator.

    dia_vals: (n_dia, n) float, dia_vals[d, i] = A[i, i + offs[d]] (entries
    past either end are ignored); offs must contain 0, the diagonal, which
    is the Jacobi D. Returns (lmin, lmax) with the safety margin applied.
    """
    from scipy.sparse import csr_matrix

    flat = np.asarray(dia_vals, np.float64)
    n_dia, n = flat.shape
    offs = [int(o) for o in offs]
    d0 = flat[offs.index(0)]
    if n == 0 or not (d0 > 0).any():
        raise ValueError("empty operator (all-zero diagonal)")
    rows, cols, vals = [], [], []
    for di, off in enumerate(offs):
        i = np.arange(max(0, -off), min(n, n - off))
        v = flat[di, i]
        keep = v != 0.0
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(v[keep])
    A = csr_matrix((np.concatenate(vals),
                    (np.concatenate(rows), np.concatenate(cols))),
                   shape=(n, n))
    return _scaled_bounds(A, d0, margin)


def ell_operator_bounds(ell_idx, ell_vals, diag, margin=0.05):
    """Spectral bounds of the Jacobi-preconditioned operator in ELL form,
    the counterpart of the JAX module's `uell_operator_bounds` on the
    port's (n, K) rows: A[i, ell_idx[i, k]] = ell_vals[i, k] (pad slots
    hold value 0). diag: (n,) the Jacobi D the recurrence applies.
    Returns (lmin, lmax) with the safety margin applied."""
    from scipy.sparse import csr_matrix

    idx = np.asarray(ell_idx, np.int64)
    vals = np.asarray(ell_vals, np.float64)
    n, K = vals.shape
    if n == 0:
        raise ValueError("empty operator")
    rows = np.repeat(np.arange(n), K).reshape(n, K)
    keep = vals != 0.0
    A = csr_matrix((vals[keep], (rows[keep], idx[keep])), shape=(n, n))
    return _scaled_bounds(A, np.asarray(diag, np.float64), margin)


def _scaled_bounds(A, d0, margin):
    """Eigenvalue bounds of diag(d0)^{-1} A via the symmetrically-scaled
    twin D^{-1/2} A D^{-1/2} (same spectrum). A: csr; d0: positive
    Jacobi diagonal. Margins widen the interval."""
    from scipy.sparse import diags
    from scipy.sparse.linalg import eigsh

    dinv_sqrt = 1.0 / np.sqrt(d0)
    B = diags(dinv_sqrt) @ A @ diags(dinv_sqrt)
    B = (B + B.T) * 0.5  # symmetrize round-off
    # deterministic Lanczos start: eigsh's default v0 is random, which
    # would make the schedule differ between identical builds
    v0 = np.random.default_rng(0).standard_normal(B.shape[0])
    lmax = float(eigsh(B, k=1, which="LA", return_eigenvectors=False,
                       tol=1e-3, v0=v0)[0])
    lmin = float(eigsh(B, k=1, which="SA", return_eigenvectors=False,
                       tol=1e-3, v0=v0)[0])
    if lmin <= 0:
        # numerically touching zero: fall back to a tiny positive bound
        lmin = 1e-6 * lmax
    return lmin * (1.0 - margin), lmax * (1.0 + margin)


def cheb_coefficients(k: int, lmin: float, lmax: float):
    """Host-precomputed per-iteration scalars for the recurrence.

    Returns (inv_theta, c1, c2): d0 = inv_theta * z0;
    d_{i+1} = c1[i]*d_i + c2[i]*z_{i+1} for i in range(k-1). A solve of
    k iterations applies k position updates.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    if delta <= 0:  # single-point spectrum: plain Richardson
        return 1.0 / theta, np.zeros(max(k - 1, 0)), np.full(
            max(k - 1, 0), 1.0 / theta)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    c1 = np.empty(max(k - 1, 0))
    c2 = np.empty(max(k - 1, 0))
    for i in range(k - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        c1[i] = rho_new * rho
        c2[i] = 2.0 * rho_new / delta
        rho = rho_new
    return 1.0 / theta, c1, c2


def cheb_solve_reference(A_mul, invd_mul, b, x0, k, lmin, lmax):
    """Numpy reference of the k-iteration solve (tests/oracles).
    A_mul(x) applies A; invd_mul(r) applies the Jacobi preconditioner."""
    inv_theta, c1, c2 = cheb_coefficients(k, lmin, lmax)
    x = x0.copy()
    z = invd_mul(b - A_mul(x))
    d = inv_theta * z
    for i in range(k):
        x = x + d
        if i == k - 1:
            break
        z = z - invd_mul(A_mul(d))
        d = c1[i] * d + c2[i] * z
    return x
