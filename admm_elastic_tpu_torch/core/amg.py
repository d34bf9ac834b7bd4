"""Aggregation-AMG preconditioner of the general route's global-step PCG
(`preconditioner="amg"` under `global_solver="ell"` with the xla CG
backend, and where no in-kernel multigrid engages).

Counterpart of `admm_elastic_tpu/core/amg.py`. The hierarchy is the JAX
package's, built by the same numpy code (greedy aggregation over the
strength graph |a_ij| >= theta sqrt(a_ii a_jj), a 0/1 tentative
prolongation, Galerkin levels P^T A P down to at most `coarse_max` dofs,
the dense inverse of the coarsest), so the aggregates, the level sizes
and the spectral bounds lmax are JAX's. The V-cycle applies, per level:

    smoothing     degree-1 Chebyshev on D^-1 A over [lmax/alpha, lmax]
                  (one ELL matvec), before and after the coarse correction
    restriction   each aggregate's residuals summed: a fixed-order gather
                  over its members (ascending, padded with a zero sentinel
                  row), as `core.solver.transpose_gather_apply` sums the
                  right-hand side; no atomics
    prolongation  the coarse correction gathered at each dof's aggregate
    coarsest      A_inv @ r, one product

JAX computes this outside any Pallas kernel (segment_sum, gathers, a
matmul under XLA), so here it is plain PyTorch on the device.
`rebuild_amg_values` refreshes a hierarchy's values over its frozen
aggregates after runtime weight edits (`System.recompute_weights`).
"""

from __future__ import annotations

import numpy as np
import torch

from .mg import _rho_dinv_a  # 10 power iterations, JAX's amg.py's
from .solver import ell_apply, transpose_gather_apply


# --------------------------------------------------------------- host setup

def _strength_graph(A, theta):
    """Strong connections |a_ij| >= theta sqrt(a_ii a_jj), off the
    diagonal, as a 0/1 CSR matrix."""
    import scipy.sparse as sp

    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    Ac = A.tocoo()
    off = Ac.row != Ac.col
    strong = off & (np.abs(Ac.data) >= theta * np.sqrt(d[Ac.row] * d[Ac.col]))
    return sp.csr_matrix(
        (np.ones(int(strong.sum())), (Ac.row[strong], Ac.col[strong])),
        shape=A.shape)


def _aggregate(S):
    """Greedy aggregation on the strength graph: a node whose strong
    neighbourhood is untouched seeds an aggregate with all of it; then a
    leftover joins the aggregate of its first owned neighbour; isolates
    become singletons. Returns (agg (n,) int64, n_agg)."""
    n = S.shape[0]
    agg = np.full(n, -1, np.int64)
    indptr, indices = S.indptr, S.indices
    n_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]: indptr[i + 1]]
        if (agg[nb] == -1).all():
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]: indptr[i + 1]]
        owned = nb[agg[nb] != -1]
        if len(owned):
            agg[i] = agg[owned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _csr_to_ell(A, pad_to=8, K_fixed=None):
    """CSR A as (n,K) ELL rows, K the widest row rounded up to pad_to (or
    K_fixed, which a wider row must not exceed), each row's entries in
    column order; the empty slots value 0 at the row's own index."""
    deg = np.diff(A.indptr)
    n = A.shape[0]
    K = max(int(deg.max()) if n else 1, 1)
    K = -(-K // pad_to) * pad_to
    if K_fixed is not None:
        if K > K_fixed:
            raise ValueError(f"amg: sparsity widened ({K} > stored {K_fixed})")
        K = K_fixed
    idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    vals = np.zeros((n, K), np.float64)
    row_of = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    idx[row_of, pos] = A.indices
    vals[row_of, pos] = A.data
    return idx.astype(np.int32), vals


def members(agg, n_agg):
    """(M, n_agg) int64, slot-major: each aggregate's members ascending, M
    the largest aggregate, the empty slots len(agg) (the zero sentinel row
    of a restriction's gather)."""
    agg = np.asarray(agg, np.int64)
    sizes = np.bincount(agg, minlength=n_agg)
    order = np.argsort(agg, kind="stable")
    slot = np.arange(len(agg)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    out = np.full((max(int(sizes.max()), 1), n_agg), len(agg), np.int64)
    out[slot, agg[order]] = order
    return out


def build_amg(A, coarse_max=1024, theta=0.08, max_levels=12):
    """The AMG hierarchy of CSR A (SPD), as JAX's build_amg makes it.
    Returns (arrays, meta): arrays, one dict of numpy arrays a level
    (ell_idx (n,K) int32, ell_vals, inv_diag (n,), agg (n,) int32, lmax,
    and the restriction's member lists `members` (nc,M), `members`
    transposed), the last {"A_inv"}; meta, one {"n", "nc"} a level."""
    import scipy.sparse as sp

    arrays, meta = [], []
    lvl = A.tocsr()
    for _ in range(max_levels):
        n = lvl.shape[0]
        if n <= coarse_max:
            break
        agg, nc = _aggregate(_strength_graph(lvl, theta))
        if nc >= n:  # no coarsening progress
            break
        idx, vals = _csr_to_ell(lvl)
        diag = lvl.diagonal()
        diag = np.where(diag > 0, diag, 1.0)
        arrays.append({
            "ell_idx": idx, "ell_vals": vals, "inv_diag": 1.0 / diag,
            "agg": agg.astype(np.int32),
            "lmax": np.float64(1.05 * max(_rho_dinv_a(lvl), 1e-12)),
            "members": np.ascontiguousarray(members(agg, nc).T),
        })
        meta.append({"n": int(n), "nc": int(nc)})
        P = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
        lvl = (P.T @ lvl @ P).tocsr()
        lvl.sum_duplicates()
    arrays.append({"A_inv": np.linalg.inv(lvl.toarray())})
    meta.append({"n": int(lvl.shape[0]), "nc": 0})
    return tuple(arrays), tuple(meta)


def rebuild_amg_values(A, arrays, meta):
    """The values of a hierarchy (`build_amg`'s arrays, as numpy) for the
    edited CSR A over its frozen aggregation, as the JAX package's
    rebuild_amg_values: a weight edit keeps the sparsity pattern (the
    assembly keeps structural zeros), so the aggregates, the member lists,
    the level sizes and the ELL widths stay; the matrices, diagonals,
    spectral bounds and the coarsest inverse are made anew."""
    import scipy.sparse as sp

    out = []
    lvl = A.tocsr()
    for lv, arr in enumerate(arrays[:-1]):
        idx, vals = _csr_to_ell(lvl, K_fixed=arr["ell_vals"].shape[1])
        diag = lvl.diagonal()
        diag = np.where(diag > 0, diag, 1.0)
        out.append({
            "ell_idx": idx, "ell_vals": vals, "inv_diag": 1.0 / diag,
            "agg": arr["agg"],
            "lmax": np.float64(1.05 * max(_rho_dinv_a(lvl), 1e-12)),
            "members": arr["members"],
        })
        n, nc = meta[lv]["n"], meta[lv]["nc"]
        agg = np.asarray(arr["agg"], np.int64)
        P = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
        lvl = (P.T @ lvl @ P).tocsr()
        lvl.sum_duplicates()
    out.append({"A_inv": np.linalg.inv(lvl.toarray())})
    return tuple(out)


def levels_to_device(arrays, dtype, device):
    """The hierarchy as tensors: floats (lmax a 0-dim tensor) in dtype,
    indices int64."""
    out = []
    for lv in arrays:
        out.append({k: torch.as_tensor(
            np.asarray(a), device=device,
            dtype=(torch.int64 if np.issubdtype(np.asarray(a).dtype,
                                                np.integer) else dtype))
            for k, a in lv.items()})
    return tuple(out)


# -------------------------------------------------------------- device apply

def make_vcycle(meta, degree=1, alpha=4.0):
    """z = M^-1 r for r (n,3), the V-cycle over `levels` (the tensors of
    `build_amg`'s arrays): apply_M(levels, r). Smoother: degree-`degree`
    Chebyshev on the Jacobi-preconditioned operator over [lmax/alpha,
    lmax], self-adjoint, so the cycle is an SPD preconditioner."""

    def cheb(lv, r):
        """z ~ A^-1 r from a zero start (a fixed polynomial)."""
        lmax = lv["lmax"]
        lmin = lmax / alpha
        th = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = th / delta
        inv_d = lv["inv_diag"][:, None]
        rho = 1.0 / sigma
        d = (1.0 / th) * (inv_d * r)
        z = d
        rk = r
        for _ in range(degree - 1):
            rk = rk - ell_apply(d, lv["ell_idx"], lv["ell_vals"])
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_d * rk)
            z = z + d
            rho = rho_new
        return z

    def vc(levels, level, r):
        lv = levels[level]
        if "A_inv" in lv:
            return lv["A_inv"] @ r
        z = cheb(lv, r)
        res = r - ell_apply(z, lv["ell_idx"], lv["ell_vals"])
        # the aggregates' sums: a gather over their members and the zero
        # sentinel row, summed in one fixed order
        rc = transpose_gather_apply(torch.cat([res, res.new_zeros((1, 3))]),
                                    lv["members"])
        z = z + vc(levels, level + 1, rc)[lv["agg"]]
        return z + cheb(lv, r - ell_apply(z, lv["ell_idx"], lv["ell_vals"]))

    def apply_M(levels, r):
        return vc(levels, 0, r)

    return apply_M
