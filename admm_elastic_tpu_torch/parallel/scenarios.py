"""Per-scenario global matrices of a scenario sweep (counterpart of
`admm_elastic_tpu/parallel/scenarios.py`'s `batched_A_values` and
`sweep_w2_b`), host numpy.

A sweep varies weights, so each scenario has its own A_hat = diag(m) +
dt^2 sum_e w2[s,e] C_e^T C_e. The sparsity pattern is topological (the
System keeps structural zeros, `core.solver._assemble_A_hat_csr`), so only
the values change: every COO entry's slot in the shared CSR pattern is
found once, and all scenarios' values are one bincount over (scenario,
slot), in the JAX package's order, so the values are its values.

The vmapped general path of the JAX module (`batch_state`, `batch_params`,
`vmap_step`) is not ported (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from ..core.solver import _assemble_A_hat_csr


def batched_A_values(system, w2_b):
    """Per-scenario A_hat values over the shared sparsity pattern.

    w2_b: (S, total elements) squared weights, the constraint forces'
    concatenated in `system._constraint_names` order. Returns (A, vals,
    diag_b): the shared-pattern CSR matrix A (its values those of the
    System's own weights: only its structure is for use), vals (S, nnz) in
    A.data (CSR) order, and diag_b (S, n)."""
    import scipy.sparse as sp

    n = system.n_nodes
    dt = system.settings.timestep_s
    dt2 = dt * dt
    S = len(w2_b)
    masses = np.asarray(system._m, np.float64)
    names = list(system._constraint_names)
    base_params = {
        name: {k: np.asarray(v) for k, v in system._params_host[name].items()}
        for name in names
    }
    A = _assemble_A_hat_csr(n, masses, dt, base_params)
    indptr, indices, nnz = A.indptr, A.indices, A.nnz
    slot_lut = sp.csr_matrix(
        (np.arange(1, nnz + 1, dtype=np.int64), indices, indptr), shape=(n, n))

    slot_all, base_all, wcol_all = [], [], []
    col_off = 0
    for name in names:
        p = base_params[name]
        C = p["coeff"].astype(np.float64)
        idx = p["indices"].astype(np.int64)
        E, K = idx.shape
        Me = np.einsum("erk,erl->ekl", C, C) * dt2
        rows = np.repeat(idx[:, :, None], K, axis=2).ravel()
        cols = np.repeat(idx[:, None, :], K, axis=1).ravel()
        slots = np.asarray(slot_lut[rows, cols]).ravel() - 1
        if (slots < 0).any():
            raise ValueError("an entry outside the shared pattern")
        slot_all.append(slots)
        base_all.append(Me.ravel())
        wcol_all.append(col_off + np.repeat(np.arange(E), K * K))
        col_off += E

    slots = np.concatenate(slot_all)
    base = np.concatenate(base_all)
    wcol = np.concatenate(wcol_all)
    w2_b = np.asarray(w2_b, np.float64)
    contrib = base[None, :] * w2_b[:, wcol]  # (S, total entries)
    comb = np.arange(S, dtype=np.int64)[:, None] * nnz + slots[None, :]
    vals = np.bincount(comb.ravel(), weights=contrib.ravel(),
                       minlength=S * nnz).reshape(S, nnz)
    dslots = np.asarray(slot_lut[np.arange(n), np.arange(n)]).ravel() - 1
    vals[:, dslots] += masses[None, :]
    return A, vals, vals[:, dslots]


def sweep_w2_b(system, sweep, n_scenarios):
    """(S, total elements) squared weights in `system._constraint_names`
    order from a sweep dict ({(force name, 'weight'): (S,) or (S, E)}, or
    {name: {'weight': (S, E)}}); a force not swept keeps its own weights."""
    S = n_scenarios
    cols = []
    for name in system._constraint_names:
        p = system._params_host[name]
        base = np.asarray(p["weight"], np.float64)
        E = len(np.asarray(p["indices"]))
        w = None
        if (name, "weight") in sweep:
            w = np.asarray(sweep[(name, "weight")], np.float64)
        elif name in sweep and "weight" in sweep[name]:
            w = np.asarray(sweep[name]["weight"], np.float64)
        if w is None:
            w = np.broadcast_to(np.broadcast_to(base, (E,)), (S, E))
        else:
            if w.ndim == 1:
                w = w[:, None]
            w = np.broadcast_to(w, (S, E))
        cols.append(w ** 2)
    return np.concatenate(cols, axis=1)
