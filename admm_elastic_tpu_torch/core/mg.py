"""Host-side builder of the geometric multigrid preconditioner that the
banded and cloth whole-timestep windows run inside their global solve
(`preconditioner="amg"` on a grid mesh in nested numbering).

Counterpart of `admm_elastic_tpu/core/mg.py` (`build_grid_mg`). The
hierarchy is the JAX package's, built by the same numpy code: two coarse
levels of Galerkin operators P^T A P over blocks of st1 and st2 grid cells
(a 0/1 P), so that on a grid numbering every level's stencil is a set of
flat-index offsets of the fine numbering, and

    level-1 matvec   masked diagonals at those offsets (zero off the
                     level's representative vertices)
    restriction      R = sum_c M_c . shift(+c) over the block corners c
                     (0/1 masks M_c handle the grid's boundaries)
    prolongation     P = R^T = sum_c shift(M_c . , -c)
    coarsest solve   the exact dense inverse of the level-2 operator, its
                     dofs in rank order (ascending fine position, rp2)
    smoothing        damped Jacobi, omega = 4 / (3 rho(D^-1 A)) per level

so a V(1,1)-cycle is symmetric positive definite, a valid PCG
preconditioner. What the JAX package adds for the TPU is left out: the
(Nr,128) lane planes, the two lane-gather pack/unpack assignments with
their row ranges, and the inverse cut into (128,128) MXU blocks. Its pack
is exactly r2[rp2] and its unpack the scatter back to rp2, which is what
the port keeps (`ops/kernels/mg.py` runs the cycle).
"""

from __future__ import annotations

import numpy as np

#: the JAX kernel's packed coarsest vector: NP2_ROWS (128,) rows, so the
#: banded window's coarsest level holds at most 512 dofs
LANES = 128
NP2_ROWS = 4


def _grid_coords_and_strides(vertices, flat_tol=1e-6):
    """ijk integer grid coords per vertex id, plus the numbering strides
    (s_i, s_j, s_k) such that id == ijk @ s (a nested axis order, any of
    the 6). Returns (ijk (n,3), strides (3,), dims (3,)) or None."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 27:
        return None
    mins = v.min(axis=0)
    span = v.max(axis=0) - mins
    tol = flat_tol * max(span.max(), 1.0)
    axes = []
    for a in range(3):
        vals = np.sort(np.unique(np.round(v[:, a] / max(tol, 1e-300))))
        vals = vals * tol
        keep = [vals[0]]
        for q in vals[1:]:
            if q - keep[-1] > tol * 4:
                keep.append(q)
        axes.append(np.asarray(keep))
    dims = np.array([len(a) for a in axes])
    if dims.prod() != n or (dims < 2).sum() > 1:
        return None
    sizes = []
    for a in range(3):
        d = np.diff(axes[a])
        if d.size == 0:
            sizes.append(1.0)
            continue
        if np.abs(d - d[0]).max() > tol * 8:
            return None
        sizes.append(d[0])
    ijk = np.round((v - mins) / np.asarray(sizes)).astype(np.int64)
    if (ijk < 0).any() or (ijk >= dims).any():
        return None
    # solve id = ijk @ s + off: unit steps from the (0,0,0) corner
    strides = np.zeros(3, np.int64)
    ids = np.arange(n)
    lut = {t: i for i, t in enumerate(map(tuple, ijk))}
    base_ijk = ijk[int(np.argmin(ijk.sum(1)))]
    base = lut[tuple(base_ijk)]
    for a in range(3):
        if dims[a] == 1:
            strides[a] = 0
            continue
        t = base_ijk.copy()
        t[a] += 1
        nb = lut.get(tuple(t))
        if nb is None:
            return None
        strides[a] = nb - base
    off = ids - ijk @ strides
    if not (off == off[0]).all():
        return None
    return ijk, strides, dims


def _level_reps(ijk, dims, st):
    """Mask of representative vertices for stride `st` blocks."""
    return ((ijk[:, 0] % st == 0) & (ijk[:, 1] % st == 0)
            & (ijk[:, 2] % st == 0))


def _galerkin(A, ijk, dims, st):
    """A_coarse = P^T A P over st-blocks (0/1 P); also the coarse block
    grid dims and, per fine vertex, its coarse block id."""
    import scipy.sparse as sp

    cd = (dims + st - 1) // st
    blk = (ijk[:, 0] // st) + cd[0] * (ijk[:, 1] // st) \
        + cd[0] * cd[1] * (ijk[:, 2] // st)
    n = A.shape[0]
    P = sp.csr_matrix((np.ones(n), (np.arange(n), blk)),
                      shape=(n, int(cd.prod())))
    Ac = (P.T @ A @ P).tocsr()
    Ac.sum_duplicates()
    return Ac, cd, blk


def _masked_dia(Ac, pos_of_dof, n):
    """Coarse matrix as masked diagonals in the FINE flat layout: entry
    (i,j) lives at fine position pos_of_dof[i], offset pos_of_dof[j] -
    pos_of_dof[i]. Returns (offsets tuple, values (D,n))."""
    Acoo = Ac.tocoo()
    pi = pos_of_dof[Acoo.row]
    pj = pos_of_dof[Acoo.col]
    offs = pj - pi
    uoffs = np.unique(offs)
    vals = np.zeros((len(uoffs), n))
    for d, o in enumerate(uoffs):
        m = offs == o
        vals[d, pi[m]] = Acoo.data[m]
    return tuple(int(o) for o in uoffs), vals


def _corner_masks(ijk, strides, dims, st_f, st_c, n, rep_c):
    """Corner masks M_c for R = sum_c M_c . shift(+c) from the stride-st_f
    level onto the stride-st_c level: M_c[p] = 1 iff p is a stride-st_c
    rep and p + c is a stride-st_f rep inside p's block. Corner offsets c
    are in fine flat index units. The block ratio st_c // st_f may exceed
    2 (aggressive coarsening of large 2D grids); flat axes (dims == 1)
    contribute no corners."""
    pos = np.arange(len(ijk))
    ratio = st_c // st_f
    assert st_c % st_f == 0
    out = []
    rng = [range(ratio) if dims[a] > 1 else range(1) for a in range(3)]
    for dz in rng[2]:
        for dy in rng[1]:
            for dx in rng[0]:
                d = np.array([dx, dy, dz]) * st_f
                c = int(d @ strides)
                ok = rep_c & (ijk + d < dims).all(1)
                m = np.zeros(n)
                m[pos[ok]] = 1.0
                out.append((c, m))
    return out


def _rho_dinv_a(A, iters=10, seed=0):
    """rho(D^-1 A) by 10 power iterations from a fixed start (the JAX
    package's, so omega comes out bitwise the same)."""
    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = (A @ x) / d
        lam = float(np.linalg.norm(y))
        if lam == 0:
            return 1.0
        x = y / lam
    return lam


def build_grid_mg(A, vertices, level_strides=(2, 4),
                  max_coarse=NP2_ROWS * LANES):
    """The multigrid of CSR A_hat on a grid mesh whose numbering is a
    nested grid order, or None when the mesh does not qualify (not a full
    grid, not in nested order, or a coarsest level of more than
    `max_coarse` dofs).

    level_strides = (st1, st2): block strides of the two coarse levels
    (st2 % st1 == 0); (2, 4) is the 3D hierarchy, large 2D grids take
    ladders like (2, 8) so the coarsest level stays small.

    Returns a dict of numpy arrays and static values, every plane (n,)
    wide, indexed by fine vertex:
      l1_offs, l1_vals (D1,n): the level-1 operator's masked diagonals;
      om_invd0, om_invd1 (n,): omega D^-1 of the fine level and of level 1
        (0 off level 1's representatives);
      t0_offs, t0_masks (C0,n): the corners fine -> level 1;
      t1_offs, t1_masks (C1,n): the corners level 1 -> level 2;
      rp2 (nc2,) int64: level 2's representative positions, ascending;
      a2inv (nc2,nc2): the inverse of level 2's operator in rp2's order;
      levels (n, n1, nc2), level_strides."""
    got = _grid_coords_and_strides(vertices)
    if got is None:
        return None
    ijk, strides, dims = got
    n = A.shape[0]
    st1, st2 = level_strides
    A1, cd1, _ = _galerkin(A, ijk, dims, st1)
    A2, cd2, _ = _galerkin(A, ijk, dims, st2)
    if A2.shape[0] > max_coarse:
        return None

    rep1 = _level_reps(ijk, dims, st1)
    rep2 = _level_reps(ijk, dims, st2)
    pos = np.arange(n)

    def pos_of(rep, st, cd):
        """Level dof (nested coarse order) -> its fine position."""
        rp = pos[rep]
        li = ijk[rp] // st
        dof = li[:, 0] + cd[0] * li[:, 1] + cd[0] * cd[1] * li[:, 2]
        out = np.zeros(int(cd.prod()), np.int64)
        out[dof] = rp
        return out

    pod1 = pos_of(rep1, st1, cd1)
    pod2 = pos_of(rep2, st2, cd2)
    l1_offs, l1_vals = _masked_dia(A1, pod1, n)

    om0 = 4.0 / (3.0 * _rho_dinv_a(A))
    om1 = 4.0 / (3.0 * _rho_dinv_a(A1))
    d0 = A.diagonal()
    om_invd0 = om0 / np.where(d0 > 0, d0, 1.0)
    d1full = np.zeros(n)
    d1v = A1.diagonal()
    d1full[pod1] = np.where(d1v > 0, d1v, 1.0)
    om_invd1 = np.where(d1full > 0, om1 / np.where(d1full > 0, d1full, 1),
                        0.0)

    t0 = _corner_masks(ijk, strides, dims, 1, st1, n, rep1)
    t1 = _corner_masks(ijk, strides, dims, st1, st2, n, rep2)

    # the coarsest level in rank order (ascending fine position); A2 is
    # numbered in nested coarse order, so permute it the same way
    import scipy.sparse as sp

    rp2 = np.sort(pos[rep2])
    perm = np.argsort(pod2)
    Pp = sp.csr_matrix((np.ones(len(perm)), (perm, np.arange(len(perm)))),
                       shape=(len(perm), len(perm)))
    a2inv = np.linalg.inv((Pp.T @ A2 @ Pp).toarray())
    return {
        "l1_offs": l1_offs, "l1_vals": l1_vals,
        "om_invd0": om_invd0, "om_invd1": om_invd1,
        "t0_offs": tuple(c for c, _ in t0),
        "t0_masks": np.stack([m for _, m in t0]),
        "t1_offs": tuple(c for c, _ in t1),
        "t1_masks": np.stack([m for _, m in t1]),
        "rp2": rp2, "a2inv": a2inv,
        "levels": (int(n), int(A1.shape[0]), int(A2.shape[0])),
        "level_strides": (int(st1), int(st2)),
    }
