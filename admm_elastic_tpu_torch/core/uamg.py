"""Host-side hierarchy of the algebraic multigrid that the banded window runs
inside its global solve on a mesh of any topology (`preconditioner="amg"`
under `global_solver="ell"`).

Counterpart of `admm_elastic_tpu/core/uamg.py` (`build_uamg`). The
hierarchy is the JAX package's, built by the same numpy code: capped
greedy aggregation over the strength graph of A_hat (level 1), then of the
level-1 Galerkin operator A1 = P1^T A P1 (level 2, composed once more
while it has more than 1,024 dofs), a 0/1 P at both levels, the exact
inverse of A2 = P2^T A1 P2 and damped-Jacobi smoothing with omega =
4 / (3 rho(D^-1 A)) per level, so that

    restriction      R_l r = each aggregate's members summed, in ascending
                     order (P_l^T)
    prolongation     P_l z = z gathered at each dof's aggregate
    level-1 matvec   A1 as ELL rows over the level-1 dofs
    coarsest solve   the dense A2^-1

and the V(1,1)-cycle is symmetric positive definite, a valid PCG
preconditioner (`ops/kernels/uamg.py` runs it).

The coarse numbering is the JAX package's: each level's aggregates ranked
by their leader's position (the least member's), at level 1 in the fine
uell layout that `pack_uell_auto` picks by plane count, at level 2 in the
level-1 numbering. The greedy level-2 aggregation walks level-1 ids in
that order, so identical aggregates need it. The port keeps a copy of the
uell candidates' vertex orders (`slab_order`, `dilute_positions`) and of
`pack_uell`'s slot and fold count, used only to choose that order. What
the JAX package adds for the TPU is left out: the (Nr,128) planes and
their packing of A1 into uell slots and folds, the transfer ops with
their budget, the (128,128) blocks of A2^-1, and its VMEM estimate. Where
those alone refuse a mesh the JAX kernel would not engage; here the
window runs all the same (ROADMAP.md, deliberate differences).
"""

from __future__ import annotations

import numpy as np

from .amg import _csr_to_ell, _strength_graph, members
from .mg import _rho_dinv_a

LANES = 128  # the JAX layout's lane width: its plane rows, and np2_max * 128
#: the coarsest level holds at most this many dofs (JAX's np2_max * LANES)
COARSE_MAX = 8 * LANES
#: the uell candidates (slab target, cap quantile) of JAX's pack_uell_auto
UELL_CANDIDATES = ((128, 0.97), (128, 0.99), (64, 0.99), (512, 0.99),
                   (512, 0.97))


# ------------------------------------------------- the fine vertex order

def slab_order(vertices, slab_target=512):
    """Vertices sorted by x-slabs of ~slab_target vertices, then (y, z)
    within each slab: position k holds vertex order[k] (core/uell.py)."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    ox = np.argsort(v[:, 0], kind="stable")
    slab = np.empty(n, np.int64)
    slab[ox] = np.arange(n) // max(int(slab_target), 1)
    return np.lexsort((v[:, 2], v[:, 1], slab))


def dilute_positions(order, dilute=8):
    """Positions of the vertices in `order` with one spare slot after each
    `dilute`: (positions (n,), number of positions)."""
    n = len(order)
    seq = np.empty(n, np.int64)
    seq[np.asarray(order, np.int64)] = np.arange(n)
    pos = seq + seq // max(int(dilute), 1)
    return pos, int(pos.max()) + 1


def _group_ranks(t, q):
    """Rank of each entry within its (t, q) group, in a stable order."""
    key = t.astype(np.int64) * 4096 + (q + 2048)
    o = np.argsort(key, kind="stable")
    ks = key[o]
    starts = np.r_[0, np.flatnonzero(np.diff(ks)) + 1]
    lens = np.diff(np.r_[starts, len(ks)])
    out = np.empty(len(t), np.int64)
    out[o] = np.arange(len(ks)) - np.repeat(starts, lens)
    return out


def _slot_count(t, s):
    """Planes of a uell packing of entries landing at t from s: one per
    (row distance q, rank within q)."""
    q = s // LANES - t // LANES
    rk = _group_ranks(t, q)
    return sum(int(rk[q == qq].max()) + 1 for qq in np.unique(q))


def uell_plane_count(rows, cols, positions, n_pos, cap_quantile=0.99,
                     max_slots=160, max_fold_layers=4, spare_pool=4096):
    """Slot planes + fold planes of JAX's `pack_uell` for these entries at
    these positions, or ValueError where it refuses them: its hub splits
    onto spare positions, layer by layer, counted without building a
    plane."""
    positions = np.asarray(positions, np.int64)
    t = positions[np.asarray(rows, np.int64)]
    s = positions[np.asarray(cols, np.int64)]
    cap_total = n_pos + int(spare_pool)
    free_mask = np.ones(cap_total, bool)
    free_mask[t] = False
    free_mask[s] = False
    free_mask[positions] = False
    fold_layers = []
    caps = None
    for layer in range(max_fold_layers + 1):
        q = s // LANES - t // LANES
        rk = _group_ranks(t, q)
        if caps is None:
            # frozen from the initial counts (core/uell.py:122-131)
            caps = {}
            for qq in np.unique(q):
                cnt = np.bincount(t[q == qq])
                cnt = cnt[cnt > 0]
                caps[int(qq)] = max(int(np.quantile(cnt, cap_quantile)), 1)
        cap_arr = np.array([caps.get(int(qq), 2) for qq in q])
        over = rk >= cap_arr
        if not over.any():
            break
        if layer == max_fold_layers:
            raise ValueError("uell: fold layers exceeded")
        chunk = rk[over] // cap_arr[over]
        key = (t[over] * 4096 + (q[over] + 2048)) * 64 + chunk
        uk, grp = np.unique(key, return_inverse=True)
        ut = uk // (4096 * 64)
        free = np.flatnonzero(free_mask)
        used = np.zeros(len(free), bool)
        if len(free) < len(uk):
            raise ValueError("uell: out of spare positions")
        alloc = np.empty(len(uk), np.int64)
        for m_i in np.argsort(ut, kind="stable"):
            tt = int(ut[m_i])
            f = np.searchsorted(free, tt)
            lo, hi = f - 1, f
            while lo >= 0 and used[lo]:
                lo -= 1
            while hi < len(free) and used[hi]:
                hi += 1
            cands = []
            if lo >= 0:
                cands.append((abs(int(free[lo]) - tt), lo))
            if hi < len(free):
                cands.append((abs(int(free[hi]) - tt), hi))
            if not cands:
                raise ValueError("uell: out of spare positions")
            ci = min(cands)[1]
            alloc[m_i] = free[ci]
            used[ci] = True
            free_mask[free[ci]] = False
        t[np.flatnonzero(over)] = alloc[grp]
        fold_layers.append((ut.copy(), alloc.copy()))
    n_slots = _slot_count(t, s)
    if n_slots > max_slots:
        raise ValueError(f"uell: {n_slots} slots exceed budget {max_slots}")
    return n_slots + sum(_slot_count(ft, fs) for ft, fs in fold_layers)


def fine_positions(A, vertices):
    """The fine layout JAX's banded kernel packs A_hat into: the
    positions (n,) of the uell candidate with the fewest planes (the
    first of equals), over A's nonzero entries. Where every candidate is
    refused (JAX's kernel would not engage), the first candidate's."""
    Ac = A.tocoo()
    nz = Ac.data != 0.0
    best = None
    for slab_target, cq in UELL_CANDIDATES:
        positions, n_pos = dilute_positions(slab_order(vertices, slab_target))
        try:
            cost = uell_plane_count(Ac.row[nz], Ac.col[nz], positions, n_pos,
                                    cap_quantile=cq)
        except ValueError:
            continue
        if best is None or cost < best[0]:
            best = (cost, positions)
    if best is None:
        return dilute_positions(slab_order(vertices, UELL_CANDIDATES[0][0]))[0]
    return best[1]


# ------------------------------------------------------------ aggregation

def aggregate_capped(S, cap=8, rounds=3):
    """Greedy aggregation with a size cap: `rounds` seeding rounds (the
    first from untouched neighbourhoods, the later ones among the
    leftovers, each seed taking at most cap - 1 free neighbours), then
    each leftover joins its smallest adjacent aggregate with room, then
    singletons. Returns (agg (n,) int64, n_agg)."""
    n = S.shape[0]
    agg = np.full(n, -1, np.int64)
    size = []
    indptr, indices = S.indptr, S.indices
    n_agg = 0
    for r in range(rounds):
        progress = False
        for i in range(n):
            if agg[i] != -1:
                continue
            nb = indices[indptr[i]: indptr[i + 1]]
            if r == 0 and (agg[nb] != -1).any():
                continue
            nb = nb[agg[nb] == -1]
            if r > 0 and len(nb) == 0:
                continue
            agg[i] = n_agg
            take = nb[: cap - 1]
            agg[take] = n_agg
            size.append(1 + len(take))
            n_agg += 1
            progress = True
        if not progress:
            break
    for i in range(n):
        if agg[i] != -1:
            continue
        best, bs = -1, cap
        for j in indices[indptr[i]: indptr[i + 1]]:
            a = agg[j]
            if a != -1 and size[a] < bs:
                best, bs = a, size[a]
        if best != -1:
            agg[i] = best
            size[best] += 1
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            size.append(1)
            n_agg += 1
    return agg, n_agg


def _rank_by_leader(agg, n_agg, member_pos):
    """rank[a]: the coarse id of aggregate a, aggregates in order of their
    least member position."""
    leader = np.full(n_agg, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(leader, agg, member_pos)
    rank = np.empty(n_agg, np.int64)
    rank[np.argsort(leader, kind="stable")] = np.arange(n_agg)
    return rank


# ------------------------------------------------------------- hierarchy

def build_uamg(A, vertices, cap=8, theta=0.08, coarse_max=COARSE_MAX):
    """The algebraic multigrid of CSR A_hat on a mesh of any topology
    (`vertices` (n,3) order the coarse dofs as JAX's fine layout does).
    Raises ValueError where JAX's build_uamg does (no
    coarsening, a coarsest level that does not shrink under 1,024 dofs).

    Returns a dict of numpy arrays and sizes:
      c0 (n,): each fine dof's level-1 dof; m1 (M1,nc1): the level-1
        members, ascending, slot-major, sentinel n;
      l1_idx, l1_vals (K1,nc1): A1 as slot-major ELL rows;
      om_invd0 (n,), om_invd1 (nc1,): omega D^-1 of the fine level and of
        level 1;
      c1 (nc1,), m2 (M2,nc2): the same from level 1 to level 2 (sentinel
        nc1);
      a2inv (nc2,nc2): the inverse of A2;
      levels (n, nc1, nc2); positions (n,): the fine layout's."""
    import scipy.sparse as sp

    A = A.tocsr()
    n = A.shape[0]
    positions = fine_positions(A, vertices)

    # level 1: capped aggregation of the fine strength graph, aggregates
    # ranked by leader position in the fine layout
    agg, nc1 = aggregate_capped(_strength_graph(A, theta), cap)
    if nc1 >= n:
        raise ValueError("uamg: no coarsening progress")
    c_of = _rank_by_leader(agg, nc1, positions)[agg]
    P1 = sp.csr_matrix((np.ones(n), (np.arange(n), c_of)), shape=(n, nc1))
    A1 = (P1.T @ A @ P1).tocsr()
    A1.sum_duplicates()

    # level 2: aggregate A1, composed again while the coarsest is too large
    agg2, nc2 = aggregate_capped(_strength_graph(A1, theta), cap)
    while nc2 > coarse_max:
        P2t = sp.csr_matrix((np.ones(nc1), (np.arange(nc1), agg2)),
                            shape=(nc1, nc2))
        A2t = (P2t.T @ A1 @ P2t).tocsr()
        aggn, ncn = aggregate_capped(_strength_graph(A2t, theta), cap)
        if ncn >= nc2:
            raise ValueError("uamg: coarsest level does not fit")
        agg2 = aggn[agg2]
        nc2 = ncn
    # ranked by leader in level-1 order (JAX's diluted coarse positions
    # id + id // 8 rise with the id, so they rank alike)
    c2_of = _rank_by_leader(agg2, nc2, np.arange(nc1))[agg2]
    P2 = sp.csr_matrix((np.ones(nc1), (np.arange(nc1), c2_of)),
                       shape=(nc1, nc2))
    a2inv = np.linalg.inv((P2.T @ A1 @ P2).toarray())

    # omega by 60 power iterations (JAX's uamg.py), bitwise JAX's
    om0 = 4.0 / (3.0 * max(_rho_dinv_a(A, iters=60), 1e-12))
    om1 = 4.0 / (3.0 * max(_rho_dinv_a(A1, iters=60), 1e-12))
    d0, d1 = A.diagonal(), A1.diagonal()
    l1_idx, l1_vals = _csr_to_ell(A1, pad_to=1)
    return {
        "c0": c_of, "m1": members(c_of, nc1),
        "l1_idx": np.ascontiguousarray(l1_idx.T),
        "l1_vals": np.ascontiguousarray(l1_vals.T),
        "om_invd0": om0 / np.where(d0 > 0, d0, 1.0),
        "om_invd1": om1 / np.where(d1 > 0, d1, 1.0),
        "c1": c2_of, "m2": members(c2_of, nc2), "a2inv": a2inv,
        "levels": (int(n), int(nc1), int(nc2)), "positions": positions,
    }
