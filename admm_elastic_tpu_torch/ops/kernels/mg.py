"""The geometric multigrid V-cycle as the preconditioner of a fixed-budget
PCG on dia rows: hand-written CUDA kernel + plain twin.

Counterpart of the multigrid mode (`mg_meta`) of the whole-timestep
Pallas kernels: `admm_elastic_tpu/ops/pallas/banded_step.py:600-739` (the
cycle) and `:924-951` (the PCG around it), and `cloth_step.py:457-595`,
`:627-673`; its numpy reference is `admm_elastic_tpu/core/mg.py`
`vcycle_np`. Per PCG iteration z = V(r) takes the place of z = D^-1 r, on
all three columns of the (n,3) vectors:

    z  = om0 r;            r1 = R0 (r - A z);    z1 = om1 r1
    r2 = R1 (r1 - A1 z1);  z2 = A2^-1 r2
    z1 = z1 + P1 z2;       z1 = z1 + om1 (r1 - A1 z1)
    z  = z + P0 z1;        z  = z + om0 (r - A z)

`core.mg.build_grid_mg` gives the hierarchy as the TPU kernel holds it,
every level indexed by fine row: R_l = sum_c M_c . shift(+c) over a
block's corners, P_l = R_l^T, A1 masked diagonals, zero off each level's
representatives. On a grid in nested numbering that is an aggregation,
and `compact_levels` converts it to the algebraic multigrid's level form
(`uamg.py`): R0 sums the members of a stride block, in corner order; P0
gathers at each fine row's one parent; A1 is ELL rows at the level-1
representatives, their slots in diagonal order; level 2 the same, A2^-1 in
rp2's order. Only exact zeros drop out of the sums (the masks' zero
terms, z1 off the representatives), so the cycle adds the same nonzero
terms in the same order and gives the masked cycle's values.

`planes_from` makes the compact planes tensors (`uamg.PLANES`);
`mg_dia_solve` runs a whole solve through `csrc/cg_dia.cu`'s multigrid
entry (one launch on one 16-CTA thread-block cluster,
`csrc/mg_vcycle.cuh`) for CUDA tensors and `mg_dia_solve_reference` (the
twin `uamg.pcg_fixed_uamg` on `dia_apply`) for CPU tensors, never falling
back from one to the other; the banded and cloth windows call the same
entry for each ADMM iteration's solve.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ...core.solver import dia_apply
from . import _build
from .cg_dia import MAX_DIAGONALS
from .cg_step import cluster_dot
from .uamg import UAMGConfig
from .uamg import check_planes as _check_level_planes
from .uamg import host_struct, pcg_fixed_uamg
from .uamg import planes_from as _level_planes
from .uamg import solve_prepare

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """The static part of a geometric multigrid: its level sizes (n, nc1,
    nc2)."""

    levels: tuple

    @classmethod
    def of(cls, mg):
        """The config of a `core.mg.build_grid_mg` result."""
        return cls(tuple(int(q) for q in mg["levels"]))


def _transfer(masks, offs, reps, rank, n_fine):
    """One level's restriction as member lists: for the coarse dofs at
    fine positions `reps` (rank order), the fine positions p + c of the
    corners c whose mask is 1 at p, in corner order, as `rank` numbers
    them (slot-major (M, nc), sentinel n_fine); and each fine dof's coarse
    dof, its one parent."""
    on = np.asarray(masks)[:, reps] != 0  # (C, nc)
    pos = reps[None, :] + np.asarray(offs, np.int64)[:, None]
    fine = rank[np.clip(pos, 0, len(rank) - 1)]  # where on: inside
    slot = np.cumsum(on, axis=0) - 1
    coarse = np.nonzero(on)[1]
    members = np.full((max(int(on.sum(0).max()), 1), len(reps)), n_fine,
                      np.int64)
    members[slot[on], coarse] = fine[on]
    parent = np.full(n_fine, -1, np.int64)
    parent[fine[on]] = coarse
    if int(on.sum()) != n_fine or (parent < 0).any() or (fine[on] < 0).any():
        raise ValueError("not an aggregation: a fine dof without exactly "
                         "one parent")
    return members, parent


def compact_levels(mg):
    """A `core.mg.build_grid_mg` result in the level form of
    `core.uamg.build_uamg` (its keys c0, m1, l1_idx, l1_vals, om_invd0,
    om_invd1, c1, m2, a2inv, levels): level 1 at its representatives in
    rank order (ascending fine position), level 2 in rp2's order, member
    lists in corner order, A1's slots in diagonal order with their exact
    zeros dropped (empty slots value 0 at the row's own index)."""
    n, nc1, nc2 = (int(q) for q in mg["levels"])
    t0, l1 = np.asarray(mg["t0_masks"]), np.asarray(mg["l1_vals"])
    rp1 = np.flatnonzero(t0.any(axis=0))
    rp2 = np.asarray(mg["rp2"], np.int64)
    if len(rp1) != nc1 or len(rp2) != nc2:
        raise ValueError("the masks' representatives are not the levels")
    rank1 = np.full(n, -1, np.int64)
    rank1[rp1] = np.arange(nc1)
    m1, c0 = _transfer(t0, mg["t0_offs"], rp1, np.arange(n), n)
    m2, c1 = _transfer(mg["t1_masks"], mg["t1_offs"], rp2, rank1, nc1)
    vals = l1[:, rp1]
    on = vals != 0
    cols = rank1[np.clip(rp1[None, :] + np.asarray(mg["l1_offs"],
                                                   np.int64)[:, None],
                         0, n - 1)]
    if (cols[on] < 0).any():
        raise ValueError("A1 reaches off the level-1 representatives")
    K1 = max(int(on.sum(0).max()), 1)
    l1_idx = np.tile(np.arange(nc1, dtype=np.int64), (K1, 1))
    l1_vals = np.zeros((K1, nc1))
    slot, row = np.cumsum(on, axis=0) - 1, np.nonzero(on)[1]
    l1_idx[slot[on], row] = cols[on]
    l1_vals[slot[on], row] = vals[on]
    return {"c0": c0, "m1": m1, "l1_idx": l1_idx, "l1_vals": l1_vals,
            "om_invd0": mg["om_invd0"],
            "om_invd1": np.asarray(mg["om_invd1"])[rp1], "c1": c1, "m2": m2,
            "a2inv": mg["a2inv"], "levels": (n, nc1, nc2)}


def planes_from(mg, dtype, device):
    """The kernel's planes (`uamg.PLANES`) of a `core.mg.build_grid_mg`
    result, in its compact level form: floats in dtype, indices int32."""
    return _level_planes(compact_levels(mg), dtype, device)


def check_planes(planes, cfg: MGConfig, n, like):
    """Raise unless the planes have cfg's level sizes for n rows,
    contiguous, on like's device in like's dtype (indices int32)."""
    if cfg.levels[0] != n:
        raise ValueError(f"{n} rows, the multigrid has {cfg.levels[0]}")
    _check_level_planes(planes, UAMGConfig(cfg.levels), like)


def mg_dia_solve_reference(b, x0, dia_vals, offsets, planes, cfg, n_iters):
    """Plain PyTorch version of `mg_dia_solve`, in its order of
    operations."""
    return pcg_fixed_uamg(lambda y: dia_apply(y, offsets, dia_vals), b, x0,
                          planes, int(n_iters), cluster_dot)


# ---------------------------------------------------------------- kernel

def _check(b, x0, dia_vals, offsets, planes, cfg):
    n = b.shape[0] if b.dim() == 2 else -1
    if b.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {b.dtype}")
    for name, t, shape in (("b", b, (n, 3)), ("x0", x0, (n, 3)),
                           ("dia_vals", dia_vals, (len(offsets), n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != b.device or t.dtype != b.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{b.dtype} on {b.device}")
    if not 1 <= len(offsets) <= MAX_DIAGONALS:
        raise ValueError(f"{len(offsets)} diagonals; the kernel takes "
                         f"1..{MAX_DIAGONALS}")
    check_planes(planes, cfg, n, b)
    return n


def mg_dia_solve(b, x0, dia_vals, offsets, planes, cfg: MGConfig, n_iters):
    """Solve A x = b by n_iters V-cycle-preconditioned PCG iterations from
    x0. b, x0: (n,3); dia_vals (D,n) at `offsets`; planes and cfg: the
    multigrid (`planes_from`, `MGConfig.of`)."""
    offsets = tuple(int(o) for o in offsets)
    n = _check(b, x0, dia_vals, offsets, planes, cfg)
    if b.device.type == "cpu":
        return mg_dia_solve_reference(b, x0, dia_vals, offsets, planes, cfg,
                                      int(n_iters))
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    host = host_struct(planes, cfg)
    scratch = solve_prepare(b, n, len(offsets), host)
    x = torch.empty_like(b)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    fn = getattr(_build.load_library(), f"mg_dia_solve_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        err = fn(b.data_ptr(), x0.data_ptr(), dia_vals.data_ptr(),
                 ctypes.addressof(offs), len(offsets), n, int(n_iters),
                 ctypes.addressof(host), x.data_ptr(), scratch.data_ptr(),
                 _build.stream_ptr(b))
    _build.check(err, "mg_dia_solve")
    mg_dia_solve.launches += 1
    return x


mg_dia_solve.launches = 0
