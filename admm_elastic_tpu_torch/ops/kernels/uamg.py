"""The algebraic multigrid V-cycle as the preconditioner of a fixed-budget
PCG on ELL rows: hand-written CUDA kernel + plain twin.

Counterpart of the algebraic multigrid mode (`uamg_meta`) of the banded
whole-timestep Pallas kernel: `admm_elastic_tpu/ops/pallas/banded_step.py:
741-888` (the cycle) and `:924-955` (the PCG around it); its numpy
reference is `admm_elastic_tpu/core/uamg.py` `vcycle_np`. Per PCG
iteration z = V(r) takes the place of z = D^-1 r, on all three columns of
the (n,3) vectors, in `vcycle_np`'s order:

    z  = om0 r;            r1 = R0 (r - A z);    z1 = om1 r1
    r2 = R1 (r1 - A1 z1);  z2 = A2^-1 r2
    z1 = z1 + P1 z2;       z1 = z1 + om1 (r1 - A1 z1)
    z  = z + P0 z1;        z  = z + om0 (r - A z)

where R_l sums each aggregate's members in ascending order, P_l gathers at
each dof's aggregate (P_l = R_l^T) and A1 is the level-1 operator's ELL
rows (`core/uamg.py` builds them). The PCG keeps JAX's guards.

The planes (`PLANES`, made tensors by `planes_from`): ua_c0 (n,) int32;
ua_m1 (M1,nc1) int32, slot-major, each aggregate's members in the order
its restriction adds them (ascending; a grid's in corner order, `mg.py`),
then the sentinel n; ua_l1_idx (K1,nc1) int32 and ua_l1_vals (K1,nc1),
slot-major; ua_om0 (n,), ua_om1 (nc1,); ua_c1 (nc1,) int32; ua_m2
(M2,nc2) int32 (sentinel nc1); ua_a2inv (nc2,nc2). Sentinels and A1's
empty slots add exactly 0. Level 1 is numbered aggregate by aggregate
(`by_aggregate`), as the kernel needs. The JAX planes' (Nr,128) layout,
its transfer ops and its (128,128) blocks of A2^-1 are TPU layout.

`uamg_ell_solve` runs a whole solve through `csrc/cg_ell.cu`'s algebraic
multigrid entry (one launch on one 16-CTA thread-block cluster,
`csrc/mg_vcycle.cuh`) for CUDA tensors and `uamg_ell_solve_reference` for
CPU tensors, never falling back from one to the other; the banded window
calls the same entry for each ADMM iteration's solve in its ELL mode. The
twin (`vcycle`, `pcg_fixed_uamg`) does the kernel's operations in its
order, every sum included (member order, ELL slot order, `coarse_solve`,
`cg_step.cluster_dot`), so the kernel equals it bitwise.

This level form is also the geometric multigrid's: `mg.planes_from`
converts a grid hierarchy to these planes, and `mg.mg_dia_solve` runs the
same kernel on dia rows. `solve_plan` and `solve_prepare` serve both.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...core.solver import pcg_fixed_precond
from . import _build
from .cg_ell import ell_apply_by_slot, slot_major
from .cg_step import _halving_tree, cluster_dot

PLANES = ("ua_c0", "ua_m1", "ua_l1_idx", "ua_l1_vals", "ua_om0", "ua_om1",
          "ua_c1", "ua_m2", "ua_a2inv")
_INT = ("ua_c0", "ua_m1", "ua_l1_idx", "ua_c1", "ua_m2")
WARP = 32  # lanes of one coarsest-level dot (csrc/mg_vcycle.cuh)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class UAMGConfig:
    """The static part of an algebraic multigrid: its level sizes (n,
    nc1, nc2)."""

    levels: tuple

    @classmethod
    def of(cls, u):
        """The config of a `core.uamg.build_uamg` result."""
        return cls(tuple(int(q) for q in u["levels"]))


def by_aggregate(u):
    """A level form (`core.uamg.build_uamg`'s keys) with level 1 numbered
    aggregate by aggregate: level 2's aggregates in order, each one's
    members consecutive in the order its member list adds them, so that
    slot 0 of m2 holds each aggregate's first member. The kernel takes the
    members of a CTA's coarsest rows as its level-1 rows
    (csrc/mg_vcycle.cuh). Every sum keeps its terms and their order, so
    the V-cycle's values do not move."""
    nc1 = int(u["levels"][1])
    m2 = np.asarray(u["m2"], np.int64)
    order = m2.T.ravel()
    order = order[order < nc1]  # old numbers, in the new order
    if len(order) != nc1 or len(np.unique(order)) != nc1:
        raise ValueError("level 2's aggregates do not cover level 1 once")
    new = np.empty(nc1, np.int64)
    new[order] = np.arange(nc1)
    c0, m1 = np.asarray(u["c0"]), np.asarray(u["m1"])
    return {**u, "c0": new[c0], "m1": m1[:, order],
            "l1_idx": new[np.asarray(u["l1_idx"])[:, order]],
            "l1_vals": np.asarray(u["l1_vals"])[:, order],
            "om_invd1": np.asarray(u["om_invd1"])[order],
            "c1": np.asarray(u["c1"])[order],
            "m2": np.where(m2 < nc1, new[np.minimum(m2, nc1 - 1)], nc1)}


def planes_from(u, dtype, device):
    """The tensors of a `core.uamg.build_uamg` result, level 1 numbered
    aggregate by aggregate (`by_aggregate`): floats in dtype, indices
    int32."""
    u = by_aggregate(u)
    src = {"ua_c0": u["c0"], "ua_m1": u["m1"], "ua_l1_idx": u["l1_idx"],
           "ua_l1_vals": u["l1_vals"], "ua_om0": u["om_invd0"],
           "ua_om1": u["om_invd1"], "ua_c1": u["c1"], "ua_m2": u["m2"],
           "ua_a2inv": u["a2inv"]}
    return {k: torch.as_tensor(np.array(a, order="C"),
                               dtype=torch.int32 if k in _INT else dtype,
                               device=device)
            for k, a in src.items()}


def check_planes(planes, cfg: UAMGConfig, like):
    """Raise unless the planes have cfg's level sizes, contiguous, on
    like's device in like's dtype (indices int32)."""
    n, nc1, nc2 = cfg.levels

    def width(name):
        t = planes[name]
        return t.shape[0] if t.dim() == 2 else -1

    want = {"ua_c0": (n,), "ua_m1": (width("ua_m1"), nc1),
            "ua_l1_idx": (width("ua_l1_idx"), nc1),
            "ua_l1_vals": (width("ua_l1_idx"), nc1), "ua_om0": (n,),
            "ua_om1": (nc1,), "ua_c1": (nc1,),
            "ua_m2": (width("ua_m2"), nc2), "ua_a2inv": (nc2, nc2)}
    for name, shape in want.items():
        t = planes[name]
        dtype = torch.int32 if name in _INT else like.dtype
        if tuple(t.shape) != shape or min(shape) < 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != like.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {like.device}")
    if like.shape[0] != n:
        raise ValueError(f"{like.shape[0]} rows, the multigrid has {n}")


# ------------------------------------------------------------ plain twin

def restrict(x, m):
    """Each coarse dof's members of x (N,3) summed in slot order: m (M,nc)
    slot-major, sentinel N (a zero row)."""
    xz = torch.cat([x, x.new_zeros((1, 3))])
    acc = xz[m[0].long()]
    for k in range(1, m.shape[0]):
        acc = acc + xz[m[k].long()]
    return acc


def coarse_solve(a2inv, r2):
    """A2^-1 r2 for r2 (nc2,3) in the kernel's order: each row's dot by
    one warp, lane l adding columns l, l + 32, ... in turn, then the
    lanes by the halving tree."""
    nc2 = r2.shape[0]
    m = -(-nc2 // WARP)
    prod = a2inv[:, :, None] * r2[None, :, :]
    lanes = F.pad(prod, (0, 0, 0, m * WARP - nc2)).view(nc2, m, WARP, 3)
    acc = torch.zeros_like(lanes[:, 0])
    for turn in lanes.unbind(1):
        acc = acc + turn
    return _halving_tree(acc.transpose(1, 2).reshape(-1, WARP)).view(nc2, 3)


def l1_apply(y, idx, vals):
    """A1 y over slot-major ELL rows (K1,nc1), the slots added in order."""
    out = torch.zeros_like(y)
    for k in range(idx.shape[0]):
        out = out + vals[k][:, None] * y[idx[k].long()]
    return out


def vcycle(r, A, planes):
    """z = V(r) for r (n,3); A applies the fine matrix (n,3) -> (n,3)."""
    om0, om1 = planes["ua_om0"][:, None], planes["ua_om1"][:, None]
    c0, c1 = planes["ua_c0"].long(), planes["ua_c1"].long()

    def A1(y):
        return l1_apply(y, planes["ua_l1_idx"], planes["ua_l1_vals"])

    z = om0 * r
    r1 = restrict(r - A(z), planes["ua_m1"])
    z1 = om1 * r1
    r2 = restrict(r1 - A1(z1), planes["ua_m2"])
    z2 = coarse_solve(planes["ua_a2inv"], r2)
    z1 = z1 + z2[c1]
    z1 = z1 + om1 * (r1 - A1(z1))
    z = z + z1[c0]
    return z + om0 * (r - A(z))


def pcg_fixed_uamg(A, b, x0, planes, n_iters, dot=None):
    """n_iters PCG iterations on A x = b from x0 with the algebraic V-cycle
    as the preconditioner (`core.solver.pcg_fixed_precond`); `dot` as in
    `core.solver.pcg_fixed_inv`. Returns x."""
    return pcg_fixed_precond(A, b, x0, lambda r: vcycle(r, A, planes),
                             int(n_iters), dot)


def uamg_ell_solve_reference(b, x0, ell_idx, ell_vals, planes, cfg,
                             n_iters):
    """Plain PyTorch version of `uamg_ell_solve`, in its order of
    operations."""
    return pcg_fixed_uamg(lambda y: ell_apply_by_slot(y, ell_idx, ell_vals),
                          b, x0, planes, n_iters, cluster_dot)


# ---------------------------------------------------------------- kernel

class UAMGHost(ctypes.Structure):
    """What the C entries take of a multigrid (csrc/mg_vcycle.cuh `Host`):
    the planes' addresses and the sizes."""

    _fields_ = [*((k, ctypes.c_void_p) for k in PLANES),
                ("nc1", ctypes.c_int), ("M1", ctypes.c_int),
                ("K1", ctypes.c_int), ("nc2", ctypes.c_int),
                ("M2", ctypes.c_int)]


def host_struct(planes, cfg) -> UAMGHost:
    """The C description of a multigrid's planes (their addresses now);
    cfg: a `UAMGConfig` or an `mg.MGConfig`."""
    _, nc1, nc2 = cfg.levels
    return UAMGHost(*(planes[k].data_ptr() for k in PLANES), nc1,
                    planes["ua_m1"].shape[0], planes["ua_l1_idx"].shape[0],
                    nc2, planes["ua_m2"].shape[0])


def solve_plan(n, D, host: UAMGHost, dtype, device=None) -> dict:
    """A multigrid solve's layout on a CUDA device (the current one by
    default), n rows, D fine matrix values a row it may keep in shared
    memory (dia: the diagonals; ELL: 0): dynamic shared memory a CTA,
    whether the fine diagonals and the CTA's rows of A2^-1 are in it, the
    elements of global scratch, whether the fine stages are fused, and
    the cluster barriers and mbarrier waits an iteration."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctypes.c_longlong * 7)()
    elem = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        _build.check(_build.load_library().mg_solve_plan(
            n, D, ctypes.addressof(host), elem, ctypes.addressof(out)),
            "mg_solve_plan")
    return {"smem_bytes": out[0], "matrix_in_smem": bool(out[1]),
            "a2inv_in_smem": bool(out[2]), "scratch": out[3],
            "fused": bool(out[4]), "cluster_barriers_per_iteration": out[5],
            "mbarrier_waits_per_iteration": out[6]}


def solve_prepare(like, n, D, host: UAMGHost):
    """The set-up of the multigrid solves of n rows on `host`'s multigrid,
    dtype and device of `like`, on dia rows (D diagonals) or ELL rows (D =
    0): the kernel's attributes and the check that the card can place the
    cluster, which a CUDA graph capture must find done. Returns the
    solve's global scratch."""
    plan = solve_plan(n, D, host, like.dtype, like.device)
    lib, suffix = _build.load_library(), _SUFFIX[like.dtype]
    with torch.cuda.device(like.device):
        err = (getattr(lib, f"mg_dia_prepare_{suffix}")(
            D, n, ctypes.addressof(host)) if D else
            getattr(lib, f"uamg_ell_prepare_{suffix}")(
                n, ctypes.addressof(host)))
    _build.check(err, "multigrid solve set-up")
    return like.new_empty(plan["scratch"])


def _check(b, x0, ell_idx, ell_vals, planes, cfg):
    n = b.shape[0] if b.dim() == 2 else -1
    K = ell_idx.shape[-1] if ell_idx.dim() == 2 else -1
    if b.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {b.dtype}")
    for name, t, shape, dtype in (
            ("b", b, (n, 3), b.dtype), ("x0", x0, (n, 3), b.dtype),
            ("ell_idx", ell_idx, (n, K), torch.int32),
            ("ell_vals", ell_vals, (n, K), b.dtype)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != b.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {b.device}")
    if K < 1:
        raise ValueError("ell_idx: no slots")
    check_planes(planes, cfg, b)
    return n, K


def uamg_ell_solve(b, x0, ell_idx, ell_vals, planes, cfg: UAMGConfig,
                   n_iters):
    """Solve A x = b by n_iters algebraic-V-cycle PCG iterations from x0.
    b, x0: (n,3); ell_idx (n,K) int32 and ell_vals (n,K): A's ELL rows;
    planes and cfg: the multigrid (`planes_from`, `UAMGConfig.of`)."""
    n, K = _check(b, x0, ell_idx, ell_vals, planes, cfg)
    if b.device.type == "cpu":
        return uamg_ell_solve_reference(b, x0, ell_idx, ell_vals, planes,
                                        cfg, int(n_iters))
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    host = host_struct(planes, cfg)
    scratch = solve_prepare(b, n, 0, host)
    x = torch.empty_like(b)
    idx_t, vals_t = slot_major(ell_idx), slot_major(ell_vals)
    fn = getattr(_build.load_library(), f"uamg_ell_solve_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        err = fn(b.data_ptr(), x0.data_ptr(), idx_t.data_ptr(),
                 vals_t.data_ptr(), K, n, int(n_iters),
                 ctypes.addressof(host), x.data_ptr(), scratch.data_ptr(),
                 _build.stream_ptr(b))
    _build.check(err, "uamg_ell_solve")
    uamg_ell_solve.launches += 1
    return x


uamg_ell_solve.launches = 0
