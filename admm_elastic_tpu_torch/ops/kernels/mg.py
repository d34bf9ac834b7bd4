"""The geometric multigrid V-cycle as the preconditioner of a fixed-budget
PCG: hand-written CUDA kernel + plain twin.

Counterpart of the multigrid mode (`mg_meta`) of the whole-timestep
Pallas kernels: `admm_elastic_tpu/ops/pallas/banded_step.py:600-739` (the
cycle) and `:924-951` (the PCG around it), and `cloth_step.py:457-595`,
`:627-673`; its numpy reference is `admm_elastic_tpu/core/mg.py`
`vcycle_np`. Per PCG iteration z = V(r) takes the place of z = D^-1 r, on
all three columns of the (n,3) vectors:

    z  = om0 r;            r1 = R0 (r - A z);    z1 = om1 r1
    r2 = R1 (r1 - A1 z1) at rp2;   z2 = scatter_rp2(A2^-1 r2)
    z1 = z1 + P1 z2;       z1 = z1 + om1 (r1 - A1 z1)
    z  = z + P0 z1;        z  = z + om0 (r - A z)

where R_l = sum_c M_c . shift(+c), P_l = R_l^T = sum_c shift(M_c . , -c)
and A1 is the masked level-1 diagonals (`core/mg.py` builds the planes).
The PCG keeps JAX's guards: alpha = rz / pAp where pAp > 0 (else / 1),
beta = rz' / rz where rz > 0 (else / 1).

The planes (`PLANES`, numpy from `core.mg.build_grid_mg`, made tensors by
`planes_from`): mg_l1 (D1,n), mg_om0, mg_om1 (n,), mg_t0 (C0,n), mg_t1
(C1,n), mg_rp2 (nc2,) int32, mg_a2inv (nc2,nc2); the static offsets are
`MGConfig`. No padding: the JAX planes' (Nr,128) layout and its pack and
unpack lane gathers are TPU layout.

`mg_dia_solve` runs a whole solve through `csrc/cg_dia.cu`'s multigrid
entry (one launch on one 16-CTA thread-block cluster,
`csrc/mg_vcycle.cuh`) for CUDA tensors and `mg_dia_solve_reference` for CPU
tensors, never falling back from one to the other; the banded and cloth
windows call the same entry for each ADMM iteration's solve. The twin
(`vcycle`, `pcg_fixed_mg`) does the kernel's operations in its order,
every sum included (`coarse_solve`, `cg_step.cluster_dot`), so the kernel
equals it bitwise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...core.solver import dia_apply, pcg_fixed_precond
from . import _build
from .cg_dia import MAX_DIAGONALS
from .cg_step import _halving_tree, cluster_dot

PLANES = ("mg_l1", "mg_om0", "mg_om1", "mg_t0", "mg_t1", "mg_rp2",
          "mg_a2inv")
MAX_CORNERS = 64  # the kernel's corner tables (csrc/mg_vcycle.cuh)
WARP = 32  # lanes of one coarsest-level dot (csrc/mg_vcycle.cuh)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """The static part of a multigrid: the level-1 operator's offsets and
    the corner offsets of the two transfers, in fine flat-index units."""

    l1_offs: tuple
    t0_offs: tuple
    t1_offs: tuple

    def __post_init__(self):
        if not 1 <= len(self.l1_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.l1_offs)} level-1 diagonals; the "
                             f"kernel takes 1..{MAX_DIAGONALS}")
        for offs in (self.t0_offs, self.t1_offs):
            if not 1 <= len(offs) <= MAX_CORNERS:
                raise ValueError(f"{len(offs)} corners; the kernel takes "
                                 f"1..{MAX_CORNERS}")

    @classmethod
    def of(cls, mg):
        """The config of a `core.mg.build_grid_mg` result."""
        return cls(*(tuple(int(o) for o in mg[k])
                     for k in ("l1_offs", "t0_offs", "t1_offs")))


def planes_from(mg, dtype, device):
    """The tensors of a `core.mg.build_grid_mg` result: floats in dtype,
    rp2 int32."""
    def dev(a, dt=dtype):
        return torch.as_tensor(np.array(a, order="C"), dtype=dt,
                               device=device)

    return {"mg_l1": dev(mg["l1_vals"]), "mg_om0": dev(mg["om_invd0"]),
            "mg_om1": dev(mg["om_invd1"]), "mg_t0": dev(mg["t0_masks"]),
            "mg_t1": dev(mg["t1_masks"]), "mg_rp2": dev(mg["rp2"],
                                                        torch.int32),
            "mg_a2inv": dev(mg["a2inv"])}


def check_planes(planes, cfg: MGConfig, n, like):
    """Raise unless the planes have cfg's shapes for n rows, contiguous,
    on like's device in like's dtype (rp2 int32)."""
    nc2 = planes["mg_rp2"].shape[0] if planes["mg_rp2"].dim() == 1 else -1
    want = {"mg_l1": (len(cfg.l1_offs), n), "mg_om0": (n,), "mg_om1": (n,),
            "mg_t0": (len(cfg.t0_offs), n), "mg_t1": (len(cfg.t1_offs), n),
            "mg_rp2": (nc2,), "mg_a2inv": (nc2, nc2)}
    for name, shape in want.items():
        t = planes[name]
        dtype = torch.int32 if name == "mg_rp2" else like.dtype
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != like.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {like.device}")
    if nc2 < 1:
        raise ValueError("an empty coarsest level")
    return nc2


# ------------------------------------------------------------ plain twin

def _shift(y, off):
    """out[i] = y[i + off], 0 past either end."""
    n = y.shape[0]
    out = torch.zeros_like(y)
    lo, hi = max(0, -off), min(n, n - off)
    if lo < hi:
        out[lo:hi] = y[lo + off:hi + off]
    return out


def restrict(x, offs, masks):
    """sum_c M_c . shift(x, +c), the corners added in order."""
    acc = None
    for c, m in zip(offs, masks):
        t = m[:, None] * _shift(x, c)
        acc = t if acc is None else acc + t
    return acc


def prolong(x, offs, masks):
    """sum_c shift(M_c . x, -c), the corners added in order."""
    acc = None
    for c, m in zip(offs, masks):
        t = _shift(m[:, None] * x, -c)
        acc = t if acc is None else acc + t
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


def vcycle(r, A, planes, cfg: MGConfig):
    """z = V(r) for r (n,3); A applies the fine matrix (n,3) -> (n,3)."""
    om0, om1 = planes["mg_om0"][:, None], planes["mg_om1"][:, None]
    t0, t1 = planes["mg_t0"], planes["mg_t1"]
    rp2 = planes["mg_rp2"].long()

    def A1(y):
        return dia_apply(y, cfg.l1_offs, planes["mg_l1"])

    z = om0 * r
    r1 = restrict(r - A(z), cfg.t0_offs, t0)
    z1 = om1 * r1
    r2 = restrict(r1 - A1(z1), cfg.t1_offs, t1)[rp2]
    z2 = torch.zeros_like(r)
    z2[rp2] = coarse_solve(planes["mg_a2inv"], r2)
    z1 = z1 + prolong(z2, cfg.t1_offs, t1)
    z1 = z1 + om1 * (r1 - A1(z1))
    z = z + prolong(z1, cfg.t0_offs, t0)
    return z + om0 * (r - A(z))


def pcg_fixed_mg(A, b, x0, planes, cfg: MGConfig, n_iters, dot=None):
    """n_iters PCG iterations on A x = b from x0 with the V-cycle as the
    preconditioner (`core.solver.pcg_fixed_precond`); `dot` sums a*b over
    all 3n values (default torch.sum; the kernel's twin passes
    `cg_step.cluster_dot`). Returns x."""
    return pcg_fixed_precond(A, b, x0, lambda r: vcycle(r, A, planes, cfg),
                             int(n_iters), dot)


def mg_dia_solve_reference(b, x0, dia_vals, offsets, planes, cfg, n_iters):
    """Plain PyTorch version of `mg_dia_solve`, in its order of
    operations."""
    return pcg_fixed_mg(lambda y: dia_apply(y, offsets, dia_vals), b, x0,
                        planes, cfg, n_iters, cluster_dot)


# ---------------------------------------------------------------- kernel

class MGHost(ctypes.Structure):
    """What the C entries take of a multigrid (csrc/mg_vcycle.cuh
    `Host`): the planes' addresses, the sizes and the offset tables."""

    _fields_ = [*((k, ctypes.c_void_p) for k in PLANES),
                ("D1", ctypes.c_int), ("C0", ctypes.c_int),
                ("C1", ctypes.c_int), ("nc2", ctypes.c_int),
                ("l1_offs", ctypes.c_int * MAX_DIAGONALS),
                ("t0_offs", ctypes.c_int * MAX_CORNERS),
                ("t1_offs", ctypes.c_int * MAX_CORNERS)]


def host_struct(planes, cfg: MGConfig) -> MGHost:
    """The C description of a multigrid's planes (their addresses now)."""
    h = MGHost(*(planes[k].data_ptr() for k in PLANES), len(cfg.l1_offs),
               len(cfg.t0_offs), len(cfg.t1_offs),
               planes["mg_rp2"].shape[0])
    h.l1_offs[:len(cfg.l1_offs)] = cfg.l1_offs
    h.t0_offs[:len(cfg.t0_offs)] = cfg.t0_offs
    h.t1_offs[:len(cfg.t1_offs)] = cfg.t1_offs
    return h


def mg_plan(n, D, nc2, dtype, device=None) -> dict:
    """The multigrid solve's layout on a CUDA device (the current one by
    default): dynamic shared memory a CTA, whether the slab's fine
    diagonals are in it, and the elements of global scratch."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctypes.c_longlong * 3)()
    elem = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        _build.check(_build.load_library().mg_dia_plan(
            n, D, nc2, elem, ctypes.addressof(out)), "mg_dia_plan")
    return {"smem_bytes": out[0], "matrix_in_smem": bool(out[1]),
            "scratch": out[2]}


def mg_prepare(like, n, D, nc2):
    """The set-up of the multigrid solves of n rows, D fine diagonals and
    nc2 coarsest dofs, dtype and device of `like`: the kernel's attributes
    and the check that the card can place the cluster, which a CUDA graph
    capture must find done. Returns the solve's global scratch."""
    plan = mg_plan(n, D, nc2, like.dtype, like.device)
    with torch.cuda.device(like.device):
        err = getattr(_build.load_library(),
                      f"mg_dia_prepare_{_SUFFIX[like.dtype]}")(D, n, nc2)
    _build.check(err, "multigrid solve set-up")
    return like.new_empty(plan["scratch"])


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
    return n, check_planes(planes, cfg, n, b)


def mg_dia_solve(b, x0, dia_vals, offsets, planes, cfg: MGConfig, n_iters):
    """Solve A x = b by n_iters V-cycle-preconditioned PCG iterations from
    x0. b, x0: (n,3); dia_vals (D,n) at `offsets`; planes and cfg: the
    multigrid (`planes_from`, `MGConfig.of`)."""
    offsets = tuple(int(o) for o in offsets)
    n, nc2 = _check(b, x0, dia_vals, offsets, planes, cfg)
    if b.device.type == "cpu":
        return mg_dia_solve_reference(b, x0, dia_vals, offsets, planes, cfg,
                                      int(n_iters))
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    scratch = mg_prepare(b, n, len(offsets), nc2)
    x = torch.empty_like(b)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    host = host_struct(planes, cfg)
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
