"""Whole ADMM timesteps in one launch: hand-written CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/banded_step.py`
(`banded_rollout` / `_banded_call`) with model nh, stvk or arap, in dia
mode and in its uell mode (A_hat as ELL rows: a tet mesh of any
topology). One
call advances `n_steps` timesteps of a tet mesh with StaticAnchors,
optional analytic collision shapes and a gravity kick:

    prologue       v += dt g (where m > 0); x_pre = x; x += dt v; M xbar
    admm_iters x   element phase: F = u + sum_k cp x[idx_k] -> SVD -> Newton
                     prox -> u' = F - z, warm' (arap: z = (k U diag(1, 1,
                     +-1) V^T + w2 F) / (w2 + k), warm untouched);
                     rows = w2 D^T (F - 2u')
                   vertex phase: b = incidence sum of the rows (slot order);
                     anchor dual (0 where the anchor weight is 0) and RHS;
                     collisions in declaration order, dual and RHS;
                     rhs = M xbar + dt^2 b
                   global solve: x = A^-1 rhs by cg_iters Jacobi-PCG
                     iterations from x (pAp > 0, rz > 0 guards)
    epilogue       v = (x - x_pre) (1/dt)

State (`STATE`): x, v, anchor dual au, collision dual cu (n,3); tet dual u
(9,E), plane 3a+b holding F_{a,b}; warm start (3,E), unused by arap.
Planes (`PLANES`): idx (4,E) int32 corner vertices; cp (12,E) selector planes; w2, mu, lam, k
(E,); mass, invd = 1/diag(A), aw2 = summed anchor weight^2 (n,); ancz
(n,3) anchor targets; inc (n,S) int32 vertex -> 4e+k incidence, sentinel
4E after the real slots (`core.solver.assemble_transpose_incidence`); the
matrix (`MATRIX_PLANES`): dia (D,n) diagonals of A at
`BandedConfig.dia_offs`, or ell_idx (n,K) int32 and ell_vals (n,K) when
`BandedConfig.ell_width` = K > 0 (`core.solver.assemble_A_hat_ell`). No
padding anywhere.

`banded_rollout` runs the window's kernels (`csrc/banded_step.cu`: per
timestep a kick, per ADMM iteration an element kernel, a vertex kernel and
one cluster solve, `csrc/cluster_pcg.cuh`, then an end kernel) for CUDA
tensors and `banded_rollout_reference`, a step-by-step transcription of
the same math in the Pallas kernel's evaluation order (its solve the
cluster solve's: `core.solver.pcg_fixed_inv` with `cg_step.cluster_dot`,
the ELL matvec slot by slot), for CPU tensors. It never falls back from
one to the other. Both return a new state dict and leave their inputs
untouched. `BandedWindow` is a window on a state's own buffers, which a
stepper advances in place through one CUDA graph a window length
(`_graph.WindowGraphs`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...core.solver import dia_apply, pcg_fixed_inv
from . import _build
from .cg_dia import MAX_DIAGONALS
from .cg_ell import bandwidth, ell_apply_by_slot, slot_major
from .cg_step import cluster_dot, cluster_prepare
from .nh_local import _newton_hyper, _svd_columns, _warm_guard

STATE = ("x", "v", "u", "warm", "au", "cu")
PLANES = ("idx", "cp", "w2", "mu", "lam", "k", "mass", "invd", "aw2", "ancz",
          "inc")
MATRIX_PLANES = {"dia": ("dia",), "ell": ("ell_idx", "ell_vals")}
MAX_SHAPES = 16  # the kernels' collision table (csrc/banded_phases.cuh)
_SHAPE_KINDS = {"floor": 0, "sphere": 1, "cylinder": 2}
_SHAPE_ARITY = {"floor": 1, "sphere": 4, "cylinder": 3}
_MODELS = {"nh": 0, "stvk": 1, "arap": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class BandedConfig:
    """The static part of a rollout: what the JAX kernel bakes in.

    coll_shapes: ('floor', (y,)) | ('sphere', (cx, cy, cz, r)) |
    ('cylinder', (cx, cy, r)), projected in this order with the shared
    weight^2 coll_w2. ell_width: K of an ELL matrix, with dia_offs = ();
    0 for a dia matrix."""

    dia_offs: tuple
    model: str
    newton_iters: int
    cg_iters: int
    admm_iters: int
    dt: float
    gravity: tuple = (0.0, -9.8, 0.0)
    coll_shapes: tuple = ()
    coll_w2: float = 0.0
    ell_width: int = 0

    def __post_init__(self):
        if self.model not in _MODELS:
            raise ValueError(f"unknown banded model {self.model!r}")
        if self.ell_width:
            if self.ell_width < 0 or self.dia_offs:
                raise ValueError("an ELL matrix takes ell_width >= 1 and no "
                                 "dia_offs")
        elif not 1 <= len(self.dia_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.dia_offs)} diagonals; the kernel "
                             f"takes 1..{MAX_DIAGONALS}")
        if len(self.coll_shapes) > MAX_SHAPES:
            raise ValueError(f"{len(self.coll_shapes)} collision shapes; the "
                             f"kernel takes at most {MAX_SHAPES}")
        for kind, prm in self.coll_shapes:
            if _SHAPE_ARITY.get(kind) != len(prm):
                raise ValueError(f"bad collision shape {kind!r} {prm!r}")
        if min(self.newton_iters, self.cg_iters, self.admm_iters) < 0:
            raise ValueError("iteration counts must be >= 0")

    @property
    def matrix(self) -> str:
        """'ell' or 'dia': how A_hat is stored in the planes."""
        return "ell" if self.ell_width else "dia"

    def scalars(self) -> tuple:
        """dt, dt^2, 1/dt, dt g (3), coll_w2: formed in double, cast to the
        working type where they are used, as the JAX kernel bakes them."""
        dt = float(self.dt)
        return (dt, dt * dt, 1.0 / dt, *(dt * float(g) for g in self.gravity),
                float(self.coll_w2))

    def shape_table(self) -> tuple:
        """(kinds, rows of 5 doubles): floor (y); sphere (cx, cy, cz, r,
        r^2); cylinder (cx, cy, r, r^2); r^2 formed in double."""
        kinds, rows = [], []
        for kind, prm in self.coll_shapes:
            prm = [float(q) for q in prm]
            if kind != "floor":
                prm.append(prm[-1] * prm[-1])
            kinds.append(_SHAPE_KINDS[kind])
            rows.append(prm + [0.0] * (5 - len(prm)))
        return kinds, rows


def _project(z, cfg: BandedConfig):
    """Collision shapes in declaration order on candidate positions (n,3),
    the banded kernel's form (banded_step.py:478-503)."""
    kinds, rows = cfg.shape_table()
    if not kinds:
        return z
    tab = torch.tensor(rows, dtype=z.dtype, device=z.device)
    zx, zy, zz = z[:, 0], z[:, 1], z[:, 2]
    for q, kind in enumerate(kinds):
        pr = tab[q]
        if kind == _SHAPE_KINDS["floor"]:
            zy = torch.maximum(zy, pr[0])
        elif kind == _SHAPE_KINDS["sphere"]:
            dx, dy, dz = zx - pr[0], zy - pr[1], zz - pr[2]
            d2 = dx * dx + dy * dy + dz * dz
            inside = d2 < pr[4]
            sc = pr[3] * torch.rsqrt(torch.clamp_min(d2, 1e-30))
            zx = torch.where(inside, pr[0] + dx * sc, zx)
            zy = torch.where(inside, pr[1] + dy * sc, zy)
            zz = torch.where(inside, pr[2] + dz * sc, zz)
        else:  # cylinder, axis parallel to z
            dx, dy = zx - pr[0], zy - pr[1]
            d2 = dx * dx + dy * dy
            inside = d2 < pr[3]
            sc = pr[2] * torch.rsqrt(torch.clamp_min(d2, 1e-30))
            zx = torch.where(inside, pr[0] + dx * sc, zx)
            zy = torch.where(inside, pr[1] + dy * sc, zy)
    return torch.stack([zx, zy, zz], dim=1)


def _element_phase(x, u, warm, planes, cfg, eps):
    """Local step of every element: (u', warm', rows (12,E))."""
    cp = [planes["cp"][q] for q in range(12)]
    xg = x[planes["idx"].long()]  # (4,E,3)
    f = []
    for a in range(3):
        for b in range(3):
            acc = u[3 * a + b]
            for k in range(4):
                acc = acc + cp[4 * b + k] * xg[k, :, a]
            f.append(acc)
    U, V, s = _svd_columns(f, eps)
    w2, kp = planes["w2"], planes["k"]
    if cfg.model == "arap":
        # sigma -> (1, 1, +-1); z = (k P + w2 F) / (w2 + k); warm untouched
        one = torch.ones_like(s[0])
        sig = (one, one, torch.where(s[2] < 0, -one, one))
        mix = 1.0 / (w2 + torch.where(w2 + kp > 0, kp, 1.0))
    else:
        sig = _newton_hyper(s, _warm_guard(warm), planes["mu"], planes["lam"],
                            kp, cfg.newton_iters, cfg.model)
        warm = torch.stack(sig)
    up, zu = [], []
    for r in range(3):
        for c in range(3):
            z = (U[0][r] * sig[0] * V[0][c] + U[1][r] * sig[1] * V[1][c]
                 + U[2][r] * sig[2] * V[2][c])
            if cfg.model == "arap":
                z = (kp * z + w2 * f[3 * r + c]) * mix
            up.append(f[3 * r + c] - z)
            zu.append(w2 * (f[3 * r + c] - 2.0 * up[-1]))  # z - u' = F - 2u'
    rows = [cp[k] * zu[3 * j] + cp[4 + k] * zu[3 * j + 1]
            + cp[8 + k] * zu[3 * j + 2] for k in range(4) for j in range(3)]
    return torch.stack(up), warm, torch.stack(rows)


def _vertex_rhs(x, au, cu, rows, planes, cfg):
    """The vertex phase's RHS: b = the incidence sum of the element rows
    (slot order; row 4e+k, column a, and the zero sentinel row at 4E), the
    anchor dual (0 where the anchor weight is 0) and its RHS, the
    collision shapes in declaration order, their dual and RHS. Returns
    (b, au', cu')."""
    E = rows.shape[1]
    aw2, ancz = planes["aw2"][:, None], planes["ancz"]
    inc = planes["inc"].long()
    flat = rows.reshape(4, 3, E).permute(2, 0, 1).reshape(4 * E, 3)
    flat = torch.cat([flat, flat.new_zeros((1, 3))])
    b = torch.zeros_like(x)
    for j in range(inc.shape[1]):  # slot order
        b = b + flat[inc[:, j]]
    au = torch.where(aw2 > 0, au + (x - ancz), 0.0)
    b = b + aw2 * (ancz - au)
    if cfg.coll_shapes:
        cw2 = torch.tensor(cfg.scalars()[-1], dtype=x.dtype, device=x.device)
        z = _project(x + cu, cfg)
        cu = cu + (x - z)
        b = b + cw2 * (z - cu)
    return b, au, cu


def banded_rollout_reference(state, planes, cfg: BandedConfig, n_steps,
                             dot=cluster_dot):
    """Plain PyTorch version of the kernels: the same phases in the same
    order, one torch op at a time. `dot` sums the solve's dots (by
    default in the cluster solve's order; None: torch.sum)."""
    x, v, u, warm, au, cu = (state[k] for k in STATE)
    dtype, dev = x.dtype, x.device
    dt, dt2, inv_dt, *rest = (torch.tensor(q, dtype=dtype, device=dev)
                              for q in cfg.scalars())
    dtg = torch.stack(rest[:3])
    eps = torch.finfo(dtype).eps
    mass = planes["mass"][:, None]

    def A(y):
        if cfg.matrix == "ell":
            return ell_apply_by_slot(y, planes["ell_idx"], planes["ell_vals"])
        return dia_apply(y, cfg.dia_offs, planes["dia"])

    for _ in range(n_steps):
        v = v + torch.where(mass > 0, dtg, 0.0)
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        for _ in range(cfg.admm_iters):
            u, warm, rows = _element_phase(x, u, warm, planes, cfg, eps)
            b, au, cu = _vertex_rhs(x, au, cu, rows, planes, cfg)
            x = pcg_fixed_inv(A, mxbar + dt2 * b, x, planes["invd"],
                              cfg.cg_iters, dot)
        v = (x - x_pre) * inv_dt
    return {"x": x, "v": v, "u": u, "warm": warm, "au": au, "cu": cu}


def _check(state, planes, cfg):
    x = state["x"]
    n = x.shape[0] if x.dim() == 2 else -1
    E = state["u"].shape[-1]
    S = planes["inc"].shape[-1]
    want = {"x": (n, 3), "v": (n, 3), "au": (n, 3), "cu": (n, 3),
            "u": (9, E), "warm": (3, E), "idx": (4, E), "cp": (12, E),
            "w2": (E,), "mu": (E,), "lam": (E,), "k": (E,), "mass": (n,),
            "invd": (n,), "aw2": (n,), "ancz": (n, 3), "inc": (n, S)}
    if cfg.matrix == "ell":
        want["ell_idx"] = want["ell_vals"] = (n, cfg.ell_width)
    else:
        want["dia"] = (len(cfg.dia_offs), n)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, shape in want.items():
        t = state[name] if name in STATE else planes[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        dtype = (torch.int32 if name in ("idx", "inc", "ell_idx")
                 else x.dtype)
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {x.device}")
    return n, E, S


class BandedWindow:
    """The kernels of a rollout window on one state's own buffers, on a
    CUDA device: `launch(n_steps)` enqueues n_steps timesteps on the
    current stream and advances `state` in place. Holds the window's
    scratch, the matrix as the cluster solve reads it (ELL: slot-major)
    and the solve's set-up, done here, before any CUDA graph captures a
    launch."""

    def __init__(self, state, planes, cfg: BandedConfig):
        self.n, self.E, self.S = _check(state, planes, cfg)
        self.state, self.planes, self.cfg = state, planes, cfg
        x = state["x"]
        self.xpre, self.mxbar, self.rhs = (torch.empty_like(x)
                                           for _ in range(3))
        self.rows = x.new_empty((12, self.E))
        if cfg.matrix == "ell":
            self.matrix = (None, slot_major(planes["ell_idx"]),
                           slot_major(planes["ell_vals"]))
            self.reach = bandwidth(planes["ell_idx"])
        else:
            self.matrix = (planes["dia"], None, None)
            self.reach = max(abs(o) for o in cfg.dia_offs)
        self.scratch = cluster_prepare(x, self.n, self.reach,
                                       len(cfg.dia_offs), cfg.matrix == "ell")
        kinds, table = cfg.shape_table()
        ns = max(len(kinds), 1)
        # the host arrays the C entry reads at each call
        self._host = (
            (ctypes.c_int * max(len(cfg.dia_offs), 1))(*cfg.dia_offs),
            (ctypes.c_int * ns)(*kinds),
            (ctypes.c_double * (5 * ns))(*[q for row in table for q in row]),
            (ctypes.c_double * 7)(*cfg.scalars()))
        self._fn = getattr(_build.load_library(),
                           "banded_rollout_" + _SUFFIX[x.dtype])

    def ops(self, n_steps):
        """Launches of an n_steps window."""
        return n_steps * (2 + 3 * self.cfg.admm_iters)

    def launch(self, n_steps):
        cfg, x = self.cfg, self.state["x"]
        ptr = [None if t is None else t.data_ptr() for t in self.matrix]
        with torch.cuda.device(x.device):
            err = self._fn(
                *(self.state[k].data_ptr() for k in STATE),
                *(self.planes[k].data_ptr() for k in PLANES), *ptr,
                *(t.data_ptr() for t in (self.xpre, self.mxbar, self.rows,
                                         self.rhs)),
                None if self.scratch is None else self.scratch.data_ptr(),
                *(ctypes.addressof(a) for a in self._host),
                self.n, self.E, len(cfg.dia_offs), cfg.ell_width, self.reach,
                self.S, len(cfg.coll_shapes), _MODELS[cfg.model],
                cfg.newton_iters, cfg.cg_iters, cfg.admm_iters,
                int(n_steps), _build.stream_ptr(x))
        _build.check(err, "banded_rollout")


def banded_rollout(state, planes, cfg: BandedConfig, n_steps):
    """Advance `n_steps` timesteps; returns the new state dict."""
    _check(state, planes, cfg)
    x = state["x"]
    if x.device.type == "cpu":
        return banded_rollout_reference(state, planes, cfg, int(n_steps))
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    out = {k: state[k].clone() for k in STATE}
    window = BandedWindow(out, planes, cfg)
    window.launch(int(n_steps))
    banded_rollout.launches += 1
    banded_rollout.ops += window.ops(int(n_steps))
    return out


banded_rollout.launches = 0
banded_rollout.ops = 0
