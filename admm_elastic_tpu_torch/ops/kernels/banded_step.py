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
                   global solve: x = A^-1 rhs by cg_iters PCG iterations
                     from x (pAp > 0, rz > 0 guards), preconditioned by
                     Jacobi or, with `BandedConfig.mg`, by the geometric
                     multigrid V-cycle (dia, `mg.py`) or the algebraic one
                     (ELL, `uamg.py`)
    epilogue       v = (x - x_pre) (1/dt)

State (`STATE`): x, v, anchor dual au, collision dual cu (n,3); tet dual u
(9,E), plane 3a+b holding F_{a,b}; warm start (3,E), unused by arap.
Planes (`PLANES`): idx (4,E) int32 corner vertices; cp (12,E) selector planes; w2, mu, lam, k
(E,); mass, invd = 1/diag(A), aw2 = summed anchor weight^2 (n,); ancz
(n,3) anchor targets; inc (n,S) int32 vertex -> 4e+k incidence, sentinel
4E after the real slots (`core.solver.assemble_transpose_incidence`); the
matrix (`MATRIX_PLANES`): dia (D,n) diagonals of A at
`BandedConfig.dia_offs`, or ell_idx (n,K) int32 and ell_vals (n,K) when
`BandedConfig.ell_width` = K > 0 (`core.solver.assemble_A_hat_ell`);
with `BandedConfig.mg` the multigrid's planes (`uamg.PLANES`, the
geometric multigrid's in its compact level form). No padding anywhere.

`banded_rollout` runs the window's kernels (`csrc/banded_step.cu`: per
timestep a kick, per ADMM iteration an element kernel, a vertex kernel and
one cluster solve, `csrc/cluster_pcg.cuh` or its multigrid mode
`csrc/mg_vcycle.cuh`, then an end kernel) for CUDA tensors and
`banded_rollout_reference`, a step-by-step transcription of the same math
in the Pallas kernel's evaluation order (its solve the cluster solve's:
`core.solver.pcg_fixed_inv` with `cg_step.cluster_dot`, the ELL matvec
slot by slot, `uamg.pcg_fixed_uamg` under either multigrid), for CPU
tensors. It never falls back from
one to the other. Both return a new state dict and leave their inputs
untouched. `BandedWindow` is a window on a state's own buffers, which a
stepper advances in place through one CUDA graph a window length
(`_graph.WindowGraphs`).

Sweep mode (`BandedConfig.n_scen` = S, the Pallas kernel's n_scen;
`core/sweep.py`): S independent simulations of one mesh. The state and
the `SWEPT` planes gain a leading S axis (x (S,n,3), u (S,9,E), w2 (S,E),
invd (S,n), dia (S,D,n), ell_vals (S,n,K), ...); idx, cp, mass, ancz,
inc and ell_idx stay shared. The kernels take the scenario from their
grid (one cluster a scenario in the solve), the same launches a timestep
whatever S is; the twin runs the single twin on each scenario's slice.
Residuals come back (S, n_steps, admm_iters). Jacobi only: the multigrid
raises under a sweep, as the Pallas kernel does.
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
from . import mg, residuals, uamg
from .nh_local import _newton_hyper, _svd_columns, _warm_guard
from .residuals import squares

STATE = ("x", "v", "u", "warm", "au", "cu")
PLANES = ("idx", "cp", "w2", "mu", "lam", "k", "mass", "invd", "aw2", "ancz",
          "inc")
MATRIX_PLANES = {"dia": ("dia",), "ell": ("ell_idx", "ell_vals")}
#: the planes a sweep gives each scenario (a leading S axis); the rest are
#: shared
SWEPT = ("w2", "mu", "lam", "k", "invd", "aw2", "dia", "ell_vals")
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
    0 for a dia matrix. mg: the multigrid whose V-cycle then
    preconditions the solve, a `mg.MGConfig` (dia) or a
    `uamg.UAMGConfig` (ELL); None for Jacobi. collect: None,
    "primal" (each ADMM iteration's primal residual) or "full" (and its
    dual residual), the JAX kernel's collect / collect_dual. n_scen:
    None, or the S scenarios of a sweep (state and SWEPT planes with a
    leading S axis)."""

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
    mg: mg.MGConfig | uamg.UAMGConfig | None = None
    collect: str | None = None
    n_scen: int | None = None

    def __post_init__(self):
        if self.n_scen is not None:
            if self.n_scen < 1:
                raise ValueError("n_scen: a sweep runs at least 1 scenario")
            if self.mg is not None:  # banded_step.py:1018-1031
                raise NotImplementedError(
                    "in-kernel multigrid: non-sweep only (the JAX kernel "
                    "raises for a sweep under the multigrid too)")
        if self.collect not in residuals.MODES:
            raise ValueError(f"collect: one of {tuple(residuals.MODES)}")
        if self.model not in _MODELS:
            raise ValueError(f"unknown banded model {self.model!r}")
        if self.ell_width:
            if self.ell_width < 0 or self.dia_offs:
                raise ValueError("an ELL matrix takes ell_width >= 1 and no "
                                 "dia_offs")
        elif not 1 <= len(self.dia_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.dia_offs)} diagonals; the kernel "
                             f"takes 1..{MAX_DIAGONALS}")
        if isinstance(self.mg, mg.MGConfig) and self.ell_width:
            raise ValueError("the geometric multigrid takes a dia matrix")
        if isinstance(self.mg, uamg.UAMGConfig) and not self.ell_width:
            raise ValueError("the algebraic multigrid takes an ELL matrix")
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


def _rows(cp, y):
    """rows[3k+j] = sum_b cp[4b+k] y[3j+b] (y already scaled by w2), the
    terms in order of b: (12,E)."""
    return torch.stack([cp[k] * y[3 * j] + cp[4 + k] * y[3 * j + 1]
                        + cp[8 + k] * y[3 * j + 2]
                        for k in range(4) for j in range(3)])


def _element_phase(x, u, warm, planes, cfg, eps, collect=None):
    """Local step of every element: (u', warm', rows (12,E)), and with
    `collect` (the twin of banded_phases.cuh's element_step) each
    element's piece of the squared primal residual w2 ||u' - u||^2 (E,)
    and, "full", the rows of w2 D^T z (12,E) (else None)."""
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
    up, zu, zs = [], [], []
    for r in range(3):
        for c in range(3):
            z = (U[0][r] * sig[0] * V[0][c] + U[1][r] * sig[1] * V[1][c]
                 + U[2][r] * sig[2] * V[2][c])
            if cfg.model == "arap":
                z = (kp * z + w2 * f[3 * r + c]) * mix
            zs.append(z)
            up.append(f[3 * r + c] - z)
            zu.append(w2 * (f[3 * r + c] - 2.0 * up[-1]))  # z - u' = F - 2u'
    up_t = torch.stack(up)
    if collect is None:
        return up_t, warm, _rows(cp, zu)
    pieces = w2 * squares((up_t - u).T)  # D x - z = u' - u
    zrows = (_rows(cp, [w2 * z for z in zs]) if collect == "full"
             else None)
    return up_t, warm, _rows(cp, zu), pieces, zrows


def _seed_rows(x_pre, planes):
    """The dual residual's seed rows, w2 D^T D x_pre (12,E): the twin of
    banded_phases.cuh's seed_rows."""
    cp = [planes["cp"][q] for q in range(12)]
    xg = x_pre[planes["idx"].long()]
    w2 = planes["w2"]
    zz = []
    for a in range(3):
        for b in range(3):
            acc = cp[4 * b] * xg[0, :, a]
            for k in range(1, 4):
                acc = acc + cp[4 * b + k] * xg[k, :, a]
            zz.append(w2 * acc)
    return _rows(cp, zz)


def seed_tz(x_pre, planes, cfg):
    """T z_prev of a step's first ADMM iteration, z_prev = D x_pre
    (System.cpp:43): the incidence sum of w2 D^T D x_pre, + aw2 x_pre, +
    cw2 x_pre with collision shapes (n,3), as banded_phases.cuh's seed
    kernels form it."""
    tz = (_gather_rows(_seed_rows(x_pre, planes), planes["inc"].long())
          + planes["aw2"][:, None] * x_pre)
    if cfg.coll_shapes:
        tz = tz + torch.tensor(cfg.scalars()[-1], dtype=x_pre.dtype,
                               device=x_pre.device) * x_pre
    return tz


def _gather_rows(rows, inc):
    """The incidence sum of each vertex's element rows (12,E), in slot
    order (row 4e+k, column a; the zero sentinel row at 4E): (n,3)."""
    E = rows.shape[1]
    flat = rows.reshape(4, 3, E).permute(2, 0, 1).reshape(4 * E, 3)
    flat = torch.cat([flat, flat.new_zeros((1, 3))])
    out = flat.new_zeros((inc.shape[0], 3))
    for j in range(inc.shape[1]):  # slot order
        out = out + flat[inc[:, j]]
    return out


def _vertex_rhs(x, au, cu, rows, planes, cfg, collect=None, zrows=None,
                tz_prev=None):
    """The vertex phase's RHS: b = the incidence sum of the element rows
    (slot order; row 4e+k, column a, and the zero sentinel row at 4E), the
    anchor dual (0 where the anchor weight is 0) and its RHS, the
    collision shapes in declaration order, their dual and RHS. Returns
    (b, au', cu'), and with `collect` (the twin of banded_phases.cuh's
    vertex_rhs) also each vertex's piece of the squared primal residual
    (n,), then under "full" T z (n,3) and each vertex's piece of ||T z -
    T z_prev||^2 (n,) (else None, None)."""
    aw2, ancz = planes["aw2"][:, None], planes["ancz"]
    inc = planes["inc"].long()
    b = _gather_rows(rows, inc)
    dlt = x - ancz
    au = torch.where(aw2 > 0, au + dlt, 0.0)
    b = b + aw2 * (ancz - au)
    full = collect == "full"
    if full:
        tz = _gather_rows(zrows, inc) + aw2 * ancz
    if collect is not None:
        pieces = aw2[:, 0] * squares(dlt)
    if cfg.coll_shapes:
        cw2 = torch.tensor(cfg.scalars()[-1], dtype=x.dtype, device=x.device)
        z = _project(x + cu, cfg)
        cu = cu + (x - z)
        b = b + cw2 * (z - cu)
        if collect is not None:
            pieces = pieces + cw2 * squares(x - z)
        if full:
            tz = tz + cw2 * z
    if collect is None:
        return b, au, cu
    if not full:
        return b, au, cu, pieces, None, None
    return b, au, cu, pieces, tz, squares(tz - tz_prev)


def scenario_planes(planes, s):
    """Scenario s's planes of a sweep: its slice of the SWEPT planes, the
    shared ones as they are."""
    return {k: t[s] if k in SWEPT else t for k, t in planes.items()}


def banded_rollout_reference(state, planes, cfg: BandedConfig, n_steps,
                             dot=cluster_dot):
    """Plain PyTorch version of the kernels: the same phases in the same
    order, one torch op at a time. `dot` sums the solve's dots (by
    default in the cluster solve's order; None: torch.sum). With
    cfg.collect the result also holds "primal" (and, "full", "dual"):
    (n_steps, admm_iters) residuals, summed in the kernels' order
    (`residuals.py`). A sweep (cfg.n_scen) runs this on each scenario's
    slice and stacks the results."""
    if cfg.n_scen is not None:
        single = dataclasses.replace(cfg, n_scen=None)
        outs = [banded_rollout_reference({k: state[k][s] for k in STATE},
                                         scenario_planes(planes, s), single,
                                         n_steps, dot)
                for s in range(cfg.n_scen)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    x, v, u, warm, au, cu = (state[k] for k in STATE)
    dtype, dev = x.dtype, x.device
    dt, dt2, inv_dt, *rest = (torch.tensor(q, dtype=dtype, device=dev)
                              for q in cfg.scalars())
    dtg = torch.stack(rest[:3])
    eps = torch.finfo(dtype).eps
    mass = planes["mass"][:, None]
    collect = cfg.collect
    res_p, res_d = [], []

    def A(y):
        if cfg.matrix == "ell":
            return ell_apply_by_slot(y, planes["ell_idx"], planes["ell_vals"])
        return dia_apply(y, cfg.dia_offs, planes["dia"])

    for _ in range(n_steps):
        v = v + torch.where(mass > 0, dtg, 0.0)
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        if collect == "full":
            tz = seed_tz(x_pre, planes, cfg)
        step_p, step_d = [], []
        for _ in range(cfg.admm_iters):
            if collect is None:
                u, warm, rows = _element_phase(x, u, warm, planes, cfg, eps)
                b, au, cu = _vertex_rhs(x, au, cu, rows, planes, cfg)
            else:
                u, warm, rows, ep, zrows = _element_phase(
                    x, u, warm, planes, cfg, eps, collect)
                b, au, cu, vp, tz_new, dp = _vertex_rhs(
                    x, au, cu, rows, planes, cfg, collect, zrows,
                    tz if collect == "full" else None)
                step_p.append(residuals.primal(ep, vp))
                if collect == "full":
                    step_d.append(residuals.dual(dt2, dp))
                    tz = tz_new
            if cfg.mg is None:
                x = pcg_fixed_inv(A, mxbar + dt2 * b, x, planes["invd"],
                                  cfg.cg_iters, dot)
            else:
                x = uamg.pcg_fixed_uamg(A, mxbar + dt2 * b, x, planes,
                                        cfg.cg_iters, dot)
        v = (x - x_pre) * inv_dt
        res_p.append(step_p)
        res_d.append(step_d)
    out = {"x": x, "v": v, "u": u, "warm": warm, "au": au, "cu": cu}
    return _with_residuals(out, collect, res_p, res_d, n_steps, cfg, x)


def _with_residuals(out, collect, res_p, res_d, n_steps, cfg, x):
    """The twins' state dict with their residuals stacked (n_steps,
    admm_iters) under "primal" (and "dual")."""
    if collect is None:
        return out

    def stack(rs):
        return (torch.stack([torch.stack(r) for r in rs]) if cfg.admm_iters
                else x.new_zeros((n_steps, 0)))

    out["primal"] = stack(res_p)
    if collect == "full":
        out["dual"] = stack(res_d)
    return out


def _check(state, planes, cfg):
    x = state["x"]
    lead = () if cfg.n_scen is None else (cfg.n_scen,)
    n = x.shape[-2] if x.dim() == 2 + len(lead) else -1
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
    for name in (*STATE, *SWEPT):
        if name in want:
            want[name] = lead + want[name]
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
    if cfg.mg is not None and cfg.matrix == "ell":
        uamg.check_planes(planes, cfg.mg, x)
    elif cfg.mg is not None:
        mg.check_planes(planes, cfg.mg, n, x)
    return n, E, S


class BandedWindow:
    """The kernels of a rollout window on one state's own buffers, on a
    CUDA device: `launch(n_steps)` enqueues n_steps timesteps on the
    current stream and advances `state` in place. Holds the window's
    scratch (a sweep's for each scenario), the matrix as the cluster
    solve reads it (ELL: slot-major), the multigrid's C description
    (`uamg.UAMGHost`), and the solve's set-up, done here, before any
    CUDA graph captures a launch."""

    def __init__(self, state, planes, cfg: BandedConfig):
        self.n, self.E, self.S = _check(state, planes, cfg)
        self.state, self.planes, self.cfg = state, planes, cfg
        self.n_scen = cfg.n_scen or 1
        x = state["x"]
        lead = x.shape[:-2]  # a sweep's (S,)
        self.xpre, self.mxbar, self.rhs = (torch.empty_like(x)
                                           for _ in range(3))
        self.rows = x.new_empty(lead + (12, self.E))
        # residual collection's scratch, and its results for each window
        # length (`residuals(n)`)
        eb, vb = (-(-m // residuals.THREADS) for m in (self.E, self.n))
        full = cfg.collect == "full"
        self.zrows = x.new_empty(lead + (12, self.E)) if full else None
        self.tz = torch.empty_like(x) if full else None
        self.part = (x.new_empty(lead + (cfg.admm_iters, eb + vb))
                     if cfg.collect else None)
        self.dpart = (x.new_empty(lead + (cfg.admm_iters, vb)) if full
                      else None)
        self._res = {}
        if cfg.matrix == "ell":
            self.matrix = (None, slot_major(planes["ell_idx"]),
                           slot_major(planes["ell_vals"]))
            self.reach = bandwidth(planes["ell_idx"])
        else:
            self.matrix = (planes["dia"], None, None)
            self.reach = max(abs(o) for o in cfg.dia_offs)
        if cfg.mg is None:
            self.mg = None
            self.scratch = cluster_prepare(x, self.n, self.reach,
                                           len(cfg.dia_offs),
                                           cfg.matrix == "ell", self.n_scen)
        else:
            self.mg = uamg.host_struct(planes, cfg.mg)
            self.scratch = uamg.solve_prepare(x, self.n, len(cfg.dia_offs),
                                              self.mg)
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
        return n_steps * (2 + 3 * self.cfg.admm_iters
                          + residuals.extra_ops(self.cfg.collect))

    def residuals(self, n_steps):
        """The (2, n_steps, admm_iters) buffer ((2, S, n_steps,
        admm_iters) for a sweep) an n_steps window writes its primal ([0])
        and dual ([1]) residuals to; None without collect."""
        if not self.cfg.collect:
            return None
        if n_steps not in self._res:
            x = self.state["x"]  # (n,3), or a sweep's (S,n,3)
            # made at a graph's capture, no launch of its own
            self._res[n_steps] = x.new_empty(
                (2, *x.shape[:-2], n_steps, self.cfg.admm_iters))
        return self._res[n_steps]

    def launch(self, n_steps):
        cfg, x = self.cfg, self.state["x"]
        res = self.residuals(n_steps)
        ptr = [None if t is None else t.data_ptr() for t in self.matrix]
        with torch.cuda.device(x.device):
            err = self._fn(
                *(self.state[k].data_ptr() for k in STATE),
                *(self.planes[k].data_ptr() for k in PLANES), *ptr,
                *(t.data_ptr() for t in (self.xpre, self.mxbar, self.rows,
                                         self.rhs)),
                *(None if t is None else t.data_ptr()
                  for t in (self.scratch, self.zrows, self.tz, self.part,
                            self.dpart)),
                *((None, None) if res is None
                  else (res[0].data_ptr(), res[1].data_ptr())),
                *(ctypes.addressof(a) for a in self._host),
                None if self.mg is None else ctypes.addressof(self.mg),
                self.n, self.E, len(cfg.dia_offs), cfg.ell_width, self.reach,
                self.S, len(cfg.coll_shapes), _MODELS[cfg.model],
                cfg.newton_iters, cfg.cg_iters, cfg.admm_iters,
                int(n_steps), residuals.MODES[cfg.collect], self.n_scen,
                _build.stream_ptr(x))
        _build.check(err, "banded_rollout")


def banded_rollout(state, planes, cfg: BandedConfig, n_steps):
    """Advance `n_steps` timesteps; returns the new state dict (with
    cfg.collect also its residuals, as `banded_rollout_reference`)."""
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
    banded_rollout.residual_launches += bool(cfg.collect)
    banded_rollout.ops += window.ops(int(n_steps))
    return residuals.attach(out, cfg.collect, window.residuals(int(n_steps)))


banded_rollout.launches = 0
#: the windows submitted in a residual mode (a count within `launches`)
banded_rollout.residual_launches = 0
banded_rollout.ops = 0
