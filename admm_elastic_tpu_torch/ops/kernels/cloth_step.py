"""Whole cloth timesteps as a window of launches: hand-written CUDA kernels
+ plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cloth_step.py` (`cloth_rollout`
/ `_cloth_call`) in its Jacobi-PCG and multigrid modes, with its in-kernel
residuals (`ClothConfig.collect`, summed in the order of
`residuals.py`). One call advances `n_steps` timesteps of a cloth with
LimitedTriangleStrain, an optional Bend, StaticAnchors, gravity and an
optional Wejchert-Haumann WindForce:

    prologue       v += dt g (where m > 0); per wind triangle: the drag
                     from x and the kicked v; per vertex: v += its wind
                     triangles' forces (incidence order); x_pre = x;
                     x += dt v; M xbar
    admm_iters x   element phase: per triangle F = u + sum_k cp x[idx_k],
                     strain-limited projection, u' = F - z; per hinge
                     F = u + x[a] - x[b] per row, alpha-weighted flat
                     projection, u' = F - z; each writes its RHS rows
                     w2 D^T (F - 2u') (= w2 D^T (z - u'))
                   vertex phase: b = incidence sum of the rows (group,
                     corner order); anchor dual (0 where the anchor weight
                     is 0) and RHS; rhs = M xbar + dt^2 b
                   global solve: x = A^-1 rhs by cg_iters PCG iterations
                     from x (pAp > 0, rz > 0 guards), preconditioned by
                     Jacobi or, with `ClothConfig.mg`, by the 2D geometric
                     multigrid V-cycle (`mg.py`)
    epilogue       v = (x - x_pre) (1/dt)

The JAX kernel works on (N,128)-lane planes with constant-offset static
shifts, a packed 16-row scratch, DMA-streamed group duals and A stored
as its diagonals at offsets >= 0 (each term mirrored). None of that is
kept: elements are read by index from per-element arrays, every sum into
a vertex is a fixed-order incidence sum, so the Pallas kernel's
group-by-group, corner-by-corner accumulation order is kept exactly, and
A is its diagonals at their signed offsets, as the general route's dia
solve takes them (its matvec adds them in offset order: round-off
against the Pallas kernel's mirrored order).

State (`STATE`): x, v, anchor dual au (n,3); triangle dual tu (6,Et),
plane 2a+b = F_{a,b}; hinge dual hu (9,Eh), plane 3r+j = row r, component
j. Planes (`PLANES`): tidx (3,Et), hidx (4,Eh), widx (3,Ew) int32 corner
vertices, elements sorted by group; tgrp (Et,), hgrp (Eh,) int32 group of
each element; ttab (Gt, TRI_TAB) and htab (Gb, BEND_TAB) the group
constants (formed in double on the host, as the Pallas kernel bakes them);
mass, invd = 1/diag(A), aw2 = anchor weight^2 (n,); ancz (n,3) anchor
targets; dia (D,n) the diagonals of A at `ClothConfig.dia_offs` (dia[d,i]
= A[i, i+off]); inc (n,S) int32 vertex -> RHS row slot, in (group,
corner) order, sentinel R = 3 Et + 4 Eh after the real slots, where
triangle slot k Et + t is corner k of triangle t and hinge slot 3 Et +
k Eh + h corner k of hinge h; winc (n,Sw) int32 vertex -> wind triangle
in (wind group, corner) order, sentinel Ew; with `ClothConfig.mg` the
multigrid's planes (`mg.PLANES`). No padding.

`cloth_rollout` runs the window's kernels (`csrc/cloth_step.cu`: per
timestep a wind kernel (with wind) and a kick, per ADMM iteration an
element kernel, a vertex kernel and one cluster solve,
`csrc/cluster_pcg.cuh` or its multigrid mode `csrc/mg_vcycle.cuh`, then an
end kernel) for CUDA tensors and `cloth_rollout_reference`, a step-by-step
transcription of the same math in the Pallas kernel's evaluation order
(its solve the cluster solve's: `core.solver.pcg_fixed_inv` with
`cg_step.cluster_dot`, or `mg.pcg_fixed_mg`), for CPU tensors. The
V-cycle's fine matvec is the full diagonals', where JAX's mirrors half of
them (cloth_step.py:481-492): round-off.
It never falls back from one to the other. Both return a new state dict
and leave their inputs untouched. `ClothWindow` is a window on a state's
own buffers, which a stepper advances in place through one CUDA graph a
window length (`_graph.WindowGraphs`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...core.solver import dia_apply, pcg_fixed_inv
from . import _build
from .cg_dia import MAX_DIAGONALS
from .cg_step import cluster_dot, cluster_prepare
from .banded_step import BandedWindow, _with_residuals
from .mg import MGConfig, check_planes, host_struct, mg_prepare, pcg_fixed_mg
from . import residuals
from .residuals import squares
from .tri_local import _tri_body

STATE = ("x", "v", "tu", "hu", "au")
PLANES = ("tidx", "tgrp", "ttab", "hidx", "hgrp", "htab", "widx", "mass",
          "invd", "aw2", "ancz", "dia", "inc", "winc")
_INT_PLANES = ("tidx", "tgrp", "hidx", "hgrp", "widx", "inc", "winc")
#: triangle group table columns: cp (6, plane 3b+k), w2, k, 1/(w2+k),
#: lmin, lmax
TRI_TAB = 11
#: bend group table columns: arow (3), arow/2 (3), 2/|arow|^2, w2, k,
#: 1/(w2+k)
BEND_TAB = 10
#: D rows of a hinge: (x0 - x2, x3 - x2, x1 - x2) (BendForce.cpp:75-131)
BEND_ROWS = ((0, 2), (3, 2), (1, 2))
WIND_ALPHA = 1000.0  # the drag's coupling strength (ExplicitForce.cpp:72)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class ClothConfig:
    """The static part of a rollout: what the JAX kernel bakes in. mg: the
    multigrid's offsets, whose V-cycle then preconditions the solve; None
    for Jacobi. collect: None, "primal" or "full", as BandedConfig's."""

    dia_offs: tuple
    cg_iters: int
    admm_iters: int
    dt: float
    gravity: tuple = (0.0, -9.8, 0.0)
    wind_dir: tuple = (0.0, 0.0, 0.0)
    limiting: bool = True
    mg: MGConfig | None = None
    collect: str | None = None

    def __post_init__(self):
        if self.collect not in residuals.MODES:
            raise ValueError(f"collect: one of {tuple(residuals.MODES)}")
        if not 1 <= len(self.dia_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.dia_offs)} diagonals; the kernel "
                             f"takes 1..{MAX_DIAGONALS}")
        if min(self.cg_iters, self.admm_iters) < 0:
            raise ValueError("iteration counts must be >= 0")

    def scalars(self) -> tuple:
        """dt, dt^2, 1/dt, dt g (3), the wind's -alpha 0.33 dt, 1/3, the
        wind direction (3): formed in double, cast to the working type
        where they are used, as the JAX kernel bakes them."""
        dt = float(self.dt)
        return (dt, dt * dt, 1.0 / dt, *(dt * float(g) for g in self.gravity),
                -WIND_ALPHA * 0.33 * dt, 1.0 / 3.0,
                *(float(w) for w in self.wind_dir))


def _slot_lists(inc, sentinel):
    """Per incidence column j: (the vertices with a real slot j, their
    slots); a vertex's real slots precede its sentinels."""
    out = []
    for j in range(inc.shape[1]):
        live = torch.nonzero(inc[:, j] < sentinel).squeeze(1)
        if live.numel() == 0:
            break
        out.append((live, inc[live, j]))
    return out


def _slot_sum(acc, rows, lists):
    """acc + the rows of each vertex's incidence slots, added one by one in
    slot order, as the kernel adds them."""
    for live, slots in lists:
        acc = acc.index_put((live,), acc[live] + rows[slots])
    return acc


def _wind_forces(x, vk, widx, sc):
    """Per wind triangle: the drag from positions x and kicked velocities
    vk, (Ew, 3) (cloth_step.py:159-204)."""
    wc, third, wd = sc["wind_c"], sc["third"], sc["wind_dir"]
    px = [x[widx[k]] for k in range(3)]
    vw = [vk[widx[k]] for k in range(3)]
    vm = [(vw[0][:, a] + vw[1][:, a] + vw[2][:, a]) * third for a in range(3)]
    e1 = [px[1][:, a] - px[0][:, a] for a in range(3)]
    e2 = [px[2][:, a] - px[0][:, a] for a in range(3)]
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / torch.where(nlen > 0, nlen, 1.0)
    nhat = [nx * inv, ny * inv, nz * inv]
    area = 0.5 * nlen
    v_n = (nhat[0] * (vm[0] - wd[0]) + nhat[1] * (vm[1] - wd[1])
           + nhat[2] * (vm[2] - wd[2]))
    scale = wc * area * v_n * torch.abs(v_n)
    return torch.stack([scale * nhat[a] for a in range(3)], dim=1)


def _tri_rows(cp, y):
    """Triangle rows (3 corners, Et, 3): cp[k] y[2j] + cp[3+k] y[2j+1], y
    already scaled by w2."""
    return torch.stack([
        torch.stack([cp[kk] * y[2 * j] + cp[3 + kk] * y[2 * j + 1]
                     for j in range(3)], dim=1)
        for kk in range(3)])


def _bend_rows(y):
    """Hinge rows (4 corners, Eh, 3) by the D^T columns: corner 0 += row 0,
    corner 1 += row 2, corner 2 -= all three rows, corner 3 += row 1."""
    return torch.stack([
        torch.stack([y[j] for j in range(3)], dim=1),
        torch.stack([y[6 + j] for j in range(3)], dim=1),
        torch.stack([-((y[j] + y[3 + j]) + y[6 + j]) for j in range(3)],
                    dim=1),
        torch.stack([y[3 + j] for j in range(3)], dim=1)])


def _tri_phase(x, tu, tidx, tc, limiting, collect=None):
    """Triangle local steps: (tu', rows (3 corners, Et, 3)), and with
    `collect` each triangle's piece w2 ||u' - u||^2 of the squared primal
    residual and ("full") its rows of w2 D^T z (else None)."""
    xg = [x[tidx[k]] for k in range(3)]
    cp, w2, k, denom, lmin, lmax = tc[:6], tc[6], tc[7], tc[8], tc[9], tc[10]
    f = []
    for a in range(3):
        for b in range(2):
            acc = tu[2 * a + b]
            for kk in range(3):
                acc = acc + cp[3 * b + kk] * xg[kk][:, a]
            f.append(acc)
    z = _tri_body(f, w2, k, denom, lmin, lmax, limiting)
    un = torch.stack([f[p] - z[p] for p in range(6)])
    zu = [w2 * (f[p] - 2.0 * un[p]) for p in range(6)]
    if collect is None:
        return un, _tri_rows(cp, zu)
    zrows = (_tri_rows(cp, [w2 * z[p] for p in range(6)])
             if collect == "full" else None)
    return un, _tri_rows(cp, zu), w2 * squares((un - tu).T), zrows


def _bend_phase(x, hu, hidx, hc, collect=None):
    """Hinge local steps (cloth_step.py:340-420): (hu', rows (4 corners,
    Eh, 3)), and with `collect` as `_tri_phase`."""
    xg = [x[hidx[k]] for k in range(4)]
    arow, half = hc[0:3], hc[3:6]
    inv_denom, w2, k, mix = hc[6], hc[7], hc[8], hc[9]
    F = [None] * 9
    for r, (ca, cb) in enumerate(BEND_ROWS):
        for j in range(3):
            F[3 * r + j] = (hu[3 * r + j] + xg[ca][:, j]) - xg[cb][:, j]
    un, zs = [None] * 9, [None] * 9
    for j in range(3):
        lam = inv_denom * (arow[0] * F[j] + arow[1] * F[3 + j]
                           + arow[2] * F[6 + j])
        for r in range(3):
            fp = F[3 * r + j]
            zs[3 * r + j] = (k * (fp - half[r] * lam) + w2 * fp) * mix
            un[3 * r + j] = fp - zs[3 * r + j]
    zu = [w2 * (F[p] - 2.0 * un[p]) for p in range(9)]
    un = torch.stack(un)
    if collect is None:
        return un, _bend_rows(zu)
    zrows = (_bend_rows([w2 * zs[p] for p in range(9)])
             if collect == "full" else None)
    return un, _bend_rows(zu), w2 * squares((un - hu).T), zrows


def _seed_rows(x_pre, tidx, tc, hidx, hc):
    """The dual residual's seed rows, w2 D^T D x_pre: the triangles'
    (3 Et, 3) and the hinges' (4 Eh, 3), as cloth_step.cu's seed_rows."""
    xg = [x_pre[tidx[k]] for k in range(3)]
    cp, w2 = tc[:6], tc[6]
    zz = []
    for a in range(3):
        for b in range(2):
            acc = cp[3 * b] * xg[0][:, a]
            acc = acc + cp[3 * b + 1] * xg[1][:, a]
            acc = acc + cp[3 * b + 2] * xg[2][:, a]
            zz.append(w2 * acc)
    rows = [_tri_rows(cp, zz).reshape(-1, 3)]
    if hidx.shape[1]:
        xh = [x_pre[hidx[k]] for k in range(4)]
        hz = [None] * 9
        for r, (ca, cb) in enumerate(BEND_ROWS):
            for j in range(3):
                hz[3 * r + j] = hc[7] * (xh[ca][:, j] - xh[cb][:, j])
        rows.append(_bend_rows(hz).reshape(-1, 3))
    return torch.cat(rows)


def seed_tz(x_pre, planes):
    """T z_prev of a step's first ADMM iteration, z_prev = D x_pre: the
    incidence sum of w2 D^T D x_pre + aw2 x_pre (n,3), as cloth_step.cu's
    seed kernels form it."""
    tidx, hidx = planes["tidx"].long(), planes["hidx"].long()
    tc = planes["ttab"][planes["tgrp"].long()].T
    hc = planes["htab"][planes["hgrp"].long()].T
    inc = _slot_lists(planes["inc"].long(),
                      3 * tidx.shape[1] + 4 * hidx.shape[1])
    return (_slot_sum(torch.zeros_like(x_pre),
                      _seed_rows(x_pre, tidx, tc, hidx, hc), inc)
            + planes["aw2"][:, None] * x_pre)


def cloth_rollout_reference(state, planes, cfg: ClothConfig, n_steps,
                            dot=cluster_dot):
    """Plain PyTorch version of the kernels: the same phases in the same
    order, one torch op at a time. `dot` sums the solve's dots (by
    default in the cluster solve's order; None: torch.sum). With
    cfg.collect the result also holds "primal" (and "dual"), as
    `banded_step.banded_rollout_reference`."""
    x, v, tu, hu, au = (state[k] for k in STATE)
    dtype, dev = x.dtype, x.device
    s = [torch.tensor(q, dtype=dtype, device=dev) for q in cfg.scalars()]
    dt, dt2, inv_dt = s[0], s[1], s[2]
    dtg = torch.stack(s[3:6])
    sc = {"wind_c": s[6], "third": s[7], "wind_dir": s[8:11]}
    mass = planes["mass"][:, None]
    aw2 = planes["aw2"][:, None]
    ancz = planes["ancz"]
    tidx, hidx, widx = (planes[k].long() for k in ("tidx", "hidx", "widx"))
    tc = planes["ttab"][planes["tgrp"].long()].T  # (TRI_TAB, Et)
    hc = planes["htab"][planes["hgrp"].long()].T  # (BEND_TAB, Eh)
    Et, Eh, Ew = tidx.shape[1], hidx.shape[1], widx.shape[1]
    inc = _slot_lists(planes["inc"].long(), 3 * Et + 4 * Eh)
    winc = _slot_lists(planes["winc"].long(), Ew)
    collect = cfg.collect
    res_p, res_d = [], []

    def A(y):
        return dia_apply(y, cfg.dia_offs, planes["dia"])

    for _ in range(n_steps):
        vk = v + torch.where(mass > 0, dtg, 0.0)
        if Ew:
            vk = _slot_sum(vk, _wind_forces(x, vk, widx, sc), winc)
        v = vk
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        if collect == "full":
            tz = seed_tz(x_pre, planes)
        step_p, step_d = [], []
        for _ in range(cfg.admm_iters):
            if collect is None:
                tu, trows = _tri_phase(x, tu, tidx, tc, cfg.limiting)
            else:
                tu, trows, pieces, tz_rows = _tri_phase(
                    x, tu, tidx, tc, cfg.limiting, collect)
                zrows = [tz_rows]
            rows = [trows.reshape(3 * Et, 3)]
            if Eh:
                if collect is None:
                    hu, hrows = _bend_phase(x, hu, hidx, hc)
                else:
                    hu, hrows, hp, hz_rows = _bend_phase(x, hu, hidx, hc,
                                                         collect)
                    pieces = torch.cat([pieces, hp])
                    zrows.append(hz_rows)
                rows.append(hrows.reshape(4 * Eh, 3))
            b = _slot_sum(torch.zeros_like(x), torch.cat(rows), inc)
            dlt = x - ancz
            au = torch.where(aw2 > 0, au + dlt, 0.0)
            b = b + aw2 * (ancz - au)
            if collect is not None:
                step_p.append(residuals.primal(pieces,
                                               aw2[:, 0] * squares(dlt)))
            if collect == "full":
                tz_new = _slot_sum(torch.zeros_like(x), torch.cat(
                    [r.reshape(-1, 3) for r in zrows]), inc) + aw2 * ancz
                step_d.append(residuals.dual(dt2, squares(tz_new - tz)))
                tz = tz_new
            if cfg.mg is None:
                x = pcg_fixed_inv(A, mxbar + dt2 * b, x, planes["invd"],
                                  cfg.cg_iters, dot)
            else:
                x = pcg_fixed_mg(A, mxbar + dt2 * b, x, planes, cfg.mg,
                                 cfg.cg_iters, dot)
        v = (x - x_pre) * inv_dt
        res_p.append(step_p)
        res_d.append(step_d)
    out = {"x": x, "v": v, "tu": tu, "hu": hu, "au": au}
    return _with_residuals(out, collect, res_p, res_d, n_steps, cfg, x)


def _check(state, planes, cfg):
    x = state["x"]
    n = x.shape[0] if x.dim() == 2 else -1
    Et = state["tu"].shape[-1]
    Eh = state["hu"].shape[-1]
    Ew = planes["widx"].shape[-1]
    Gt, Gb = planes["ttab"].shape[0], planes["htab"].shape[0]
    S, Sw = planes["inc"].shape[-1], planes["winc"].shape[-1]
    want = {"x": (n, 3), "v": (n, 3), "au": (n, 3), "tu": (6, Et),
            "hu": (9, Eh), "tidx": (3, Et), "tgrp": (Et,),
            "ttab": (Gt, TRI_TAB), "hidx": (4, Eh), "hgrp": (Eh,),
            "htab": (Gb, BEND_TAB), "widx": (3, Ew), "mass": (n,),
            "invd": (n,), "aw2": (n,), "ancz": (n, 3),
            "dia": (len(cfg.dia_offs), n), "inc": (n, S), "winc": (n, Sw)}
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if Et < 1 or min(S, Sw) < 1:
        raise ValueError("a cloth needs triangles and incidence columns")
    for name, shape in want.items():
        t = state[name] if name in STATE else planes[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        dtype = torch.int32 if name in _INT_PLANES else x.dtype
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {x.device}")
    if cfg.mg is not None:
        check_planes(planes, cfg.mg, n, x)
    return n, Et, Eh, Ew, S, Sw


class ClothWindow:
    """The kernels of a rollout window on one state's own buffers, on a
    CUDA device: `launch(n_steps)` enqueues n_steps timesteps on the
    current stream and advances `state` in place. Holds the window's
    scratch, the multigrid's C description and the solve's set-up, done
    here, before any CUDA graph captures a launch."""

    def __init__(self, state, planes, cfg: ClothConfig):
        (self.n, self.Et, self.Eh, self.Ew, self.S,
         self.Sw) = _check(state, planes, cfg)
        self.state, self.planes, self.cfg = state, planes, cfg
        x = state["x"]
        self.xpre, self.mxbar, self.rhs = (torch.empty_like(x)
                                           for _ in range(3))
        self.rows = x.new_empty((3, 3 * self.Et + 4 * self.Eh))
        self.wf = x.new_empty((3, self.Ew))
        # residual collection's scratch, and its results for each window
        # length (`residuals(n)`)
        eb, vb = (-(-m // residuals.THREADS)
                  for m in (self.Et + self.Eh, self.n))
        full = cfg.collect == "full"
        self.zrows = torch.empty_like(self.rows) if full else None
        self.tz = torch.empty_like(x) if full else None
        self.part = (x.new_empty((cfg.admm_iters, eb + vb))
                     if cfg.collect else None)
        self.dpart = x.new_empty((cfg.admm_iters, vb)) if full else None
        self._res = {}
        self.reach = max(abs(o) for o in cfg.dia_offs)
        if cfg.mg is None:
            self.mg = None
            self.scratch = cluster_prepare(x, self.n, self.reach,
                                           len(cfg.dia_offs))
        else:
            self.mg = host_struct(planes, cfg.mg)
            self.scratch = mg_prepare(x, self.n, len(cfg.dia_offs),
                                      planes["mg_rp2"].shape[0])
        scal = cfg.scalars()
        # the host arrays the C entry reads at each call
        self._host = ((ctypes.c_int * len(cfg.dia_offs))(*cfg.dia_offs),
                      (ctypes.c_double * len(scal))(*scal))
        self._fn = getattr(_build.load_library(),
                           "cloth_rollout_" + _SUFFIX[x.dtype])

    def ops(self, n_steps):
        """Launches of an n_steps window."""
        return n_steps * ((3 if self.Ew else 2) + 3 * self.cfg.admm_iters
                          + residuals.extra_ops(self.cfg.collect))

    residuals = BandedWindow.residuals

    def launch(self, n_steps):
        cfg, x = self.cfg, self.state["x"]
        res = self.residuals(n_steps)
        with torch.cuda.device(x.device):
            err = self._fn(
                *(self.state[k].data_ptr() for k in STATE),
                *(self.planes[k].data_ptr() for k in PLANES),
                *(t.data_ptr() for t in (self.xpre, self.mxbar, self.rows,
                                         self.wf, self.rhs)),
                *(None if t is None else t.data_ptr()
                  for t in (self.scratch, self.zrows, self.tz, self.part,
                            self.dpart)),
                *((None, None) if res is None
                  else (res[0].data_ptr(), res[1].data_ptr())),
                *(ctypes.addressof(a) for a in self._host),
                None if self.mg is None else ctypes.addressof(self.mg),
                self.n, self.Et, self.Eh, self.Ew, len(cfg.dia_offs),
                self.reach, self.S, self.Sw, int(bool(cfg.limiting)),
                cfg.cg_iters, cfg.admm_iters, int(n_steps),
                residuals.MODES[cfg.collect], _build.stream_ptr(x))
        _build.check(err, "cloth_rollout")


def cloth_rollout(state, planes, cfg: ClothConfig, n_steps):
    """Advance `n_steps` timesteps; returns the new state dict (with
    cfg.collect also its residuals, as `cloth_rollout_reference`)."""
    _check(state, planes, cfg)
    x = state["x"]
    if x.device.type == "cpu":
        return cloth_rollout_reference(state, planes, cfg, int(n_steps))
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    out = {k: state[k].clone() for k in STATE}
    window = ClothWindow(out, planes, cfg)
    window.launch(int(n_steps))
    cloth_rollout.launches += 1
    cloth_rollout.residual_launches += bool(cfg.collect)
    cloth_rollout.ops += window.ops(int(n_steps))
    return residuals.attach(out, cfg.collect, window.residuals(int(n_steps)))


cloth_rollout.launches = 0
#: the windows submitted in a residual mode (a count within `launches`)
cloth_rollout.residual_launches = 0
cloth_rollout.ops = 0
