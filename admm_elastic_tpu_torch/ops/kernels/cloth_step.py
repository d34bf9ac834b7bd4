"""Whole cloth timesteps in one launch: hand-written CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cloth_step.py` (`cloth_rollout`
/ `_cloth_call`) in Jacobi-PCG mode, without the in-kernel multigrid and
residuals. One call advances `n_steps` timesteps of a cloth with
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
                     is 0) and RHS; r = M xbar + dt^2 b - A x; p = D^-1 r
                   cg_iters Jacobi-PCG iterations (pAp > 0, rz > 0 guards)
                     with the symmetric-dia matvec
    epilogue       v = (x - x_pre) (1/dt)

The JAX kernel works on (N,128)-lane planes with constant-offset static
shifts, a packed 16-row scratch and DMA-streamed group duals. None of that
is kept: elements are read by index from per-element arrays, and every
sum into a vertex is a fixed-order incidence sum, so the Pallas kernel's
group-by-group, corner-by-corner accumulation order is kept exactly.

State (`STATE`): x, v, anchor dual au (n,3); triangle dual tu (6,Et),
plane 2a+b = F_{a,b}; hinge dual hu (9,Eh), plane 3r+j = row r, component
j. Planes (`PLANES`): tidx (3,Et), hidx (4,Eh), widx (3,Ew) int32 corner
vertices, elements sorted by group; tgrp (Et,), hgrp (Eh,) int32 group of
each element; ttab (Gt, TRI_TAB) and htab (Gb, BEND_TAB) the group
constants (formed in double on the host, as the Pallas kernel bakes them);
mass, invd = 1/diag(A), aw2 = anchor weight^2 (n,); ancz (n,3) anchor
targets; dia (D,n) the diagonals of A at the non-negative offsets
`ClothConfig.dia_offs` (dia[d,i] = A[i, i+off]); inc (n,S) int32 vertex ->
RHS row slot, in (group, corner) order, sentinel R = 3 Et + 4 Eh after the
real slots, where triangle slot k Et + t is corner k of triangle t and
hinge slot 3 Et + k Eh + h corner k of hinge h; winc (n,Sw) int32 vertex
-> wind triangle in (wind group, corner) order, sentinel Ew. No padding.

`cloth_rollout` launches the cooperative kernel (`csrc/cloth_step.cu`, one
launch per call) for CUDA tensors and runs `cloth_rollout_reference`, a
step-by-step transcription of the same math in the Pallas kernel's
evaluation order, for CPU tensors. It never falls back from one to the
other. Both return a new state dict and leave their inputs untouched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .cg_dia import MAX_DIAGONALS
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
    """The static part of a rollout: what the JAX kernel bakes in."""

    dia_offs: tuple
    cg_iters: int
    admm_iters: int
    dt: float
    gravity: tuple = (0.0, -9.8, 0.0)
    wind_dir: tuple = (0.0, 0.0, 0.0)
    limiting: bool = True

    def __post_init__(self):
        if not 1 <= len(self.dia_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.dia_offs)} diagonals; the kernel "
                             f"takes 1..{MAX_DIAGONALS}")
        if min(self.dia_offs) < 0:
            raise ValueError("the symmetric dia matvec stores offsets >= 0")
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


def sym_dia_apply(y, offs, dia):
    """A y for the symmetric A stored at offsets >= 0 (dia[d,i] = A[i,
    i+off]), in the Pallas kernel's order: per diagonal, the upper term,
    then the mirrored lower term."""
    n = y.shape[0]
    out = torch.zeros_like(y)
    for d, off in enumerate(offs):
        w = dia[d][:, None]
        if off == 0:
            out = out + w * y
        elif off < n:
            upper = out[: n - off] + w[: n - off] * y[off:]
            out = torch.cat([upper, out[n - off:]])
            lower = out[off:] + w[: n - off] * y[: n - off]
            out = torch.cat([out[:off], lower])
    return out


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


def _tri_phase(x, tu, tidx, tc, limiting):
    """Triangle local steps: (tu', rows (3 corners, Et, 3))."""
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
    un = [f[p] - z[p] for p in range(6)]
    zu = [w2 * (f[p] - 2.0 * un[p]) for p in range(6)]
    rows = torch.stack([
        torch.stack([cp[kk] * zu[2 * j] + cp[3 + kk] * zu[2 * j + 1]
                     for j in range(3)], dim=1)
        for kk in range(3)])
    return torch.stack(un), rows


def _bend_phase(x, hu, hidx, hc):
    """Hinge local steps (cloth_step.py:340-420): (hu', rows (4 corners,
    Eh, 3))."""
    xg = [x[hidx[k]] for k in range(4)]
    arow, half = hc[0:3], hc[3:6]
    inv_denom, w2, k, mix = hc[6], hc[7], hc[8], hc[9]
    F = [None] * 9
    for r, (ca, cb) in enumerate(BEND_ROWS):
        for j in range(3):
            F[3 * r + j] = (hu[3 * r + j] + xg[ca][:, j]) - xg[cb][:, j]
    un = [None] * 9
    for j in range(3):
        lam = inv_denom * (arow[0] * F[j] + arow[1] * F[3 + j]
                           + arow[2] * F[6 + j])
        for r in range(3):
            fp = F[3 * r + j]
            z = (k * (fp - half[r] * lam) + w2 * fp) * mix
            un[3 * r + j] = fp - z
    zu = [w2 * (F[p] - 2.0 * un[p]) for p in range(9)]
    # D^T columns: corner 0 += row 0, corner 1 += row 2, corner 2 -= all
    # three rows, corner 3 += row 1
    rows = torch.stack([
        torch.stack([zu[j] for j in range(3)], dim=1),
        torch.stack([zu[6 + j] for j in range(3)], dim=1),
        torch.stack([-((zu[j] + zu[3 + j]) + zu[6 + j]) for j in range(3)],
                    dim=1),
        torch.stack([zu[3 + j] for j in range(3)], dim=1)])
    return torch.stack(un), rows


def cloth_rollout_reference(state, planes, cfg: ClothConfig, n_steps):
    """Plain PyTorch version of the kernel: the same phases in the same
    order, one torch op at a time."""
    x, v, tu, hu, au = (state[k] for k in STATE)
    dtype, dev = x.dtype, x.device
    s = [torch.tensor(q, dtype=dtype, device=dev) for q in cfg.scalars()]
    dt, dt2, inv_dt = s[0], s[1], s[2]
    dtg = torch.stack(s[3:6])
    sc = {"wind_c": s[6], "third": s[7], "wind_dir": s[8:11]}
    mass = planes["mass"][:, None]
    invd = planes["invd"][:, None]
    aw2 = planes["aw2"][:, None]
    ancz = planes["ancz"]
    tidx, hidx, widx = (planes[k].long() for k in ("tidx", "hidx", "widx"))
    tc = planes["ttab"][planes["tgrp"].long()].T  # (TRI_TAB, Et)
    hc = planes["htab"][planes["hgrp"].long()].T  # (BEND_TAB, Eh)
    Et, Eh, Ew = tidx.shape[1], hidx.shape[1], widx.shape[1]
    inc = _slot_lists(planes["inc"].long(), 3 * Et + 4 * Eh)
    winc = _slot_lists(planes["winc"].long(), Ew)

    def A(y):
        return sym_dia_apply(y, cfg.dia_offs, planes["dia"])

    for _ in range(n_steps):
        vk = v + torch.where(mass > 0, dtg, 0.0)
        if Ew:
            vk = _slot_sum(vk, _wind_forces(x, vk, widx, sc), winc)
        v = vk
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        for _ in range(cfg.admm_iters):
            tu, trows = _tri_phase(x, tu, tidx, tc, cfg.limiting)
            rows = [trows.reshape(3 * Et, 3)]
            if Eh:
                hu, hrows = _bend_phase(x, hu, hidx, hc)
                rows.append(hrows.reshape(4 * Eh, 3))
            b = _slot_sum(torch.zeros_like(x), torch.cat(rows), inc)
            au = torch.where(aw2 > 0, au + (x - ancz), 0.0)
            b = b + aw2 * (ancz - au)
            r = mxbar + dt2 * b - A(x)
            p = invd * r
            rz = torch.sum(r * p)
            for _ in range(cfg.cg_iters):
                Ap = A(p)
                pAp = torch.sum(p * Ap)
                alpha = rz / torch.where(pAp > 0, pAp, 1.0)
                x = x + alpha * p
                r = r - alpha * Ap
                rz_new = torch.sum(r * invd * r)
                beta = rz_new / torch.where(rz > 0, rz, 1.0)
                p = invd * r + beta * p
                rz = rz_new
        v = (x - x_pre) * inv_dt
    return {"x": x, "v": v, "tu": tu, "hu": hu, "au": au}


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
    return n, Et, Eh, Ew, S, Sw


@functools.cache
def _grid_blocks(suffix, device_index) -> int:
    """Blocks of the cooperative grid: SMs x resident blocks per SM."""
    with torch.cuda.device(device_index):
        blocks = getattr(_build.load_library(), "cloth_rollout_grid_" + suffix)()
    if blocks <= 0:
        _build.check(-blocks, "cloth_rollout grid size")
    return blocks


def cloth_rollout(state, planes, cfg: ClothConfig, n_steps):
    """Advance `n_steps` timesteps; returns the new state dict."""
    n, Et, Eh, Ew, S, Sw = _check(state, planes, cfg)
    x = state["x"]
    if x.device.type == "cpu":
        return cloth_rollout_reference(state, planes, cfg, int(n_steps))
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    suffix = _SUFFIX[x.dtype]
    blocks = _grid_blocks(suffix, x.device.index)
    out = {k: state[k].clone() for k in STATE}
    xpre, mxbar, r, p, ap = (torch.empty_like(x) for _ in range(5))
    rows = x.new_empty((3, 3 * Et + 4 * Eh))
    wf = x.new_empty((3, Ew))
    part = x.new_empty(2 * blocks)
    offs = (ctypes.c_int * len(cfg.dia_offs))(*cfg.dia_offs)
    scal = cfg.scalars()
    c_scal = (ctypes.c_double * len(scal))(*scal)
    fn = getattr(_build.load_library(), "cloth_rollout_" + suffix)
    with torch.cuda.device(x.device):
        err = fn(*(out[k].data_ptr() for k in STATE),
                 *(planes[k].data_ptr() for k in PLANES),
                 *(t.data_ptr() for t in (xpre, mxbar, rows, wf, r, p, ap,
                                          part)),
                 ctypes.addressof(offs), ctypes.addressof(c_scal),
                 n, Et, Eh, Ew, len(cfg.dia_offs), S, Sw,
                 int(bool(cfg.limiting)), cfg.cg_iters, cfg.admm_iters,
                 int(n_steps), part.numel(), _build.stream_ptr(x))
    _build.check(err, "cloth_rollout")
    cloth_rollout.launches += 1
    return out


cloth_rollout.launches = 0
