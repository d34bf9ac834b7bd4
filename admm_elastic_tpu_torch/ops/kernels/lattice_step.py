"""Whole ADMM timesteps on a uniform beam lattice in one launch: hand-written
CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/lattice_step.py`
(`lattice_rollout` / `_lattice_call`, kernel `_make_lattice_kernel`). One
call advances `n_steps` timesteps of a `make_beam_tets(nx, ny, nz, size)`
beam, in the lattice's canonical numbering, with one tet force (NeoHookean,
StVK or ARAP, uniform material), StaticAnchors of one weight, an optional
Floor and a gravity kick:

    prologue       v += dt g (where m > 0); x_pre = x; x += dt v; M xbar
    admm_iters x   element phase, per tet of a valid cell: its group g =
                     5 parity + slot, F = u + sum_k cp_g[b,k] x[base +
                     off(corner_k)] (zero coefficients skipped);
                     nh/stvk: SVD -> warm-start guards -> Newton prox ->
                     z = U sigma V^T; arap: z = (U diag(1,1,+-1) V^T + F)/2;
                     u' = F - z; rows = w2_g D_g^T (F - 2u')
                   vertex phase: b = the vertex's rows in group-major,
                     corner-minor order (the Pallas kernel's accumulation);
                     anchor dual u' = (u + x) - z_anchor where the anchor
                     weight is > 0, else 0, b += w2 (z_anchor - u'); the
                     floor's z = max(x + u, y_floor), u' = (u + x) - z,
                     b += w2_floor (z - u'); rhs = M xbar + dt^2 b
                   global solve: x = A^-1 rhs by cg_iters Jacobi-PCG
                     iterations from x (pAp > 0, rz > 0 guards)
    epilogue       v = (x - x_pre) (1/dt)

Tets are numbered as `make_beam_tets` numbers them: tet e = 5 c + slot of
valid cell c = (i ny + j) nz + k; the vertex of cell corner (di, dj, dk)
is (i + di) gy gz + (j + dj) gz + (k + dk). The ten groups' selector
coefficients and weights are `LatticeConfig.cp` and `.w2`.

State (`STATE`): x, v, anchor dual au, floor dual cu (n,3); tet dual u
(9,E), plane 3a+b holding F_{a,b}; warm start (3,E) (untouched by arap).
Planes (`PLANES`): mass, invd = 1/diag(A), aw2 = anchor weight^2 (n,);
ancz (n,3) anchor targets (the rest positions); dia (D,n) the diagonals of
A at `LatticeConfig.dia_offs`.

The Pallas kernel's (3,N) lane planes with 128-lane padding, its (G,16,N)
and (G,8,N) HBM dual tiles, the DMA streaming of u/warm and the lane
shifts are TPU layout and are not carried over. Nor are its phantom cells
(the i = nx, j = ny, k = nz faces, which it computes and masks out of b):
only valid cells are stepped.

`lattice_rollout` runs the window's kernels (`csrc/lattice_step.cu`: per
timestep a kick, per ADMM iteration an element kernel, a vertex kernel and
one cluster solve on the diagonals, `csrc/cg_dia.cu`, then an end kernel)
for CUDA tensors and `lattice_rollout_reference`, a step-by-step
transcription of the same math in the kernels' order of arithmetic (its
solve the cluster solve's: `core.solver.pcg_fixed_inv` with
`cg_step.cluster_dot`), for CPU tensors. It never falls back from one to
the other. Both return a new state dict and leave their inputs untouched.
`LatticeWindow` is a window on a state's own buffers, which a stepper
advances in place through one CUDA graph a window length
(`_graph.WindowGraphs`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...core.solver import dia_apply, pcg_fixed_inv
from . import _build
from .cg_dia import MAX_DIAGONALS
from .cg_step import cluster_dot, cluster_prepare
from .nh_local import _newton_hyper, _svd_columns, _warm_guard

STATE = ("x", "v", "u", "warm", "au", "cu")
PLANES = ("mass", "invd", "aw2", "ancz", "dia")
_MODELS = {"nh": 0, "stvk": 1, "arap": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# the 5-tet decompositions of an even and an odd cell (make_beam_tets) and
# the (di, dj, dk) of each cell corner
_EVEN = ((0, 1, 2, 5), (0, 2, 3, 7), (0, 5, 7, 4), (2, 7, 5, 6), (0, 2, 5, 7))
_ODD = ((1, 3, 0, 4), (1, 6, 2, 3), (1, 4, 6, 5), (3, 6, 4, 7), (1, 3, 4, 6))
_CORNER_DIJK = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
#: group g = 5 parity + slot -> its four cell corners
GROUP_CORNERS = _EVEN + _ODD
N_GROUPS = len(GROUP_CORNERS)


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    """The static part of a rollout: what the JAX kernel bakes in.

    dims: (nx, ny, nz) cells. cp: per group, its 12 selector coefficients,
    entry 4b+k = cp[b,k] = B[k,b] of the group's tet. w2: per group,
    kprox * volume. mu, lam, kprox: the uniform material (kprox = min(mu,
    lam), or the stiffness for arap). floor_y: the Floor's height, or None
    for no floor; floor_w2 its weight^2."""

    dims: tuple
    cp: tuple
    w2: tuple
    dia_offs: tuple
    model: str
    mu: float
    lam: float
    kprox: float
    newton_iters: int
    cg_iters: int
    admm_iters: int
    dt: float
    gravity: tuple = (0.0, -9.8, 0.0)
    floor_y: float | None = None
    floor_w2: float = 0.0

    def __post_init__(self):
        if self.model not in _MODELS:
            raise ValueError(f"unknown lattice model {self.model!r}")
        if len(self.dims) != 3 or min(self.dims) < 1:
            raise ValueError(f"bad lattice dims {self.dims!r}")
        if len(self.cp) != N_GROUPS or any(len(c) != 12 for c in self.cp):
            raise ValueError("cp takes 12 coefficients for each of 10 groups")
        if len(self.w2) != N_GROUPS:
            raise ValueError("w2 takes one weight per group")
        if not 1 <= len(self.dia_offs) <= MAX_DIAGONALS:
            raise ValueError(f"{len(self.dia_offs)} diagonals; the kernel "
                             f"takes 1..{MAX_DIAGONALS}")
        if min(self.newton_iters, self.cg_iters, self.admm_iters) < 0:
            raise ValueError("iteration counts must be >= 0")

    @property
    def n_nodes(self) -> int:
        nx, ny, nz = self.dims
        return (nx + 1) * (ny + 1) * (nz + 1)

    @property
    def n_elements(self) -> int:
        nx, ny, nz = self.dims
        return 5 * nx * ny * nz

    def scalars(self) -> tuple:
        """dt, dt^2, 1/dt, dt g (3), floor y, floor w2, mu, lam, kprox:
        formed in double, cast to the working type where they are used, as
        the JAX kernel bakes them."""
        dt = float(self.dt)
        return (dt, dt * dt, 1.0 / dt, *(dt * float(g) for g in self.gravity),
                0.0 if self.floor_y is None else float(self.floor_y),
                float(self.floor_w2), float(self.mu), float(self.lam),
                float(self.kprox))


@functools.cache
def lattice_tables(dims):
    """Host tables of a lattice (numpy int64): idx (4,E) tet corner
    vertices, grp (E,) the group of each tet, inc (n,S) vertex -> RHS row
    4e+k in group-major, corner-minor order, padded with the sentinel 4E."""
    nx, ny, nz = dims
    gy, gz = ny + 1, nz + 1
    n = (nx + 1) * gy * gz
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    base = (I * gy + J) * gz + K
    parity = (I + J + K) % 2
    E = 5 * len(base)
    slot = np.arange(E) % 5
    cell = np.arange(E) // 5
    grp = 5 * parity[cell] + slot
    off = np.asarray([di * gy * gz + dj * gz + dk
                      for di, dj, dk in _CORNER_DIJK])
    corners = np.asarray(GROUP_CORNERS)  # (10, 4)
    idx = (base[cell][None, :] + off[corners[grp]].T)  # (4, E)
    # the incidence: each (vertex, key 4g + k, row 4e + k), sorted by vertex
    # then key
    vert = idx.T.ravel()
    key = (4 * grp[:, None] + np.arange(4)[None, :]).ravel()
    row = np.arange(4 * E)
    order = np.lexsort((key, vert))
    counts = np.bincount(vert, minlength=n)
    S = int(counts.max())
    inc = np.full((n, S), 4 * E, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(4 * E) - np.repeat(start, counts)
    inc[vert[order], pos] = row[order]
    return idx, grp, inc


def _element_phase(x, u, warm, cfg, idx, members):
    """Local step of every tet: (u', warm', rows (12,E)). members[g]: the
    tets of group g. A group's coefficients are constants, and a zero one
    is skipped, as in the kernel (and the Pallas kernel's static loops)."""
    dtype, dev = x.dtype, x.device
    E = u.shape[1]
    cp = [[torch.tensor(q, dtype=dtype, device=dev) for q in g]
          for g in cfg.cp]
    xg = x[idx]  # (4,E,3)
    F = u.clone()
    for g, el in enumerate(members):
        fg = [u[q, el] for q in range(9)]
        for k in range(4):
            for a in range(3):
                for b in range(3):
                    if cfg.cp[g][4 * b + k] != 0:
                        fg[3 * a + b] = (fg[3 * a + b]
                                         + cp[g][4 * b + k] * xg[k, el, a])
        F[:, el] = torch.stack(fg)
    f = list(F)
    eps = torch.finfo(dtype).eps
    U, V, s = _svd_columns(f, eps)
    if cfg.model == "arap":
        one = torch.ones_like(s[0])
        sig = (one, one, torch.where(s[2] < 0, -one, one))
    else:
        full = functools.partial(torch.full_like, f[0])
        sig = _newton_hyper(s, _warm_guard(warm), full(cfg.mu), full(cfg.lam),
                            full(cfg.kprox), cfg.newton_iters, cfg.model)
        warm = torch.stack(sig)
    w2 = torch.empty(E, dtype=dtype, device=dev)
    for g, el in enumerate(members):
        w2[el] = cfg.w2[g]
    up, zu = [], []
    for r in range(3):
        for c in range(3):
            proj = (U[0][r] * sig[0] * V[0][c] + U[1][r] * sig[1] * V[1][c]
                    + U[2][r] * sig[2] * V[2][c])
            z = 0.5 * (proj + f[3 * r + c]) if cfg.model == "arap" else proj
            up.append(f[3 * r + c] - z)
            zu.append(w2 * (f[3 * r + c] - 2.0 * up[-1]))  # z - u' = F - 2u'
    rows = torch.empty((12, E), dtype=dtype, device=dev)
    for g, el in enumerate(members):
        zg = [t[el] for t in zu]
        for k in range(4):
            for j in range(3):
                acc = None
                for r in range(3):
                    if cfg.cp[g][4 * r + k] != 0:
                        t = cp[g][4 * r + k] * zg[3 * j + r]
                        acc = t if acc is None else acc + t
                rows[3 * k + j, el] = acc
    return torch.stack(up), warm, rows


def lattice_rollout_reference(state, planes, cfg: LatticeConfig, n_steps,
                              dot=cluster_dot):
    """Plain PyTorch version of the kernels: the same phases in the same
    order, one torch op at a time. `dot` sums the solve's dots (by
    default in the cluster solve's order; None: torch.sum)."""
    x, v, u, warm, au, cu = (state[k] for k in STATE)
    dtype, dev = x.dtype, x.device
    (dt, dt2, inv_dt, g0, g1, g2, floor_y, floor_w2,
     *_) = (torch.tensor(q, dtype=dtype, device=dev) for q in cfg.scalars())
    dtg = torch.stack([g0, g1, g2])
    mass = planes["mass"][:, None]
    aw2 = planes["aw2"][:, None]
    ancz = planes["ancz"]
    idx, grp, inc = lattice_tables(tuple(cfg.dims))
    members = [torch.as_tensor(np.flatnonzero(grp == g), device=dev)
               for g in range(N_GROUPS)]
    idx, inc = torch.as_tensor(idx, device=dev), torch.as_tensor(inc,
                                                                 device=dev)
    E = u.shape[1]

    def A(y):
        return dia_apply(y, cfg.dia_offs, planes["dia"])

    for _ in range(n_steps):
        v = v + torch.where(mass > 0, dtg, 0.0)
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        for _ in range(cfg.admm_iters):
            u, warm, rows = _element_phase(x, u, warm, cfg, idx, members)
            # row 4e+k, column j; the zero row at 4E is the sentinel's
            flat = rows.reshape(4, 3, E).permute(2, 0, 1).reshape(4 * E, 3)
            flat = torch.cat([flat, flat.new_zeros((1, 3))])
            b = torch.zeros_like(x)
            for j in range(inc.shape[1]):  # group-major, corner-minor
                b = b + flat[inc[:, j]]
            au = torch.where(aw2 > 0, (au + x) - ancz, 0.0)
            b = b + aw2 * (ancz - au)
            if cfg.floor_y is not None:
                z = x + cu
                z = torch.stack([z[:, 0], torch.maximum(z[:, 1], floor_y),
                                 z[:, 2]], dim=1)
                cu = (cu + x) - z
                b = b + floor_w2 * (z - cu)
            x = pcg_fixed_inv(A, mxbar + dt2 * b, x, planes["invd"],
                              cfg.cg_iters, dot)
        v = (x - x_pre) * inv_dt
    return {"x": x, "v": v, "u": u, "warm": warm, "au": au, "cu": cu}


def _check(state, planes, cfg):
    x = state["x"]
    n, E = cfg.n_nodes, cfg.n_elements
    want = {"x": (n, 3), "v": (n, 3), "au": (n, 3), "cu": (n, 3),
            "u": (9, E), "warm": (3, E), "mass": (n,), "invd": (n,),
            "aw2": (n,), "ancz": (n, 3), "dia": (len(cfg.dia_offs), n)}
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, shape in want.items():
        t = state[name] if name in STATE else planes[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{x.dtype} on {x.device}")
    return n, E


class LatticeWindow:
    """The kernels of a rollout window on one state's own buffers, on a
    CUDA device: `launch(n_steps)` enqueues n_steps timesteps on the
    current stream and advances `state` in place. Holds the window's
    scratch and the cluster solve's set-up, done here, before any CUDA
    graph captures a launch."""

    def __init__(self, state, planes, cfg: LatticeConfig):
        self.n, self.E = _check(state, planes, cfg)
        self.state, self.planes, self.cfg = state, planes, cfg
        x = state["x"]
        self.xpre, self.mxbar, self.rhs = (torch.empty_like(x)
                                           for _ in range(3))
        self.rows = x.new_empty((12, self.E))
        self.reach = max(abs(o) for o in cfg.dia_offs)
        self.scratch = cluster_prepare(x, self.n, self.reach,
                                       len(cfg.dia_offs))
        scal = cfg.scalars()
        # the host arrays the C entry reads at each call
        self._host = (
            (ctypes.c_int * len(cfg.dia_offs))(*cfg.dia_offs),
            (ctypes.c_double * (12 * N_GROUPS))(*(q for g in cfg.cp
                                                  for q in g)),
            (ctypes.c_double * N_GROUPS)(*cfg.w2),
            (ctypes.c_int * (4 * N_GROUPS))(*(c for g in GROUP_CORNERS
                                              for c in g)),
            (ctypes.c_double * len(scal))(*scal))
        self._fn = getattr(_build.load_library(),
                           "lattice_rollout_" + _SUFFIX[x.dtype])

    def ops(self, n_steps):
        """Launches of an n_steps window."""
        return n_steps * (2 + 3 * self.cfg.admm_iters)

    def launch(self, n_steps):
        cfg, x = self.cfg, self.state["x"]
        with torch.cuda.device(x.device):
            err = self._fn(
                *(self.state[k].data_ptr() for k in STATE),
                *(self.planes[k].data_ptr() for k in PLANES),
                *(t.data_ptr() for t in (self.xpre, self.mxbar, self.rows,
                                         self.rhs)),
                None if self.scratch is None else self.scratch.data_ptr(),
                *(ctypes.addressof(a) for a in self._host),
                *cfg.dims, len(cfg.dia_offs), self.reach, _MODELS[cfg.model],
                int(cfg.floor_y is not None), cfg.newton_iters,
                cfg.cg_iters, cfg.admm_iters, int(n_steps),
                _build.stream_ptr(x))
        _build.check(err, "lattice_rollout")


def lattice_rollout(state, planes, cfg: LatticeConfig, n_steps):
    """Advance `n_steps` timesteps; returns the new state dict."""
    _check(state, planes, cfg)
    x = state["x"]
    if x.device.type == "cpu":
        return lattice_rollout_reference(state, planes, cfg, int(n_steps))
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    out = {k: state[k].clone() for k in STATE}
    window = LatticeWindow(out, planes, cfg)
    window.launch(int(n_steps))
    lattice_rollout.launches += 1
    lattice_rollout.ops += window.ops(int(n_steps))
    return out


lattice_rollout.launches = 0
lattice_rollout.ops = 0
