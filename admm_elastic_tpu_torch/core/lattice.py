"""The lattice whole-timestep route (`LatticeStepper`, `detect_lattice`,
`lattice_from_system`) and grid detection by vertex positions.

Counterpart of `admm_elastic_tpu/core/lattice.py`. A `make_beam_tets` beam
of uniform cube cells, in any vertex numbering, with one tet force of
uniform material (NeoHookean, StVK or ARAP), StaticAnchors of one weight,
an optional Floor and gravity kicks runs whole windows of timesteps in one
submission (a CUDA graph of the window's kernels,
`ops/kernels/lattice_step.py`, `csrc/lattice_step.cu`): the tets' vertices and the RHS gather follow from the cell index by
arithmetic, with no index arrays. The stepper works in the lattice's
canonical numbering; `lattice_from_system` returns the map from the
caller's numbering (`System._to_canon`).

`detect_grid_numbering` serves `System.initialize`: it says whether the JAX
package would renumber a mesh whose A_hat has too many diagonals for the
dia solver (its `reorder="auto"`). The renumbering itself is not ported
(ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.primitives import make_beam_tets
from ..models import (Collision, ExplicitForce, Floor, HyperElasticTet,
                      LinearTetStrain, StaticAnchor, WindForce)
from ..models.tet import build_tet_basis
from ..ops.kernels._graph import WindowGraphs
from ..ops.kernels.lattice_step import (_CORNER_DIJK, _EVEN, _ODD, STATE,
                                        LatticeConfig, LatticeWindow,
                                        lattice_rollout)
from .solver import assemble_A_hat_dia


def corner_offsets(gy: int, gz: int):
    """Linear vertex-index offset of each cell corner from corner 0."""
    return [di * gy * gz + dj * gz + dk for (di, dj, dk) in _CORNER_DIJK]


def group_tables(size: float):
    """Per-group (corners, parity, cp (3,4), volume) for a uniform cell of
    edge `size`. cp[b,k] = B[k,b] with B from models/tet.build_tet_basis."""
    coords = np.asarray(_CORNER_DIJK, dtype=np.float64) * size
    groups = []
    for parity, pattern in ((0, _EVEN), (1, _ODD)):
        for corners in pattern:
            B, vol = build_tet_basis(coords[list(corners)],
                                     np.asarray([[0, 1, 2, 3]]))
            groups.append((tuple(corners), parity, B[0].T, float(vol[0])))
    return groups


class LatticeStepper:
    """Whole-timestep ADMM stepper for an (nx,ny,nz)-cell uniform beam.

    Matches System semantics for one tet force, NeoHookean/StVK (uniform
    mu/lam, `newton_iters` warm-started Newton iterations) or
    LinearTetStrain (model='arap', the uniform stiffness passed as mu);
    StaticAnchor on `anchor_idx` (one `anchor_weight`); an optional
    Collision floor at `floor_y` (weight `floor_weight`); a gravity kick;
    and the dia global solve with `cg_iters` fixed Jacobi-PCG iterations.
    Everything is in the canonical lattice numbering ((i gy + j) gz + k),
    positions starting at the rest lattice moved by `origin`.
    """

    ROLLOUT_WINDOW = 10

    def __init__(self, nx, ny, nz, size, masses, mu, lam, anchor_idx,
                 gravity=(0.0, -9.8, 0.0), dt=0.04, admm_iters=10,
                 newton_iters=5, cg_iters=25, anchor_weight=1000.0,
                 dtype=torch.float32, model="nh", floor_y=None,
                 floor_weight=32.0, origin=(0.0, 0.0, 0.0), device="cuda"):
        if model not in ("nh", "stvk", "arap"):
            raise ValueError(f"unknown lattice model {model!r}")
        self.mesh = make_beam_tets(nx, ny, nz, size)
        self.mesh.vertices = self.mesh.vertices + np.asarray(origin,
                                                             np.float64)
        n = self.mesh.n_vertices
        self.n_nodes, self.n_elements = n, len(self.mesh.tets)
        self.dt = float(dt)
        self.dtype, self.device = dtype, torch.device(device)
        self.model = model
        masses = np.broadcast_to(np.asarray(masses, np.float64), (n,)).copy()

        # prox constant k: min(mu, lam) for hyperelastic (TetForce.cpp:306),
        # the stiffness itself for ARAP (TetForce.cpp:116, passed as mu)
        kprox = float(min(mu, lam)) if model != "arap" else float(mu)
        groups = group_tables(size)

        # the general route's global matrix, from the same forces
        if model == "arap":
            tet = LinearTetStrain(self.mesh.tets, mu, backend="pallas")
        else:
            tet = HyperElasticTet(self.mesh.tets, mu, lam,
                                  max_iters=newton_iters, model=model,
                                  backend="pallas")
        fp = {"tet": tet.build(self.mesh.vertices, masses, self.dt)[0],
              "anchor": StaticAnchor(anchor_idx, weight=anchor_weight).build(
                  self.mesh.vertices, masses, self.dt)[0]}
        if floor_y is not None:
            fp["collision"] = Collision(
                [Floor(center=(0.0, float(floor_y), 0.0))], n_nodes=n,
                weight=float(floor_weight)).build(self.mesh.vertices, masses,
                                                  self.dt)[0]
        out = assemble_A_hat_dia(n, masses, self.dt, fp)
        if out is None:
            raise ValueError("mesh is not dia-structured (not a lattice?)")
        dia_offs, dia_vals, diag = out

        aw2 = np.zeros(n)
        aidx = np.asarray(anchor_idx, np.int64).reshape(-1)
        aw2[aidx] = np.broadcast_to(
            np.asarray(anchor_weight, np.float64) ** 2, aidx.shape)
        self.planes = {
            "mass": self._dev(masses),
            "invd": self._dev(1.0 / diag),
            "aw2": self._dev(aw2),
            "ancz": self._dev(self.mesh.vertices),
            "dia": self._dev(dia_vals),
        }
        # gravity is rounded to the working type first, as the JAX stepper
        # stores it
        grav = torch.tensor(gravity, dtype=dtype).tolist()
        self.cfg = LatticeConfig(
            dims=(int(nx), int(ny), int(nz)),
            cp=tuple(tuple(float(q) for q in np.asarray(cp).ravel())
                     for (_, _, cp, _) in groups),
            w2=tuple(kprox * vol for (_, _, _, vol) in groups),
            dia_offs=tuple(int(o) for o in dia_offs), model=model,
            mu=float(mu), lam=float(lam), kprox=kprox,
            newton_iters=int(newton_iters), cg_iters=int(cg_iters),
            admm_iters=int(admm_iters), dt=self.dt,
            gravity=tuple(float(g) for g in grav),
            floor_y=None if floor_y is None else float(floor_y),
            floor_w2=float(floor_weight) ** 2,
        )
        E = self.n_elements
        self.state = {
            "x": self._dev(self.mesh.vertices),
            "v": self._dev(np.zeros((n, 3))),
            "u": self._dev(np.zeros((9, E))),
            "warm": self._dev(np.ones((3, E))),
            "au": self._dev(np.zeros((n, 3))),
            "cu": self._dev(np.zeros((n, 3))),
            "t": torch.zeros((), dtype=dtype, device=self.device),
        }
        self._graphs = WindowGraphs(LatticeWindow, lattice_rollout,
                                    (1, self.ROLLOUT_WINDOW))

    def _dev(self, a):
        return torch.as_tensor(np.array(a, np.float64, order="C"),
                               dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ access

    @property
    def x(self) -> np.ndarray:
        """(n,3) positions, canonical numbering."""
        return self.state["x"].cpu().numpy()

    @property
    def v(self) -> np.ndarray:
        return self.state["v"].cpu().numpy()

    def set_positions(self, value):
        """Overwrite positions, (n,3) in the canonical numbering: copied into the state's own
        buffer, which the captured windows hold."""
        self.state["x"].copy_(self._dev(np.asarray(value, np.float64)
                                        .reshape(self.n_nodes, 3)))

    def set_velocities(self, value):
        self.state["v"].copy_(self._dev(np.asarray(value, np.float64)
                                        .reshape(self.n_nodes, 3)))

    # ---------------------------------------------------------- stepping

    def _advance(self, n_steps):
        """n_steps timesteps: on a card in place, as one graph replay of
        the window's kernels (captured on first use, `WindowGraphs`); on
        the CPU by the kernels' plain twin."""
        state = {k: self.state[k] for k in STATE}
        if self.device.type == "cuda":
            self._graphs.advance(state, self.planes, self.cfg, n_steps)
        else:
            self.state.update(lattice_rollout(state, self.planes, self.cfg,
                                              n_steps))
        self.state["t"] = self.state["t"] + n_steps * self.dt

    def step(self):
        """One timestep (a 1-step window)."""
        self._advance(1)
        return True

    def run(self, n_steps: int):
        """n_steps timesteps: ROLLOUT_WINDOW-step windows, then the
        remainder as single steps."""
        full, rem = divmod(int(n_steps), self.ROLLOUT_WINDOW)
        for _ in range(full):
            self._advance(self.ROLLOUT_WINDOW)
        for _ in range(rem):
            self._advance(1)
        return True


def detect_lattice(vertices, tets, rel_tol=1e-6):
    """Whether (vertices, tets) is a uniform-cube beam lattice with the
    make_beam_tets 5-tet decomposition, in any vertex numbering.

    Returns (nx, ny, nz, size, origin, to_canonical) where
    to_canonical[orig_id] = canonical lattice id ((i*gy + j)*gz + k), or
    None if the mesh does not qualify. The order of a tet's vertices may
    differ from the canonical one: isotropic energies on singular values
    do not see it."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 8:
        return None
    mins = v.min(axis=0)
    span = v.max(axis=0) - mins
    scale = max(span.max(), 1.0)
    tol = rel_tol * scale

    axes = []
    for a in range(3):
        s = np.sort(np.unique(np.round(v[:, a] / tol).astype(np.int64)))
        vals = s * tol
        # merge near-duplicates
        keep = [vals[0]]
        for q in vals[1:]:
            if q - keep[-1] > tol * 4:
                keep.append(q)
        axes.append(np.asarray(keep))
    g = [len(a) for a in axes]
    if g[0] * g[1] * g[2] != n or min(g) < 2:
        return None
    spacings = []
    for a in range(3):
        d = np.diff(axes[a])
        if d.size == 0 or np.abs(d - d[0]).max() > tol * 8:
            return None
        spacings.append(d[0])
    size = spacings[0]
    if max(abs(s - size) for s in spacings) > tol * 8:
        return None  # the group tables assume uniform cube cells

    ijk = np.round((v - mins) / size).astype(np.int64)
    if np.abs(v - (mins + ijk * size)).max() > tol * 8:
        return None
    if (ijk < 0).any() or (ijk >= np.asarray(g)).any():
        return None
    gx, gy, gz = g
    cid = (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]
    if len(np.unique(cid)) != n:
        return None

    nx, ny, nz = gx - 1, gy - 1, gz - 1
    canon = make_beam_tets(nx, ny, nz, size)
    t = np.asarray(tets, np.int64)
    if t.shape != canon.tets.shape:
        return None
    remapped = np.sort(cid[t], axis=1)
    expected = np.sort(np.asarray(canon.tets, np.int64), axis=1)
    rm = remapped[np.lexsort(remapped.T[::-1])]
    ex = expected[np.lexsort(expected.T[::-1])]
    if not np.array_equal(rm, ex):
        return None
    return nx, ny, nz, float(size), mins, cid


def lattice_from_system(system):
    """A LatticeStepper equivalent to a built System, and the map to its
    canonical numbering, (stepper, to_canonical); or None when the scene
    does not qualify. Checks no global mode: it is tried after the banded
    route, which takes the dia and ell modes, as in the JAX package.

    Qualifying (as the JAX package's lattice_from_system): one tet force
    (HyperElasticTet nh/stvk with uniform mu and lam, or LinearTetStrain
    with uniform stiffness), at least one StaticAnchor, all of one weight,
    at most one Collision holding exactly one Floor over all nodes,
    all-node ExplicitForce kicks only, relaxation 1, no acceleration and no
    residuals, and a uniform-cube lattice mesh in any vertex numbering. A
    `(first, rest)` cg_fixed_iters raises: the kernel takes one budget
    (the JAX stepper's int() of a tuple fails as well)."""
    s = system.settings
    if s.collect_residuals or s.residual_tol is not None:
        return None
    # the kernel runs the plain relaxation-1 reference iteration only
    if s.relaxation != 1.0 or s.acceleration is not None:
        return None

    tet, anchors, floor = None, [], None
    for f in system.forces:
        if isinstance(f, HyperElasticTet):
            if tet is not None:
                return None
            mu, lam = np.unique(f.mu), np.unique(f.lam)
            if len(mu) != 1 or len(lam) != 1:
                return None
            tet = ("hyper", f, float(mu[0]), float(lam[0]))
        elif isinstance(f, LinearTetStrain):
            if tet is not None:
                return None
            k = np.unique(f.stiffness)
            if len(k) != 1:
                return None
            tet = ("arap", f, float(k[0]), float(k[0]))
        elif isinstance(f, StaticAnchor):
            anchors.append(f)
        elif isinstance(f, Collision):
            if (floor is not None or len(f.shapes) != 1
                    or not isinstance(f.shapes[0], Floor)
                    or f.n_nodes != system.n_nodes):
                return None
            floor = f
        else:
            return None
    if tet is None or not anchors:
        return None
    aw = np.unique(np.concatenate([np.asarray(a.weight).ravel()
                                   for a in anchors]))
    if len(aw) != 1:
        return None

    gravity = np.zeros(3)
    for e in system.explicit_forces:
        if isinstance(e, WindForce) or not isinstance(e, ExplicitForce):
            return None
        if e.indices is not None:
            return None
        gravity = gravity + np.asarray(e.direction, np.float64)

    kind, tf, p0, p1 = tet
    det = detect_lattice(system._x, tf.tets)
    if det is None:
        return None
    nx, ny, nz, size, origin, cid = det
    if isinstance(s.cg_fixed_iters, (tuple, list)):
        raise NotImplementedError(
            "the lattice whole-timestep kernel runs one CG budget for every "
            f"ADMM iteration; cg_fixed_iters={s.cg_fixed_iters!r} is a "
            "(first, rest) schedule (the JAX stepper rejects it too). Give "
            "an int, or lattice_fast_path=False for the general route"
        )

    masses_c = np.empty(system.n_nodes)
    masses_c[cid] = system._m
    anchor_cids = np.concatenate(
        [cid[np.asarray(a.indices, np.int64).ravel()] for a in anchors])
    if kind == "arap":
        model, mu, lam, newton_iters = "arap", p0, p0, 1
    else:
        model, mu, lam, newton_iters = tf.model, p0, p1, tf.max_iters
    stepper = LatticeStepper(
        nx, ny, nz, size, masses_c, mu, lam, anchor_cids,
        gravity=tuple(gravity), dt=s.timestep_s, admm_iters=s.admm_iters,
        newton_iters=newton_iters,
        cg_iters=25 if s.cg_fixed_iters is None else int(s.cg_fixed_iters),
        anchor_weight=float(aw[0]), dtype=s.dtype, model=model,
        floor_y=(float(floor.shapes[0].center[1]) if floor is not None
                 else None),
        floor_weight=floor.weight_value if floor is not None else 32.0,
        origin=tuple(origin), device=s.device,
    )
    return stepper, cid


def detect_grid_numbering(vertices, rel_tol=1e-6):
    """If the vertices form a full regular grid (uniform spacing per axis;
    axes may differ, one may be flat), return to_canonical[orig_id] =
    (i*gy + j)*gz + k, else None."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 8:
        return None
    mins = v.min(axis=0)
    span = v.max(axis=0) - mins
    scale = max(span.max(), 1.0)
    tol = rel_tol * scale

    axes = []
    for a in range(3):
        vals = np.sort(np.unique(np.round(v[:, a] / tol).astype(np.int64)))
        vals = vals * tol
        keep = [vals[0]]
        for q in vals[1:]:
            if q - keep[-1] > tol * 4:
                keep.append(q)
        axes.append(np.asarray(keep))
    g = [len(a) for a in axes]
    if g[0] * g[1] * g[2] != n or sorted(g)[1] < 2:
        return None
    sizes = []
    for a in range(3):
        d = np.diff(axes[a])
        if d.size == 0:
            sizes.append(1.0)  # degenerate axis: spacing irrelevant
            continue
        if np.abs(d - d[0]).max() > tol * 8:
            return None
        sizes.append(d[0])
    ijk = np.round((v - mins) / np.asarray(sizes)).astype(np.int64)
    if np.abs(v - (mins + ijk * np.asarray(sizes))).max() > tol * 8:
        return None
    if (ijk < 0).any() or (ijk >= np.asarray(g)).any():
        return None
    gy, gz = g[1], g[2]
    cid = (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]
    if len(np.unique(cid)) != n:
        return None
    return cid
