"""The cloth whole-timestep route: `ClothStepper` and `cloth_from_system`.

Counterpart of `admm_elastic_tpu/core/cloth.py` in Jacobi-PCG mode. One
kernel launch (`ops/kernels/cloth_step.py`) runs a whole window of
timesteps of a {LimitedTriangleStrain, Bend, StaticAnchor, gravity,
WindForce} cloth on the dia solver: explicit kicks, every ADMM iteration's
triangle and hinge local steps, dual updates, anchors and the fixed-budget
Jacobi-PCG solves. Trajectories match the general `System` route to
round-off (tests/test_torch_cloth.py).

Qualification is the JAX package's: faces and hinges are grouped by their
vertex-offset stencils from each element's minimum index
(`group_constant_offsets`), and the route engages when the grouping is
small and every group's constants are uniform, which is the regular grid.
The kernel itself reads elements by index, so the groups only fix the
order of each vertex's sums (group by group, corner by corner, as the
Pallas kernel accumulates them) and the per-group constants.

Out of this slice (raise, see ROADMAP.md): the scrambled-grid and
sym-plane numberings (`detect_grid_numbering`,
`detect_symplane_numbering`, `detect_symplane_positions`), the in-kernel
2D multigrid (`preconditioner="amg"`) and in-kernel residuals.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import (Bend, ExplicitForce, LimitedTriangleStrain,
                      StaticAnchor, WindForce)
from ..ops.kernels.cloth_step import (BEND_TAB, TRI_TAB, ClothConfig,
                                      cloth_rollout)
from .solver import assemble_A_hat_dia

# group budget of the JAX kernel (sym-plane: 4 tri + 6 hinge stencils;
# editor-reordered face lists up to 4 + 12)
MAX_GROUPS = 16
MAX_WIND_GROUPS = 4
MAX_DIAGONALS = 24  # non-negative offsets of the symmetric dia planes


def group_constant_offsets(indices):
    """Group elements by their vertex-offset stencil.

    indices: (E, K) int. base = per-row min. Returns list of
    (offsets tuple(K), element_ids array, bases array), or None if more
    than MAX_GROUPS distinct stencils exist (not a regular grid) or a base
    vertex hosts two elements of the same stencil (duplicate elements)."""
    idx = np.asarray(indices, np.int64)
    base = idx.min(axis=1)
    offs = idx - base[:, None]
    keys, inv = np.unique(offs, axis=0, return_inverse=True)
    if len(keys) > MAX_GROUPS:
        return None
    out = []
    for g in range(len(keys)):
        es = np.flatnonzero(inv == g)
        bases = base[es]
        if len(np.unique(bases)) != len(bases):
            return None
        out.append((tuple(int(o) for o in keys[g]), es, bases))
    return out


def _uniform(arr, rel=1e-6):
    """Representative value if all rows of `arr` are equal (to rel
    tolerance of the magnitude scale), else None."""
    a = np.asarray(arr, np.float64)
    r = a.reshape(len(a), -1)
    scale = max(1.0, float(np.abs(r[0]).max()))
    if np.abs(r - r[0]).max() > rel * scale:
        return None
    return a[0]


def _ordered_incidence(n, verts, keys):
    """(n, S) int32 vertex -> slot table: slot m belongs to vertex
    verts[m]; each vertex's slots are sorted by keys[m], then padded with
    the sentinel len(verts)."""
    verts = np.asarray(verts, np.int64)
    M = len(verts)
    order = np.lexsort((np.asarray(keys, np.int64), verts))
    sv = verts[order]
    counts = np.bincount(sv, minlength=n)
    S = max(int(counts.max()) if M else 0, 1)
    inc = np.full((n, S), M, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    inc[sv, np.arange(M) - np.repeat(starts, counts)] = order
    return inc.astype(np.int32)


def _sorted_groups(groups):
    """(element order, group of each, base of each) for a grouping."""
    if not groups:
        return (np.zeros(0, np.int64),) * 3
    order = np.concatenate([es for _, es, _ in groups])
    grp = np.concatenate([np.full(len(es), g) for g, (_, es, _)
                          in enumerate(groups)])
    base = np.concatenate([bases for _, _, bases in groups])
    return order, grp, base


class ClothStepper:
    """Single-kernel ADMM stepper for constant-offset-groupable cloth.

    Matches System semantics for: one LimitedTriangleStrain (uniform
    stiffness/limits per stencil group), an optional Bend (uniform alpha
    per group), StaticAnchors (one weight), all-node gravity kicks, an
    optional WindForce over groupable triangles, and the dia global solve
    with `cg_iters` fixed Jacobi-PCG iterations. `wind` is (direction,
    triangles) or None. Arrays are numpy, in the System's numbering.
    Raises ValueError when the mesh does not qualify."""

    model = "cloth"
    ROLLOUT_WINDOW = 10

    def __init__(self, vertices, masses, tri_force, bend_force, anchor_idx,
                 anchor_weight=1000.0, gravity=(0.0, -9.8, 0.0), wind=None,
                 dt=0.04, admm_iters=10, cg_iters=25, dtype=torch.float32,
                 device="cuda"):
        v = np.asarray(vertices, np.float64)
        n = len(v)
        self.n_nodes = n
        self.dtype, self.device = dtype, torch.device(device)
        masses = np.broadcast_to(np.asarray(masses, np.float64), (n,)).copy()

        # ---- triangle strain groups: cp (6), w2, k, 1/(w2+k), lmin, lmax
        pt, _ = tri_force.build(v, masses, dt)
        gt = group_constant_offsets(tri_force.faces)
        if gt is None:
            raise ValueError("faces are not constant-offset groupable")
        ttab = []
        for _, es, _ in gt:
            cp = _uniform(pt["coeff"][es])  # (2,3)
            w = _uniform(pt["weight"][es])
            k = _uniform(pt["k"][es])
            lmin = _uniform(pt["limit_min"][es])
            lmax = _uniform(pt["limit_max"][es])
            if any(q is None for q in (cp, w, k, lmin, lmax)):
                raise ValueError("non-uniform triangle group constants")
            w2, k = float(w) ** 2, float(k)
            ttab.append([*(float(q) for q in cp.ravel()), w2, k,
                         1.0 / (w2 + k), float(lmin), float(lmax)])

        # ---- bend groups: arow (3), arow/2 (3), 2/|arow|^2, w2, k, 1/(w2+k)
        gh, htab, pb = [], [], None
        if bend_force is not None and bend_force.n_elements:
            pb, _ = bend_force.build(v, masses, dt)
            gh = group_constant_offsets(bend_force.hinges)
            if gh is None or len(gt) + len(gh) > MAX_GROUPS:
                raise ValueError("hinges are not constant-offset groupable")
            for _, es, _ in gh:
                al = _uniform(pb["alpha"][es])  # (4,)
                w = _uniform(pb["weight"][es])
                k = _uniform(pb["stiffness"][es])
                if any(q is None for q in (al, w, k)):
                    raise ValueError("non-uniform bend group constants")
                # projection row weights (alpha0, alpha3, alpha1)
                # (BendForce.cpp:139-142)
                arow = (float(al[0]), float(al[3]), float(al[1]))
                denom = arow[0] ** 2 + arow[1] ** 2 + arow[2] ** 2
                w2, k = float(w) ** 2, float(k)
                htab.append([*arow, *(0.5 * a for a in arow),
                             (2.0 / denom) if denom > 0 else 0.0, w2, k,
                             1.0 / (w2 + k)])

        # ---- wind groups (optional)
        gw, wind_dir, wtris = [], (0.0, 0.0, 0.0), np.zeros((0, 3), np.int64)
        if wind is not None:
            wdir, wtris = wind
            wtris = np.asarray(wtris, np.int64).reshape(-1, 3)
            gw = group_constant_offsets(wtris)
            if gw is None or len(gw) > MAX_WIND_GROUPS:
                raise ValueError("wind triangles not groupable")
            wind_dir = tuple(float(q) for q in wdir)

        # ---- the general route's global matrix, stored as its diagonals
        # at offsets >= 0 (dia[d,i] = A[i, i+off])
        anchor_idx = np.asarray(anchor_idx, np.int64).reshape(-1)
        fp = {"tri": pt}
        if pb is not None:
            fp["bend"] = pb
        if len(anchor_idx):
            anc = StaticAnchor(anchor_idx, weight=anchor_weight)
            fp["anchor"], _ = anc.build(v, masses, dt)
        out = assemble_A_hat_dia(n, masses, dt, fp,
                                 max_diagonals=2 * MAX_DIAGONALS)
        if out is None:
            raise ValueError("mesh is not dia-structured (not a grid?)")
        all_offs, dia_vals, diag = out
        pos = [d for d, o in enumerate(all_offs) if o >= 0]
        if len(pos) > MAX_DIAGONALS:
            raise ValueError("too many diagonals for the cloth kernel")

        self.cfg = ClothConfig(
            dia_offs=tuple(all_offs[d] for d in pos), cg_iters=int(cg_iters),
            admm_iters=int(admm_iters), dt=float(dt),
            gravity=tuple(float(g) for g in gravity), wind_dir=wind_dir,
            limiting=bool(tri_force.strain_limiting),
        )
        self.groups = [("tri", offs) for offs, _, _ in gt] + [
            ("bend", offs) for offs, _, _ in gh]
        self.wind_groups = [offs for offs, _, _ in gw]

        # ---- elements sorted by group; incidences in (group, corner)
        # order, the order the Pallas kernel adds them in
        faces = np.asarray(tri_force.faces, np.int64)
        torder, self._tgrp, self._tbase = _sorted_groups(gt)
        Et = len(torder)
        tidx = faces[torder].T  # (3,Et)
        hinges = (np.asarray(bend_force.hinges, np.int64)
                  if gh else np.zeros((0, 4), np.int64))
        horder, self._hgrp, self._hbase = _sorted_groups(gh)
        Eh = len(horder)
        hidx = hinges[horder].T  # (4,Eh)
        worder, wgrp, _ = _sorted_groups(gw)
        widx = wtris[worder].T  # (3,Ew)
        self.n_elements = (Et, Eh)
        corner3, corner4 = np.arange(3)[:, None], np.arange(4)[:, None]
        inc = _ordered_incidence(
            n, np.concatenate([tidx.ravel(), hidx.ravel()]),
            np.concatenate([(4 * self._tgrp[None, :] + corner3).ravel(),
                            (4 * (len(gt) + self._hgrp[None, :])
                             + corner4).ravel()]))
        winc = _ordered_incidence(
            n, widx.ravel(), (4 * wgrp[None, :] + corner3).ravel())
        # a wind slot is the triangle itself: one force for all 3 corners
        Ew = widx.shape[1]
        winc = np.where(winc < 3 * Ew, winc % max(Ew, 1), Ew).astype(np.int32)

        aw2 = np.zeros(n)
        aw2[anchor_idx] = float(anchor_weight) ** 2
        self.planes = {
            "tidx": self._dev(tidx, torch.int32),
            "tgrp": self._dev(self._tgrp, torch.int32),
            "ttab": self._dev(np.asarray(ttab).reshape(-1, TRI_TAB)),
            "hidx": self._dev(hidx, torch.int32),
            "hgrp": self._dev(self._hgrp, torch.int32),
            "htab": self._dev(np.asarray(htab).reshape(-1, BEND_TAB)),
            "widx": self._dev(widx, torch.int32),
            "mass": self._dev(masses),
            "invd": self._dev(1.0 / diag),
            "aw2": self._dev(aw2),
            "ancz": self._dev(v),
            "dia": self._dev(dia_vals[pos]),
            "inc": self._dev(inc, torch.int32),
            "winc": self._dev(winc, torch.int32),
        }
        self.state = {
            "x": self._dev(v),
            "v": self._dev(np.zeros((n, 3))),
            "tu": self._dev(np.zeros((6, Et))),
            "hu": self._dev(np.zeros((9, Eh))),
            "au": self._dev(np.zeros((n, 3))),
            "t": torch.zeros((), dtype=dtype, device=self.device),
        }

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.array(a, order="C"),
                               dtype=dtype or self.dtype, device=self.device)

    # ------------------------------------------------------------ access

    @property
    def x(self) -> np.ndarray:
        return self.state["x"].cpu().numpy()

    @property
    def v(self) -> np.ndarray:
        return self.state["v"].cpu().numpy()

    def set_positions(self, value):
        """Overwrite positions, (n,3)."""
        self.state["x"] = self._dev(np.asarray(value, np.float64)
                                    .reshape(self.n_nodes, 3))

    def set_velocities(self, value):
        self.state["v"] = self._dev(np.asarray(value, np.float64)
                                    .reshape(self.n_nodes, 3))

    # ---------------------------------------------------------- stepping

    def _advance(self, n_steps):
        new = cloth_rollout(self.state, self.planes, self.cfg, n_steps)
        new["t"] = self.state["t"] + n_steps * self.cfg.dt
        self.state = new

    def step(self):
        self._advance(1)
        return True

    def run(self, n_steps: int):
        """n_steps timesteps: ROLLOUT_WINDOW-step launches, then the
        remainder as single steps."""
        full, rem = divmod(int(n_steps), self.ROLLOUT_WINDOW)
        for _ in range(full):
            self._advance(self.ROLLOUT_WINDOW)
        for _ in range(rem):
            self._advance(1)
        return True


def cloth_from_system(system):
    """A ClothStepper equivalent to an initialized dia-route System, or
    None when the scene is not a cloth scene.

    Qualifying (as the JAX package's cloth_from_system): one
    LimitedTriangleStrain whose faces group into constant-offset stencils
    with uniform constants, at most one Bend (same condition on hinges),
    StaticAnchors with one shared weight, all-node ExplicitForce kicks, at
    most one WindForce over groupable triangles, and a dia-structured
    A_hat. (Relaxation, residuals and the multigrid never reach here:
    System.initialize rejects them.) A cloth scene whose vertex numbering
    does not group raises NotImplementedError: the JAX package would try
    its grid and sym-plane renumberings next, which are not ported."""
    s = system.settings
    tri, bend, anchors = None, None, []
    for f in system.forces:
        if type(f) is LimitedTriangleStrain:
            if tri is not None:
                return None
            tri = f
        elif type(f) is Bend:
            if bend is not None:
                return None
            bend = f
        elif isinstance(f, StaticAnchor):
            anchors.append(f)
        else:
            return None
    if tri is None:
        return None

    anchor_weight = 1000.0
    if anchors:
        aw = np.unique(np.concatenate([np.asarray(a.weight).ravel()
                                       for a in anchors]))
        if len(aw) != 1:
            return None
        anchor_weight = float(aw[0])

    gravity = np.zeros(3)
    wind = None
    for e in system.explicit_forces:
        if isinstance(e, WindForce):
            if wind is not None:
                return None
            wind = e
        elif isinstance(e, ExplicitForce):
            if e.indices is not None:
                return None
            gravity = gravity + e.direction
        else:
            return None
    if isinstance(s.cg_fixed_iters, (tuple, list)):
        raise NotImplementedError(
            "the cloth whole-timestep kernel runs one CG budget for every "
            f"ADMM iteration; cg_fixed_iters={s.cg_fixed_iters!r} is a "
            "(first, rest) schedule. Give an int, or lattice_fast_path=False "
            "for the general route"
        )

    anchor_idx = (np.concatenate([np.asarray(a.indices, np.int64).ravel()
                                  for a in anchors])
                  if anchors else np.zeros(0, np.int64))
    try:
        return ClothStepper(
            system._x, system._m, tri, bend, anchor_idx,
            anchor_weight=anchor_weight, gravity=tuple(gravity),
            wind=((wind.direction, wind.tris) if wind is not None else None),
            dt=s.timestep_s, admm_iters=s.admm_iters,
            cg_iters=25 if s.cg_fixed_iters is None else int(s.cg_fixed_iters),
            dtype=s.dtype, device=s.device,
        )
    except ValueError as err:
        raise NotImplementedError(
            f"lattice_fast_path=True: the cloth does not qualify in its own "
            f"vertex numbering ({err}); the JAX package's grid and sym-plane "
            "renumberings (detect_grid_numbering, detect_symplane_numbering, "
            "detect_symplane_positions) are not ported (ROADMAP B9); use "
            "lattice_fast_path=False for the general route"
        ) from err
