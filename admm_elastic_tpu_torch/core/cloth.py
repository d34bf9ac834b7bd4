"""The cloth whole-timestep route: `ClothStepper` and `cloth_from_system`.

Counterpart of `admm_elastic_tpu/core/cloth.py`, with the Jacobi-PCG and
the in-kernel 2D geometric multigrid (`preconditioner="amg"`,
`ClothStepper(multigrid=True)`: `core/mg.py` on the first stride ladder of
`MG_LADDERS` whose coarsest level fits) as the solve's preconditioner. One
submission (a CUDA graph of the window's kernels,
`ops/kernels/cloth_step.py`) runs a whole window of timesteps of a
{LimitedTriangleStrain, Bend, StaticAnchor, gravity, WindForce} cloth on
the dia solver: explicit kicks, every ADMM iteration's triangle and hinge
local steps, dual updates, anchors and the fixed-budget PCG solve
on one thread-block cluster on the general route's dia matrix. Trajectories
match the general `System` route to round-off
(tests/test_torch_cloth.py).

Qualification is the JAX package's: faces and hinges are grouped by their
vertex-offset stencils from each element's minimum index
(`group_constant_offsets`), and the route engages when the grouping is
small and every group's constants are uniform, which is the regular grid.
The kernel itself reads elements by index, so the groups only fix the
order of each vertex's sums (group by group, corner by corner, as the
Pallas kernel accumulates them) and the per-group constants.

With `collect_residuals` ("primal" or True) the window's kernels also
compute each ADMM iteration's primal (and dual) residual, read after each
window into `last_primal` / `last_dual` (n_steps, admm_iters).

Out of this slice (raise, see ROADMAP.md): the kernel on a sheet that
qualifies only after the JAX package's scrambled-grid or sym-plane
renumbering (the detectors are here, to tell when that happens).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import (Bend, ExplicitForce, LimitedTriangleStrain,
                      StaticAnchor, WindForce)
from ..ops.kernels import residuals
from ..ops.kernels._graph import WindowGraphs
from ..ops.kernels.cloth_step import (BEND_TAB, STATE, TRI_TAB, ClothConfig,
                                      ClothWindow, cloth_rollout)
from ..ops.kernels.mg import MGConfig, planes_from
from .banded import BandedStepper, collect_mode, host_residuals
from .lattice import detect_grid_numbering
from .mg import LANES, build_grid_mg
from .solver import _assemble_A_hat_csr, assemble_A_hat_dia

# group budget of the JAX kernel (sym-plane: 4 tri + 6 hinge stencils;
# editor-reordered face lists up to 4 + 12)
MAX_GROUPS = 16
MAX_WIND_GROUPS = 4
# non-negative offsets of the JAX kernel's symmetric dia planes: a matrix
# with more takes the general route there, and so here
MAX_DIAGONALS = 24
# the in-kernel multigrid's stride ladders, tried in the JAX package's
# order of preference (tools/cloth_mg_study.py), and the cap on its
# coarsest level: MG_MAX_NP2 x 128 dofs
MG_LADDERS = ((2, 4), (2, 8), (4, 8), (4, 16))
MG_MAX_NP2 = 8


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


def detect_symplane_numbering(faces, n):
    """Canonical permutation for the sym-plane tessellation (the reference's
    cloth builder, make_sym_plane): (W+1)x(H+1) grid corners x-major
    followed by WxH quad centers, 4 triangles per quad around the center.
    Interleaving each x-column's corners with its centers (column x maps to
    rows x (2H+1): corners at +y, centers at +(H+1)+y) puts every triangle
    class on constant offsets.

    Detection is exact: (W, H) are recovered from the vertex and face
    counts (n = 2WH + W + H + 1, n_faces = 4WH) and the face list must
    regenerate verbatim. Returns cid (new index per old vertex) or None."""
    f = np.asarray(faces, np.int64)
    if f.ndim != 2 or f.shape[1] != 3 or len(f) % 4:
        return None
    F = len(f) // 4  # = W*H
    s = n - 2 * F - 1  # = W + H
    if F <= 0 or s <= 1:
        return None
    disc = s * s - 4 * F
    if disc < 0:
        return None
    r = int(round(np.sqrt(disc)))
    if r * r != disc or (s - r) % 2:
        return None
    for W, H in {((s + r) // 2, (s - r) // 2), ((s - r) // 2, (s + r) // 2)}:
        if W < 1 or H < 1 or W * H != F:
            continue
        n_grid = (W + 1) * (H + 1)
        quads = []
        for x in range(W):
            for y in range(H):
                ll = y + x * (H + 1)
                lr = y + (x + 1) * (H + 1)
                ul, ur = ll + 1, lr + 1
                cent = n_grid + x * H + y
                quads += [(ll, lr, cent), (lr, ur, cent),
                          (cent, ur, ul), (ll, cent, ul)]
        if not np.array_equal(f, np.asarray(quads, np.int64)):
            continue
        cid = np.empty(n, np.int64)
        for x in range(W + 1):
            base = x * (2 * H + 1)
            cid[x * (H + 1): (x + 1) * (H + 1)] = base + np.arange(H + 1)
        for x in range(W):
            base = x * (2 * H + 1) + (H + 1)
            cid[n_grid + x * H: n_grid + (x + 1) * H] = base + np.arange(H)
        return cid
    return None


def detect_symplane_positions(vertices, rel_tol=1e-5):
    """Position-based sym-plane canonicalization, the fallback when
    detect_symplane_numbering's exact regeneration fails (reordered faces,
    renumbered vertices): the rest positions projected onto their best-fit
    plane quantize onto a half-spacing lattice, grid corners on (even,
    even) and quad centers on (odd, odd) coordinates. Returns the same
    interleaved-column permutation cid, or None. The caller validates it by
    building the stepper."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 5:  # W = H = 1 -> 5 vertices
        return None
    c = v.mean(0)
    _, sv, vt = np.linalg.svd(v - c, full_matrices=False)
    scale = max(sv[0], 1e-30)
    if sv[2] > 1e-4 * scale:  # not planar
        return None
    p = (v - c) @ vt[:2].T
    p -= p.min(0)

    q = np.empty((n, 2), np.int64)
    for a in range(2):
        vals = np.unique(np.sort(p[:, a]))
        keep = [vals[0]]  # merge within tolerance
        for x in vals[1:]:
            if x - keep[-1] > rel_tol * scale * 8:
                keep.append(x)
        keep = np.asarray(keep)
        if len(keep) < 3:
            return None
        h = np.diff(keep)
        if np.abs(h - h[0]).max() > rel_tol * scale * 16:
            return None  # not a uniform half-spacing lattice
        q[:, a] = np.round(p[:, a] / h[0]).astype(np.int64)
        if np.abs(p[:, a] - q[:, a] * h[0]).max() > rel_tol * scale * 16:
            return None
    par = q % 2
    corner = (par[:, 0] == 0) & (par[:, 1] == 0)
    center = (par[:, 0] == 1) & (par[:, 1] == 1)
    if not (corner | center).all():
        return None
    W2, H2 = q.max(0)
    if W2 % 2 or H2 % 2 or W2 < 2 or H2 < 2:
        return None
    W, H = W2 // 2, H2 // 2
    if corner.sum() != (W + 1) * (H + 1) or center.sum() != W * H:
        return None
    i, j = q[:, 0] // 2, q[:, 1] // 2
    cid = np.where(
        corner,
        i * (2 * H + 1) + j,
        i * (2 * H + 1) + (H + 1) + j,
    ).astype(np.int64)
    if len(np.unique(cid)) != n:
        return None
    return cid


def ladder_mg(A, vertices):
    """The cloth kernel's multigrid of CSR A on a grid sheet: that of the
    first ladder of MG_LADDERS whose coarsest level has at most
    MG_MAX_NP2 x 128 dofs (`core.mg.build_grid_mg`), or None."""
    for ladder in MG_LADDERS:
        mg = build_grid_mg(A, vertices, ladder,
                           max_coarse=MG_MAX_NP2 * LANES)
        if mg is not None:
            return mg
    return None


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
    with `cg_iters` fixed PCG iterations, preconditioned by Jacobi or,
    with multigrid=True, by the V-cycle of the first ladder of MG_LADDERS
    whose coarsest level has at most MG_MAX_NP2 x 128 dofs. `wind` is
    (direction, triangles) or None. Arrays are numpy, in the System's
    numbering. Raises ValueError when the mesh does not qualify.
    collect_residuals, last_primal and last_dual: as BandedStepper's."""

    model = "cloth"
    ROLLOUT_WINDOW = 10

    def __init__(self, vertices, masses, tri_force, bend_force, anchor_idx,
                 anchor_weight=1000.0, gravity=(0.0, -9.8, 0.0), wind=None,
                 dt=0.04, admm_iters=10, cg_iters=25, dtype=torch.float32,
                 device="cuda", multigrid=False, collect_residuals=False):
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

        # ---- the general route's global matrix, as its diagonals at
        # their signed offsets (dia[d,i] = A[i, i+off])
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
        if sum(o >= 0 for o in all_offs) > MAX_DIAGONALS:
            raise ValueError("too many diagonals for the cloth kernel")
        mg = None
        if multigrid:
            mg = ladder_mg(_assemble_A_hat_csr(n, masses, dt, fp), v)
            if mg is None:
                raise ValueError(
                    "in-kernel multigrid: no stride ladder fits this "
                    "grid (not a full grid in nested numbering?)")
            self.mg_levels = mg["levels"]
        #: the multigrid as its host builder returned it, None under Jacobi
        self.hierarchy = mg

        self.cfg = ClothConfig(
            dia_offs=tuple(int(o) for o in all_offs), cg_iters=int(cg_iters),
            admm_iters=int(admm_iters), dt=float(dt),
            gravity=tuple(float(g) for g in gravity), wind_dir=wind_dir,
            limiting=bool(tri_force.strain_limiting),
            mg=None if mg is None else MGConfig.of(mg),
            collect=collect_mode(collect_residuals),
        )
        #: (n_steps, admm_iters) residuals of the last step()/run() window
        #: when collect_residuals is on (host copies)
        self.last_primal = self.last_dual = None
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
            "dia": self._dev(dia_vals),
            "inc": self._dev(inc, torch.int32),
            "winc": self._dev(winc, torch.int32),
        }
        if mg is not None:
            self.planes.update(planes_from(mg, dtype, self.device))
        self.state = {
            "x": self._dev(v),
            "v": self._dev(np.zeros((n, 3))),
            "tu": self._dev(np.zeros((6, Et))),
            "hu": self._dev(np.zeros((9, Eh))),
            "au": self._dev(np.zeros((n, 3))),
            "t": torch.zeros((), dtype=dtype, device=self.device),
        }
        self._graphs = WindowGraphs(ClothWindow, cloth_rollout,
                                    (1, self.ROLLOUT_WINDOW))

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.array(a, order="C"),
                               dtype=dtype or self.dtype, device=self.device)

    collect_residuals = BandedStepper.collect_residuals

    # ------------------------------------------------------------ access

    @property
    def x(self) -> np.ndarray:
        return self.state["x"].cpu().numpy()

    @property
    def v(self) -> np.ndarray:
        return self.state["v"].cpu().numpy()

    def set_positions(self, value):
        """Overwrite positions, (n,3): copied into the state's own
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
            out = residuals.attach({}, self.cfg.collect,
                                   self._graphs.window.residuals(n_steps))
        else:
            out = cloth_rollout(state, self.planes, self.cfg, n_steps)
            self.state.update({k: out[k] for k in STATE})
        self.state["t"] = self.state["t"] + n_steps * self.cfg.dt
        self.last_primal, self.last_dual = host_residuals(out)

    def step(self):
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


def cloth_from_system(system):
    """A ClothStepper equivalent to an initialized System, or None when the
    scene does not qualify.

    Qualifying (as the JAX package's cloth_from_system): one
    LimitedTriangleStrain whose faces group into constant-offset stencils
    with uniform constants, at most one Bend (same condition on hinges),
    StaticAnchors with one shared weight, all-node ExplicitForce kicks, at
    most one WindForce over groupable triangles, and a dia-structured
    A_hat; under preconditioner="amg" the multigrid builds (default budget
    10); no residual_tol, collect_residuals False, "primal" or True (the
    kernel emits them). (Relaxation never reaches here: System.initialize
    keeps it on the general route.) Where the sheet does not qualify in
    its own numbering, the JAX package tries its grid and sym-plane
    renumberings (`detect_grid_numbering`, `detect_symplane_numbering`,
    `detect_symplane_positions`) and runs the kernel on the first that
    qualifies; the port raises NotImplementedError there, and returns None
    (the general route) where none qualifies. A `(first, rest)`
    cg_fixed_iters raises, as the JAX stepper's int() of a tuple fails."""
    s = system.settings
    # the residual-driven early exit needs the general route
    # (cloth.py:518-523)
    if s.collect_residuals not in (False, None, True, "primal") or (
            s.residual_tol is not None):
        return None
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
    verts, n = system._x, system.n_nodes
    mg = s.preconditioner == "amg"

    def build(cid):
        """The stepper with vertex permutation cid (None: the System's
        own numbering), or None where the mesh does not qualify."""
        if cid is None:
            vv, mm, remap = verts, system._m, np.asarray
            tri_r, bend_r = tri, bend
        else:
            vv = np.empty_like(verts)
            vv[cid] = verts
            mm = np.empty(n)
            mm[cid] = system._m

            def remap(idx):
                return cid[np.asarray(idx, np.int64)]

            tri_r = LimitedTriangleStrain(
                remap(tri.faces), tri.stiffness, tri.limit_min,
                tri.limit_max, strain_limiting=tri.strain_limiting,
                backend=tri.backend)
            bend_r = (Bend(remap(bend.hinges), bend.stiffness)
                      if bend is not None else None)
        try:
            return ClothStepper(
                vv, mm, tri_r, bend_r, remap(anchor_idx),
                anchor_weight=anchor_weight, gravity=tuple(gravity),
                wind=((wind.direction, remap(wind.tris)) if wind is not None
                      else None),
                dt=s.timestep_s, admm_iters=s.admm_iters,
                cg_iters=((10 if mg else 25) if s.cg_fixed_iters is None
                          else int(s.cg_fixed_iters)),
                dtype=s.dtype, device=s.device, multigrid=mg,
                collect_residuals=s.collect_residuals)
        except ValueError:
            return None

    stepper = build(None)
    if stepper is not None:
        return stepper
    # the JAX package's renumberings (cloth.py:612-623): the port does not
    # run the cloth kernel on a renumbered sheet, so where one of them
    # would engage it, it raises; where none does, the general route runs
    for name, detect in (
            ("grid", lambda: detect_grid_numbering(verts)),
            ("sym-plane", lambda: detect_symplane_numbering(tri.faces, n)),
            ("sym-plane positions", lambda: detect_symplane_positions(verts))):
        cid = detect()
        if cid is not None and build(cid) is not None:
            raise NotImplementedError(
                f"lattice_fast_path=True: the JAX package runs this cloth on "
                f"the cloth whole-timestep kernel after its {name} "
                "renumbering, which is not ported (ROADMAP A8b); use "
                "lattice_fast_path=False for the general route")
    return None
