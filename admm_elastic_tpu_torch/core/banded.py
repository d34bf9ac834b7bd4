"""The banded whole-timestep route: `BandedStepper` and `banded_from_system`.

Counterpart of `admm_elastic_tpu/core/banded.py` with a NeoHookean, StVK
or corotational (ARAP) tet force, in dia mode and in ell mode (its uell
matvec: a tet mesh of any topology). One submission (a CUDA graph of the
window's kernels, `ops/kernels/banded_step.py`) runs a whole window of
timesteps: gravity kick, every ADMM iteration's local steps and dual
updates, anchors, collisions and the fixed-budget PCG solve on one
thread-block cluster, preconditioned by Jacobi or, under
`preconditioner="amg"`, by a multigrid V-cycle: the geometric one on a
grid mesh in nested numbering (dia mode, `core/mg.py`, `ops/kernels/mg.py`)
or the algebraic one on a mesh of any topology (ell mode, `core/uamg.py`,
`ops/kernels/uamg.py`).
Trajectories match the general `System` route to round-off
(tests/test_torch_banded.py).

The JAX stepper packs the mesh for the TPU: (Nr,128) lane planes, tets
sorted and packed into 128-lane sub-blocks with distinct scatter lanes
(`place_elements`), per-chunk vertex windows bounded by MAX_WR. None of it
is needed here. Element planes stay (P,E) in the tet force's own order,
vertex data (n,3), and the right-hand side is a fixed-order gather over the
vertex incidence (`core.solver.assemble_transpose_incidence`), so any mesh
whose global matrix fits the dia solver's diagonals qualifies, with no
window limit. In ell mode the matrix is the System's own ELL form
(`core.solver.assemble_A_hat_ell`); the JAX uell packing (slot and fold
planes over a diluted, spatially ordered vertex layout, hub splits, an
85 MB VMEM budget) is TPU layout and is dropped, so a mesh that packing
rejects still takes this kernel here, with the same physics.

With `collect_residuals` ("primal" or True) the window's kernels also
compute each ADMM iteration's primal (and dual) residual, read after each
window into `last_primal` / `last_dual` (n_steps, admm_iters).

S scenarios of one mesh step together in the kernels' sweep mode:
`core/sweep.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import (Collision, Cylinder, ExplicitForce, Floor,
                      HyperElasticTet, LinearTetStrain, Sphere, StaticAnchor)
from ..ops.kernels._graph import WindowGraphs
from ..ops.kernels.banded_step import (STATE, BandedConfig, BandedWindow,
                                       banded_rollout, slot_planes)
from ..ops.kernels import mg as kmg
from ..ops.kernels import residuals, uamg as kuamg
from .mg import build_grid_mg
from .uamg import build_uamg
from .solver import _assemble_A_hat_csr, assemble_transpose_incidence


def collect_mode(collect_residuals):
    """A stepper's collect_residuals (False, "primal" or True) -> its
    kernels' collect mode (None, "primal" or "full")."""
    if collect_residuals is True:
        return "full"
    return "primal" if collect_residuals else None


def host_residuals(out):
    """(last_primal, last_dual) of a window's result: host copies, taken
    after the window, or None."""
    return tuple(None if k not in out else out[k].cpu().numpy()
                 for k in ("primal", "dual"))


class BandedStepper:
    """Whole-timestep ADMM stepper for a tet mesh on the dia or ell solver.

    Matches the System dia route for one `HyperElasticTet` (nh or stvk,
    per-element materials, `newton_iters` warm-started Newton iterations)
    or one `LinearTetStrain` (model 'arap', per-element k),
    StaticAnchors with per-node weights, an optional Collision of
    floor/sphere/cylinder shapes, all-node gravity kicks and `cg_iters`
    fixed PCG iterations per global solve. Arrays are numpy, in the
    System's vertex and element numbering. A_hat is given by its diagonals
    (dia_offs, dia_vals) or, with `ell=(idx, vals)` ((n,K) each) and
    dia_offs = (), dia_vals = None, in ELL form. The preconditioner is
    Jacobi, or with `mg` a multigrid V-cycle: a `core.mg.build_grid_mg`
    result (dia) or a `core.uamg.build_uamg` result (ELL).
    collect_residuals: False, "primal" or True, as the JAX stepper's;
    the residuals of the last step() or run() window are host arrays
    (n_steps, admm_iters) in last_primal (and last_dual).
    """

    ROLLOUT_WINDOW = 10

    def __init__(self, vertices, masses, tet_idx, tet_coeff, tet_w2,
                 tet_mu, tet_lam, tet_k, model, newton_iters,
                 anchor_idx, anchor_w2, anchor_pos,
                 dia_offs, dia_vals, diag, *,
                 gravity=(0.0, -9.8, 0.0), dt=0.04, admm_iters=10,
                 cg_iters=25, dtype=torch.float32, device="cuda",
                 coll_shapes=(), coll_w2=0.0, ell=None, mg=None,
                 collect_residuals=False):
        v = np.asarray(vertices, np.float64)
        n = len(v)
        idx = np.asarray(tet_idx, np.int64).reshape(-1, 4)
        E = len(idx)
        self.n_nodes, self.n_elements = n, E
        self.dtype, self.device = dtype, torch.device(device)
        self.model = str(model)
        self.cfg = BandedConfig(
            dia_offs=tuple(int(o) for o in dia_offs), model=self.model,
            newton_iters=int(newton_iters), cg_iters=int(cg_iters),
            admm_iters=int(admm_iters), dt=float(dt),
            gravity=tuple(float(g) for g in gravity),
            coll_shapes=tuple((str(k), tuple(float(q) for q in prm))
                              for k, prm in coll_shapes),
            coll_w2=float(coll_w2),
            ell_width=0 if ell is None else int(np.shape(ell[0])[1]),
            mg=(None if mg is None else kuamg.UAMGConfig.of(mg)
                if ell is not None else kmg.MGConfig.of(mg)),
        )
        self.collect_residuals = collect_residuals
        #: (n_steps, admm_iters) primal residuals of the last step()/run()
        #: window when collect_residuals is on (a host copy)
        self.last_primal = None
        #: (n_steps, admm_iters) dual residuals (collect_residuals=True)
        self.last_dual = None

        coeff = np.asarray(tet_coeff, np.float64).reshape(E, 3, 4)
        aw2 = np.zeros(n)
        anchor_idx = np.asarray(anchor_idx, np.int64).reshape(-1)
        np.add.at(aw2, anchor_idx, np.asarray(anchor_w2, np.float64))
        ancz = v.copy()
        ancz[anchor_idx] = np.asarray(anchor_pos, np.float64).reshape(-1, 3)
        inc, _ = assemble_transpose_incidence(n, {"tet": {"indices": idx}},
                                              ["tet"])

        def per_elem(a):
            return np.broadcast_to(np.asarray(a, np.float64), (E,))

        self.planes = {
            "idx": self._dev(idx.T, torch.int32),
            # cp[4b+k, e] = coeff[e, b, k]
            "cp": self._dev(np.transpose(coeff, (1, 2, 0)).reshape(12, E)),
            "w2": self._dev(per_elem(tet_w2)),
            "mu": self._dev(per_elem(tet_mu)),
            "lam": self._dev(per_elem(tet_lam)),
            "k": self._dev(per_elem(tet_k)),
            "mass": self._dev(np.broadcast_to(np.asarray(masses, np.float64),
                                              (n,))),
            "invd": self._dev(1.0 / np.asarray(diag, np.float64)),
            "aw2": self._dev(aw2),
            "ancz": self._dev(ancz),
            "inc": self._dev(inc, torch.int32),
        }
        # the incidence as the kernels read it
        self.planes["pos"], self.planes["off"] = slot_planes(
            self.planes["inc"], E)
        if ell is None:
            self.planes["dia"] = self._dev(dia_vals)
        else:
            self.planes["ell_idx"] = self._dev(ell[0], torch.int32)
            self.planes["ell_vals"] = self._dev(ell[1])
        #: the multigrid as its host builder returned it, None under Jacobi
        self.hierarchy = mg
        if mg is not None:
            self.planes.update((kmg if ell is None else kuamg).planes_from(
                mg, dtype, self.device))
            self.mg_levels = mg["levels"]
        self.state = {
            "x": self._dev(v),
            "v": self._dev(np.zeros((n, 3))),
            "u": self._dev(np.zeros((9, E))),
            "warm": self._dev(np.ones((3, E))),
            "au": self._dev(np.zeros((n, 3))),
            "cu": self._dev(np.zeros((n, 3))),
            "t": torch.zeros((), dtype=dtype, device=self.device),
        }
        self._graphs = WindowGraphs(BandedWindow, banded_rollout,
                                    (1, self.ROLLOUT_WINDOW))

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.array(a, order="C"),
                               dtype=dtype or self.dtype, device=self.device)

    @property
    def collect_residuals(self):
        return {None: False, "primal": "primal", "full": True}[
            self.cfg.collect]

    @collect_residuals.setter
    def collect_residuals(self, value):
        # a new cfg: the windows are captured anew, never replayed
        self.cfg = dataclasses.replace(self.cfg, collect=collect_mode(value))

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
            out = banded_rollout(state, self.planes, self.cfg, n_steps)
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


def banded_from_system(system):
    """A BandedStepper equivalent to an initialized dia- or ell-mode
    System, with its matrix in the same form, or None when the scene does
    not qualify.

    Qualifying (as the JAX package's banded_from_system): the dia or ell
    global mode, one HyperElasticTet (nh or stvk) or LinearTetStrain (the
    kernel's arap mode), StaticAnchors with any weights, at most one
    Collision over all nodes holding only Floor/Sphere/Cylinder, all-node
    ExplicitForce kicks, no residual_tol, collect_residuals False,
    "primal" or True (the kernel emits them), relaxation 1 and no
    acceleration (the kernel runs the plain alpha = 1 iteration): the
    functions that call this directly (`sweep_from_system`,
    `sharded_banded_from_system`) return None otherwise, as JAX's do. A
    `(first, rest)` cg_fixed_iters raises: the kernel takes one budget
    (the JAX stepper's int() of a tuple fails as well).

    Under preconditioner="amg" (default budget 8) the dia mode builds the
    geometric multigrid (`core.mg.build_grid_mg`) and returns None where
    the mesh is not a full grid in nested numbering; the ell mode builds
    the algebraic multigrid (`core.uamg.build_uamg`) and returns None
    where build_uamg raises, so System falls back to the general route's
    AMG, as the JAX package does.
    """
    s = system.settings
    # the residual-driven early exit needs the general route
    # (banded.py:584-589)
    if s.collect_residuals not in (False, None, True, "primal") or (
            s.residual_tol is not None):
        return None
    # the kernel runs the plain alpha = 1 iteration only (banded.py:590-591)
    if s.relaxation != 1.0 or s.acceleration is not None:
        return None
    if system._solver_mode not in ("dia", "ell"):
        return None
    tet, anchors, coll = None, [], None
    for f in system.forces:
        if isinstance(f, (HyperElasticTet, LinearTetStrain)):
            if tet is not None:
                return None
            tet = f
        elif type(f) is StaticAnchor:
            anchors.append(f)
        elif isinstance(f, Collision):
            if (coll is not None or f.n_nodes != system.n_nodes
                    or not all(isinstance(q, (Floor, Sphere, Cylinder))
                               for q in f.shapes)):
                return None
            coll = f
        else:
            return None
    if tet is None:
        return None
    gravity = np.zeros(3)
    for e in system.explicit_forces:
        if type(e) is not ExplicitForce or e.indices is not None:
            return None
        gravity = gravity + e.direction
    if isinstance(s.cg_fixed_iters, (tuple, list)):
        raise NotImplementedError(
            "the banded whole-timestep kernel runs one CG budget for every "
            f"ADMM iteration; cg_fixed_iters={s.cg_fixed_iters!r} is a "
            "(first, rest) schedule (the JAX stepper rejects it too). Give "
            "an int, or lattice_fast_path=False for the general route"
        )

    host = system._params_host
    p = host[tet.name]
    E = len(p["indices"])
    if isinstance(tet, LinearTetStrain):
        # the arap mode: the stiffness-weighted k per element, mu = lam = 1
        # and one (unused) Newton iteration, as the JAX package passes them
        model, mu, lam, newton_iters = "arap", np.ones(E), np.ones(E), 1
    else:
        model, mu, lam = tet.model, p["mu"], p["lam"]
        newton_iters = tet.max_iters
    anchor_idx = [np.asarray(host[a.name]["indices"]).ravel() for a in anchors]
    anchor_w2 = [np.asarray(host[a.name]["weight"], np.float64) ** 2
                 for a in anchors]
    anchor_pos = [np.asarray(host[a.name]["pos"]) for a in anchors]
    shapes = []
    for q in (coll.shapes if coll is not None else ()):
        if isinstance(q, Floor):
            shapes.append(("floor", (q.center[1],)))
        elif isinstance(q, Sphere):
            shapes.append(("sphere", (*q.center, q.radius)))
        else:
            shapes.append(("cylinder", (q.center[0], q.center[1], q.radius)))
    sv = host["_solver"]
    amg = s.preconditioner == "amg"
    if system._solver_mode == "ell":
        matrix = dict(dia_offs=(), dia_vals=None,
                      ell=(sv["ell_idx"], sv["ell_vals"]))
    else:
        matrix = dict(dia_offs=system._dia_offsets, dia_vals=sv["dia_vals"])
    if amg:
        cparams = {k: host[k] for k in system._constraint_names}
        A = _assemble_A_hat_csr(system.n_nodes, system._m, s.timestep_s,
                                cparams)
        if system._solver_mode == "ell":
            try:
                matrix["mg"] = build_uamg(A, system._x)
            except ValueError:
                return None  # System falls back to the general route's AMG
            kind = "algebraic multigrid"
        else:
            matrix["mg"] = build_grid_mg(A, system._x)
            if matrix["mg"] is None:
                return None  # System.initialize raises JAX's ValueError
            kind = "multigrid"
        if s.verbose:
            lv = matrix["mg"]["levels"]
            print(f"Solver: in-kernel {kind} engaged "
                  f"({lv[0]} -> {lv[1]} -> {lv[2]})")
    return BandedStepper(
        system._x, system._m, p["indices"], p["coeff"],
        np.asarray(p["weight"], np.float64) ** 2, mu, lam,
        p["k"], model, newton_iters,
        np.concatenate(anchor_idx or [np.zeros(0, np.int64)]),
        np.concatenate(anchor_w2 or [np.zeros(0)]),
        np.concatenate(anchor_pos or [np.zeros((0, 3))]),
        diag=sv["diag"], **matrix, gravity=tuple(gravity), dt=s.timestep_s,
        admm_iters=s.admm_iters,
        cg_iters=((8 if amg else 25) if s.cg_fixed_iters is None
                  else int(s.cg_fixed_iters)),
        dtype=s.dtype, device=s.device, coll_shapes=shapes,
        coll_w2=(coll.weight_value ** 2 if coll is not None else 0.0),
        collect_residuals=s.collect_residuals,
    )
