"""The banded whole-timestep route: `BandedStepper` and `banded_from_system`.

Counterpart of `admm_elastic_tpu/core/banded.py` in dia mode with a
NeoHookean or StVK tet force. One kernel launch (`ops/kernels/
banded_step.py`) runs a whole window of timesteps: gravity kick, every ADMM
iteration's local steps and dual updates, anchors, collisions and the
fixed-budget Jacobi-PCG solves. Trajectories match the general `System`
route to round-off (tests/test_torch_banded.py).

The JAX stepper packs the mesh for the TPU: (Nr,128) lane planes, tets
sorted and packed into 128-lane sub-blocks with distinct scatter lanes
(`place_elements`), per-chunk vertex windows bounded by MAX_WR. None of it
is needed here. Element planes stay (P,E) in the tet force's own order,
vertex data (n,3), and the right-hand side is a fixed-order gather over the
vertex incidence (`core.solver.assemble_transpose_incidence`), so any mesh
whose global matrix fits the dia solver's diagonals qualifies, with no
window limit.

Out of this slice (raise or do not qualify, see ROADMAP.md): LinearTetStrain
'arap', in-kernel residuals, in-kernel multigrid, the uell (ell) mode and
scenario sweeps (B2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import (Collision, Cylinder, ExplicitForce, Floor,
                      HyperElasticTet, Sphere, StaticAnchor)
from ..ops.kernels.banded_step import BandedConfig, banded_rollout
from .solver import assemble_transpose_incidence


class BandedStepper:
    """Whole-timestep ADMM stepper for a tet mesh on the dia solver.

    Matches the System dia route for one `HyperElasticTet` (nh or stvk,
    per-element materials, `newton_iters` warm-started Newton iterations),
    StaticAnchors with per-node weights, an optional Collision of
    floor/sphere/cylinder shapes, all-node gravity kicks and `cg_iters`
    fixed Jacobi-PCG iterations per global solve. Arrays are numpy, in the
    System's vertex and element numbering.
    """

    ROLLOUT_WINDOW = 10

    def __init__(self, vertices, masses, tet_idx, tet_coeff, tet_w2,
                 tet_mu, tet_lam, tet_k, model, newton_iters,
                 anchor_idx, anchor_w2, anchor_pos,
                 dia_offs, dia_vals, diag, *,
                 gravity=(0.0, -9.8, 0.0), dt=0.04, admm_iters=10,
                 cg_iters=25, dtype=torch.float32, device="cuda",
                 coll_shapes=(), coll_w2=0.0):
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
        )

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
            "dia": self._dev(dia_vals),
            "inc": self._dev(inc, torch.int32),
        }
        self.state = {
            "x": self._dev(v),
            "v": self._dev(np.zeros((n, 3))),
            "u": self._dev(np.zeros((9, E))),
            "warm": self._dev(np.ones((3, E))),
            "au": self._dev(np.zeros((n, 3))),
            "cu": self._dev(np.zeros((n, 3))),
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
        new = banded_rollout(self.state, self.planes, self.cfg, n_steps)
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


def banded_from_system(system):
    """A BandedStepper equivalent to an initialized dia-route System, or
    None when the scene does not qualify.

    Qualifying (as the JAX package's banded_from_system): one
    HyperElasticTet (nh or stvk), StaticAnchors with any weights, at most
    one Collision over all nodes holding only Floor/Sphere/Cylinder,
    all-node ExplicitForce kicks. (Relaxation, acceleration and the
    other global modes never reach here: System.initialize rejects them.)
    A `(first, rest)` cg_fixed_iters raises: the kernel takes one budget
    (the JAX stepper's int() of a tuple fails as well).
    """
    s = system.settings
    tet, anchors, coll = None, [], None
    for f in system.forces:
        if isinstance(f, HyperElasticTet):
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
    return BandedStepper(
        system._x, system._m, p["indices"], p["coeff"], p["w2"], p["mu"],
        p["lam"], p["k"], tet.model, tet.max_iters,
        np.concatenate(anchor_idx or [np.zeros(0, np.int64)]),
        np.concatenate(anchor_w2 or [np.zeros(0)]),
        np.concatenate(anchor_pos or [np.zeros((0, 3))]),
        system._dia_offsets, sv["dia_vals"], sv["diag"],
        gravity=tuple(gravity), dt=s.timestep_s, admm_iters=s.admm_iters,
        cg_iters=25 if s.cg_fixed_iters is None else int(s.cg_fixed_iters),
        dtype=s.dtype, device=s.device, coll_shapes=shapes,
        coll_w2=(coll.weight_value ** 2 if coll is not None else 0.0),
    )
