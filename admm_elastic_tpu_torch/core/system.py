"""The ADMM elastodynamics system: host-side builder + timestep.

Same API as `admm_elastic_tpu.core.system` (reference System.hpp:29-99):
`add_nodes`, `add_force`, `add_explicit_force`, `initialize`, `step`,
`run`, `pre_step_callbacks`. The timestep runs eagerly in PyTorch on
`Settings.device`:

    explicit forces kick velocities                System.cpp:37-39
    x_bar = x + dt v;   M x_bar                    System.cpp:46-47
    admm_iters times:                              System.cpp:51-67
      z, u  = per-element local step + dual update (fused kernel for tets)
      b     = M x_bar + dt^2 D^T W^2 (z - u)       (incidence gather)
      x     = fixed-budget Jacobi-PCG on A_hat     (dia kernel)
    v = (x' - x)/dt                                System.cpp:70-71

With `Settings.lattice_fast_path=True` the whole timestep runs instead as
one kernel launch per rollout window, when the scene qualifies: tet scenes
on the banded kernel (`core/banded.py`), grid cloth on the cloth kernel
(`core/cloth.py`); a scene that qualifies for neither raises.

Ported so far: the dia global solver with kernel-backed tets and
triangle strain, bend hinges, anchors, collisions, gravity and wind, on
the general route and the two whole-timestep routes. Every other setting
raises NotImplementedError rather than running something else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..models.base import ForceBatch
from ..ops.kernels.cg_dia import MAX_DIAGONALS, cg_dia_solve
from .banded import banded_from_system
from .cloth import cloth_from_system
from .solver import (
    assemble_A_hat_dia,
    assemble_transpose_incidence,
    transpose_gather_apply,
)


@dataclasses.dataclass
class Settings:
    """Solver settings (reference System::Settings, System.hpp:35-42)."""

    timestep_s: float = 0.04
    admm_iters: int = 10
    verbose: int = 1
    #: float32 on the card; float64 for parity runs against the reference
    dtype: torch.dtype = torch.float32
    #: where the state lives and the step runs; never changed silently
    device: str = "cuda"
    #: only 'dia' is ported
    global_solver: str = "dia"
    #: CG iterations per global solve (None means 25). A tuple
    #: (first, rest) gives ADMM iteration 0, whose warm start is stale by
    #: the whole explicit kick, a deeper solve than the others
    cg_fixed_iters: int | tuple | None = None
    #: global-step PCG preconditioner: only 'jacobi' is ported ('amg', the
    #: in-kernel multigrid of the whole-timestep kernels, raises)
    preconditioner: str = "jacobi"
    #: CG execution backend of the JAX package's ell mode; under 'dia' it
    #: is ignored there and here ('dia' always runs the dia CG kernel)
    cg_backend: str = "xla"
    #: True runs whole timesteps in one kernel launch per rollout window:
    #: the banded route (core/banded.py) for a tet scene, else the cloth
    #: route (core/cloth.py). A scene that neither kernel takes raises: the
    #: lattice fast path is not ported (ROADMAP B10), and the general route
    #: never runs in its place
    lattice_fast_path: bool = False
    # Settings of the JAX package that the port does not implement yet.
    # They keep the reference's defaults; any other value raises.
    reorder: str = "auto"
    relaxation: float = 1.0
    acceleration: str | None = None
    residual_tol: float | None = None
    collect_residuals: bool | str = False

    def unsupported(self) -> list[str]:
        """Names of the settings that ask for an unported feature."""
        out = []
        if self.global_solver != "dia":
            out.append(f"global_solver={self.global_solver!r} (only 'dia')")
        if self.preconditioner != "jacobi":
            out.append(f"preconditioner={self.preconditioner!r} (only "
                       "'jacobi'; the in-kernel multigrid is ROADMAP B2/B9)")
        if self.relaxation != 1.0:
            out.append(f"relaxation={self.relaxation}")
        if self.acceleration is not None:
            out.append(f"acceleration={self.acceleration!r}")
        if self.residual_tol is not None:
            out.append(f"residual_tol={self.residual_tol}")
        if self.collect_residuals:
            out.append(f"collect_residuals={self.collect_residuals!r} "
                       "(ROADMAP A2 item 2d; in-kernel residuals B2)")
        if self.reorder != "auto":
            out.append(f"reorder={self.reorder!r}")
        return out


def _to_device(tree, dtype, device):
    """numpy tree -> tensors: floats in `dtype`, integers as int64."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dtype, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, device=device)


class System:
    def __init__(self, settings: Settings | None = None):
        self.settings = settings or Settings()
        self.forces: list[ForceBatch] = []
        self.explicit_forces: list = []
        self.pre_step_callbacks: list[Callable[["System"], None]] = []
        self._x = np.zeros((0, 3), dtype=np.float64)
        self._m = np.zeros((0,), dtype=np.float64)
        self.initialized = False
        self.elapsed_s = 0.0
        self._stepper = None

    # ------------------------------------------------------------- building

    @property
    def n_nodes(self) -> int:
        return len(self._x)

    def add_nodes(self, x, masses) -> int:
        """Append nodes; accepts (n,3) or flat (3n,). Masses: (n,) or flat
        (3n,) with per-node replication. Returns total node count."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x.reshape(-1, 3)
        m = np.asarray(masses, dtype=np.float64)
        if m.ndim == 1 and m.shape[0] == 3 * x.shape[0]:
            m = m.reshape(-1, 3)[:, 0]
        if m.shape[0] != x.shape[0]:
            raise ValueError("masses/positions node count mismatch")
        self._x = np.concatenate([self._x, x], axis=0)
        self._m = np.concatenate([self._m, m], axis=0)
        return self.n_nodes

    def add_force(self, f: ForceBatch) -> ForceBatch:
        self.forces.append(f)
        return f

    def add_explicit_force(self, f) -> Any:
        self.explicit_forces.append(f)
        return f

    # --------------------------------------------------------- initialize

    def initialize(self) -> bool:
        s = self.settings
        bad = s.unsupported()
        if bad:
            raise NotImplementedError(
                "not ported yet (see ROADMAP.md): " + "; ".join(bad)
            )
        device = torch.device(s.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Settings.device is 'cuda' but no CUDA device is available; "
                "pass device='cpu' explicitly to run the plain versions"
            )
        if s.timestep_s <= 0.0:
            print(f"**Solver Error: timestep {s.timestep_s}s, changing to 0.04s")
            s.timestep_s = 0.04
        if self.n_nodes < 1:
            print("**Solver Error: Problem with node data!")
            return False
        dt = s.timestep_s
        n = self.n_nodes

        params: dict[str, Any] = {}
        state_forces: dict[str, Any] = {}
        u0: dict[str, Any] = {}
        for i, f in enumerate(self.forces):
            f.name = f"c{i}_{type(f).__name__}"
            p, st = f.build(self._x, self._m, dt)
            params[f.name] = p
            state_forces[f.name] = st
            u0[f.name] = f.dual_init()
        for i, e in enumerate(self.explicit_forces):
            e.name = f"e{i}_{type(e).__name__}"
            params[e.name] = e.build(n)

        self._constraint_names = [f.name for f in self.forces]
        cparams = {k: params[k] for k in self._constraint_names}
        dia = assemble_A_hat_dia(n, self._m, dt, cparams,
                                 max_diagonals=MAX_DIAGONALS)
        if dia is None:
            raise NotImplementedError(
                f"A_hat has more than {MAX_DIAGONALS} diagonals in this "
                "vertex numbering; the ell solver and grid renumbering are "
                "not ported yet (see ROADMAP.md)"
            )
        self._dia_offsets, dia_vals, diag = dia
        inc_idx, _ = assemble_transpose_incidence(n, cparams,
                                                  self._constraint_names)
        params["_solver"] = {"dia_vals": dia_vals, "diag": diag,
                             "inc_idx": inc_idx}

        dtype = s.dtype
        self._params_host = params
        self.params = _to_device(params, dtype, device)
        self.state = {
            "x": torch.as_tensor(self._x, dtype=dtype, device=device),
            "v": torch.zeros((n, 3), dtype=dtype, device=device),
            "t": torch.zeros((), dtype=dtype, device=device),
            "u": _to_device(u0, dtype, device),
            "forces": _to_device(state_forces, dtype, device),
        }
        self._masses_dev = torch.as_tensor(self._m, dtype=dtype, device=device)
        # the zero row that the incidence's padding slots gather
        self._sentinel = torch.zeros((1, 3), dtype=dtype, device=device)

        if s.lattice_fast_path:
            self._route_fast_path()

        if s.verbose >= 1:
            print(
                f"Solver::initialize: {n} nodes, {len(self.forces)} constraint "
                f"batches ({sum(f.n_elements for f in self.forces)} elements), "
                f"global solver = dia ({len(self._dia_offsets)} diagonals), "
                f"device = {device}"
            )
        self.initialized = True
        return True

    def _route_fast_path(self):
        """Engage a whole-timestep kernel, tried in the JAX package's order
        (the banded kernel, then the cloth kernel; the lattice kernel
        between them is not ported), or raise."""
        self._stepper = banded_from_system(self)
        if self._stepper is None:
            self._stepper = cloth_from_system(self)
        if self._stepper is None:
            raise NotImplementedError(
                "lattice_fast_path=True: the scene qualifies for neither "
                "the banded nor the cloth whole-timestep kernel, and the "
                "lattice fast path is not ported (ROADMAP B10); use "
                "lattice_fast_path=False for the general route"
            )
        if self.settings.verbose >= 1:
            print("Solver: whole-timestep fast path engaged "
                  f"(model={self._stepper.model})")

    # ----------------------------------------------------------- step fn

    def _cg_budget(self, i: int) -> int:
        fixed = self.settings.cg_fixed_iters
        if fixed is None:
            return 25
        if isinstance(fixed, (tuple, list)):
            return int(fixed[0]) if i == 0 else int(fixed[1])
        return int(fixed)

    def _step(self, state, params):
        dt = self.settings.timestep_s
        dt2 = dt * dt
        masses = self._masses_dev
        x0, v = state["x"], state["v"]
        for e in self.explicit_forces:
            v = e.apply(dt, x0, v, masses, params[e.name])

        xbar = x0 + dt * v
        Mxbar = masses[:, None] * xbar
        u = dict(state["u"])
        fstate = dict(state["forces"])
        sv = params["_solver"]

        curr_x = xbar
        for i in range(self.settings.admm_iters):
            contribs = []
            for f in self.forces:
                p = params[f.name]
                if getattr(f, "supports_fused_local_rhs", False):
                    _, u[f.name], fstate[f.name], c = f.fused_local_rhs(
                        p, curr_x, u[f.name], fstate[f.name]
                    )
                else:
                    Dx = f.compute_Dx(p, curr_x)
                    z, u[f.name], fstate[f.name] = f.project_with_dual(
                        Dx, u[f.name], p, fstate[f.name]
                    )
                    c = f.rhs_contribution(p, z, u[f.name])
                contribs.append(c)
            contribs.append(self._sentinel)
            # scatter-free RHS: per-element rows gathered through the
            # vertex incidence (fixed-order sum, no atomics)
            out = transpose_gather_apply(torch.cat(contribs, dim=0),
                                         sv["inc_idx"])
            b = Mxbar + dt2 * out
            curr_x = cg_dia_solve(b, curr_x, sv["diag"], sv["dia_vals"],
                                  self._dia_offsets, self._cg_budget(i))

        return {
            "x": curr_x,
            "v": (curr_x - x0) / dt,
            "t": state["t"] + dt,
            "u": u,
            "forces": fstate,
        }

    # ----------------------------------------------------------- stepping

    def step(self):
        """One timestep; runs host callbacks first (System.cpp:29)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        for cb in self.pre_step_callbacks:
            cb(self)
        if self._stepper is not None:
            self._stepper.step()
        else:
            self.state = self._step(self.state, self.params)
        self.elapsed_s += self.settings.timestep_s
        return True

    def run(self, n_steps: int):
        """Advance n_steps with no per-step callbacks."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        if self._stepper is not None:
            self._stepper.run(n_steps)
        else:
            for _ in range(n_steps):
                self.state = self._step(self.state, self.params)
        self.elapsed_s += n_steps * self.settings.timestep_s
        return True

    # ------------------------------------------------------------- access

    @property
    def x(self) -> np.ndarray:
        if not self.initialized:
            return self._x
        if self._stepper is not None:
            return self._stepper.x
        return self.state["x"].cpu().numpy()

    @x.setter
    def x(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self._stepper is not None:
            self._stepper.set_positions(value)
        elif self.initialized:
            self.state["x"] = torch.as_tensor(
                value, dtype=self.settings.dtype, device=self.state["x"].device
            )
        self._x = value

    @property
    def v(self) -> np.ndarray:
        if not self.initialized:
            return np.zeros_like(self._x)
        if self._stepper is not None:
            return self._stepper.v
        return self.state["v"].cpu().numpy()

    @v.setter
    def v(self, value):
        if not self.initialized:
            raise RuntimeError("set velocities after initialize()")
        vv = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self._stepper is not None:
            self._stepper.set_velocities(vv)
            return
        self.state["v"] = torch.as_tensor(
            vv, dtype=self.settings.dtype, device=self.state["v"].device
        )

    @property
    def masses(self) -> np.ndarray:
        return self._m
