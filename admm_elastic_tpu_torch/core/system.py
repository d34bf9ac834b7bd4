"""The ADMM elastodynamics system: host-side builder + timestep.

Same API as `admm_elastic_tpu.core.system` (reference System.hpp:29-99):
`add_nodes`, `add_force`, `add_explicit_force`, `initialize`, `step`,
`run`, `pre_step_callbacks`. The timestep runs eagerly in PyTorch on
`Settings.device`:

    explicit forces kick velocities                System.cpp:37-39
    x_bar = x + dt v;   M x_bar                    System.cpp:46-47
    admm_iters times:                              System.cpp:51-67
      z, u  = per-element local step + dual update
      b     = M x_bar + dt^2 D^T W^2 (z - u)       (incidence gather)
      x     = global solve of A_hat x = b
    v = (x' - x)/dt                                System.cpp:70-71

The local step of a kernel-backed force runs fused (one kernel from the
gathered positions to the RHS rows) under the dia and ell modes with
relaxation 1, and otherwise unfused, as in the JAX package: D x, the
over-relaxation blend h = a D x + (1 - a) z_prev (z_prev starts at D x0),
the prox and dual update on h, then the RHS rows. Either way the rows are
summed per vertex through the fixed-order incidence gather (no atomics).

The global solve, in the JAX package's order: 'dense' (and 'auto' for up to
dense_max_nodes nodes) multiplies by A_hat^-1, inverted once at
initialize, plus dense_refine_steps rounds of residual correction; 'dia'
runs the dia CG kernel when A_hat fits MAX_DIAGONALS diagonals in the
caller's numbering, else falls back to 'ell'; 'ell' (any topology) runs,
with a fixed budget, the plain ELL PCG (`cg_backend="xla"`), the ELL matvec
plus one fused update kernel per iteration ("fused") or the whole solve in
the ELL CG kernel ("kernel"); 'cg' runs a matrix-free Jacobi PCG (A_hat
applied element by element). Under 'ell' and 'cg', `cg_fixed_iters=None`
means the tolerance-driven PCG.

With `Settings.lattice_fast_path=True` the whole timestep runs instead as
one kernel launch per rollout window, when the scene qualifies, tried in
the JAX package's order: tet scenes under 'dia' or 'ell' on the banded
kernel (`core/banded.py`, dia or ELL matvec), uniform beam lattices on the
lattice kernel (`core/lattice.py`), grid cloth on the cloth kernel
(`core/cloth.py`); any other scene steps the general route. Over-
relaxation disables the fast paths (the kernels run the plain iteration),
as in the JAX package.

Ported so far: every global mode, with kernel-backed hyperelastic and
corotational tets and triangle strain, bend hinges, anchors, collisions,
gravity and wind, relaxation, on the general route and the three
whole-timestep routes. Every other setting raises NotImplementedError
rather than running something else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..models.base import ForceBatch
from ..ops.kernels.cg_dia import MAX_DIAGONALS, cg_dia_solve
from ..ops.kernels.cg_ell import cg_ell_solve
from ..ops.kernels.cg_step import pcg_solve_fixed_fused
from .banded import banded_from_system
from .cloth import cloth_from_system
from .lattice import detect_grid_numbering, lattice_from_system
from .solver import (
    A_hat_apply,
    A_hat_diag,
    assemble_A_hat,
    assemble_A_hat_dia,
    assemble_A_hat_ell,
    assemble_transpose_incidence,
    dense_inverse,
    ell_apply,
    pcg_solve,
    pcg_solve_fixed,
    transpose_gather_apply,
)

GLOBAL_SOLVERS = ("auto", "dense", "cg", "ell", "dia")
CG_BACKENDS = ("xla", "fused", "kernel")


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
    #: 'auto' resolves as in the JAX package: 'dense' for n <=
    #: dense_max_nodes, else 'dia'. 'dia' falls back to 'ell' when A_hat
    #: has more than MAX_DIAGONALS diagonals; 'ell' takes any topology;
    #: 'cg' is matrix-free
    global_solver: str = "auto"
    dense_max_nodes: int = 4096
    #: 'dense': rounds of x += A_inv (b - A_hat x) after the product with
    #: the stored inverse (A_hat applied in ELL form), to recover accuracy
    #: a float32 inverse loses
    dense_refine_steps: int = 0
    #: relative residual tolerance and iteration cap of the
    #: tolerance-driven PCG, which 'ell' and 'cg' run when cg_fixed_iters
    #: is None
    cg_tol: float = 1e-10
    cg_max_iters: int = 250
    #: CG iterations per global solve; None means 25 under 'dia' and the
    #: tolerance-driven PCG under 'ell' and 'cg'. A tuple (first, rest)
    #: gives ADMM iteration 0, whose warm start is stale by the whole
    #: explicit kick, a deeper solve than the others
    cg_fixed_iters: int | tuple | None = None
    #: default backend for constraint batches built by the scene layer:
    #: 'xla' or 'pallas' (the scene layer is not ported yet, ROADMAP A7)
    local_backend: str = "xla"
    #: global-step PCG preconditioner: only 'jacobi' is ported ('amg', the
    #: in-kernel multigrid of the whole-timestep kernels, raises)
    preconditioner: str = "jacobi"
    #: 'ell' with a fixed budget: 'xla' (plain PyTorch PCG), 'fused' (ELL
    #: matvec + one cg_update kernel per iteration) or 'kernel' (the whole
    #: solve in the cg_ell kernel). Ignored under 'dia', as in JAX
    cg_backend: str = "xla"
    #: True runs whole timesteps in one kernel launch per rollout window
    #: where the scene qualifies, trying the JAX package's chain in order:
    #: the banded kernel (core/banded.py; a tet scene under 'dia' or
    #: 'ell', nh/stvk or arap), the lattice kernel (core/lattice.py; a
    #: uniform make_beam_tets beam in any vertex numbering under any mode,
    #: one uniform tet force, StaticAnchors of one weight, at most one
    #: Floor, gravity kicks), the cloth kernel (core/cloth.py; grid cloth).
    #: A scene that none takes steps the general route, with JAX's note at
    #: verbose >= 1. It raises only where the JAX package would engage a
    #: kernel or mode the port lacks: the cloth kernel after a grid or
    #: sym-plane renumbering, and a (first, rest) cg_fixed_iters on a
    #: kernel (which the JAX steppers reject too)
    lattice_fast_path: bool = False
    #: 'auto': a mesh that 'dia' rejects but whose positions form a regular
    #: grid is renumbered by the JAX package; the port raises there
    #: (ROADMAP 5c). 'none': straight to 'ell'
    reorder: str = "auto"
    # Settings of the JAX package that the port does not implement yet.
    # They keep the reference's defaults; any other value raises.
    relaxation: float = 1.0
    acceleration: str | None = None
    residual_tol: float | None = None
    collect_residuals: bool | str = False
    #: Anderson history depth m; inert while `acceleration` raises
    anderson_m: int = 5

    def parse_args(self, argv):
        """CLI parity with the reference: -dt, -v, -it, -help
        (System.cpp:182-208)."""
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-help":
                print(
                    "Args:\n\t-dt: time step (s)\n\t-v: verbosity"
                    "\n\t-it: # admm iters"
                )
            elif a == "-dt" and i + 1 < len(argv):
                self.timestep_s = float(argv[i + 1])
                i += 1
            elif a == "-v" and i + 1 < len(argv):
                self.verbose = int(argv[i + 1])
                i += 1
            elif a == "-it" and i + 1 < len(argv):
                self.admm_iters = int(argv[i + 1])
                i += 1
            i += 1
        return self

    def unsupported(self) -> list[str]:
        """Names of the settings that ask for an unported feature."""
        out = []
        if self.preconditioner != "jacobi":
            out.append(f"preconditioner={self.preconditioner!r} (only "
                       "'jacobi'; the in-kernel multigrid is ROADMAP B2/B9)")
        if self.acceleration is not None:
            out.append(f"acceleration={self.acceleration!r}")
        if self.residual_tol is not None:
            out.append(f"residual_tol={self.residual_tol}")
        if self.collect_residuals:
            out.append(f"collect_residuals={self.collect_residuals!r} "
                       "(ROADMAP A2 item 2d; in-kernel residuals B2)")
        return out

    def check(self) -> None:
        """Raise ValueError on a value that no version of the system takes."""
        for name, value, allowed in (
                ("global_solver", self.global_solver, GLOBAL_SOLVERS),
                ("cg_backend", self.cg_backend, CG_BACKENDS),
                ("reorder", self.reorder, ("auto", "none"))):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; one of {allowed}")


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
        # a whole-timestep stepper, and the caller's vertex id -> its own
        self._stepper = None
        self._to_canon = None

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
        s.check()
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
        cparams = self._cparams(params)
        params["_solver"] = self._assemble_solver(cparams)

        dtype = s.dtype
        self._params_host = params
        self.params = _to_device(params, dtype, device)
        sv = self.params["_solver"]
        if "ell_idx" in sv:
            # the ELL CG kernel and the banded kernel take int32 indices
            sv["ell_idx"] = torch.as_tensor(
                params["_solver"]["ell_idx"], dtype=torch.int32, device=device)
        self._masses_dev = torch.as_tensor(self._m, dtype=dtype, device=device)
        if self._solver_mode == "dense":
            sv["A_inv"] = dense_inverse(assemble_A_hat(n, self._m, dt, cparams),
                                        dtype, device)
        elif self._solver_mode == "cg":
            sv["diag"] = A_hat_diag(self._masses_dev, dt * dt,
                                    self._cparams(self.params), sv["inc_idx"])
        self.state = {
            "x": torch.as_tensor(self._x, dtype=dtype, device=device),
            "v": torch.zeros((n, 3), dtype=dtype, device=device),
            "t": torch.zeros((), dtype=dtype, device=device),
            "u": _to_device(u0, dtype, device),
            "forces": _to_device(state_forces, dtype, device),
        }
        # the zero row that the incidence's padding slots gather
        self._sentinel = torch.zeros((1, 3), dtype=dtype, device=device)

        if s.lattice_fast_path and s.relaxation != 1.0:
            # the whole-timestep kernels run the plain iteration only
            if s.verbose >= 1:
                print("Solver: relaxation active, whole-timestep fast paths "
                      "disabled (the general route honors it)")
        elif s.lattice_fast_path:
            self._route_fast_path()

        if s.verbose >= 1:
            shape = {"dia": lambda: f"{len(self._dia_offsets)} diagonals",
                     "ell": lambda: f"ELL width {sv['ell_idx'].shape[1]}",
                     "dense": lambda: f"inverse of {n} x {n}",
                     "cg": lambda: "matrix-free"}[self._solver_mode]()
            print(
                f"Solver::initialize: {n} nodes, {len(self.forces)} constraint "
                f"batches ({sum(f.n_elements for f in self.forces)} elements), "
                f"global solver = {self._solver_mode} ({shape}), "
                f"device = {device}"
            )
        self.initialized = True
        return True

    def _cparams(self, params):
        """The constraint forces' params, in the incidence's order."""
        return {k: params[k] for k in self._constraint_names}

    def _assemble_solver(self, cparams) -> dict:
        """Choose the global mode as the JAX package does and assemble its
        host arrays; sets `_solver_mode` ('dense', 'cg', 'dia' or 'ell').
        The dense inverse and the cg diagonal are made on the device in
        initialize()."""
        s = self.settings
        n, dt = self.n_nodes, s.timestep_s
        mode = s.global_solver
        if mode == "auto":
            mode = "dense" if n <= s.dense_max_nodes else "dia"
        sv = {}
        if mode == "dense" and s.dense_refine_steps > 0:
            sv["ell_idx"], sv["ell_vals"], _ = assemble_A_hat_ell(
                n, self._m, dt, cparams)
        if mode == "dia":
            dia = assemble_A_hat_dia(n, self._m, dt, cparams,
                                     max_diagonals=MAX_DIAGONALS)
            grid = (dia is None and s.reorder == "auto"
                    and detect_grid_numbering(self._x) is not None)
            if dia is not None:
                self._dia_offsets, sv["dia_vals"], sv["diag"] = dia
            elif grid:
                raise NotImplementedError(
                    f"A_hat has more than {MAX_DIAGONALS} diagonals in this "
                    "vertex numbering, and the vertices form a regular grid: "
                    "the JAX package would renumber them (reorder='auto'), "
                    "which is not ported (ROADMAP 5c). Pass reorder='none' "
                    "for the ell solver in this numbering")
            else:
                if s.verbose:
                    print("Solver: unstructured numbering, dia -> ell")
                mode = "ell"
        if mode == "ell":
            sv["ell_idx"], sv["ell_vals"], sv["diag"] = assemble_A_hat_ell(
                n, self._m, dt, cparams)
        self._solver_mode = mode
        sv["inc_idx"], _ = assemble_transpose_incidence(
            n, cparams, self._constraint_names)
        return sv

    def _route_fast_path(self):
        """Engage a whole-timestep kernel, tried in the JAX package's order
        (system.py:899-942): the banded kernel (dia and ell modes), then
        the lattice kernel, then the cloth kernel. A scene that none takes
        steps the general route, with JAX's note. Sets `_stepper` and
        `_to_canon` (the caller's vertex id -> the stepper's)."""
        stepper, to_canon = banded_from_system(self), np.arange(self.n_nodes)
        if stepper is None:
            stepper, to_canon = lattice_from_system(self) or (None, to_canon)
        if stepper is None:
            stepper = cloth_from_system(self)
        if stepper is None:
            if self.settings.verbose >= 1:
                print("Solver: scene does not qualify for a whole-timestep "
                      "fast path; using the general solver")
            return
        self._stepper, self._to_canon = stepper, to_canon
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

    def _solve(self, i, b, x, params):
        """The global solve of ADMM iteration i, warm-started at x, in the
        JAX package's order of branches."""
        s = self.settings
        sv = params["_solver"]
        mode = self._solver_mode
        if mode == "dense":
            # A_inv @ b is one product outside any kernel, as in the JAX
            # package (torch.matmul, full float32: TF32 stays off)
            x = sv["A_inv"] @ b
            for _ in range(s.dense_refine_steps):
                x = x + sv["A_inv"] @ (b - ell_apply(x, sv["ell_idx"],
                                                     sv["ell_vals"]))
            return x
        if mode == "dia":
            return cg_dia_solve(b, x, sv["diag"], sv["dia_vals"],
                                self._dia_offsets, self._cg_budget(i))
        if mode == "ell":
            def A(y):
                return ell_apply(y, sv["ell_idx"], sv["ell_vals"])
        else:
            dt2 = s.timestep_s ** 2
            cparams = self._cparams(params)

            def A(y):
                return A_hat_apply(y, self._masses_dev, dt2, cparams,
                                   sv["inc_idx"])

        if s.cg_fixed_iters is None:
            return pcg_solve(A, b, x, sv["diag"], s.cg_tol, s.cg_max_iters)[0]
        k = self._cg_budget(i)
        if mode == "ell" and s.cg_backend == "kernel":
            return cg_ell_solve(b, x, sv["diag"], sv["ell_idx"],
                                sv["ell_vals"], k)
        if mode == "ell" and s.cg_backend == "fused":
            return pcg_solve_fixed_fused(A, b, x, sv["diag"], k)
        return pcg_solve_fixed(A, b, x, sv["diag"], k)[0]

    def _step(self, state, params):
        dt = self.settings.timestep_s
        dt2 = dt * dt
        relax = float(self.settings.relaxation)
        masses = self._masses_dev
        x0, v = state["x"], state["v"]
        for e in self.explicit_forces:
            v = e.apply(dt, x0, v, masses, params[e.name])

        xbar = x0 + dt * v
        Mxbar = masses[:, None] * xbar
        u = dict(state["u"])
        fstate = dict(state["forces"])
        sv = params["_solver"]
        # the fused kernels consume x directly; the other modes and the
        # relaxation blend run the unfused per-force pipeline
        fused = self._solver_mode in ("dia", "ell") and relax == 1.0
        # z_prev of over-relaxation starts at D x0 (System.cpp:43)
        zprev = ({f.name: f.compute_Dx(params[f.name], x0)
                  for f in self.forces} if relax != 1.0 else None)

        curr_x = xbar
        for i in range(self.settings.admm_iters):
            contribs = []
            for f in self.forces:
                p = params[f.name]
                if fused and getattr(f, "supports_fused_local_rhs", False):
                    _, u[f.name], fstate[f.name], c = f.fused_local_rhs(
                        p, curr_x, u[f.name], fstate[f.name]
                    )
                else:
                    h = f.compute_Dx(p, curr_x)
                    if zprev is not None:
                        h = relax * h + (1.0 - relax) * zprev[f.name]
                    z, u[f.name], fstate[f.name] = f.project_with_dual(
                        h, u[f.name], p, fstate[f.name]
                    )
                    if zprev is not None:
                        zprev[f.name] = z
                    c = f.rhs_contribution(p, z, u[f.name])
                contribs.append(c)
            contribs.append(self._sentinel)
            # scatter-free RHS: per-element rows gathered through the
            # vertex incidence (fixed-order sum, no atomics)
            out = transpose_gather_apply(torch.cat(contribs, dim=0),
                                         sv["inc_idx"])
            b = Mxbar + dt2 * out
            curr_x = self._solve(i, b, curr_x, params)

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
            # the stepper's numbering -> the caller's
            return self._stepper.x[self._to_canon]
        return self.state["x"].cpu().numpy()

    @x.setter
    def x(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self._stepper is not None:
            xc = np.empty_like(value)
            xc[self._to_canon] = value
            self._stepper.set_positions(xc)
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
            return self._stepper.v[self._to_canon]
        return self.state["v"].cpu().numpy()

    @v.setter
    def v(self, value):
        if not self.initialized:
            raise RuntimeError("set velocities after initialize()")
        vv = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self._stepper is not None:
            vc = np.empty_like(vv)
            vc[self._to_canon] = vv
            self._stepper.set_velocities(vc)
            return
        self.state["v"] = torch.as_tensor(
            vv, dtype=self.settings.dtype, device=self.state["v"].device
        )

    @property
    def masses(self) -> np.ndarray:
        return self._m
