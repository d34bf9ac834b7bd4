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
as in the JAX package. `preconditioner="amg"` runs a multigrid in place
of the Jacobi preconditioner where the JAX package does: the banded or
cloth kernel's in-kernel geometric multigrid (dia, `core/mg.py`), the
banded kernel's in-kernel algebraic multigrid (ell, `core/uamg.py`), or
the general route's aggregation AMG (ell with the xla CG backend, and the
fallback where no in-kernel multigrid engages, `core/amg.py`).

Ported so far: every global mode, with kernel-backed hyperelastic and
corotational tets and triangle strain, bend hinges, anchors, collisions,
gravity and wind, relaxation, the per-iteration residuals
(`collect_residuals`, `residual_tol`, `last_aux`), on the general route
and the three whole-timestep routes. Every other setting raises
NotImplementedError rather than running something else.
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
from .amg import build_amg, levels_to_device, make_vcycle
from .banded import banded_from_system
from .cloth import cloth_from_system
from .lattice import detect_grid_numbering, lattice_from_system
from .solver import (
    _assemble_A_hat_csr,
    A_hat_apply,
    A_hat_diag,
    assemble_A_hat,
    assemble_A_hat_dia,
    assemble_A_hat_ell,
    assemble_transpose_incidence,
    dense_inverse,
    ell_apply,
    pcg_fixed_precond,
    pcg_solve,
    pcg_solve_fixed,
    pcg_solve_precond,
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
    #: 'auto' resolves as in the JAX package: 'dense' for n <=
    #: dense_max_nodes, else 'dia'. 'dia' falls back to 'ell' when A_hat
    #: has more than MAX_DIAGONALS diagonals; 'ell' takes any topology;
    #: 'cg' is matrix-free
    global_solver: str = "auto"
    dense_max_nodes: int = 4096
    #: relative residual tolerance and iteration cap of the
    #: tolerance-driven PCG, which 'ell' and 'cg' run when cg_fixed_iters
    #: is None
    cg_tol: float = 1e-10
    cg_max_iters: int = 250
    #: CG iterations per global solve; None means 25 under 'dia' (8 on the
    #: banded and 10 on the cloth kernel under preconditioner='amg') and
    #: the tolerance-driven PCG under 'ell' and 'cg'. A tuple (first, rest)
    #: gives ADMM iteration 0, whose warm start is stale by the whole
    #: explicit kick, a deeper solve than the others
    cg_fixed_iters: int | tuple | None = None
    #: default backend for constraint batches built by the scene layer:
    #: 'xla' or 'pallas' (the scene layer is not ported yet, ROADMAP A7)
    local_backend: str = "xla"
    #: 'ell' with a fixed budget: 'xla' (plain PyTorch PCG), 'fused' (ELL
    #: matvec + one cg_update kernel per iteration) or 'kernel' (the whole
    #: solve in the cg_ell kernel). Ignored under 'dia', as in JAX
    cg_backend: str = "xla"
    #: 'dense': rounds of x += A_inv (b - A_hat x) after the product with
    #: the stored inverse (A_hat applied in ELL form), to recover accuracy
    #: a float32 inverse loses
    dense_refine_steps: int = 0
    #: global-step PCG preconditioner: 'jacobi' (diagonal) or 'amg', as in
    #: the JAX package: with lattice_fast_path=True the in-kernel V-cycle
    #: of a whole-timestep kernel, geometric under 'dia' (the banded
    #: kernel on a full tet grid, the cloth kernel on a full triangle
    #: grid, both in nested numbering; core/mg.py) or algebraic under
    #: 'ell' (the banded kernel on a tet mesh of any topology;
    #: core/uamg.py); else, and where none engages, the general route's
    #: aggregation AMG on 'ell' with cg_backend='xla' (core/amg.py)
    preconditioner: str = "jacobi"
    #: per-ADMM-iteration residuals in `System.last_aux` (step: (iters,),
    #: run: (n_steps, iters)): "primal" the primal residual ||W(Dx - z)||,
    #: True also the dual residual ||dt^2 D^T W^2 (z - z_prev)||. The
    #: banded and cloth whole-timestep kernels compute them in their own
    #: kernels; the lattice kernel does not, so the scene steps elsewhere
    collect_residuals: bool | str = False
    #: stop the ADMM iterations of a step (on the device: later iterations
    #: change nothing) once the primal residual is at or under it. The
    #: whole-timestep kernels run every iteration, so the scene steps the
    #: general route
    residual_tol: float | None = None
    #: True runs whole timesteps in one kernel launch per rollout window
    #: where the scene qualifies, trying the JAX package's chain in order:
    #: the banded kernel (core/banded.py; a tet scene under 'dia' or
    #: 'ell', nh/stvk or arap), the lattice kernel (core/lattice.py; a
    #: uniform make_beam_tets beam in any vertex numbering under any mode,
    #: one uniform tet force, StaticAnchors of one weight, at most one
    #: Floor, gravity kicks; skipped under preconditioner='amg'), the
    #: cloth kernel (core/cloth.py; grid cloth). A scene that none takes
    #: steps the general route, with JAX's note at verbose >= 1. It raises
    #: only where the JAX package would engage a kernel or mode the port
    #: lacks: the cloth kernel after a grid or sym-plane renumbering, and a
    #: (first, rest) cg_fixed_iters on a kernel (which the JAX steppers
    #: reject too)
    lattice_fast_path: bool = False
    #: 'auto': a mesh that 'dia' rejects but whose positions form a regular
    #: grid is renumbered by the JAX package; the port raises there
    #: (ROADMAP 5c). 'none': straight to 'ell'
    reorder: str = "auto"
    relaxation: float = 1.0
    #: not ported yet (ROADMAP A7): any value but None raises
    acceleration: str | None = None
    #: Anderson history depth m; inert while `acceleration` raises
    anderson_m: int = 5
    #: where the state lives and the step runs; never changed silently.
    #: Not a JAX setting, so it comes last: positional arguments mean what
    #: they mean in the JAX package
    device: str = "cuda"

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
        if self.preconditioner not in ("jacobi", "amg"):
            out.append(f"preconditioner={self.preconditioner!r} (only "
                       "'jacobi' and 'amg')")
        if self.acceleration is not None:
            out.append(f"acceleration={self.acceleration!r}")
        return out

    def check(self) -> None:
        """Raise ValueError on a value that no version of the system takes."""
        for name, value, allowed in (
                ("global_solver", self.global_solver, GLOBAL_SOLVERS),
                ("cg_backend", self.cg_backend, CG_BACKENDS),
                ("reorder", self.reorder, ("auto", "none"))):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; one of {allowed}")
        # the JAX package's checks of its step (system.py:562-568)
        if self.acceleration not in (None, "anderson"):
            raise ValueError(f"unknown acceleration {self.acceleration!r}")
        if self.acceleration is not None and self.residual_tol is not None:
            raise ValueError(
                "acceleration and residual_tol cannot be combined"
            )


def _keep_if(done, old, new):
    """The carry `old` where the 0-dim bool `done` holds, else `new`, over
    nested tuples, dicts and None (torch.where per tensor)."""
    if isinstance(old, tuple):
        return tuple(_keep_if(done, o, n) for o, n in zip(old, new))
    if isinstance(old, dict):
        return {k: _keep_if(done, old[k], new[k]) for k in old}
    if old is None:
        return None
    return torch.where(done, old, new)


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
        amg_levels = None
        if s.preconditioner == "amg":
            mode = self._solver_mode
            # the JAX package's homes of the multigrid (system.py:438-457):
            # the banded and cloth kernels' in-kernel multigrid, tried when
            # the fast path routes, or the general route's algebraic one
            in_kernel = s.lattice_fast_path and mode in ("dia", "ell")
            if not in_kernel and (mode != "ell" or s.cg_backend != "xla"):
                raise ValueError(
                    "preconditioner='amg' needs global_solver='ell' with "
                    "cg_backend='xla' (general path), or "
                    "lattice_fast_path=True with global_solver='dia' "
                    "(in-kernel geometric MG on grid meshes) or 'ell' "
                    "(in-kernel algebraic MG, any topology)"
                )
            if not in_kernel:
                amg_levels = self._build_general_amg(cparams)

        dtype = s.dtype
        self._params_host = params
        self.params = _to_device(params, dtype, device)
        sv = self.params["_solver"]
        if "ell_idx" in sv:
            # the ELL CG kernel and the banded kernel take int32 indices
            sv["ell_idx"] = torch.as_tensor(
                params["_solver"]["ell_idx"], dtype=torch.int32, device=device)
        self._masses_dev = torch.as_tensor(self._m, dtype=dtype, device=device)
        if amg_levels is not None:
            sv["amg"] = amg_levels
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
        # (3 columns, or 6 with the dual residual's rows)
        self._sentinel = torch.zeros((1, 6), dtype=dtype, device=device)
        # the element steps' two sets of output buffers, by force, entry
        # and residual mode (_out)
        self._out_sets = {}

        if s.lattice_fast_path and s.relaxation != 1.0:
            # the whole-timestep kernels run the plain iteration only
            if s.verbose >= 1:
                print("Solver: relaxation active, whole-timestep fast paths "
                      "disabled (the general route honors it)")
        elif s.lattice_fast_path:
            self._route_fast_path()
        if (s.preconditioner == "amg" and "amg" not in sv
                and self._stepper is None):
            # an in-kernel candidate that did not engage: the JAX package
            # falls back to its general-path algebraic multigrid
            # (system.py:483-497), so 'amg' never runs on a Jacobi budget.
            # Under 'dia' (relaxation != 1 keeps the kernels off) JAX builds
            # it and its dia branch still runs the Jacobi cg_dia_solve;
            # the port does the same
            if s.cg_backend != "xla":
                raise ValueError(
                    "preconditioner='amg' fallback needs cg_backend='xla'"
                )
            sv["amg"] = self._build_general_amg(cparams, label="fallback")

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

    def _build_general_amg(self, cparams, label="hierarchy"):
        """The general route's aggregation-AMG hierarchy of A_hat
        (core/amg.py) as tensors on the device; sets the V-cycle
        `_amg_vcycle`."""
        s = self.settings
        A = _assemble_A_hat_csr(self.n_nodes, self._m, s.timestep_s, cparams)
        arrays, meta = build_amg(A)
        self._amg_vcycle = make_vcycle(meta)
        if s.verbose:
            sizes = " -> ".join(str(m["n"]) for m in meta)
            print(f"Solver: AMG {label} {sizes}")
        return levels_to_device(arrays, s.dtype, torch.device(s.device))

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
        the lattice kernel (not under preconditioner='amg': it has no
        multigrid), then the cloth kernel. A scene that none takes steps
        the general route, with JAX's note; under 'amg' with 'dia' it
        raises JAX's ValueError. Sets `_stepper` and `_to_canon` (the
        caller's vertex id -> the stepper's)."""
        amg = self.settings.preconditioner == "amg"
        stepper, to_canon = banded_from_system(self), np.arange(self.n_nodes)
        if stepper is None and not amg:
            stepper, to_canon = lattice_from_system(self) or (None, to_canon)
        if stepper is None:
            stepper = cloth_from_system(self)
        if stepper is None and amg and self._solver_mode == "dia":
            raise ValueError(
                "preconditioner='amg' with global_solver='dia' needs "
                "a whole-timestep kernel with in-kernel multigrid — "
                "the banded kernel on a full tet grid, or the cloth "
                "kernel on a full triangle grid, both in nested "
                "numbering (core/mg.py) — and the scene did not "
                "qualify; use global_solver='ell' for the "
                "general-path AMG instead"
            )
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

        if "amg" in sv:
            # the general route's AMG V-cycle (system.py:744-765)
            def M(r):
                return self._amg_vcycle(sv["amg"], r)

            if s.cg_fixed_iters is None:
                return pcg_solve_precond(A, M, b, x, s.cg_tol,
                                         s.cg_max_iters)[0]
            return pcg_fixed_precond(A, b, x, M, self._cg_budget(i))
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
        """One timestep from `state`; returns (new state, aux). aux holds
        the per-ADMM-iteration residuals, as the JAX package's step:
        "primal_residual" ||W (D x - z)|| by the dual-update identity D x
        - z = u' - u, and "dual_residual" ||dt^2 D^T W^2 (z - z_prev)||
        with z_prev starting at D x0 (System.cpp:64-65), each (admm_iters,)
        when collected, else (0,); the dual stays 0 unless
        collect_residuals is True. Under residual_tol every iteration after
        the one whose primal residual is at or under it is frozen on the
        device (x, duals, force state and residuals keep their values), so
        no iteration reads a value back to the host."""
        s = self.settings
        dt = s.timestep_s
        dt2 = dt * dt
        relax = float(s.relaxation)
        masses = self._masses_dev
        mode = self._solver_mode
        gathered = mode in ("dia", "ell")
        collect_dual = s.collect_residuals is True
        early_tol = s.residual_tol
        collect = bool(s.collect_residuals) or early_tol is not None
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
        fused = gathered and relax == 1.0
        # z_prev of over-relaxation starts at D x0 (System.cpp:43)
        zprev = ({f.name: f.compute_Dx(params[f.name], x0)
                  for f in self.forces} if relax != 1.0 else None)
        # the dual residual's carry: under dia and ell T z = sum_f D^T W^2 z
        # per vertex, from the RHS's own incidence gather of 6-wide rows;
        # else each force's z, whose difference is gathered on its own
        rc = None
        if collect_dual:
            z0 = {f.name: f.compute_Dx(params[f.name], x0)
                  for f in self.forces}
            rc = (self._gather([f.rhs_contribution(params[f.name],
                                                   z0[f.name],
                                                   torch.zeros_like(z0[f.name]))
                                for f in self.forces], 3)
                  if gathered else z0)
        iters = s.admm_iters
        rp = x0.new_zeros((iters if collect else 0,))
        rd = x0.new_zeros((iters if collect else 0,))
        if early_tol is not None:
            done = torch.zeros((), dtype=torch.bool, device=x0.device)

        curr_x = xbar
        for i in range(iters):
            contribs, z, new_u, new_fstate = [], {}, dict(u), dict(fstate)
            new_zprev = dict(zprev) if zprev is not None else None
            for f in self.forces:
                p = params[f.name]
                if fused and getattr(f, "supports_fused_local_rhs", False):
                    z[f.name], new_u[f.name], new_fstate[f.name], c = \
                        f.fused_local_rhs(p, curr_x, u[f.name],
                                          fstate[f.name], with_z=collect_dual,
                                          **self._out(f, "fused", curr_x, i,
                                                      iters, collect_dual))
                else:
                    h = f.compute_Dx(p, curr_x)
                    if zprev is not None:
                        h = relax * h + (1.0 - relax) * zprev[f.name]
                    z[f.name], new_u[f.name], new_fstate[f.name] = \
                        f.project_with_dual(h, u[f.name], p, fstate[f.name],
                                            **self._out(f, "project", curr_x,
                                                        i, iters))
                    if zprev is not None:
                        new_zprev[f.name] = z[f.name]
                    c = (f.rhs_contribution6 if collect_dual and gathered
                         else f.rhs_contribution)(p, z[f.name], new_u[f.name])
                contribs.append(c)
            # scatter-free RHS: per-element rows gathered through the
            # vertex incidence (fixed-order sum, no atomics)
            out = self._gather(contribs, 6 if collect_dual and gathered
                               else 3)
            b = Mxbar + dt2 * out[:, :3]
            new_x = self._solve(i, b, curr_x, params)
            new_rc = rc
            residuals = []
            if collect:
                # ||W (Dx - z)||^2 = sum_f w^2 ||u' - u||^2 (System.cpp:64)
                residuals.append((rp, torch.sqrt(sum(
                    (f.primal_piece(params[f.name], new_u[f.name], u[f.name])
                     for f in self.forces), x0.new_zeros(())))))
            if collect_dual:
                # ||dt^2 D^T W^2 (z - z_prev)|| (System.cpp:65)
                if gathered:
                    new_rc = out[:, 3:]
                    dual = dt2 * torch.linalg.norm(new_rc - rc)
                else:
                    new_rc = z
                    dual = torch.linalg.norm(dt2 * self._gather(
                        [f.rhs_contribution(params[f.name], z[f.name],
                                            rc[f.name])
                         for f in self.forces], 3))
                residuals.append((rd, dual))
            if early_tol is None:
                for res, value in residuals:
                    res[i] = value
                curr_x, u, fstate, zprev, rc = (new_x, new_u, new_fstate,
                                                new_zprev, new_rc)
                continue
            # the masked early exit (system.py:806-827): once done, an
            # iteration keeps every value of the carry, its residuals 0
            for res, value in residuals:
                res[i] = torch.where(done, res[i], value)
            curr_x, u, fstate, zprev, rc = _keep_if(
                done, (curr_x, u, fstate, zprev, rc),
                (new_x, new_u, new_fstate, new_zprev, new_rc))
            done = done | (rp[i] <= early_tol)

        new_state = {
            "x": curr_x,
            "v": (curr_x - x0) / dt,
            "t": state["t"] + dt,
            "u": u,
            "forces": fstate,
        }
        return new_state, {"primal_residual": rp, "dual_residual": rd}

    def _out(self, f, entry, x, i, iters, *args):
        """The out= argument of iteration i's element step `entry`
        ("fused": fused_local_rhs, "project": project_with_dual) of force
        f: where f takes output buffers (its `ENTRY_out_buffers(x,
        *args)`), one of two sets made once, in turn, so that an iteration
        writes the set its inputs are not in and allocates nothing; the
        last iteration writes new tensors, so that no buffer of a set
        leaves the step in its state."""
        make = getattr(f, f"{entry}_out_buffers", None)
        if make is None or i == iters - 1:
            return {}
        key = (f.name, entry, *args)
        sets = self._out_sets.get(key)
        if sets is None:
            sets = self._out_sets[key] = (make(x, *args), make(x, *args))
        return {"out": sets[i % 2]}

    def _gather(self, rows, width):
        """Per-vertex sums of the forces' rows (one (E*K, width) block per
        force, in the incidence's order) through the vertex incidence, with
        the zero sentinel row appended: a fixed-order sum, no atomics."""
        rows = [*rows, self._sentinel[:, :width]]
        return transpose_gather_apply(torch.cat(rows, dim=0),
                                      self.params["_solver"]["inc_idx"])

    # ----------------------------------------------------------- stepping

    def step(self):
        """One timestep; runs host callbacks first (System.cpp:29). Sets
        `last_aux`: the step's residuals, (admm_iters,) each (see _step);
        on a whole-timestep stepper only when it collects them."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        for cb in self.pre_step_callbacks:
            cb(self)
        if self._stepper is not None:
            self._stepper.step()
            self._stepper_aux(lambda r: r[0])
        else:
            self.state, self.last_aux = self._step(self.state, self.params)
        self.elapsed_s += self.settings.timestep_s
        return True

    def make_rollout(self, n_steps: int):
        """n_steps timesteps of the general route with no callbacks:
        returns rollout(state, params) -> (state, aux), aux's residuals
        stacked (n_steps, admm_iters)."""
        def rollout(state, params):
            auxes = []
            for _ in range(n_steps):
                state, aux = self._step(state, params)
                auxes.append(aux)
            return state, {k: torch.stack([a[k] for a in auxes])
                           if auxes else state["x"].new_zeros((0, 0))
                           for k in ("primal_residual", "dual_residual")}

        return rollout

    def run(self, n_steps: int):
        """Advance n_steps with no per-step callbacks. Sets `last_aux`: on
        the general route the steps' residuals stacked (n_steps,
        admm_iters); on a collecting stepper its last window's."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        if self._stepper is not None:
            self._stepper.run(n_steps)
            self._stepper_aux(lambda r: r)
        else:
            self.state, self.last_aux = self.make_rollout(n_steps)(
                self.state, self.params)
        self.elapsed_s += n_steps * self.settings.timestep_s
        return True

    def _stepper_aux(self, pick):
        """last_aux from a stepper's last_primal / last_dual, as the JAX
        package sets it (system.py:844-853, 877-887): nothing when the
        stepper collects no residuals."""
        primal = getattr(self._stepper, "last_primal", None)
        if primal is None:
            return
        self.last_aux = {"primal_residual": pick(primal)}
        dual = getattr(self._stepper, "last_dual", None)
        if dual is not None:
            self.last_aux["dual_residual"] = pick(dual)

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
