"""The sharded banded stepper, at one device.

Counterpart of `admm_elastic_tpu/parallel/banded_spmd.py`. The banded
whole-timestep kernel (`core/banded.py`) fuses every phase of every ADMM
iteration into one launch; the sharded stepper splits a timestep at the
ADMM iteration instead, so that each device could run the local phase on
its own elements and the global solve could exchange only halo rows:

    prologue     v += dt g where m > 0; x_pre = x; x += dt v; M xbar
    admm_iters x local phase (`ops/kernels/banded_local.py`, B11): element
                   prox, dual update, RHS rows, anchors and collisions
                 global solve of A x = M xbar + dt^2 b, warm-started at x:
                   'cg'   fixed-budget Jacobi-PCG (pAp > 0 and rz > 0
                          guards), summed in the order of the banded
                          route's solve (`cg_step.cluster_dot`): with the
                          'pallas' backend the banded route's own cluster
                          solve (`cg_dia_solve` / `cg_ell_solve`, one
                          launch a solve), else plain torch;
                   'cheb' the dot-free Chebyshev recurrence
                          (`parallel/cheb.py`): on a dia matrix with the
                          'pallas' backend one `cheb_dia_chunk` launch per
                          solve (B12), else the plain torch recurrence over
                          the dia or ELL matvec
    epilogue     v = (x - x_pre) / dt

This port runs one device (D = 1). There the JAX stepper's halo refresh
and RHS combine return at once, and its slab and chunk planes, pad chunks,
windows, lane permutations and `_positions` are TPU layout: the stepper
here works on its base `BandedStepper`'s arrays as they are, in the
System's vertex numbering. More devices (the collectives over
`torch.distributed`) are the rest of ROADMAP A9; the sharded multigrid
solve needs A6; residual collection is 2d and `refresh_params` 2e. Those
raise NotImplementedError.

`backend`: "pallas" (the default on a CUDA base) calls the kernel
wrappers, which launch their kernels on CUDA tensors and run their plain
twins on CPU tensors; "xla" (the default on a CPU base) runs the plain
torch composition, as the JAX stepper's xla backend does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.banded import BandedStepper, banded_from_system
from ..core.solver import dia_apply, pcg_fixed_inv
from ..ops.kernels.banded_local import (banded_local_rhs,
                                        banded_local_rhs_reference)
from ..ops.kernels.cg_dia import cg_dia_solve
from ..ops.kernels.cg_ell import cg_ell_solve, ell_apply_by_slot
from ..ops.kernels.cg_step import cluster_dot
from ..ops.kernels.cheb_dia import cheb_dia_chunk, cheb_recurrence
from .cheb import cheb_coefficients, dia_operator_bounds, ell_operator_bounds


def _one_device(mesh, base_device):
    """The one device of `mesh` (a sequence of torch devices; None: the
    base's), which must be the base's."""
    if mesh is None:
        return base_device
    devices = [torch.device(d) for d in mesh]
    if len(devices) != 1:
        raise NotImplementedError(
            f"ShardedBandedStepper over {len(devices)} devices: the port "
            "runs one device; the collectives over torch.distributed are "
            "the rest of ROADMAP A9")
    dev = devices[0]
    if dev.type != base_device.type or (
            dev.index is not None and base_device.index is not None
            and dev.index != base_device.index):
        raise ValueError(f"mesh device {dev} is not the base stepper's "
                         f"{base_device}")
    return base_device


class ShardedBandedStepper:
    """Step a `BandedStepper`'s scene as the sharded banded stepper does,
    at one device.

    Usage:
        out = sharded_banded_from_system(system, solver="cheb",
                                         cheb_iters=180)  # or None
        spmd, to_canonical = out
        spmd.run(10)
        x = spmd.x   # (n, 3) in the System's numbering

    `state` holds the base's keys: x, v, au (anchor dual), cu (collision
    dual) (n,3); u (9,E) and warm (3,E) element duals; t. `axis`,
    `mg_cycles` and `system` keep the JAX signature and are ignored: at
    one device there is no mesh axis to shard over, and the multigrid
    (ROADMAP A6) and `refresh_params` (ROADMAP 2e) that read the others
    are not ported.
    """

    model_name = "banded_spmd"
    #: steps per window of `run`, as the JAX stepper's scanned windows
    ROLLOUT_WINDOW = 10

    def __init__(self, base: BandedStepper, mesh=None, axis: str = "elem",
                 backend: str | None = None, solver: str = "cg",
                 cheb_iters: int | None = None, mg_cycles: int = 10,
                 system=None):
        if solver not in ("cg", "cheb", "mg"):
            raise ValueError(
                f"solver must be 'cg', 'cheb' or 'mg', got {solver}")
        if solver == "mg":
            raise NotImplementedError(
                "solver='mg': the sharded geometric multigrid is not ported "
                "(ROADMAP A6)")
        if getattr(base, "collect_residuals", False):
            raise NotImplementedError(
                "sharded banded residual collection is not ported "
                "(ROADMAP 2d)")
        self.device = _one_device(mesh, base.device)
        self.base = base
        self.mesh = mesh
        self.D = 1
        if backend is None:
            backend = "pallas" if base.device.type == "cuda" else "xla"
        if backend not in ("pallas", "xla"):
            raise ValueError(f"backend must be 'pallas' or 'xla', got "
                             f"{backend}")
        self.backend = backend
        self.solver = solver
        cfg = base.cfg
        self.cfg = cfg
        self.cheb_iters = int(cheb_iters or cfg.cg_iters)
        self.model = base.model
        self.dt = cfg.dt
        self.admm_iters = cfg.admm_iters
        self.cg_iters = cfg.cg_iters
        #: residuals are not collected (ROADMAP 2d)
        self.collect_residuals = False
        self.last_primal = None
        if solver == "cheb":
            p = base.planes
            if cfg.matrix == "ell":
                lmin, lmax = ell_operator_bounds(
                    p["ell_idx"].cpu().numpy(),
                    p["ell_vals"].double().cpu().numpy(),
                    1.0 / p["invd"].double().cpu().numpy())
            else:
                lmin, lmax = dia_operator_bounds(
                    p["dia"].double().cpu().numpy(), cfg.dia_offs)
            self.set_cheb_bounds(lmin, lmax)
        # dt, dt^2, 1/dt and dt g as the banded twin forms them, made once
        dt, dt2, inv_dt, *dtg, _ = (
            torch.tensor(q, dtype=base.dtype, device=base.device)
            for q in cfg.scalars())
        self._scalars = (dt, dt2, inv_dt, torch.stack(dtg))
        self.state = {k: t.clone() for k, t in base.state.items()}

    def set_cheb_bounds(self, lmin: float, lmax: float):
        """Adopt the spectral interval of D^-1 A (margins applied) and
        rebuild the Chebyshev schedule from it."""
        #: measured spectral interval of D^{-1}A (margins applied)
        self.cheb_bounds = (float(lmin), float(lmax))
        inv_theta, c1, c2 = cheb_coefficients(self.cheb_iters,
                                              *self.cheb_bounds)
        dev, dtype = self.base.device, self.base.dtype
        # an init-only schedule keeps one (unread) coefficient
        self._cheb_c = (float(inv_theta),
                        torch.as_tensor(c1 if len(c1) else np.zeros(1),
                                        dtype=dtype, device=dev),
                        torch.as_tensor(c2 if len(c2) else np.zeros(1),
                                        dtype=dtype, device=dev))

    # ------------------------------------------------------------ access

    @property
    def x(self) -> np.ndarray:
        return self.state["x"].cpu().numpy()

    @property
    def v(self) -> np.ndarray:
        return self.state["v"].cpu().numpy()

    # --------------------------------------------------------- stepping

    def _matvec(self, y):
        """A y, its terms added in the banded route's order."""
        p, cfg = self.base.planes, self.cfg
        if cfg.matrix == "ell":
            return ell_apply_by_slot(y, p["ell_idx"], p["ell_vals"])
        return dia_apply(y, cfg.dia_offs, p["dia"])

    def _cg(self, x, rhs):
        """Jacobi-PCG with the JAX stepper's guards (banded_spmd.py:
        785-806), in the banded route's order of sums: its cluster solve
        with the pallas backend, else plain torch."""
        p, cfg = self.base.planes, self.cfg
        if self.backend == "xla":
            return pcg_fixed_inv(self._matvec, rhs, x, p["invd"],
                                 self.cg_iters, dot=cluster_dot)
        if cfg.matrix == "ell":
            return cg_ell_solve(rhs, x, p["invd"], p["ell_idx"],
                                p["ell_vals"], self.cg_iters, inverse=True)
        return cg_dia_solve(rhs, x, p["invd"], p["dia"], cfg.dia_offs,
                            self.cg_iters, inverse=True)

    def _cheb(self, x, rhs):
        """The Chebyshev solve of cheb_iters iterations: one cheb_dia_chunk
        launch on a dia matrix with the pallas backend, else the plain
        recurrence."""
        inv_theta, c1, c2 = self._cheb_c
        kw = dict(n_it=self.cheb_iters - 1, first=True, last=True,
                  inv_theta=inv_theta)
        p = self.base.planes
        if self.backend == "pallas" and self.cfg.matrix == "dia":
            x, _, _ = cheb_dia_chunk(rhs, x, rhs, rhs, p["invd"], p["dia"],
                                     c1, c2, offsets=self.cfg.dia_offs, **kw)
            return x
        x, _, _ = cheb_recurrence(self._matvec, rhs, x, rhs, rhs, p["invd"],
                                  c1, c2, **kw)
        return x

    def _advance(self, st, n_steps):
        """n_steps timesteps from the state dict st; returns the new one."""
        for _ in range(n_steps):
            st = self._timestep(st)
        return st

    def _timestep(self, st):
        cfg, planes = self.cfg, self.base.planes
        x, v = st["x"], st["v"]
        dt, dt2, inv_dt, dtg = self._scalars
        mass = planes["mass"][:, None]
        local = (banded_local_rhs if self.backend == "pallas"
                 else banded_local_rhs_reference)
        solve = self._cheb if self.solver == "cheb" else self._cg
        # gated by mass > 0, as the banded kernel's kick
        v = v + torch.where(mass > 0, dtg, 0.0)
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        au, cu, u, warm = st["au"], st["cu"], st["u"], st["warm"]
        for _ in range(self.admm_iters):
            b, au, cu, u, warm = local(x, au, cu, u, warm, planes, cfg)
            x = solve(x, mxbar + dt2 * b)
        return {"x": x, "v": (x - x_pre) * inv_dt, "u": u, "warm": warm,
                "au": au, "cu": cu, "t": st["t"] + cfg.dt}

    def step(self):
        self.state = self._timestep(self.state)
        return True

    def run(self, n_steps: int):
        """n_steps timesteps: ROLLOUT_WINDOW-step windows, each writing the
        state back once at its end as the JAX stepper's scanned window
        does, then the remainder one step at a time."""
        full, rem = divmod(int(n_steps), self.ROLLOUT_WINDOW)
        for _ in range(full):
            self.state = self._advance(self.state, self.ROLLOUT_WINDOW)
        for _ in range(rem):
            self.step()
        return True

    def refresh_params(self):
        raise NotImplementedError(
            "ShardedBandedStepper.refresh_params: runtime force edits "
            "(set_force_param, recompute_weights) are not ported "
            "(ROADMAP 2e)")

    def detach(self):
        """Write the stepper's state (x, v, anchor and collision duals,
        element duals, t) back into the wrapped BandedStepper, which then
        steps on from here. Returns the base stepper."""
        self.base.state = {k: t.clone() for k, t in self.state.items()}
        return self.base


def sharded_banded_from_system(system, mesh=None, axis: str = "elem",
                               backend: str | None = None,
                               solver: str = "cg",
                               cheb_iters: int | None = None,
                               mg_cycles: int = 10):
    """A ShardedBandedStepper for an initialized dia- or ell-mode System
    whose scene qualifies for the banded whole-timestep kernel. Returns
    (stepper, to_canonical) or None, as `banded_from_system`; the port's
    stepper works in the System's numbering, so to_canonical is the
    identity."""
    base = banded_from_system(system)
    if base is None:
        return None
    spmd = ShardedBandedStepper(base, mesh, axis=axis, backend=backend,
                                solver=solver, cheb_iters=cheb_iters,
                                mg_cycles=mg_cycles, system=system)
    return spmd, np.arange(system.n_nodes)
