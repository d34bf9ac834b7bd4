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
`torch.distributed`) are the rest of ROADMAP A9, and the sharded
multigrid solve needs A6: those raise NotImplementedError. After runtime
edits of the System it was built from (`set_force_param`,
`recompute_weights`), `refresh_params` re-packs its planes from that System
and keeps its live state.
A base stepper that collects "primal" residuals makes this one collect
them too (B11's collect output, square-rooted: `last_primal`, (admm_iters,)
of the last step); True raises the JAX stepper's ValueError.

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
    dual) (n,3); u (9,E) and warm (3,E) element duals; t. On a card with
    the pallas backend the duals live in two sets of buffers that the
    ADMM iterations write in turn, so a state dict's duals hold until the
    next step (`detach` hands over copies). `axis` and `mg_cycles` keep
    the JAX signature and are ignored: at one device there is no mesh axis
    to shard over, and the multigrid (ROADMAP A6) that reads the other is
    not ported. `system`, the System the base was built from
    (`sharded_banded_from_system` records it), is what `refresh_params`
    re-packs from.
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
        if base.collect_residuals is True:
            raise ValueError(
                "sharded banded path collects 'primal' residuals only"
            )
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
        self._system = system
        self.cheb_iters = int(cheb_iters or base.cfg.cg_iters)
        self.model = base.model
        #: (admm_iters,) primal residuals of the last step (collect mode),
        #: a host copy
        self.last_primal = None
        self._adopt(base)
        self.state = {k: t.clone() for k, t in base.state.items()}
        #: on a card, the local phase's two sets of output buffers
        #: (`_local_out`), made at the first step
        self._sets = None

    def _adopt(self, base: BandedStepper):
        """Take the base stepper's planes and configuration: the scalars,
        and under 'cheb' the spectral bounds of its matrix (a host Lanczos
        from a fixed start, `parallel/cheb.py`) and their schedule."""
        self.base = base
        cfg = self.cfg = base.cfg
        self.dt = cfg.dt
        self.admm_iters = cfg.admm_iters
        self.cg_iters = cfg.cg_iters
        self.collect_residuals = bool(base.collect_residuals)
        if self.solver == "cheb":
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

    def _local_out(self, u):
        """On a card, the (b, au', cu', u', warm') buffers the next local
        phase writes: of the stepper's two sets, the one that does not hold
        its inputs (u among them), so that the ADMM iterations alternate
        between them and allocate nothing; else None (new tensors)."""
        if self.backend != "pallas" or u.device.type != "cuda":
            return None
        if self._sets is None:
            st = self.state
            self._sets = [tuple(torch.empty_like(st[k]) for k in (
                "x", "au", "cu", "u", "warm")) for _ in range(2)]
        return self._sets[1] if u is self._sets[0][3] else self._sets[0]

    def _timestep(self, st):
        cfg, planes = self.cfg, self.base.planes
        x, v = st["x"], st["v"]
        dt, dt2, inv_dt, dtg = self._scalars
        mass = planes["mass"][:, None]
        solve = self._cheb if self.solver == "cheb" else self._cg
        # gated by mass > 0, as the banded kernel's kick
        v = v + torch.where(mass > 0, dtg, 0.0)
        x_pre = x
        x = x_pre + dt * v
        mxbar = mass * x
        au, cu, u, warm = st["au"], st["cu"], st["u"], st["warm"]
        r2 = []
        for _ in range(self.admm_iters):
            if self.backend == "pallas":
                b, au, cu, u, warm, *sq = banded_local_rhs(
                    x, au, cu, u, warm, planes, cfg, self.collect_residuals,
                    out=self._local_out(u))
            else:
                b, au, cu, u, warm, *sq = banded_local_rhs_reference(
                    x, au, cu, u, warm, planes, cfg, self.collect_residuals)
            r2 += sq
            x = solve(x, mxbar + dt2 * b)
        out = {"x": x, "v": (x - x_pre) * inv_dt, "u": u, "warm": warm,
               "au": au, "cu": cu, "t": st["t"] + cfg.dt}
        if self.collect_residuals:
            # sqrt of the (at one device, un-reduced) sum of squares
            # (banded_spmd.py:1011-1014)
            self.last_primal = torch.sqrt(
                torch.stack(r2) if r2 else x.new_zeros((0,))).cpu().numpy()
        return out

    def step(self):
        self.state = self._timestep(self.state)
        return True

    def run(self, n_steps: int):
        """n_steps timesteps: ROLLOUT_WINDOW-step windows, each writing the
        state back once at its end as the JAX stepper's scanned window
        does, then the remainder one step at a time; a collecting stepper
        steps one at a time (last_primal is the last step's), as JAX's."""
        full, rem = divmod(int(n_steps), self.ROLLOUT_WINDOW)
        if self.collect_residuals:
            full, rem = 0, int(n_steps)
        for _ in range(full):
            self.state = self._advance(self.state, self.ROLLOUT_WINDOW)
        for _ in range(rem):
            self.step()
        return True

    def refresh_params(self):
        """After runtime force edits on the originating System
        (`set_force_param` + `recompute_weights()`, the poordillo release):
        re-pack the planes from the System without re-partitioning, keeping
        the live state, as the JAX stepper's refresh_params
        (banded_spmd.py:1101-1150). The structure must stay (AssertionError
        else: the partition, the matrix's diagonals or ELL columns); a
        weight edit moves the spectrum, so the Chebyshev bounds and
        schedule are made anew."""
        if self._system is None:
            raise ValueError(
                "refresh_params needs a System reference — build via "
                "sharded_banded_from_system")
        if self.D != 1:
            raise NotImplementedError(
                f"refresh_params over {self.D} devices: the port runs one "
                "device; the collectives over torch.distributed are the rest "
                "of ROADMAP A9")
        new = banded_from_system(self._system)
        assert new is not None, "scene no longer qualifies for the kernel"
        old = self.base
        assert (new.n_nodes, new.n_elements) == (old.n_nodes, old.n_elements)
        assert new.cfg.dia_offs == old.cfg.dia_offs
        assert new.cfg.ell_width == old.cfg.ell_width
        if old.cfg.matrix == "ell":
            # a weight edit that changes the pattern is a rebuild
            assert torch.equal(new.planes["ell_idx"], old.planes["ell_idx"])
        assert torch.equal(new.planes["inc"], old.planes["inc"])
        self._adopt(new)

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
