"""The scenario sweep: `SweepStepper` and `sweep_from_system`.

Counterpart of `admm_elastic_tpu/core/sweep.py`: S independent
simulations of one tet mesh (varied materials, weights, anchor weights and
initial state), stepped together by the banded window's kernels in their
sweep mode (`ops/kernels/banded_step.py`, `BandedConfig.n_scen`): per
timestep the same 2 + 3 admm_iters launches as one simulation, each
kernel over every scenario, the solve one 16-CTA cluster a scenario, one
CUDA graph a window. Every scenario runs the single-scenario program on
its own state and planes, so it is bitwise the `BandedStepper` fed its
planes (`SweepStepper.scenario`).

The topology planes (idx, cp, mass, ancz, inc, the ELL indices) are
shared. Each scenario has its own tet w2, mu, lam, k, its anchor weights
(aw2), its global matrix (dia diagonals or ELL values) and D^-1, assembled
on the host by `parallel/scenarios.py` in the JAX package's order.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from ..models import HyperElasticTet, LinearTetStrain, StaticAnchor
from ..ops.kernels._graph import WindowGraphs
from ..ops.kernels.banded_step import (STATE, BandedWindow, banded_rollout,
                                       scenario_planes)
from ..parallel.scenarios import batched_A_values, sweep_w2_b
from .banded import BandedStepper, banded_from_system

__all__ = ["SweepStepper", "sweep_from_system"]


def _get_sweep(sweep, name, key, base, S, E):
    """Per-scenario (S, E) values of force `name`'s param `key`: the
    sweep's, else `base` for every scenario."""
    v = sweep.get((name, key))
    if v is None:
        return np.broadcast_to(np.broadcast_to(
            np.asarray(base, np.float64), (E,)), (S, E))
    v = np.asarray(v, np.float64)
    if v.ndim == 1:
        v = v[:, None]
    return np.broadcast_to(v, (S, E))


class SweepStepper(BandedStepper):
    """A `BandedStepper` over S scenarios: its state (x, v, u, warm, au, cu)
    and its swept planes (`banded_step.SWEPT`) carry a leading S axis,
    the shared planes are the base's. x and v are (S, n, 3) host arrays in
    the System's numbering; last_primal / last_dual (S, n_steps,
    admm_iters) with collect_residuals on."""

    model_name = "sweep"

    def __init__(self, base: BandedStepper, n_scen: int, swept: dict):
        S = int(n_scen)
        self.base, self.n_scen = base, S
        self.n_nodes, self.n_elements = base.n_nodes, base.n_elements
        self.dtype, self.device, self.model = base.dtype, base.device, \
            base.model
        self.dt = base.cfg.dt
        self.cfg = dataclasses.replace(base.cfg, n_scen=S)
        self.planes = {**base.planes, **{k: self._dev(a)
                                         for k, a in swept.items()}}
        self.state = {k: base.state[k].expand(S, *base.state[k].shape)
                      .contiguous() for k in STATE}
        self.state["t"] = base.state["t"].clone()
        self.last_primal = self.last_dual = None
        self._graphs = WindowGraphs(BandedWindow, banded_rollout,
                                    (1, self.ROLLOUT_WINDOW))

    def _per_scenario(self, value):
        value = np.asarray(value, np.float64)
        return np.broadcast_to(value, (self.n_scen, self.n_nodes, 3))

    def set_positions(self, value):
        """Overwrite positions, (S, n, 3) or (n, 3) for every scenario:
        copied into the state's own buffer, which the windows hold."""
        self.state["x"].copy_(self._dev(self._per_scenario(value)))

    def set_velocities(self, value):
        self.state["v"].copy_(self._dev(self._per_scenario(value)))

    def scenario(self, s: int) -> BandedStepper:
        """Scenario s as a single-scenario `BandedStepper`: the base's
        stepper on s's planes and a copy of s's state, with windows of its
        own."""
        one = copy.copy(self.base)
        one.cfg = dataclasses.replace(self.cfg, n_scen=None)
        one.planes = {k: t.clone() for k, t in
                      scenario_planes(self.planes, s).items()}
        one.state = {k: self.state[k][s].clone() for k in STATE}
        one.state["t"] = self.state["t"].clone()
        one.last_primal = one.last_dual = None
        one._graphs = WindowGraphs(BandedWindow, banded_rollout,
                                   (1, self.ROLLOUT_WINDOW))
        return one


def _one_device(mesh):
    if mesh is not None and len(list(mesh)) > 1:
        raise NotImplementedError(
            f"a sweep over {len(list(mesh))} devices: the port runs one "
            "device; sharding the scenarios over torch.distributed is part "
            "of ROADMAP A9")


def sweep_from_system(system, sweep, n_scenarios, x0=None, v0=None,
                      mesh=None, data_axis="data"):
    """A SweepStepper for `n_scenarios` variants of an initialized System
    that `banded_from_system` takes, or None where it does not.

    sweep: {(force name, key): (S,) or (S, E) values}: 'weight' of any
    constraint force (the tet's changes its local step and the global
    matrix; a StaticAnchor's its anchor weight and the matrix), and 'mu',
    'lam', 'k' of the tet force (arap: 'k'). x0 / v0: per-scenario
    initial positions / velocities (S, n, 3) or (n, 3), in the System's
    numbering. mesh: a sequence of devices; more than one raises
    (data_axis names the axis the JAX package shards over). A multigrid
    preconditioner raises (`BandedConfig`). Returns (stepper, cid), cid
    the identity: the port steps in the System's own numbering."""
    _one_device(mesh)
    S = int(n_scenarios)
    base = banded_from_system(system)
    if base is None:
        return None
    cfg = dataclasses.replace(base.cfg, n_scen=S)  # raises under the MG
    n = system.n_nodes
    w2_b = sweep_w2_b(system, sweep, S)
    A, vals, diag_b = batched_A_values(system, w2_b)
    swept = {"invd": 1.0 / np.where(diag_b > 0, diag_b, 1.0)}
    if cfg.matrix == "ell":
        deg = np.diff(A.indptr)
        row_of = np.repeat(np.arange(n), deg)
        pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
        swept["ell_vals"] = np.zeros((S, n, cfg.ell_width))
        swept["ell_vals"][:, row_of, pos] = vals
    else:
        offs = np.asarray(cfg.dia_offs)
        coo = A.tocoo()
        d_idx = np.searchsorted(offs, coo.col - coo.row)
        if not (offs[d_idx] == coo.col - coo.row).all():
            raise ValueError("an A_hat entry off the dia offsets")
        swept["dia"] = np.zeros((S, len(offs), n))
        swept["dia"][:, d_idx, coo.row] = vals

    host = system._params_host
    anchors = [f for f in system.forces if type(f) is StaticAnchor]
    if any((a.name, "weight") in sweep for a in anchors):
        aw2_b = np.zeros((S, n))
        for a in anchors:
            ap = host[a.name]
            aidx = np.asarray(ap["indices"], np.int64).ravel()
            w = _get_sweep(sweep, a.name, "weight",
                           np.asarray(ap["weight"], np.float64), S, len(aidx))
            np.add.at(aw2_b, (slice(None), aidx), w ** 2)
        swept["aw2"] = aw2_b
    else:
        swept["aw2"] = np.broadcast_to(base.planes["aw2"].cpu().numpy(),
                                       (S, n))

    tf = next(f for f in system.forces
              if isinstance(f, (HyperElasticTet, LinearTetStrain)))
    tp = host[tf.name]
    E = len(np.asarray(tp["indices"]))
    swept["w2"] = _get_sweep(sweep, tf.name, "weight", tp["weight"], S,
                             E) ** 2
    if base.model == "arap":
        swept["mu"] = swept["lam"] = np.ones((S, E))
    else:
        swept["mu"] = _get_sweep(sweep, tf.name, "mu", tp["mu"], S, E)
        swept["lam"] = _get_sweep(sweep, tf.name, "lam", tp["lam"], S, E)
    swept["k"] = _get_sweep(sweep, tf.name, "k", tp["k"], S, E)

    stepper = SweepStepper(base, S, swept)
    if x0 is not None:
        stepper.set_positions(x0)
    if v0 is not None:
        stepper.set_velocities(v0)
    return stepper, np.arange(n)
