"""The port's twins of tests/test_hyper_oracle.py: the hyperelastic
end-to-end runs held to tests/reference_impl.py's scipy L-BFGS-B oracle
of the reference's local solve, with the port's System (dense mode, the
default element backend, f64 on the CPU) in place of the JAX package's and
the same one-sided bounds: the per-iteration primal and dual residuals at
most RATIO_HI times the oracle's, the trajectories within 0.05 m.

  * bunnyexpand-shaped: StVK, scrambled start (recovery from inversion),
    mu = lambda = 100, 5 local iterations, 10 ADMM iterations, dt 0.04
  * poordillo-shaped: NeoHookean, MovingAnchor grab -> drag -> release
    (weight -> 0, active False, recompute_weights), mu = lambda = 1e5,
    5 local iterations, dt 0.06
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

from admm_elastic_tpu_torch import Settings, System
from admm_elastic_tpu_torch.geometry import make_beam_tets
from admm_elastic_tpu_torch.models import (
    ExplicitForce,
    HyperElasticTet,
    MovingAnchor,
    StaticAnchor,
)

from reference_impl import (
    RefAnchor,
    RefHyperElastic,
    RefMovingAnchor,
    RefSystem,
)

torch.set_num_threads(1)

#: residual-trajectory bound vs the L-BFGS oracle, ONE-SIDED: the framework
#: must never converge meaningfully worse than the oracle (ratio <= 2), but
#: is allowed to converge better — near equilibrium the exact-Hessian Newton
#: drives residuals ~50x below 5-iteration L-BFGS (ratios ~0.02), which is
#: an improvement over the reference algorithm, not a mismatch
RATIO_HI = 2.0


def _ratios_ok(r_sys, r_ref, floor):
    """Elementwise one-sided ratio bound, ignoring entries below `floor`."""
    mask = (r_ref > floor) | (r_sys > floor)
    ratio = r_sys[mask] / np.maximum(r_ref[mask], 1e-300)
    return ratio.max() <= RATIO_HI, ratio


def test_torch_bunnyexpand_shaped_stvk_oracle():
    """StVK recovery-from-scramble: residual trajectories track the L-BFGS
    oracle within a factor of 2 over 12 steps."""
    beam = make_beam_tets(3, 2, 2)
    n = beam.n_vertices
    rng = np.random.default_rng(0)
    scrambled = beam.vertices + rng.uniform(-0.75, 0.75, beam.vertices.shape)

    ref = RefSystem(dt=0.04, iters=10)
    ref.setup(beam.vertices, np.full(n, 1.0 / n))
    for t in beam.tets:
        ref.forces.append(RefHyperElastic(t, 100.0, 100.0, 5, "stvk"))
    ref.initialize()
    ref.x = scrambled.reshape(-1).copy()

    sys = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                          dtype=torch.float64, device="cpu",
                          global_solver="dense", collect_residuals=True))
    sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    sys.add_force(HyperElasticTet(beam.tets, mu=100.0, lam=100.0,
                                  max_iters=5, model="stvk"))
    assert sys.initialize()
    sys.x = scrambled

    rp0 = None
    for step in range(12):
        rp_r, rd_r = ref.step(collect_residuals=True)
        sys.step()
        rp_s = np.asarray(sys.last_aux["primal_residual"])
        rd_s = np.asarray(sys.last_aux["dual_residual"])
        if rp0 is None:
            rp0 = rp_r[0]
        ok_p, ratio_p = _ratios_ok(rp_s, rp_r, 1e-8 * rp0)
        ok_d, ratio_d = _ratios_ok(rd_s, rd_r, 1e-8 * rp0)
        assert ok_p, f"step {step}: primal ratios {ratio_p}"
        assert ok_d, f"step {step}: dual ratios {ratio_d}"
        # trajectories drift only slowly apart (different local solvers)
        assert np.abs(sys.x.reshape(-1) - ref.x).max() < 0.05


def test_torch_poordillo_shaped_nh_grab_release_oracle():
    """NeoHookean grab/drag/release vs the oracle: the runtime weight-zeroing
    path (recompute_weights) and NH residual trajectories both match."""
    beam = make_beam_tets(3, 2, 2)
    n = beam.n_vertices
    masses = np.full(n, 2.0 / n)
    anchored = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
    tip = int(np.argmax(beam.vertices[:, 0]))
    grab_target = beam.vertices[tip] + np.array([0.5, 0.3, 0.0])

    mu = lam = 1e5

    ref = RefSystem(dt=0.06, iters=10)
    ref.setup(beam.vertices, masses)
    for i in anchored:
        ref.forces.append(RefAnchor(int(i)))
    for t in beam.tets:
        ref.forces.append(RefHyperElastic(t, mu, lam, 5, "nh"))
    ref_grab = RefMovingAnchor(tip, weight=1000.0)
    ref.forces.append(ref_grab)
    ref.gravity = np.array([0.0, -9.8, 0.0])
    ref.initialize()
    ref_grab.pos = grab_target.copy()

    sys = System(Settings(timestep_s=0.06, admm_iters=10, verbose=0,
                          dtype=torch.float64, device="cpu",
                          global_solver="dense", collect_residuals=True))
    sys.add_nodes(beam.vertices, masses)
    sys.add_force(StaticAnchor(anchored))
    sys.add_force(HyperElasticTet(beam.tets, mu=mu, lam=lam, max_iters=5,
                                  model="nh"))
    grab = sys.add_force(MovingAnchor([tip], weight=1000.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    sys.set_force_state(grab, "pos", grab_target[None, :])

    def compare(step):
        rp_r, rd_r = ref.step(collect_residuals=True)
        sys.step()
        rp_s = np.asarray(sys.last_aux["primal_residual"])
        rd_s = np.asarray(sys.last_aux["dual_residual"])
        floor = 1e-8 * rp_r[0]
        ok_p, ratio_p = _ratios_ok(rp_s, rp_r, floor)
        ok_d, ratio_d = _ratios_ok(rd_s, rd_r, floor)
        assert ok_p, f"step {step}: primal ratios {ratio_p}"
        assert ok_d, f"step {step}: dual ratios {ratio_d}"
        assert np.abs(sys.x.reshape(-1) - ref.x).max() < 0.05

    for step in range(6):  # dragged phase
        compare(step)
    # node was pulled toward the grab target in both
    assert abs(sys.x[tip, 0] - grab_target[0]) < 0.2

    # release (poordillo.cpp:190-215): weight -> 0, deactivate, recompute
    ref_grab.active = False
    ref_grab.w = 0.0
    ref.recompute_weights()
    sys.set_force_param(grab, "weight", np.array([0.0]))
    sys.set_force_state(grab, "active", np.array([False]))
    sys.recompute_weights()

    for step in range(6, 12):  # released phase
        compare(step)
    # elasticity pulled the tip back toward the anchored rest shape
    assert sys.x[tip, 0] < grab_target[0] - 0.05
