"""The port's scenario sweep (`core/sweep.py`, the banded window's sweep
mode) against the JAX package's on the CPU, f64.

The JAX sweeps run once each (module-scoped) in interpret mode, as
tests/test_sweep_kernel.py runs them, on its 4 x 3 x 3 jittered beam with
3 stiffness scenarios. One JAX dia sweep carries the default-run
comparisons: x and v of every scenario after 4 steps at the banded
tolerance (tests/test_torch_banded.py), a per-scenario x0, and both
residuals. The port's ELL sweep and its arap sweep with swept anchor
weights are held to the port's own single-scenario routes here, and to the
JAX sweeps under the `slow` mark (each JAX sweep compiles for ~20 s). The
twin's scenarios are held bitwise to the single twin fed their planes, the
per-scenario matrices to JAX's at 1e-12, and the errors are JAX's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core.sweep import sweep_from_system as jax_sweep
from admm_elastic_tpu.parallel import scenarios as jax_scenarios
from admm_elastic_tpu_torch.core.sweep import SweepStepper, sweep_from_system
from admm_elastic_tpu_torch.ops.kernels import banded_step
from admm_elastic_tpu_torch.parallel import scenarios
from admm_elastic_tpu_torch.utils import opcount
from admm_elastic_tpu_torch.utils.scenes import (jittered_beam, small_mg_beam,
                                                 stiffness_sweep)

X_TOL = dict(rtol=1e-6, atol=1e-8)
V_TOL = dict(rtol=1e-5, atol=1e-7)
MUS = np.array([4e3, 1e4, 3e4])
STEPS = 4


def build(pkg, mesh, *, solver="dia", model="nh", mu=1e4, lam=2.5e4,
          anchor_w=1000.0, collect=False, fast=False):
    """tests/test_sweep_kernel.py build_system, for `pkg` in (aet, pt)."""
    n = mesh.n_vertices
    if pkg is aet:
        s = aet.System(aet.Settings(
            timestep_s=0.04, admm_iters=6, verbose=0, dtype=jnp.float64,
            global_solver=solver, dense_max_nodes=0, cg_fixed_iters=20,
            collect_residuals=collect, lattice_fast_path=fast))
    else:
        s = pt.System(pt.Settings(
            timestep_s=0.04, admm_iters=6, verbose=0, dtype=torch.float64,
            device="cpu", global_solver=solver, cg_fixed_iters=20,
            collect_residuals=collect, lattice_fast_path=fast))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    m = pkg.models
    if model == "arap":
        s.add_force(m.LinearTetStrain(mesh.tets, mu, backend="pallas"))
    else:
        s.add_force(m.HyperElasticTet(mesh.tets, mu=mu, lam=lam, max_iters=4,
                                      model=model, backend="pallas"))
    s.add_force(m.StaticAnchor([0, 1], weight=anchor_w))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def x0_of(mesh):
    """Scenario 1 starts perturbed, the others at rest."""
    rng = np.random.RandomState(0)
    x0 = np.repeat(mesh.vertices[None], len(MUS), axis=0)
    x0[1] = x0[1] + 0.02 * rng.randn(*mesh.vertices.shape)
    return x0


def run_both(pkg, mesh, sweep_of, steps=STEPS, **kw):
    """(x, v, last_primal, last_dual) of the sweep of `pkg` after `steps`
    single steps, x and v in the System's numbering. sweep_of(port System)
    gives the sweep dict, whose force names are the same in both
    packages."""
    system = kw.pop("system", {})
    s = build(pkg, mesh, **system)
    sweep = sweep_of(s if pkg is pt else build(pt, mesh, **system))
    stepper, cid = (jax_sweep if pkg is aet else sweep_from_system)(
        s, sweep, len(MUS), **kw)
    for _ in range(steps):
        stepper.step()
    return tuple(None if a is None else np.asarray(a) for a in (
        np.asarray(stepper.x)[:, cid], np.asarray(stepper.v)[:, cid],
        stepper.last_primal, stepper.last_dual))


def nh_sweep(s):
    return stiffness_sweep(s, MUS)


def arap_anchor_sweep(s):
    sweep = stiffness_sweep(s, np.full(3, 1e4), "arap")
    sweep[(s.forces[1].name, "weight")] = np.array([1000.0, 10.0, 1e-6])
    return sweep


@pytest.fixture(scope="module")
def mesh():
    return jittered_beam()


@pytest.fixture(scope="module")
def dia_runs(mesh):
    """The dia nh sweep with a per-scenario x0, collecting both residuals,
    through either package."""
    kw = dict(system={"collect": True}, x0=x0_of(mesh))
    return {pkg: run_both(pkg, mesh, nh_sweep, **kw) for pkg in (aet, pt)}


def test_sweep_matches_jax_dia(dia_runs):
    """x and v of every scenario after 4 steps, dia, nh."""
    (jx, jv, _, _), (px, pv, _, _) = dia_runs[aet], dia_runs[pt]
    np.testing.assert_allclose(px, jx, **X_TOL)
    np.testing.assert_allclose(pv, jv, **V_TOL)
    assert np.abs(px[0] - px[-1]).max() > 1e-4  # the sweep acts


def test_sweep_per_scenario_x0(dia_runs, mesh):
    """x0 is each scenario's start, and scenario 1's perturbed start
    follows JAX's trajectory."""
    jx, px = dia_runs[aet][0], dia_runs[pt][0]
    np.testing.assert_allclose(px[1], jx[1], **X_TOL)
    s = build(pt, mesh)
    sw = sweep_from_system(s, nh_sweep(s), 3, x0=x0_of(mesh),
                           v0=np.ones(3))[0]
    np.testing.assert_array_equal(sw.x, x0_of(mesh))
    np.testing.assert_array_equal(sw.v, np.ones((3, mesh.n_vertices, 3)))


def test_sweep_residuals_match_jax(dia_runs):
    """collect_residuals=True: last_primal and last_dual (S, 1,
    admm_iters) of the last step, against JAX's."""
    (_, _, jp, jd), (_, _, pp, pd) = dia_runs[aet], dia_runs[pt]
    assert pp.shape == jp.shape == (3, 1, 6)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-9)


def test_sweep_primal_mode(mesh):
    """collect_residuals="primal": the primal residuals of the full mode,
    no dual, and the state of the sweep without collection, bitwise."""
    runs = {c: run_both(pt, mesh, nh_sweep, steps=1,
                        system={"collect": c})
            for c in (False, "primal", True)}
    x, v, rp, rd = runs["primal"]
    assert rd is None and rp.shape == (3, 1, 6)
    np.testing.assert_array_equal(rp, runs[True][2])
    for got in (runs[False], runs[True]):
        np.testing.assert_array_equal(x, got[0])
        np.testing.assert_array_equal(v, got[1])


@pytest.mark.parametrize("solver", ["ell", "dia"])
def test_sweep_matches_single_scenario_routes(mesh, solver):
    """Each scenario against the port's own banded route of a System built
    with that scenario's stiffness (its matrix assembled by the System, so
    to round-off), in either matrix form, 2 steps."""
    px = run_both(pt, mesh, nh_sweep, steps=2, system={"solver": solver})[0]
    for i, mu in enumerate(MUS):
        s = build(pt, mesh, solver=solver, mu=mu, lam=2.5 * mu, fast=True)
        assert s._stepper is not None
        for _ in range(2):
            s.step()
        np.testing.assert_allclose(px[i], s.x, **X_TOL)


def test_sweep_arap_anchor_weights(mesh):
    """An arap sweep with swept anchor weights (the last all but released)
    against the port's general route of each scenario, 3 steps."""
    px = run_both(pt, mesh, arap_anchor_sweep, steps=3,
                  system={"model": "arap", "mu": 1e4})[0]
    for i, aw in enumerate([1000.0, 10.0, 1e-6]):
        s = build(pt, mesh, model="arap", mu=1e4, anchor_w=aw)
        for _ in range(3):
            s.step()
        np.testing.assert_allclose(px[i], s.x, **X_TOL)
    assert px[2][:, 1].mean() < px[0][:, 1].mean() - 1e-3  # released falls


@pytest.mark.slow
@pytest.mark.parametrize("case", ["ell nh", "dia arap anchors"])
def test_sweep_matches_jax_slow(mesh, case):
    """The ELL sweep and the arap sweep with swept anchor weights against
    JAX's sweeps (interpret mode, ~20 s each)."""
    if case == "ell nh":
        kw = dict(system={"solver": "ell"})
        sweep_of = nh_sweep
    else:
        kw = dict(system={"model": "arap", "mu": 1e4})
        sweep_of = arap_anchor_sweep
    (jx, jv, _, _), (px, pv, _, _) = (run_both(pkg, mesh, sweep_of, **kw)
                                      for pkg in (aet, pt))
    np.testing.assert_allclose(px, jx, **X_TOL)
    np.testing.assert_allclose(pv, jv, **V_TOL)


@pytest.mark.parametrize("solver", ["dia", "ell"])
def test_twin_scenarios_are_the_single_twin(mesh, solver):
    """The sweep twin (f64, collecting both residuals, 1 step): each
    scenario torch.equal to the single-scenario twin fed its planes."""
    s = build(pt, mesh, solver=solver, collect=True)
    sw = sweep_from_system(s, nh_sweep(s), 3)[0]
    got = banded_step.banded_rollout(sw.state, sw.planes, sw.cfg, 1)
    for i in range(3):
        one = sw.scenario(i)
        want = banded_step.banded_rollout(one.state, one.planes, one.cfg, 1)
        for k in (*banded_step.STATE, "primal", "dual"):
            assert torch.equal(got[k][i], want[k]), (i, k)


@pytest.mark.parametrize("case", ["tet weight", "anchor weight"])
def test_batched_matrices_match_jax(mesh, case):
    """sweep_w2_b and batched_A_values against JAX's at 1e-12: the tet
    weights swept, or the anchor weights."""
    js, ps = build(aet, mesh), build(pt, mesh)
    sweep = nh_sweep(ps)
    if case == "anchor weight":
        sweep = {(ps.forces[1].name, "weight"): np.array([1e3, 10.0, 0.0])}
    jw, pw = (m.sweep_w2_b(s, sweep, 3)
              for m, s in ((jax_scenarios, js), (scenarios, ps)))
    np.testing.assert_allclose(pw, jw, rtol=1e-12, atol=0)
    (ja, jv, jd), (pa, pv, pd) = (m.batched_A_values(s, jw) for m, s in (
        (jax_scenarios, js), (scenarios, ps)))
    assert (pa.indptr == ja.indptr).all() and (pa.indices == ja.indices).all()
    np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=0)
    np.testing.assert_allclose(pd, jd, rtol=1e-12, atol=0)


def test_sweep_api(mesh):
    """The stepper's shapes and setters: x, v (S, n, 3); an (n, 3) value
    set for every scenario; run(3) in windows of 2 = a window and a step;
    cid the identity; a scene the banded route does not take gives
    None."""
    s = build(pt, mesh)
    sw, cid = sweep_from_system(s, stiffness_sweep(s, MUS[:2]), 2)
    assert isinstance(sw, SweepStepper) and sw.cfg.n_scen == 2
    n = mesh.n_vertices
    assert sw.x.shape == sw.v.shape == (2, n, 3)
    np.testing.assert_array_equal(cid, np.arange(n))
    sw.set_positions(mesh.vertices + 0.01)
    np.testing.assert_array_equal(sw.x, np.broadcast_to(mesh.vertices + 0.01,
                                                        (2, n, 3)))
    start = {k: sw.state[k].clone() for k in banded_step.STATE}
    sw.ROLLOUT_WINDOW = 2
    sw.run(3)
    want = start
    for steps in (2, 1):
        want = banded_step.banded_rollout_reference(want, sw.planes, sw.cfg,
                                                    steps)
    for k in banded_step.STATE:
        assert torch.equal(sw.state[k], want[k]), k
    assert float(sw.state["t"]) == pytest.approx(3 * 0.04)
    dense = pt.System(pt.Settings(global_solver="dense", device="cpu",
                                  dtype=torch.float64, verbose=0))
    dense.add_nodes(mesh.vertices, np.full(n, 1.0))
    dense.add_force(pt.models.HyperElasticTet(mesh.tets, mu=1e4, lam=1e4,
                                              backend="pallas"))
    assert dense.initialize()
    assert sweep_from_system(dense, {}, 2) is None


def test_sweep_errors(mesh):
    """The multigrid under a sweep raises (BandedConfig, and through
    sweep_from_system), as a mesh of more than one device does."""
    s = build(pt, mesh)
    with pytest.raises(NotImplementedError, match="A9"):
        sweep_from_system(s, nh_sweep(s), 3, mesh=["cpu", "cpu"])
    mg_sys = small_mg_beam(device="cpu")
    assert mg_sys._stepper.cfg.mg is not None
    with pytest.raises(NotImplementedError, match="multigrid"):
        sweep_from_system(mg_sys, {}, 2)
    with pytest.raises(NotImplementedError, match="multigrid"):
        dataclasses.replace(mg_sys._stepper.cfg, n_scen=2)
    with pytest.raises(ValueError, match="n_scen"):
        dataclasses.replace(sweep_from_system(s, {}, 1)[0].cfg, n_scen=0)


def test_sweep_counts(mesh):
    """The sweep window's operations are S times one scenario's, its bytes
    the per-scenario state and planes S times and the shared planes
    once."""
    s = build(pt, mesh)
    sw = sweep_from_system(s, nh_sweep(s), 3)[0]
    cfg = dataclasses.replace(sw.cfg, admm_iters=1)
    ops, nbytes = opcount.sweep_counts(sw.state, sw.planes, cfg, 1)
    one = sw.scenario(0)
    ops1, bytes1 = opcount.rollout_counts(
        banded_step.banded_rollout_reference, banded_step.STATE, one.state,
        one.planes, dataclasses.replace(one.cfg, admm_iters=1), 1)
    shared = sum(t.numel() * t.element_size() for k, t in one.planes.items()
                 if k not in banded_step.SWEPT)
    assert ops == 3 * ops1
    assert nbytes == 3 * (bytes1 - shared) + shared
