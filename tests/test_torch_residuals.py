"""The per-ADMM-iteration residuals of the port (`collect_residuals`,
`residual_tol`, `System.last_aux`) on the CPU, f64.

The JAX package is the reference of the general route only: one
module-scoped ell + Pallas run of the 4x3x3 beam of
tests/test_system.py:636, and the 4-node scene of its early-exit test
(tests/test_system.py:261-286). Its whole-timestep kernels are too slow in
interpret mode to run here; the port's banded and cloth twins, whose
residual order the card holds its kernels to bitwise
(tests/test_torch_cuda.py), are held to the port's general route instead.

Tolerances. Against JAX the trajectories agree to ~1e-11 m, but a residual
is a difference of O(1) duals from one ADMM iteration to the next, so the
element steps' round-off (the Pallas interpreter contracts FMAs, the
port's twins do not) shows at ~1e-7 of a residual: the residuals compare
at rtol 1e-6 with an absolute floor of 1e-9 of the largest (the dual of
iteration 0 is round-off itself), x at 1e-8. The twins against the port's
general route: tests/test_torch_banded.py's rtol 1e-5 and atol 1e-9.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.core.cloth import ClothStepper
from admm_elastic_tpu_torch.ops.kernels import banded_step as pbs
from admm_elastic_tpu_torch.ops.kernels import residuals as pres
from admm_elastic_tpu_torch.parallel import sharded_banded_from_system
from admm_elastic_tpu_torch.utils.scenes import (beam_system, small_cloth,
                                                 small_uamg)
from torch_banded_scenes import build, jittered_beam

torch.set_num_threads(1)
RES = ("primal_residual", "dual_residual")


def _beam_433(pkg, mode, collect=True, steps=3, **settings):
    """tests/test_system.py:636's beam: NeoHookean, anchored at x = 0,
    gravity, 8 ADMM iterations of 40 CG iterations; (rp, rd, x) stacked
    over `steps` steps."""
    beam = aet.geometry.make_beam_tets(4, 3, 3)
    n = beam.n_vertices
    kw = dict(timestep_s=0.04, admm_iters=8, verbose=0, global_solver=mode,
              cg_fixed_iters=40, collect_residuals=collect, **settings)
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **kw))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu", **kw))
    s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    s.add_force(pkg.models.StaticAnchor(
        np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(pkg.models.HyperElasticTet(beam.tets, mu=1e4, lam=4e4,
                                           max_iters=5, model="nh",
                                           backend="pallas"))
    s.add_explicit_force(pkg.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    out = {k: [] for k in RES}
    for _ in range(steps):
        s.step()
        for k in RES:
            out[k].append(np.asarray(s.last_aux[k]))
    return np.stack(out[RES[0]]), np.stack(out[RES[1]]), np.asarray(s.x)


@pytest.fixture(scope="module")
def jax_beam():
    return _beam_433(aet, "ell")


def _close_residuals(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["dia", "ell"])
def test_general_route_matches_jax(jax_beam, mode):
    rp, rd, x = _beam_433(pt, mode)
    assert rp.shape == rd.shape == (3, 8) and np.all(rp > 0)
    _close_residuals(rp, jax_beam[0])
    _close_residuals(rd, jax_beam[1])
    np.testing.assert_allclose(x, jax_beam[2], rtol=0, atol=1e-8)


def test_dense_and_cg_match_the_gathered_modes():
    """dense and cg carry each force's z and gather the dual's difference
    on its own; dia and ell gather T z with the RHS (6-wide rows)."""
    ref = _beam_433(pt, "ell", steps=2)
    for mode in ("dense", "cg"):
        rp, rd, x = _beam_433(pt, mode, steps=2)
        np.testing.assert_allclose(rp, ref[0], rtol=1e-6)
        np.testing.assert_allclose(rd, ref[1], rtol=1e-6,
                                   atol=1e-9 * ref[1].max())


def test_scatter_rhs_is_the_gathered_rows():
    """ForceBatch.scatter_rhs (the JAX package's per-force segment sum)
    summed over the forces equals the System's one incidence gather of
    their rows, which the dense and cg modes' dual residual uses."""
    s = build(pt, jittered_beam(), fast=False, shapes=True, admm=2)
    s.step()
    rng = np.random.default_rng(2)
    rows, total = [], torch.zeros((s.n_nodes, 3), dtype=torch.float64)
    for f in s.forces:
        p = s.params[f.name]
        z = f.compute_Dx(p, s.state["x"])
        u = torch.as_tensor(rng.standard_normal(tuple(z.shape)))
        rows.append(f.rhs_contribution(p, z, u))
        total = total + f.scatter_rhs(p, z, u, s.n_nodes)
    np.testing.assert_allclose(s._gather(rows, 3).numpy(), total.numpy(),
                               rtol=1e-12, atol=1e-9)


def _tet4(pkg, **settings):
    """tests/test_system.py:261-286's scene: one LinearTetStrain tet with
    three anchored corners and the fourth displaced, dense, 50 ADMM
    iterations; one step."""
    kw = dict(timestep_s=0.04, verbose=0, **settings)
    kw.setdefault("admm_iters", 50)
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **kw))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu", **kw))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    s.add_nodes(x, np.ones(4))
    s.add_force(pkg.models.StaticAnchor([0, 1, 2]))
    s.add_force(pkg.models.LinearTetStrain(np.array([[0, 1, 2, 3]]),
                                           stiffness=100.0, backend="pallas"))
    assert s.initialize()
    s.x = x + np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.4, 0.2, -0.1]])
    s.step()
    return s


@pytest.mark.parametrize("tol", [1e-6, 0.0])
def test_early_exit_matches_jax(tol):
    """The masked early exit: the iterations after the first whose primal
    residual is <= tol change nothing and keep their residuals 0."""
    j = _tet4(aet, collect_residuals=True, residual_tol=tol)
    p = _tet4(pt, collect_residuals=True, residual_tol=tol)
    rj = np.asarray(j.last_aux["primal_residual"])
    rp = p.last_aux["primal_residual"].numpy()
    used = np.count_nonzero(rp)
    assert used == np.count_nonzero(rj)
    assert (0 < used < 50) if tol else used == 50
    assert np.count_nonzero(p.last_aux["dual_residual"].numpy()) == used
    np.testing.assert_allclose(p.x, np.asarray(j.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rp, rj, rtol=1e-6, atol=1e-12)


def test_relaxation_collects_as_jax():
    """relaxation != 1: the unfused pipeline collects both residuals."""
    j = _tet4(aet, collect_residuals=True, relaxation=1.5, admm_iters=12)
    p = _tet4(pt, collect_residuals=True, relaxation=1.5, admm_iters=12)
    for k in RES:
        want = np.asarray(j.last_aux[k])
        _close_residuals(p.last_aux[k].numpy(), want)
    np.testing.assert_allclose(p.x, np.asarray(j.x), rtol=0, atol=1e-10)


def _route_pair(make, collect):
    """(general, whole-timestep) Systems of the same scene."""
    return make(fast=False, collect_residuals=collect), make(
        fast=True, collect_residuals=collect)


def _assert_route_residuals(gen, fast, steps):
    """Step both `steps` times, one at a time: x and each step's residuals
    at test_banded.py:358's bounds."""
    for _ in range(steps):
        gen.step()
        fast.step()
        for k in fast.last_aux:
            np.testing.assert_allclose(fast.last_aux[k],
                                       gen.last_aux[k].numpy(), rtol=1e-5,
                                       atol=1e-9)
    np.testing.assert_allclose(fast.x, gen.x, rtol=1e-6, atol=1e-8)


def _released_floor(fast, **kw):
    """The jittered beam pinned at vertices 0 and 1 by a StaticAnchor
    whose vertex 0 is released (weight 0), hitting a Floor."""
    mesh = jittered_beam()
    n = mesh.n_vertices
    s = pt.System(pt.Settings(
        timestep_s=0.04, admm_iters=6, verbose=0, dtype=torch.float64,
        device="cpu", global_solver="dia", lattice_fast_path=fast,
        cg_fixed_iters=25, **kw))
    s.add_nodes(mesh.vertices + np.array([0.0, 0.6, 0.0]), np.full(n, 2 / n))
    s.add_force(pt.models.HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4,
                                          max_iters=4, backend="pallas"))
    s.add_force(pt.models.StaticAnchor([0, 1], weight=[0.0, 1000.0]))
    s.add_force(pt.models.Collision([pt.models.Floor(center=(0, 0.55, 0))],
                                    n_nodes=n))
    s.add_explicit_force(pt.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def _renumbered_ell(fast, **kw):
    """The jittered beam with its vertices in a random order (seed 1), on
    the ell solver: the banded kernel's ELL rows."""
    mesh = jittered_beam()
    perm = np.random.default_rng(1).permutation(mesh.n_vertices)
    inv = np.argsort(perm)
    n = mesh.n_vertices
    s = pt.System(pt.Settings(
        timestep_s=0.04, admm_iters=6, verbose=0, dtype=torch.float64,
        device="cpu", global_solver="ell", reorder="none",
        lattice_fast_path=fast, cg_fixed_iters=25, **kw))
    s.add_nodes(mesh.vertices[perm], np.full(n, 2 / n))
    s.add_force(pt.models.HyperElasticTet(inv[mesh.tets], mu=1e4, lam=2.5e4,
                                          max_iters=4, backend="pallas"))
    s.add_force(pt.models.StaticAnchor(inv[[0, 1]]))
    s.add_explicit_force(pt.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


ROUTES = {
    "banded-dia-shapes": lambda **kw: build(pt, jittered_beam(), shapes=True,
                                            **kw),
    "banded-arap": lambda **kw: build(pt, jittered_beam(), model="arap",
                                      **kw),
    "banded-released-floor": _released_floor,
    "banded-ell-renumbered": _renumbered_ell,
    "cloth": lambda fast, **kw: small_cloth(device="cpu", fast=fast, **kw),
}


@pytest.mark.parametrize("collect", ["primal", True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_twin_matches_general_route(route, collect):
    gen, fast = _route_pair(ROUTES[route], collect)
    kind = ClothStepper if route == "cloth" else BandedStepper
    assert isinstance(fast._stepper, kind), "whole-timestep route engaged"
    if route == "banded-ell-renumbered":
        assert fast._stepper.cfg.matrix == "ell"
    _assert_route_residuals(gen, fast, 2)
    assert set(fast.last_aux) == (set(RES) if collect is True
                                  else {RES[0]})
    if route == "banded-released-floor":
        st = fast._stepper.state
        assert float(st["au"][fast._to_canon[0]].abs().max()) == 0.0
        assert torch.count_nonzero(st["cu"]) > 0, "the floor engaged"


def test_collecting_changes_no_state():
    """Collecting reads the state: every state tensor of a window is the
    same bits with collection on and off, in both modes."""
    st = build(pt, jittered_beam(), fast=True, shapes=True)._stepper
    off = pbs.banded_rollout_reference(st.state, st.planes, st.cfg, 2)
    for collect in ("primal", "full"):
        on = pbs.banded_rollout_reference(
            st.state, st.planes, dataclasses.replace(st.cfg, collect=collect),
            2)
        assert all(torch.equal(on[k], off[k]) for k in pbs.STATE)
        assert on["primal"].shape == (2, st.cfg.admm_iters)
        assert ("dual" in on) == (collect == "full")


def test_multigrid_twin_matches_an_exact_solve():
    """The banded twin's multigrid mode (6x5x4 beam, mg8) against the
    general route's dense (exact) solve: the V-cycle PCG is not exact, so
    the residuals agree to its convergence, ~1e-5 of the largest."""
    mg = beam_system((6, 5, 4), 0.05, 50.0, 8, torch.float64, "cpu",
                     fast=True, preconditioner="amg", collect_residuals=True)
    ref = beam_system((6, 5, 4), 0.05, 50.0, 8, torch.float64, "cpu",
                      global_solver="dense", collect_residuals=True)
    assert mg._stepper.cfg.mg is not None
    for _ in range(2):
        mg.step()
        ref.step()
    for k in RES:
        want = ref.last_aux[k].numpy()
        np.testing.assert_allclose(mg.last_aux[k], want, rtol=1e-3,
                                   atol=1e-4 * want.max())


def test_algebraic_multigrid_twin_matches_an_exact_solve():
    """The banded twin's algebraic multigrid mode (the 420-node Delaunay
    scene) collecting both residuals, against the general route's AMG PCG
    run to cg_tol 1e-10: at 30 V-cycle PCG iterations, converged on this
    scene (at 8 its primal residuals lie ~1% off), they agree as the
    geometric mode's do at 8."""
    mg = small_uamg(30, torch.float64, "cpu")
    ref = small_uamg(None, torch.float64, "cpu", fast=False)
    mg._stepper.collect_residuals = True
    ref.settings.collect_residuals = True
    assert mg._stepper.cfg.mg is not None and "amg" in ref.params["_solver"]
    for _ in range(2):
        mg.step()
        ref.step()
    for k in RES:
        want = ref.last_aux[k].numpy()
        np.testing.assert_allclose(mg.last_aux[k], want, rtol=1e-3,
                                   atol=1e-4 * want.max())


def test_sharded_primal_equals_banded():
    s = build(pt, jittered_beam(), fast=True, shapes=True,
              collect_residuals="primal")
    for backend in ("xla", "pallas"):
        spmd, _ = sharded_banded_from_system(s, backend=backend)
        ref = s._stepper
        start = {k: t.clone() for k, t in ref.state.items()}
        spmd.step()
        ref.step()
        assert spmd.last_primal.shape == (s.settings.admm_iters,)
        assert np.array_equal(spmd.last_primal, ref.last_primal[0])
        assert torch.equal(spmd.state["x"], ref.state["x"])
        spmd.run(2)  # a collecting stepper steps one at a time
        assert spmd.last_primal.shape == (s.settings.admm_iters,)
        ref.state = start


def test_gates():
    # residual_tol: the whole-timestep kernels run every iteration
    s = build(pt, jittered_beam(), fast=True, residual_tol=1e-6)
    assert s._stepper is None
    s = small_cloth(device="cpu", residual_tol=1e-6)
    assert s._stepper is None
    # the lattice kernel computes no residuals: a beam on the cg mode
    # steps the general route when collecting
    for collect in ("primal", True):
        s = beam_system((4, 3, 3), 0.05, 50.0, 25, torch.float64, "cpu",
                        fast=True, global_solver="cg",
                        collect_residuals=collect)
        assert s._stepper is None
    # preconditioner='amg' on 'dia' needs a kernel: JAX's ValueError
    with pytest.raises(ValueError, match="in-kernel multigrid"):
        beam_system((6, 5, 4), 0.05, 50.0, 8, torch.float64, "cpu",
                    fast=True, preconditioner="amg", residual_tol=1e-6)
    with pytest.raises(ValueError, match="cannot be combined"):
        beam_system((2, 2, 2), 0.05, 50.0, 8, torch.float64, "cpu",
                    acceleration="anderson", residual_tol=1e-6)
    s = build(pt, jittered_beam(), fast=True, collect_residuals=True)
    with pytest.raises(ValueError, match="'primal' residuals only"):
        sharded_banded_from_system(s)


@pytest.mark.parametrize("collect", [False, "primal", True])
@pytest.mark.parametrize("fast", [False, True])
def test_last_aux_shapes(collect, fast):
    """JAX's shapes: step() (iters,), run(n) (n, iters) on the general
    route, (0,) when nothing is collected; a stepper sets last_aux only
    when it collects (its last window's residuals after run)."""
    s = build(pt, jittered_beam(2, 2, 2), fast=fast,
              collect_residuals=collect, admm=4, cg=5)
    assert not hasattr(s, "last_aux")
    s.step()
    width = 4 if collect else 0
    if fast and not collect:
        assert not hasattr(s, "last_aux")
    else:
        keys = set(RES) if (collect is True or not fast) else {RES[0]}
        assert set(s.last_aux) == keys
        assert all(np.shape(s.last_aux[k]) == (width,) for k in keys)
    s.run(11)
    if fast and collect:
        # the last window: the remainder's single step, as JAX's
        assert np.shape(s.last_aux[RES[0]]) == (1, 4)
    elif not fast:
        assert all(tuple(s.last_aux[k].shape) == (11, width) for k in RES)
        if collect == "primal":
            assert torch.count_nonzero(s.last_aux[RES[1]]) == 0


def test_make_rollout():
    s = build(pt, jittered_beam(2, 2, 2), fast=False,
              collect_residuals=True, admm=4, cg=5)
    twin = build(pt, jittered_beam(2, 2, 2), fast=False,
                 collect_residuals=True, admm=4, cg=5)
    rollout = s.make_rollout(3)
    state, aux = rollout(s.state, s.params)
    assert all(tuple(aux[k].shape) == (3, 4) for k in RES)
    twin.run(3)
    assert torch.equal(state["x"], twin.state["x"])
    assert all(torch.equal(aux[k], twin.last_aux[k]) for k in RES)


def test_stepper_collect_toggle():
    """A stepper whose collect_residuals changes runs another config (its
    windows are captured anew on a card); it stays on the same state."""
    s = build(pt, jittered_beam(2, 2, 2), fast=True, admm=4, cg=5)
    st = s._stepper
    assert st.collect_residuals is False and st.cfg.collect is None
    st.collect_residuals = "primal"
    assert st.cfg.collect == "primal"
    s.step()
    assert st.last_primal.shape == (1, 4) and st.last_dual is None
    st.collect_residuals = True
    s.run(10)
    assert st.last_primal.shape == st.last_dual.shape == (10, 4)
    st.collect_residuals = False
    s.step()
    assert st.last_primal is None


def test_residual_order_helpers():
    """residuals.py's sums: block partials of 128 by the halving tree, then
    the strided turns; exact on integers."""
    v = torch.arange(300, dtype=torch.float64)
    parts = pres.block_partials(v)
    assert parts.tolist() == [float(sum(range(0, 128))),
                              float(sum(range(128, 256))),
                              float(sum(range(256, 300)))]
    assert float(pres.sum_partials(parts)) == float(v.sum())
    assert float(pres.primal(v, v[:5])) == pytest.approx(
        np.sqrt(float(v.sum() + v[:5].sum())))
