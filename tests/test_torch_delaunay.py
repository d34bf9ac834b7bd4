"""A tet mesh of arbitrary topology through the port: the small Delaunay
mesh of tests/test_uell.py (140 nodes; A_hat has more than 48 diagonals),
f64, kernel-backed tets (`backend="pallas"`) on both sides.

- the general ell route against the JAX package's, for every cg_backend
  and budget, and with the tolerance-driven solve, over 5 steps. One ADMM
  iteration agrees to ~2e-15; from the second on, a last-bit difference
  (torch's CPU sqrt and XLA's log, PERF.md) flips a Newton branch on a tie
  element, and this mesh carries that into x at ~5e-10 after one step and
  up to ~4.4e-8 after five (JAX's own tests/test_uell.py compares its
  routes at 5e-8 on it). So x compares at 1e-7 and v = (x - x_prev)/dt at
  1e-7/dt = 2.5e-6, not at the 1e-8 of the dia beam in
  tests/test_torch_system.py;
- the mode choice (`Settings` defaults, auto, dia -> ell, reorder) as JAX;
- the banded route with the ELL matvec (plain twin) against the port's
  general ell route (1e-12 for one ADMM iteration, where both run the same
  prox; trajectories at tests/test_torch_banded.py's tolerances, since a
  last-bit difference can flip a Newton branch) and against the JAX uell
  BandedStepper (Pallas interpret mode, run once per module) at
  tests/test_torch_banded_ref.py's tolerances, from scratch and carried
  over by `banded_from_reference`;
- run(12) = 12 x step() and two runs bitwise equal, on both routes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core.banded import BandedStepper as JaxBandedStepper
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.ops.kernels import banded_step as pbs
from admm_elastic_tpu_torch.utils import banded_from_reference
from admm_elastic_tpu_torch.utils.scenes import delaunay_mesh

torch.set_num_threads(1)

PTS, TETS = delaunay_mesh()


def build(pkg, *, fast=False, cg=25, admm=10, floor=False, per_elem=False,
          pts=PTS, tets=TETS, **settings):
    """test_uell.py's _build_system for pkg in (aet, pt): anchors at the
    minimum x, NeoHookean tets (mu = lam = 1e4, or per-element), gravity;
    floor=True lifts the mesh by 0.1 m over a Floor 0.02 m above its
    lowest point."""
    n = len(pts)
    common = {"timestep_s": 0.04, "admm_iters": admm, "verbose": 0,
              "global_solver": "ell", "cg_fixed_iters": cg,
              "lattice_fast_path": fast, **settings}
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **common))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                  **common))
    if floor:
        pts = pts + np.array([0.0, 0.1, 0.0])
    s.add_nodes(pts, np.full(n, 2.0 / n))
    m = pkg.models
    s.add_force(m.StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 1e-3)))
    mu = lam = 1e4
    if per_elem:
        rng = np.random.default_rng(7)
        mu = rng.uniform(5e3, 2e4, len(tets))
        lam = rng.uniform(5e3, 2e4, len(tets))
    s.add_force(m.HyperElasticTet(tets, mu=mu, lam=lam, max_iters=5,
                                  model="nh", backend="pallas"))
    if floor:
        s.add_force(m.Collision(
            [m.Floor(center=(0.0, float(pts[:, 1].min()) + 0.02, 0.0))],
            n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def _stepper(s):
    assert isinstance(s._stepper, BandedStepper), "banded route not engaged"
    assert s._stepper.cfg.matrix == "ell"
    return s._stepper


# ------------------------------------------------------------ general route

TOL_X = 1e-7
TOL_V = TOL_X / 0.04


def _assert_trajectory(s, x, v):
    assert np.abs(s.x - x).max() < TOL_X, np.abs(s.x - x).max()
    assert np.abs(s.v - v).max() < TOL_V, np.abs(s.v - v).max()


@pytest.fixture(scope="module", params=[25, (40, 25)],
                ids=["cg25", "cg40-25"])
def jax_general(request):
    """The JAX general ell route, once per budget (each JAX System compiles
    for ~10 s here). It runs cg_backend='xla': the JAX package's own tests
    hold its fused and kernel backends to it (tests/test_system.py), and
    tests/test_torch_ell.py holds the port's twins of those kernels to
    the Pallas kernels at 1e-12."""
    s = build(aet, cg=request.param)
    assert s._solver_mode == "ell"
    s.run(5)
    return request.param, np.asarray(s.x), np.asarray(s.v)


@pytest.mark.parametrize("backend", ["xla", "fused", "kernel"])
def test_general_ell_route_matches_jax(jax_general, backend):
    cg, x5, v5 = jax_general
    s = build(pt, cg=cg, cg_backend=backend)
    assert s._solver_mode == "ell" and s._stepper is None
    s.run(5)
    _assert_trajectory(s, x5, v5)
    assert s.x[:, 1].min() < s._x[:, 1].min() - 1e-3  # it sagged


def test_tolerance_solve_matches_jax():
    """cg_fixed_iters=None: the tolerance-driven PCG (cg_tol 1e-10, at most
    cg_max_iters 250 iterations), whatever the backend, as in JAX."""
    j = build(aet, cg=None, cg_backend="kernel")
    s = build(pt, cg=None, cg_backend="kernel")
    j.run(3)
    s.run(3)
    _assert_trajectory(s, np.asarray(j.x), np.asarray(j.v))


# --------------------------------------------------------------- mode choice

def _scrambled_beam():
    beam = pt.geometry.make_beam_tets(5, 4, 3)
    perm = np.random.default_rng(0).permutation(beam.n_vertices)
    return beam.vertices[perm], np.argsort(perm)[beam.tets]


def test_dia_falls_back_to_ell():
    """dia on a mesh with more than 48 diagonals: reorder='none' (and any
    reorder, for a mesh that is no grid) gives ell, as JAX's
    test_dia_falls_back_for_unstructured."""
    verts, tets = _scrambled_beam()
    for pkg in (aet, pt):
        s = build(pkg, pts=verts, tets=tets, global_solver="dia",
                  reorder="none")
        assert s._solver_mode == "ell"
    s.step()
    assert np.isfinite(s.x).all()
    assert build(pt, global_solver="dia")._solver_mode == "ell"


def test_grid_renumbering_raises():
    """reorder='auto' on a scrambled grid: JAX renumbers it back to dia;
    the port does not step another route."""
    verts, tets = _scrambled_beam()
    j = build(aet, pts=verts, tets=tets, global_solver="dia")
    assert j._solver_mode == "dia" and j._o2i is not None
    with pytest.raises(NotImplementedError, match="renumber"):
        build(pt, pts=verts, tets=tets, global_solver="dia")


def test_settings_defaults_match_jax():
    """The defaults that pick the global solve are JAX's; bare Settings()
    on a small beam resolves 'auto' to 'dense' in both packages (only the
    device is set here: this machine may have no card)."""
    ps, js = pt.Settings(), aet.Settings()
    for name in ("global_solver", "dense_max_nodes", "cg_tol", "cg_max_iters",
                 "cg_backend", "reorder", "cg_fixed_iters",
                 "preconditioner"):
        assert getattr(ps, name) == getattr(js, name), name
    beam = pt.geometry.make_beam_tets(3, 2, 2)
    for pkg, settings in ((aet, aet.Settings(verbose=0)),
                          (pt, pt.Settings(verbose=0, device="cpu"))):
        s = pkg.System(settings)
        s.add_nodes(beam.vertices, np.full(beam.n_vertices, 0.1))
        s.add_force(pkg.models.StaticAnchor([0, 1]))
        s.add_force(pkg.models.HyperElasticTet(beam.tets, 1e4, 1e4,
                                               backend="pallas"))
        assert s.initialize() and s._solver_mode == "dense"


@pytest.mark.parametrize("bad,err", [
    (dict(cg_backend="triton"), ValueError),
    (dict(global_solver="sparse"), ValueError),
    (dict(reorder="rcm"), ValueError),
    # the banded kernel takes only dia and ell, the lattice kernel only a
    # make_beam_tets beam, the cloth kernel only cloth: the cg mode with the
    # fast path steps the general route, as in JAX (err None)
    (dict(global_solver="cg", fast=True), None),
    (dict(fast=True, cg=(40, 25)), NotImplementedError),
    # the banded kernel's algebraic multigrid engages, as in JAX (err
    # BandedStepper; tests/test_torch_uamg.py holds it to JAX's)
    (dict(fast=True, preconditioner="amg"), BandedStepper),
], ids=["cg_backend", "global_solver", "reorder", "cg-mode", "fast-schedule",
        "fast-amg"])
def test_bad_settings_raise(bad, err):
    if err is BandedStepper:
        s = build(pt, admm=2, **bad)
        assert isinstance(s._stepper, BandedStepper)
        assert s._stepper.cfg.mg is not None and s._stepper.cfg.cg_iters == 25
        s.run(2)
        assert np.isfinite(s.x).all()
        return
    if err is None:
        runs = []
        for fast in (True, False):
            s = build(pt, admm=2, **dict(bad, fast=fast))
            assert s._stepper is None and s._solver_mode == "cg"
            s.run(2)
            runs.append(s.x)
        assert np.array_equal(runs[0], runs[1])
        return
    with pytest.raises(err):
        build(pt, **bad)


# ---------------------------------------------------------- banded route

def test_banded_ell_one_iteration_matches_general():
    ref = build(pt, admm=1)
    fast = build(pt, admm=1, fast=True)
    st = _stepper(fast)
    ref.step()
    fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fast.v, ref.v, rtol=0, atol=1e-12)
    tk = ref.forces[1].name
    np.testing.assert_allclose(st.state["u"].numpy(),
                               ref.state["u"][tk].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(st.state["warm"].numpy(),
                               ref.state["forces"][tk]["sigma"].numpy(),
                               rtol=0, atol=1e-12)


def test_banded_ell_matches_general():
    """5 steps with floor and per-element materials."""
    ref = build(pt, floor=True, per_elem=True)
    fast = build(pt, floor=True, per_elem=True, fast=True)
    _stepper(fast)
    for _ in range(5):
        ref.step()
        fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(fast.v, ref.v, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def jax_uell():
    """The JAX uell BandedStepper with floor and per-element materials: its
    state after 2 steps, and x, v after 5."""
    s = build(aet, floor=True, per_elem=True, fast=True)
    st = s._lattice
    assert isinstance(st, JaxBandedStepper) and st._uell is not None
    assert np.array_equal(s._to_canon, np.arange(s.n_nodes))
    s.run(2)
    snap = (jax.device_get(st.state), np.asarray(st._subs),
            np.asarray(st._positions))
    s.run(3)
    return snap, np.asarray(s.x), np.asarray(s.v)


def test_banded_ell_matches_jax_uell(jax_uell):
    _, x5, v5 = jax_uell
    s = build(pt, floor=True, per_elem=True, fast=True)
    _stepper(s)
    s.run(5)
    np.testing.assert_allclose(s.x, x5, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(s.v, v5, rtol=1e-5, atol=1e-7)
    floor_y = PTS[:, 1].min() + 0.12
    assert abs(s.x[:, 1].min() - floor_y) < 0.01  # held at the floor


def test_carry_over_from_jax_uell(jax_uell):
    """banded_from_reference reads the uell stepper's diluted vertex slots
    (`positions`) and its element chunks (`subs`)."""
    (state, subs, positions), x5, v5 = jax_uell
    assert len(positions) == len(PTS) and positions.max() >= len(PTS)
    s = build(pt, floor=True, per_elem=True, fast=True)
    banded_from_reference(_stepper(s), state, subs, positions)
    np.testing.assert_array_equal(
        s.x, np.asarray(state["x"]).reshape(3, -1)[:, positions].T)
    assert float(s._stepper.state["t"]) == pytest.approx(0.08)
    s.run(3)
    assert np.abs(s.x - x5).max() < 1e-8, np.abs(s.x - x5).max()
    np.testing.assert_allclose(s.v, v5, rtol=1e-5, atol=1e-7)


def test_banded_wrapper_checks_ell_planes():
    st = _stepper(build(pt, fast=True))
    assert pbs.banded_rollout.launches == 0  # no kernel on the CPU
    bad = dict(st.planes, ell_idx=st.planes["ell_idx"].long())
    with pytest.raises(ValueError, match="ell_idx"):
        pbs.banded_rollout(st.state, bad, st.cfg, 1)
    with pytest.raises(ValueError, match="ELL"):
        dataclasses.replace(st.cfg, dia_offs=(0,))


# ------------------------------------------------------------ both routes

@pytest.mark.parametrize("fast", [False, True], ids=["general", "banded"])
def test_run_equals_steps_bitwise(fast):
    """run(12): on the banded route one 10-step launch and 2 single steps."""
    a = build(pt, fast=fast, admm=3, cg=10, cg_backend="fused")
    b = build(pt, fast=fast, admm=3, cg=10, cg_backend="fused")
    for _ in range(12):
        a.step()
    b.run(12)
    assert np.array_equal(a.x, b.x) and np.array_equal(a.v, b.v)
    assert b.elapsed_s == pytest.approx(0.48)


@pytest.mark.parametrize("fast", [False, True], ids=["general", "banded"])
def test_bitwise_repeat(fast):
    def run():
        s = build(pt, fast=fast, admm=4, cg=(40, 25) if not fast else 25,
                  cg_backend="kernel")
        s.run(3)
        return s.x, s.v

    (xa, va), (xb, vb) = run(), run()
    assert np.array_equal(xa, xb) and np.array_equal(va, vb)
