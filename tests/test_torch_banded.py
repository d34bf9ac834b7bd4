"""The port's banded whole-timestep route (`lattice_fast_path=True`,
core/banded.py + ops/kernels/banded_step.py, plain twin on the CPU) against
the port's general route, plus its API, routing and out-of-slice errors,
and the port's general route with collisions against the JAX package's.

Jittered beams of tests/test_banded.py, f64. Tolerances are that file's
own: one ADMM iteration runs the same prox code on both routes, so x, v, u
and the warm start agree to round-off of the summation order; over several
iterations a last-bit difference can flip a Newton backtracking branch, so
trajectories compare at rtol 1e-6 / atol 1e-8 (x) and 1e-5 / 1e-7 (v)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import dataclasses

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.ops.kernels import banded_step as pbs
from torch_banded_scenes import aet, build, jittered_beam, pt

torch.set_num_threads(1)


def _stepper(s):
    assert isinstance(s._stepper, BandedStepper), "banded route not engaged"
    return s._stepper


def test_single_iteration_matches_general():
    mesh = jittered_beam()
    ref = build(pt, mesh, fast=False, admm=1)
    fast = build(pt, mesh, fast=True, admm=1)
    st = _stepper(fast)
    ref.step()
    fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=0, atol=1e-13)
    np.testing.assert_allclose(fast.v, ref.v, rtol=0, atol=1e-12)
    tk = ref.forces[0].name
    np.testing.assert_allclose(st.state["u"].numpy(),
                               ref.state["u"][tk].numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(st.state["warm"].numpy(),
                               ref.state["forces"][tk]["sigma"].numpy(),
                               rtol=0, atol=1e-14)


def test_arap_single_iteration_matches_general():
    """The banded kernel's arap mode against the general route's
    arap_local_step_fused: one ADMM iteration runs the same projection on
    both routes (no inverted elements at rest, where the two ARAP forms
    agree), so x, v and u agree to round-off of the summation order."""
    mesh = jittered_beam()
    ref = build(pt, mesh, fast=False, admm=1, model="arap")
    fast = build(pt, mesh, fast=True, admm=1, model="arap")
    st = _stepper(fast)
    assert st.model == "arap" and st.cfg.model == "arap"
    ref.step()
    fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fast.v, ref.v, rtol=0, atol=1e-12)
    tk = ref.forces[0].name
    np.testing.assert_allclose(st.state["u"].numpy(),
                               ref.state["u"][tk].numpy(), rtol=0, atol=1e-12)
    assert torch.equal(st.state["warm"], torch.ones_like(st.state["warm"]))


@pytest.mark.parametrize("model", ["nh", "stvk", "arap"])
def test_five_steps_match_general(model):
    mesh = jittered_beam()
    ref = build(pt, mesh, fast=False, model=model)
    fast = build(pt, mesh, fast=True, model=model)
    _stepper(fast)
    for _ in range(5):
        ref.step()
        fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(fast.v, ref.v, rtol=1e-5, atol=1e-7)


def test_floor_and_shapes_match_general():
    """Anchor weight 0 with a floor, then floor + sphere + cylinder: the
    banded route's rsqrt projection against the general route's
    Collision.project, and the released anchors' dual stays exactly 0."""
    mesh = jittered_beam(seed=5)
    ref = build(pt, mesh, fast=False, floor_y=0.0, anchor_w=0.0)
    fast = build(pt, mesh, fast=True, floor_y=0.0, anchor_w=0.0)
    for _ in range(8):
        ref.step()
        fast.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)
    assert torch.count_nonzero(_stepper(fast).state["au"]) == 0
    mesh = jittered_beam(seed=11)
    ref = build(pt, mesh, fast=False, shapes=True)
    fast = build(pt, mesh, fast=True, shapes=True)
    for _ in range(10):
        ref.step()
        fast.step()
    assert fast.x[:, 1].min() > mesh.vertices[:, 1].min() - 0.8
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)


def test_run_windows_equal_steps():
    """run(12) = one 10-step launch + 2 single steps."""
    mesh = jittered_beam(seed=9)
    a = build(pt, mesh, fast=True)
    b = build(pt, mesh, fast=True)
    for _ in range(12):
        a.step()
    b.run(12)
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.v, a.v, rtol=0, atol=1e-12)
    assert float(_stepper(b).state["t"]) == pytest.approx(0.48)
    assert b.elapsed_s == pytest.approx(a.elapsed_s)


def test_setters_round_trip_and_feed_the_step():
    mesh = jittered_beam(seed=11)
    s = build(pt, mesh, fast=True)
    ref = build(pt, mesh, fast=False)
    rng = np.random.RandomState(0)
    newx = mesh.vertices + 0.01 * rng.randn(*mesh.vertices.shape)
    newv = 0.1 * rng.randn(*mesh.vertices.shape)
    for sys_ in (s, ref):
        sys_.x = newx
        sys_.v = newv
    np.testing.assert_allclose(s.x, newx, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(s.v, newv)
    calls = []
    s.pre_step_callbacks.append(lambda sys_: calls.append(sys_.elapsed_s))
    s.step()
    ref.step()
    assert calls == [0.0]
    np.testing.assert_allclose(s.x, ref.x, rtol=1e-6, atol=1e-8)


def test_bitwise_repeat():
    def run():
        s = build(pt, jittered_beam(seed=3), fast=True, model="stvk",
                  floor_y=0.0)
        s.run(3)
        return s.x, s.v

    (xa, va), (xb, vb) = run(), run()
    assert np.array_equal(xa, xb) and np.array_equal(va, vb)


@pytest.mark.parametrize("bad", [
    dict(explicit_indices=[0, 3, 5]),
    dict(residual_tol=1e-6),
    dict(cg=(75, 25)),
], ids=["explicit-subset", "residuals", "cg-schedule"])
def test_out_of_slice_scenes_raise(bad):
    """A (first, rest) CG schedule raises. A gravity kick over a node subset
    qualifies for no whole-timestep kernel in the JAX package
    (banded.py:625-626, lattice.py:354-355, and no triangles), and the
    residual_tol early exit takes none either (banded.py:584-589,
    lattice.py:306, cloth.py:518-523): the JAX package steps its general
    route, and so does the port, bitwise as with the fast path off."""
    if "explicit_indices" in bad or "residual_tol" in bad:
        runs = []
        for fast in (True, False):
            s = build(pt, jittered_beam(), fast=fast, **bad)
            assert s._stepper is None
            s.run(3)
            runs.append((s.x, s.v))
        assert np.array_equal(runs[0][0], runs[1][0])
        assert np.array_equal(runs[0][1], runs[1][1])
        return
    with pytest.raises(NotImplementedError):
        build(pt, jittered_beam(), fast=True, **bad)


def test_wrapper_routing_and_checks():
    """CPU tensors take the twin; another device raises; shapes, dtypes and
    the collision table are checked."""
    s = build(pt, jittered_beam(), fast=True, floor_y=0.0)
    st = _stepper(s)
    got = pbs.banded_rollout(st.state, st.planes, st.cfg, 2)
    want = pbs.banded_rollout_reference(st.state, st.planes, st.cfg, 2)
    for k in pbs.STATE:
        assert torch.equal(got[k], want[k]), k
    assert pbs.banded_rollout.launches == 0  # no kernel on the CPU
    meta = {k: t.to("meta") for k, t in st.state.items()}
    mplanes = {k: t.to("meta") for k, t in st.planes.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        pbs.banded_rollout(meta, mplanes, st.cfg, 1)
    bad = dict(st.planes, inc=st.planes["inc"].long())
    with pytest.raises(ValueError, match="inc"):
        pbs.banded_rollout(st.state, bad, st.cfg, 1)
    with pytest.raises(ValueError, match="collision shapes"):
        dataclasses.replace(st.cfg, coll_shapes=(("floor", (0.0,)),) * 17)


@pytest.mark.parametrize("matrix", ["dia", "ell"])
def test_twin_solve_is_the_cluster_solves_twin(matrix):
    """The twin's global solve is `pcg_fixed_inv` with the cluster
    solve's order of sums (`cluster_dot`; ELL rows slot by slot), from x,
    with D^-1 as stored: one step of one ADMM iteration on a small beam
    (dia) and on the 140-node Delaunay mesh (ELL), bitwise. A plain
    torch.sum in its place moves x."""
    from admm_elastic_tpu_torch.core.solver import dia_apply, pcg_fixed_inv
    from admm_elastic_tpu_torch.ops.kernels.cg_ell import ell_apply_by_slot
    from admm_elastic_tpu_torch.ops.kernels.cg_step import cluster_dot
    from admm_elastic_tpu_torch.utils.scenes import small_delaunay

    if matrix == "dia":
        st = _stepper(build(pt, jittered_beam(seed=4), fast=True))
    else:
        st = small_delaunay(25, torch.float64, "cpu", fast=True)._stepper
    cfg, p = dataclasses.replace(st.cfg, admm_iters=1), st.planes
    got = pbs.banded_rollout_reference(st.state, p, cfg, 1)

    def A(y):
        if matrix == "ell":
            return ell_apply_by_slot(y, p["ell_idx"], p["ell_vals"])
        return dia_apply(y, cfg.dia_offs, p["dia"])

    dt, g = cfg.dt, torch.tensor(cfg.scalars()[3:6], dtype=torch.float64)
    v = st.state["v"] + torch.where(p["mass"][:, None] > 0, g, 0.0)
    x = st.state["x"] + torch.tensor(dt, dtype=torch.float64) * v
    u, warm, rows = pbs._element_phase(x, st.state["u"], st.state["warm"],
                                       p, cfg, torch.finfo(x.dtype).eps)
    b, _, _ = pbs._vertex_rhs(x, st.state["au"], st.state["cu"], rows, p,
                              cfg)
    rhs = p["mass"][:, None] * x + torch.tensor(dt * dt,
                                               dtype=torch.float64) * b
    want = pcg_fixed_inv(A, rhs, x, p["invd"], cfg.cg_iters, cluster_dot)
    assert torch.equal(got["x"], want)
    plain = pcg_fixed_inv(A, rhs, x, p["invd"], cfg.cg_iters)
    assert not torch.equal(got["x"], plain)


def test_collision_projections_agree():
    """The banded twin's projection (r rsqrt(d^2)) against
    Collision.project (d / |d|) on points in and around every shape."""
    mesh = jittered_beam(seed=11)
    s = build(pt, mesh, fast=True, shapes=True)
    st = _stepper(s)
    rng = np.random.default_rng(1)
    lo = mesh.vertices.min(0)
    pts = torch.as_tensor(lo + rng.uniform(-0.6, 0.4, size=(4000, 3)))
    got = pbs._project(pts, st.cfg)
    coll = s.forces[1]
    want, _ = coll.project(pts[:, None, :], torch.zeros_like(pts)[:, None, :],
                           s.params[coll.name], {})
    moved = (want[:, 0] != pts).any(dim=1)
    assert int(moved.sum()) > 500
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), rtol=0,
                               atol=1e-14)


@pytest.fixture(scope="module")
def jax_general_collision():
    mesh = jittered_beam(seed=11)
    s = build(aet, mesh, fast=False, shapes=True)
    for _ in range(5):
        s.step()
    return mesh, np.asarray(s.x), np.asarray(s.v)


def test_collision_general_route_matches_jax(jax_general_collision):
    """x to 1e-8. v = (x - x_prev)/dt carries x's difference times 1/dt:
    at first contact a last-bit difference flips a Newton branch (the two
    port routes differ by ~2e-8 in v there too), so v compares at the
    JAX banded test's v tolerance."""
    mesh, x5, v5 = jax_general_collision
    s = build(pt, mesh, fast=False, shapes=True)
    for _ in range(5):
        s.step()
    assert np.abs(s.x - x5).max() < 1e-8, np.abs(s.x - x5).max()
    np.testing.assert_allclose(s.v, v5, rtol=1e-5, atol=1e-7)


def test_collision_project_matches_jax():
    import jax.numpy as jnp

    from torch_banded_scenes import mixed_shapes

    mesh = jittered_beam(seed=11)
    rng = np.random.default_rng(1)
    pts = mesh.vertices.min(0) + rng.uniform(-0.6, 0.4, size=(4000, 3))
    out = []
    for pkg, asarray in ((aet, jnp.asarray), (pt, torch.as_tensor)):
        c = pkg.models.Collision(mixed_shapes(pkg, mesh), n_nodes=len(pts))
        params, _ = c.build(pts, None, 0.04)
        z, _ = c.project(asarray(pts)[:, None, :],
                         asarray(np.zeros((len(pts), 1, 3))),
                         {k: asarray(v) for k, v in params.items()}, {})
        out.append(np.asarray(z)[:, 0])
    assert (out[0] != pts).any(axis=1).sum() > 500
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-15)
