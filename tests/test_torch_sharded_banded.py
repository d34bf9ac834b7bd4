"""The port's sharded banded stepper at one device
(`parallel/banded_spmd.py`, plain twins on the CPU), f64.

Against the JAX package's `ShardedBandedStepper` on a one-device mesh with
its xla backend, cg and cheb, on a jittered 6x4x4 beam over a floor (3
ADMM iterations): the JAX state and Chebyshev bounds carried over by
`sharded_banded_from_reference`, then 2 steps within 1e-8 (x; v = dx/dt
at the trajectory tolerance of tests/test_torch_banded_ref.py), and once
more from the JAX stepper's detached state. The two JAX steppers are made
once per module.

Against the port's own `BandedStepper` (no JAX): the sharded cg solve at
the same budget is the banded route's arithmetic (the local phase is the
banded twin's, and the PCG differs only in how r D^-1 r is associated),
within 1e-10, for nh, stvk, arap, a released anchor over a floor, the
floor/sphere/cylinder shapes and the ELL matrix of the 140-node Delaunay
mesh, and after an anchor release through refresh_params (cg; cheb
bitwise a sharded stepper built from the released System). The Chebyshev solve at a generous budget tracks a cg200 solve
within 2e-3 of the scale, as tests/test_banded_spmd.py asks of JAX's."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import numpy as np
import pytest
import torch

from admm_elastic_tpu.parallel.banded_spmd import (
    sharded_banded_from_system as jax_sharded)
from admm_elastic_tpu_torch.core.banded import banded_from_system
from admm_elastic_tpu_torch.ops.kernels import banded_local as pbl
from admm_elastic_tpu_torch.ops.kernels import cheb_dia as pcheb
from admm_elastic_tpu_torch.parallel import (ShardedBandedStepper,
                                             sharded_banded_from_system)
from admm_elastic_tpu_torch.utils import sharded_banded_from_reference
from admm_elastic_tpu_torch.utils.scenes import small_cloth, small_delaunay
from torch_banded_scenes import aet, build, jittered_beam, pt

torch.set_num_threads(1)

JAX_SCENE = dict(admm=3, cg=10, floor_y=0.0)
CHEB_ITERS = 40


def _jax_mesh():
    return jax.make_mesh((1,), ("elem",))


def _port(solver, mesh=None, **kw):
    s = build(pt, mesh or jittered_beam(6, 4, 4, seed=4), fast=True,
              **{**JAX_SCENE, **kw})
    spmd, to_canon = sharded_banded_from_system(s, solver=solver,
                                                cheb_iters=CHEB_ITERS)
    assert np.array_equal(to_canon, np.arange(s.n_nodes))
    return spmd


@pytest.fixture(scope="module", params=["cg", "cheb"])
def jax_run(request):
    """A JAX ShardedBandedStepper (xla backend): its start state, x and v
    after 2 steps, the detached state there, and x, v after 1 step
    more."""
    s = build(aet, jittered_beam(6, 4, 4, seed=4), fast=True, **JAX_SCENE)
    sp, cid = jax_sharded(s, _jax_mesh(), backend="xla",
                          solver=request.param, cheb_iters=CHEB_ITERS)
    assert np.array_equal(np.asarray(cid), np.arange(s.n_nodes))
    carry = (np.asarray(sp.base._subs), np.asarray(sp.base._positions),
             getattr(sp, "cheb_bounds", None))
    start = jax.device_get(sp.base.state)
    sp.run(2)
    two = (np.asarray(sp.x), np.asarray(sp.v))
    detached = jax.device_get(sp.detach().state)
    sp.step()
    return request.param, carry, start, two, detached, (np.asarray(sp.x),
                                                        np.asarray(sp.v))


def test_matches_jax_sharded(jax_run):
    solver, carry, start, (x2, v2), detached, (x3, v3) = jax_run
    p = _port(solver)
    assert p.backend == "xla" and p.solver == solver
    if solver == "cheb":
        # the port's bounds, from its own (n_dia, n) diagonals, are the
        # JAX stepper's from its lane planes
        np.testing.assert_allclose(p.cheb_bounds, carry[2], rtol=1e-10)
    sharded_banded_from_reference(p, start, *carry)
    assert getattr(p, "cheb_bounds", None) == carry[2]
    p.run(2)
    assert np.abs(p.x - x2).max() < 1e-8, np.abs(p.x - x2).max()
    np.testing.assert_allclose(p.v, v2, rtol=1e-5, atol=1e-7)
    assert p.x[:, 1].min() > -0.05, "the floor acts"
    # carried over from the JAX stepper's detached state, one step more
    q = _port(solver)
    sharded_banded_from_reference(q, detached, *carry)
    np.testing.assert_array_equal(q.x, x2)
    assert float(q.state["t"]) == pytest.approx(0.08)
    q.step()
    assert np.abs(q.x - x3).max() < 1e-8, np.abs(q.x - x3).max()
    np.testing.assert_allclose(q.v, v3, rtol=1e-5, atol=1e-7)


# the port's own banded route as the oracle: (mesh kwargs, build kwargs)
SCENES = {
    "nh": (dict(seed=1), dict(admm=4)),
    "stvk": (dict(seed=2), dict(admm=4, model="stvk")),
    "arap": (dict(seed=3), dict(admm=4, model="arap")),
    "floor-anchor-w0": (dict(seed=5), dict(admm=4, floor_y=0.0,
                                           anchor_w=0.0)),
    "floor-sphere-cylinder": (dict(seed=11), dict(admm=4, shapes=True)),
}


def _pair(name, backend):
    mesh_kw, kw = SCENES[name]
    s = build(pt, jittered_beam(**mesh_kw), fast=True, **kw)
    spmd, _ = sharded_banded_from_system(s, backend=backend)
    return spmd, banded_from_system(s)


@pytest.mark.parametrize("name,backend", [
    ("nh", "xla"), ("stvk", "pallas"), ("arap", "xla"),
    ("floor-anchor-w0", "pallas"), ("floor-sphere-cylinder", "xla")])
def test_cg_matches_banded_route(name, backend):
    spmd, ref = _pair(name, backend)
    assert spmd.backend == backend
    for _ in range(4):
        spmd.step()
        ref.step()
    for k in ("x", "v", "au", "cu", "u", "warm"):
        err = float((spmd.state[k] - ref.state[k]).abs().max())
        assert err < 1e-10, f"{name} {k}: {err}"
    if name == "floor-anchor-w0":
        # released anchors: the anchor dual stays exactly 0
        assert torch.count_nonzero(spmd.state["au"]) == 0
        assert spmd.x[:, 1].min() > -0.05
    if name == "floor-sphere-cylinder":
        assert torch.count_nonzero(spmd.state["cu"]) > 0, "shapes engaged"


def test_cg_matches_banded_route_ell():
    s = small_delaunay(cg=25, device="cpu")
    assert s._stepper.cfg.matrix == "ell"
    spmd, _ = sharded_banded_from_system(s)
    ref = banded_from_system(s)
    spmd.run(3)
    ref.run(3)
    err = float(np.abs(spmd.x - ref.x).max())
    assert err < 1e-10, err


@pytest.mark.parametrize("matrix", ["dia", "ell"])
def test_cheb_tracks_deep_cg(matrix):
    if matrix == "dia":
        s = build(pt, jittered_beam(6, 4, 4, seed=7), fast=True, admm=4,
                  cg=200)
    else:
        s = small_delaunay(cg=200, device="cpu")
    ref, _ = sharded_banded_from_system(s)
    ch, _ = sharded_banded_from_system(s, solver="cheb", cheb_iters=80)
    lmin, lmax = ch.cheb_bounds
    assert 0 < lmin < lmax
    ref.run(4)
    ch.run(4)
    scale = np.abs(ref.x).max()
    assert np.abs(ch.x - ref.x).max() < 2e-3 * scale


def test_pallas_backend_launches_nothing_on_cpu():
    """The default backend of a CPU base is xla; with backend='pallas' the
    wrappers run their twins on CPU tensors, with the same numbers, and
    count no launch."""
    spmd = _port("cheb")
    kern, _ = sharded_banded_from_system(
        build(pt, jittered_beam(6, 4, 4, seed=4), fast=True, **JAX_SCENE),
        backend="pallas", solver="cheb", cheb_iters=CHEB_ITERS)
    pbl.banded_local_rhs.launches = pcheb.cheb_dia_chunk.launches = 0
    spmd.run(2)
    kern.run(2)
    assert pbl.banded_local_rhs.launches == pcheb.cheb_dia_chunk.launches == 0
    np.testing.assert_array_equal(kern.x, spmd.x)


@pytest.mark.parametrize("solver", ["cg", "cheb"])
def test_repeats_bitwise(solver):
    a, b = _port(solver), _port(solver)
    a.run(3)
    b.run(3)
    for k in ("x", "v", "au", "cu", "u", "warm"):
        assert torch.equal(a.state[k], b.state[k]), k


def test_run_windows_match_single_steps():
    """run(n) steps in ROLLOUT_WINDOW windows and then the remainder: two
    windows of 2 and one step give the five single steps bitwise."""
    a, b = _port("cg"), _port("cg")
    a.ROLLOUT_WINDOW = 2
    a.run(5)
    for _ in range(5):
        b.step()
    for k in ("x", "v", "au", "cu", "u", "warm", "t"):
        assert torch.equal(a.state[k], b.state[k]), k


def test_detach_then_base_steps_on():
    spmd, ref = _pair("nh", "xla")
    spmd.run(2)
    base = spmd.detach()
    assert base is spmd.base
    assert float(base.state["t"]) == pytest.approx(0.08)
    spmd.step()
    base.step()
    err = float(np.abs(base.x - spmd.x).max())
    assert err < 1e-10, err
    # the base's own stepper from the start agrees too
    ref.run(3)
    assert float(np.abs(ref.x - base.x).max()) < 1e-10


@pytest.mark.parametrize("solver", ["cg", "cheb"])
def test_refresh_params_release(solver):
    """An anchor release on the System (set_force_param, recompute_weights)
    reaches the sharded stepper through refresh_params, which keeps its
    state: under cg it steps on as the System's released BandedStepper
    from that state (within 1e-10), under cheb bitwise as a sharded stepper
    built from the released System given that state, with the bounds of
    the new matrix. D > 1 and a stepper without its System raise."""
    s = build(pt, jittered_beam(**SCENES["nh"][0]), fast=True, admm=4,
              anchor_w=np.array([1000.0, 1000.0]))
    spmd, _ = sharded_banded_from_system(s, solver=solver,
                                         cheb_iters=CHEB_ITERS)
    bounds = getattr(spmd, "cheb_bounds", None)
    spmd.run(2)
    anchor = s.forces[1]
    s.set_force_param(anchor, "weight", np.array([0.0, 1000.0]))
    s.recompute_weights()
    spmd.refresh_params()
    assert spmd.base is not s._stepper
    assert float(spmd.base.planes["aw2"][0]) == 0.0
    state = {k: t.clone() for k, t in spmd.state.items()}
    if solver == "cg":
        ref = s._stepper
    else:
        ref, _ = sharded_banded_from_system(s, solver=solver,
                                            cheb_iters=CHEB_ITERS)
        assert ref.cheb_bounds == spmd.cheb_bounds != bounds
    ref.state = state
    spmd.run(3)
    ref.run(3)
    for k in ("x", "v", "au", "cu", "u", "warm"):
        err = float((spmd.state[k] - ref.state[k]).abs().max())
        assert err < 1e-10 if solver == "cg" else err == 0.0, f"{k}: {err}"
    # the released node moved, the one still anchored barely
    moved = np.abs(spmd.x[:2] - s._x[:2]).max(axis=1)
    assert moved[0] > 1e-4 > moved[1], moved
    spmd.D = 2
    with pytest.raises(NotImplementedError, match="A9"):
        spmd.refresh_params()
    with pytest.raises(ValueError, match="System reference"):
        ShardedBandedStepper(spmd.base).refresh_params()


def test_out_of_slice_raises():
    spmd, _ = _pair("nh", "xla")
    base = spmd.base
    with pytest.raises(NotImplementedError, match="A9"):
        ShardedBandedStepper(base, mesh=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="A6"):
        ShardedBandedStepper(base, solver="mg")
    with pytest.raises(ValueError, match="solver"):
        ShardedBandedStepper(base, solver="lu")
    with pytest.raises(ValueError, match="mesh device"):
        ShardedBandedStepper(base, mesh=[torch.device("meta")])
    base.collect_residuals = True
    with pytest.raises(ValueError, match="'primal' residuals only"):
        ShardedBandedStepper(base)
    base.collect_residuals = False
    st = spmd.state
    # collect: the five outputs, then the squared primal residual
    *outs, r2 = pbl.banded_local_rhs(st["x"], st["au"], st["cu"], st["u"],
                                     st["warm"], base.planes, base.cfg,
                                     collect=True)
    for a, b in zip(outs, pbl.banded_local_rhs(
            st["x"], st["au"], st["cu"], st["u"], st["warm"], base.planes,
            base.cfg)):
        assert torch.equal(a, b)
    assert r2.shape == () and float(r2) >= 0.0
    # one device given explicitly is the base's
    one = ShardedBandedStepper(_pair("nh", "xla")[1],
                               mesh=[torch.device("cpu")])
    assert one.D == 1 and one.device == torch.device("cpu")
    # a scene the banded kernel does not take
    assert sharded_banded_from_system(
        small_cloth(device="cpu", fast=False)) is None
