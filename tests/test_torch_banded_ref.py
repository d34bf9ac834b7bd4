"""The port's banded whole-timestep route (plain twin on the CPU) against
the JAX package's banded kernel (`BandedStepper`, Pallas interpret mode),
on the jittered beams of tests/test_banded.py, f64, in the nh, stvk and
arap modes.

Tolerances: 1e-8 for one ADMM iteration, the slice parity bound of
tests/test_torch_system.py: torch's CPU sqrt and XLA's log differ in the
last bit on a fraction of a percent of inputs, and the Newton ladder turns
that into differences of up to ~3e-8 in sigma on tie elements (PERF.md, PR
1). Trajectories: test_banded.py's rtol 1e-6 / atol 1e-8 (x) and 1e-5 /
1e-7 (v). Each JAX run is made once per module."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import numpy as np
import pytest
import torch

from admm_elastic_tpu.core.banded import BandedStepper as JaxBandedStepper
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.utils import banded_from_reference
from torch_banded_scenes import aet, build, jittered_beam, pt

torch.set_num_threads(1)

SCENES = {
    "one-iteration": (dict(), dict(admm=1), 1),
    "nh": (dict(), dict(), 5),
    "stvk": (dict(), dict(model="stvk"), 5),
    "materials": (dict(seed=3), dict(seed=7), 5),
    "floor-anchor-w0": (dict(seed=5), dict(floor_y=0.0, anchor_w=0.0), 8),
    "floor-sphere-cylinder": (dict(seed=11), dict(shapes=True), 10),
    "arap": (dict(seed=2), dict(model="arap"), 5),
}


def _run(pkg, name):
    mesh_kw, kw, steps = SCENES[name]
    s = build(pkg, jittered_beam(**mesh_kw), fast=True, **kw)
    if pkg is aet:
        assert isinstance(s._lattice, JaxBandedStepper)
    else:
        assert isinstance(s._stepper, BandedStepper)
    for _ in range(steps):
        s.step()
    return s


@pytest.fixture(scope="module", params=list(SCENES))
def jax_run(request):
    s = _run(aet, request.param)
    out = (request.param, np.asarray(s.x), np.asarray(s.v),
           jax.device_get(s._lattice.state))
    if request.param != "arap":
        return out
    # one step more from that state, for the carry-over of an arap stepper
    st = s._lattice
    carry = (np.asarray(st._subs), np.asarray(st._positions))
    s.step()
    return (*out, carry, np.asarray(s.x))


def test_matches_jax_banded(jax_run):
    name, x, v, state = jax_run[:4]
    s = _run(pt, name)
    if name == "one-iteration":
        assert np.abs(s.x - x).max() < 1e-8, np.abs(s.x - x).max()
        assert np.abs(s.v - v).max() < 1e-8, np.abs(s.v - v).max()
    else:
        np.testing.assert_allclose(s.x, x, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(s.v, v, rtol=1e-5, atol=1e-7)
    if name == "floor-anchor-w0":
        assert x[:, 1].min() > -0.25  # the floor acts
        # released anchors: both kernels keep the anchor dual exactly 0
        assert not np.asarray(state["ancu"]).any()
        assert torch.count_nonzero(s._stepper.state["au"]) == 0
    if name == "floor-sphere-cylinder":
        lo = jittered_beam(seed=11).vertices[:, 1].min()
        assert x[:, 1].min() > lo - 0.8, "shapes must stop the fall"
    if name == "arap":
        # the kernel's arap mode, and banded_from_reference on its stepper
        assert s._stepper.cfg.model == "arap"
        (subs, positions), x_next = jax_run[4:]
        c = build(pt, jittered_beam(**SCENES[name][0]), fast=True,
                  **SCENES[name][1])
        banded_from_reference(c._stepper, state, subs, positions)
        np.testing.assert_array_equal(c.x, x)
        c.step()
        np.testing.assert_allclose(c.x, x_next, rtol=1e-6, atol=1e-8)


@pytest.fixture(scope="module")
def jax_carry():
    """The JAX banded stepper's state after 2 steps, then 1 step more."""
    mesh = jittered_beam(seed=9)
    s = build(aet, mesh, fast=True, floor_y=0.0)
    assert np.array_equal(s._to_canon, np.arange(mesh.n_vertices))
    s.run(2)
    st = s._lattice
    snap = (jax.device_get(st.state), np.asarray(st._subs),
            np.asarray(st._positions))
    s.step()
    return mesh, snap, np.asarray(s.x), np.asarray(s.v)


def test_carry_over_from_jax_banded(jax_carry):
    mesh, (state, subs, positions), x3, v3 = jax_carry
    s = build(pt, mesh, fast=True, floor_y=0.0)
    banded_from_reference(s._stepper, state, subs, positions)
    np.testing.assert_array_equal(
        s.x, np.asarray(state["x"]).reshape(3, -1)[:, positions].T)
    assert float(s._stepper.state["t"]) == pytest.approx(0.08)
    s.step()
    # v = (x - x_prev)/dt: x's 1e-8 bound times 1/dt = 25, so v takes the
    # trajectory tolerance
    assert np.abs(s.x - x3).max() < 1e-8, np.abs(s.x - x3).max()
    np.testing.assert_allclose(s.v, v3, rtol=1e-5, atol=1e-7)
