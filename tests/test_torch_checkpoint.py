"""Checkpoints of the port (`System.save_checkpoint`, `load_checkpoint`,
`utils/checkpoint.py`), f64 on the CPU.

Within the port, bitwise: a System saved mid-run and loaded into a fresh
one built the same way steps on as the original, on the general route
(the grab beam of tests/test_torch_edits.py, dragged and released, so the
file holds a MovingAnchor's control points and flags) and on every
whole-timestep route (banded dia and ELL, multigrid, algebraic multigrid,
lattice, cloth), whose state is copied into the stepper's own buffers.
Across the packages, on the general route: a JAX checkpoint loaded into
the port and a port checkpoint loaded into JAX, 3 steps on, within 1e-10
of the package that saved it. The JAX package's errors where route, keys
or shapes differ, a JAX whole-timestep checkpoint in the port among them
(each package's stepper keeps its own state)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.utils.checkpoint import load_state, save_state
from torch_edit_scenes import FAST, aet, grab_beam, pt

torch.set_num_threads(1)

GENERAL = {"dia": dict(global_solver="dia", cg_fixed_iters=30),
           "dense": dict(global_solver="dense")}


def drag_and_release(s, grab):
    """Two steps with the grab moved, then its release."""
    for k in range(2):
        s.set_force_state(grab, "pos", np.asarray(s.x)[grab.indices]
                          + 0.05 * (k + 1))
        s.step()
    n = grab.n_elements
    s.set_force_param(grab, "weight", np.zeros(n))
    s.set_force_state(grab, "active", np.zeros(n, bool))
    s.recompute_weights()


@pytest.mark.parametrize("mode", list(GENERAL))
def test_general_resumes_bitwise(mode, tmp_path):
    path = str(tmp_path / "general.npz")
    a, grab = grab_beam(pt, **GENERAL[mode])
    drag_and_release(a, grab)
    a.step()
    a.save_checkpoint(path)
    a.run(3)
    b, bgrab = grab_beam(pt, **GENERAL[mode])
    drag_and_release(b, bgrab)  # the same weights, from a fresh start
    b.x = np.zeros_like(b.x)
    b.load_checkpoint(path)
    assert b.elapsed_s == pytest.approx(3 * 0.04)
    assert not b.state["forces"][bgrab.name]["active"].any()
    b.run(3)
    np.testing.assert_array_equal(a.x, b.x)
    for k in a.state["u"]:
        assert torch.equal(a.state["u"][k], b.state["u"][k]), k


@pytest.mark.parametrize("route", list(FAST))
def test_stepper_resumes_bitwise(route, tmp_path):
    path = str(tmp_path / "fast.npz")
    a = FAST[route]()
    a.run(1)
    a.save_checkpoint(path)
    a.run(2)
    b = FAST[route]()
    buffers = dict(b._stepper.state)
    b.load_checkpoint(path)
    assert b.elapsed_s == pytest.approx(0.04)
    assert all(b._stepper.state[k] is t for k, t in buffers.items())
    b.run(2)
    for k, t in a._stepper.state.items():
        assert torch.equal(t, b._stepper.state[k]), k


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_general_checkpoint_crosses_packages(saver, tmp_path):
    """The general route's file has the same keys in both packages."""
    path = str(tmp_path / "cross.npz")
    pkgs = {"jax": aet, "port": pt}
    src, grab = grab_beam(pkgs[saver], **GENERAL["dia"])
    drag_and_release(src, grab)
    src.step()
    src.save_checkpoint(path)
    with np.load(path) as f:
        keys = set(f.files)
    assert "forces/c2_MovingAnchor/active" in keys and "_elapsed_s" in keys
    for _ in range(3):
        src.step()
    dst, dgrab = grab_beam(pkgs["port" if saver == "jax" else "jax"],
                           **GENERAL["dia"])
    drag_and_release(dst, dgrab)
    dst.load_checkpoint(path)
    for _ in range(3):
        dst.step()
    err = float(np.abs(np.asarray(dst.x) - np.asarray(src.x)).max())
    assert err < 1e-10, err


def test_mismatches_raise(tmp_path):
    gen, fast = (str(tmp_path / f"{k}.npz") for k in ("gen", "fast"))
    s = FAST["banded-dia"]()
    s.save_checkpoint(fast)
    g, _ = grab_beam(pt, **GENERAL["dia"])
    g.save_checkpoint(gen)
    with pytest.raises(ValueError, match="saved from the general path"):
        s.load_checkpoint(gen)
    with pytest.raises(ValueError, match="saved from a whole-timestep fast"):
        g.load_checkpoint(fast)
    # another mesh on the same route
    other = FAST["mg"]()
    with pytest.raises(ValueError, match="mesh/settings differ"):
        other.load_checkpoint(fast)
    # a JAX whole-timestep checkpoint: the JAX banded stepper's planes
    from torch_banded_scenes import build, jittered_beam

    j = build(aet, jittered_beam(5, 3, 3, seed=1), fast=True, admm=3, cg=10)
    assert j._lattice is not None
    jfast = str(tmp_path / "jfast.npz")
    j.save_checkpoint(jfast)
    with pytest.raises(ValueError, match="keys .* do not match"):
        s.load_checkpoint(jfast)


def test_save_load_state_tree(tmp_path):
    """load_state's `like` restores empty sub-dicts, casts floats to the
    dtype and keeps integer and bool leaves, as the JAX module's."""
    path = str(tmp_path / "tree.npz")
    tree = {"x": torch.arange(6.0).reshape(2, 3), "forces": {"a": {},
            "b": {"on": np.array([True, False]), "i": np.arange(3)}}}
    save_state(path, tree)
    out = load_state(path, dtype=torch.float32, like=tree)
    assert out["forces"]["a"] == {}
    assert out["x"].dtype == torch.float32
    assert out["forces"]["b"]["on"].dtype == torch.bool
    assert out["forces"]["b"]["i"].tolist() == [0, 1, 2]
    from admm_elastic_tpu.utils.checkpoint import load_state as jax_load

    j = jax_load(path, dtype=jnp.float64, like={
        "x": np.zeros((2, 3)), "forces": {"a": {}, "b": {"on": 0, "i": 0}}})
    np.testing.assert_array_equal(np.asarray(j["x"]), out["x"].numpy())
