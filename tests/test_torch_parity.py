"""Trajectory parity of the port: the PyTorch System with its default
(`backend="xla"`) element models against the direct numpy transcription of
the reference algorithm (tests/reference_impl.py), f64 on the CPU.

The six cases of tests/test_parity.py, scene for scene and with its
tolerances: the single stretched tet, the spring chain (dense and cg), the
cloth, the full windyflag physics and the tets dropping onto collision
shapes. Only the port runs here; the JAX package is not imported."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import admm_elastic_tpu_torch as pt  # noqa: E402
from admm_elastic_tpu_torch.geometry import extract_hinges, make_sym_plane  # noqa: E402
from admm_elastic_tpu_torch.models import (  # noqa: E402
    Bend,
    Collision,
    Cylinder,
    ExplicitForce,
    Floor,
    LimitedTriangleStrain,
    LinearTetStrain,
    Sphere,
    Spring,
    StaticAnchor,
    WindForce,
)
from reference_impl import (  # noqa: E402
    RefAnchor,
    RefBend,
    RefCollision,
    RefLinearTetStrain,
    RefSpring,
    RefSystem,
    RefTriangleStrain,
    RefWind,
)

torch.set_num_threads(1)


def _sys(dt, iters, mode="dense"):
    return pt.System(pt.Settings(
        timestep_s=dt, admm_iters=iters, verbose=0, dtype=torch.float64,
        global_solver=mode, cg_tol=1e-13, cg_max_iters=2000, device="cpu"))


def test_singletet_parity():
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    stretched = x.copy()
    stretched[3, 0] = 200.0

    ref = RefSystem(dt=1.0, iters=20)
    ref.setup(x, np.ones(4))
    ref.forces += [RefAnchor(0), RefAnchor(1), RefAnchor(2),
                   RefLinearTetStrain([0, 1, 2, 3], 1.0)]
    ref.initialize()
    ref.x = stretched.reshape(-1).copy()

    sys_ = _sys(1.0, 20)
    sys_.add_nodes(x, np.ones(4))
    sys_.add_force(StaticAnchor([0, 1, 2]))
    sys_.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=1.0))
    assert sys_.initialize()
    sys_.x = stretched

    for _ in range(4):
        ref.step()
        sys_.step()
        np.testing.assert_allclose(sys_.x.reshape(-1), ref.x, rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("mode", ["dense", "cg"])
def test_spring_chain_parity(mode):
    n = 5
    x = np.stack([np.linspace(0, 1, n), np.zeros(n), np.zeros(n)], axis=1)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)

    ref = RefSystem(dt=0.02, iters=12)
    ref.setup(x, np.full(n, 0.1))
    ref.forces.append(RefAnchor(0))
    for e in edges:
        ref.forces.append(RefSpring(int(e[0]), int(e[1]), 500.0))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])

    sys_ = _sys(0.02, 12, mode)
    sys_.add_nodes(x, np.full(n, 0.1))
    sys_.add_force(StaticAnchor([0]))
    sys_.add_force(Spring(edges, stiffness=500.0))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()

    for _ in range(8):
        ref.step()
        sys_.step()
        np.testing.assert_allclose(sys_.x.reshape(-1), ref.x, rtol=1e-8,
                                   atol=1e-9)


def _cloth_pair(tess, anchors, iters, wind_dir=None):
    """The reference's and the port's sym-plane cloth: triangle strain
    (100, limits 0.95 / 1.05), bend (20), two anchors, gravity and, with
    wind_dir, the Wejchert-Haumann wind."""
    mesh = make_sym_plane(*tess)
    n = mesh.n_vertices
    masses = np.full(n, 0.5 / n)
    hinges = extract_hinges(mesh.faces)

    ref = RefSystem(dt=0.04, iters=iters)
    ref.setup(mesh.vertices, masses)
    for a in anchors:
        ref.forces.append(RefAnchor(a))
    for f in mesh.faces:
        ref.forces.append(
            RefTriangleStrain([int(v) for v in f], 100.0, 0.95, 1.05))
    for h in hinges:
        ref.forces.append(RefBend([int(v) for v in h], 20.0))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])
    if wind_dir is not None:
        ref.wind = RefWind(mesh.faces, wind_dir)

    sys_ = _sys(0.04, iters)
    sys_.add_nodes(mesh.vertices, masses)
    sys_.add_force(StaticAnchor(list(anchors)))
    sys_.add_force(LimitedTriangleStrain(mesh.faces, stiffness=100.0,
                                         limit_min=0.95, limit_max=1.05))
    sys_.add_force(Bend(hinges, stiffness=20.0))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    if wind_dir is not None:
        sys_.add_explicit_force(WindForce(mesh.faces, direction=wind_dir))
    assert sys_.initialize()
    return ref, sys_


@pytest.mark.parametrize("case", ["cloth", "windyflag"])
def test_cloth_parity(case):
    """Plane cloth with triangle strain + bend + anchors + gravity (the
    windyflag physics minus wind), and the complete windyflag physics
    with the wind, vs the numpy oracle."""
    if case == "cloth":
        ref, sys_ = _cloth_pair((3, 2), (0, 2), 15)
    else:
        ref, sys_ = _cloth_pair((3, 3), (0, 3), 10,
                                np.array([2.0, 0.0, 0.5]))
    for step in range(6):
        ref.step()
        sys_.step()
        np.testing.assert_allclose(
            sys_.x.reshape(-1), ref.x, rtol=1e-7, atol=1e-8,
            err_msg=f"divergence at step {step}")


def test_collision_parity():
    """Tet body dropping onto a floor + cylinder + sphere (plinkopony
    physics) vs the numpy oracle: identity-selector collision force inside
    ADMM."""
    x = np.array(
        [[0, 1.2, 0], [0.4, 1.2, 0], [0, 1.6, 0], [0, 1.2, 0.4],
         [0.6, 1.7, 0.2]], dtype=float)
    tets = np.array([[0, 1, 2, 3], [4, 1, 2, 3]], dtype=np.int32)
    n = len(x)
    shapes_ours = [Floor(center=(0, 0.0, 0)),
                   Cylinder(center=(0.2, 0.6, 0), radius=0.3),
                   Sphere(center=(-0.3, 0.5, 0.1), radius=0.25)]
    shapes_ref = [("floor", 0.0), ("cylinder", (0.2, 0.6), 0.3),
                  ("sphere", (-0.3, 0.5, 0.1), 0.25)]

    ref = RefSystem(dt=0.04, iters=13)
    ref.setup(x, np.ones(n))
    for t in tets:
        ref.forces.append(RefLinearTetStrain([int(v) for v in t], 1e4))
    ref.forces.append(RefCollision(n, shapes_ref))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])

    sys_ = _sys(0.04, 13)
    sys_.add_nodes(x, np.ones(n))
    sys_.add_force(LinearTetStrain(tets, stiffness=1e4))
    sys_.add_force(Collision(shapes_ours, n_nodes=n))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()

    for step in range(12):
        ref.step()
        sys_.step()
        np.testing.assert_allclose(
            sys_.x.reshape(-1), ref.x, rtol=1e-6, atol=1e-7,
            err_msg=f"divergence at step {step}")
