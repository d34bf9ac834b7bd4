"""Scenes shared by tests/test_torch_banded*.py: the jittered beam of
tests/test_banded.py built through either package (JAX, or the port on
the CPU), f64, dia solver, Pallas-backed tets on both sides."""

import jax.numpy as jnp
import numpy as np
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.utils.scenes import jittered_beam

__all__ = ["aet", "pt", "build", "jittered_beam", "mixed_shapes"]


def mixed_shapes(pkg, mesh):
    """Floor + Sphere + Cylinder under the beam (test_banded.py:166-176)."""
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    mid = 0.5 * (lo + hi)
    m = pkg.models
    return [
        m.Floor(center=(0.0, float(lo[1]) - 0.45, 0.0)),
        m.Sphere(center=(float(mid[0]), float(lo[1]) - 0.25, float(mid[2])),
                 radius=0.2),
        m.Cylinder(center=(float(lo[0]) + 0.1, float(lo[1]) - 0.2, 0.0),
                   radius=0.15),
    ]


def build(pkg, mesh, *, fast, model="nh", mu=1e4, lam=2.5e4, floor_y=None,
          anchor_w=1000.0, seed=None, admm=6, shapes=False, cg=25,
          explicit_indices=None, **settings):
    """test_banded.py build_system, for `pkg` in (aet, pt). shapes=True
    replaces the anchors by the mixed collision shapes; model="arap" takes
    a LinearTetStrain of stiffness mu in place of the hyperelastic tet."""
    n = mesh.n_vertices
    if pkg is aet:
        s = aet.System(aet.Settings(
            timestep_s=0.04, admm_iters=admm, verbose=0, dtype=jnp.float64,
            lattice_fast_path=fast, global_solver="dia", dense_max_nodes=0,
            cg_fixed_iters=cg, **settings))
    else:
        s = pt.System(pt.Settings(
            timestep_s=0.04, admm_iters=admm, verbose=0, dtype=torch.float64,
            device="cpu", global_solver="dia", lattice_fast_path=fast,
            cg_fixed_iters=cg, **settings))
    verts = mesh.vertices.copy()
    if floor_y is not None:
        verts = verts + np.array([0.0, 0.6, 0.0])
    s.add_nodes(verts, np.full(n, 2.0 / n))
    if seed is not None:  # per-element materials
        rng = np.random.RandomState(seed)
        mu = mu * (0.5 + rng.rand(len(mesh.tets)))
        lam = lam * (0.5 + rng.rand(len(mesh.tets)))
    m = pkg.models
    if model == "arap":  # LinearTetStrain with stiffness mu
        s.add_force(m.LinearTetStrain(mesh.tets, stiffness=mu,
                                      backend="pallas"))
    else:
        s.add_force(m.HyperElasticTet(mesh.tets, mu=mu, lam=lam, max_iters=4,
                                      model=model, backend="pallas"))
    if shapes:
        s.add_force(m.Collision(mixed_shapes(pkg, mesh), n_nodes=n))
    else:
        s.add_force(m.StaticAnchor([0, 1], weight=anchor_w))
    if floor_y is not None:
        s.add_force(m.Collision([m.Floor(center=(0.0, floor_y, 0.0))],
                                n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0),
                                         indices=explicit_indices))
    assert s.initialize()
    return s
