"""Scenes shared by tests/test_torch_edits.py and
tests/test_torch_checkpoint.py, built through either package (JAX, or the
port on the CPU), f64, with the default element backend."""

import jax.numpy as jnp
import numpy as np
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.core.cloth import ClothStepper
from admm_elastic_tpu_torch.core.lattice import LatticeStepper
from admm_elastic_tpu_torch.utils import scenes
from torch_banded_scenes import build as banded_build, jittered_beam

__all__ = ["aet", "pt", "grab_beam", "arap_scene", "release", "FAST",
           "ROUTE"]


def grab_beam(pkg, **settings):
    """A 4 x 2 x 2 beam (45 nodes) anchored at x = 0, a Spring(1e3) on
    every tet edge (the JAX package compiles its step in a second, where
    a tet model's SVD takes several), a MovingAnchor on the 9 nodes of the
    free end, gravity; dt 0.04, 4 ADMM iterations. Returns (system,
    grab)."""
    mesh = pkg.geometry.make_beam_tets(4, 2, 2)
    n = mesh.n_vertices
    kw = dict(timestep_s=0.04, admm_iters=4, verbose=0, **settings)
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **kw))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu", **kw))
    m = pkg.models
    x = mesh.vertices
    s.add_nodes(x, np.full(n, 2.0 / n))
    s.add_force(m.StaticAnchor(np.flatnonzero(x[:, 0] < 1e-9)))
    edges = np.concatenate([mesh.tets[:, [a, b]] for a in range(4)
                            for b in range(a + 1, 4)])
    s.add_force(m.Spring(np.unique(np.sort(edges, axis=1), axis=0), 1e3))
    grab = s.add_force(m.MovingAnchor(
        np.flatnonzero(x[:, 0] > x[:, 0].max() - 1e-9)))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s, grab


def arap_scene(pkg, mesh, fast, mode):
    """mesh (vertices, tets) with LinearTetStrain(1e4) on the default
    backend, StaticAnchors on the nodes within a tenth of the mesh's
    length of its lowest x, gravity; 3 ADMM iterations of cg10 under
    `mode`: the banded kernel's arap mode in the port (fast), the general
    route in JAX."""
    x, tets = mesh
    n = len(x)
    kw = dict(timestep_s=0.04, admm_iters=3, verbose=0, global_solver=mode,
              cg_fixed_iters=10, lattice_fast_path=fast, reorder="none")
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **kw))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu", **kw))
    m = pkg.models
    s.add_nodes(x, np.full(n, 2.0 / n))
    a = s.add_force(m.StaticAnchor(
        np.flatnonzero(x[:, 0] < x[:, 0].min() + 0.4 * (np.ptp(x[:, 0])
                                                        / 4))))
    s.add_force(m.LinearTetStrain(tets, 1e4))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s, a


def release(weights):
    """The anchor weights with every other one released (0)."""
    w = np.array(weights, np.float64)
    w[::2] = 0.0
    return w


def _lattice(fast=True):
    """A 4 x 2 x 2 beam of tet100k's physics on the cg mode: the lattice
    window."""
    return scenes.beam_system((4, 2, 2), 0.05, 2.0, 10, torch.float64, "cpu",
                              fast=fast, global_solver="cg", admm_iters=3)


#: the port's whole-timestep routes on small scenes, f64 on the CPU
FAST = {
    "banded-dia": lambda: banded_build(pt, jittered_beam(5, 3, 3, seed=1),
                                       fast=True, admm=3, cg=10),
    "banded-ell": lambda: scenes.small_delaunay(cg=10, device="cpu"),
    "mg": lambda: scenes.small_mg_beam(device="cpu"),
    "uamg": lambda: scenes.small_uamg(device="cpu"),
    "lattice": _lattice,
    "cloth": lambda: scenes.small_cloth(device="cpu"),
}
ROUTE = {"banded-dia": BandedStepper, "banded-ell": BandedStepper,
         "mg": BandedStepper, "uamg": BandedStepper,
         "lattice": LatticeStepper, "cloth": ClothStepper}
