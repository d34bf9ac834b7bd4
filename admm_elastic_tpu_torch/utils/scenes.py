"""The workloads through the port's public API, for `chip_smoke.py` and
`profile_step`.

`tet100k`: a `make_beam_tets` beam with a StaticAnchor on the x=0 face,
gravity, and a kernel-backed HyperElasticTet (mu = lam = 1e5, 5 Newton
iterations) on the dia solver, dt 0.04, 10 ADMM iterations; with
`fast=True` it runs on the banded whole-timestep route
(`lattice_fast_path=True`), as `bench.py --preset tet100k` does.

`cloth100k`: the windyflag physics of `bench.py --preset cloth100k` on a
225 x 225 `make_plane_grid` sheet: kernel-backed LimitedTriangleStrain,
Bend, 26 StaticAnchors on the top edge, gravity and WindForce, dia solver;
with `fast=True` on the cloth whole-timestep route. `small_cloth` is the
8 x 6 sheet of the cloth parity tests.

`jittered_beam` is the randomly perturbed beam of the banded parity tests:
no constant-offset stencil survives the jitter, while the numbering stays
banded."""

from __future__ import annotations

import numpy as np
import torch

from ..core.system import Settings, System
from ..geometry import extract_hinges, make_beam_tets, make_plane_grid
from ..models import (Bend, Collision, Cylinder, ExplicitForce, Floor,
                      HyperElasticTet, LimitedTriangleStrain, Sphere,
                      StaticAnchor, WindForce)


def beam_system(dims, size, total_mass, cg, dtype=torch.float32,
                device="cuda", fast=False) -> System:
    beam = make_beam_tets(*dims, size=size)
    n = beam.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                        dtype=dtype, device=device, cg_fixed_iters=cg,
                        lattice_fast_path=fast))
    s.add_nodes(beam.vertices, np.full(n, total_mass / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh", backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def tet100k(cg, dtype=torch.float32, fast=False) -> System:
    """The repo's headline workload (bench.py build_tet100k): 40 x 25 x 20
    cells x 5 = 100,000 tets, 22,386 nodes, 50 kg, cell size 0.05 m."""
    return beam_system((40, 25, 20), 0.05, 50.0, cg, dtype, fast=fast)


def cloth_system(nx, ny, cg, dtype=torch.float32, device="cuda", fast=True,
                 wind=(4.0, 0.0, 1.0), anchors=None) -> System:
    """A make_plane_grid(nx, ny) sheet with bench.py build_cloth100k's
    physics and Settings: 0.5 kg, LimitedTriangleStrain(100, 0.95, 1.05),
    Bend(20), StaticAnchors on the top edge (every len(top)//24-th vertex,
    or the first `anchors`), gravity and WindForce(wind)."""
    mesh = make_plane_grid(nx, ny)
    n = mesh.n_vertices
    s = System(Settings(
        timestep_s=0.04, admm_iters=10, verbose=0, dtype=dtype,
        device=device, global_solver="dia", cg_fixed_iters=cg,
        cg_backend="fused", preconditioner="jacobi", lattice_fast_path=fast))
    s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05,
                                      backend="pallas"))
    s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
    top = np.flatnonzero(np.abs(mesh.vertices[:, 1]
                                - mesh.vertices[:, 1].max()) < 1e-9)
    s.add_force(StaticAnchor(top[:: max(1, len(top) // 24)]
                             if anchors is None else top[:anchors]))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    s.add_explicit_force(WindForce(mesh.faces, direction=wind))
    assert s.initialize()
    return s


def cloth100k(cg, dtype=torch.float32, fast=True) -> System:
    """bench.py build_cloth100k: 225 x 225 quads, 51,076 nodes, 101,250
    triangles, 151,425 hinges, 26 anchors, wind (4, 0, 1)."""
    return cloth_system(225, 225, cg, dtype, fast=fast)


def small_cloth(dtype=torch.float64, device="cuda", fast=True) -> System:
    """The 8 x 6 sheet of tests/test_cloth_fast.py: the same physics with
    4 anchors, wind (1.5, 0, 0.4) (the cloth100k wind makes so coarse a
    sheet diverge) and 30 CG iterations."""
    return cloth_system(8, 6, 30, dtype, device, fast, wind=(1.5, 0.0, 0.4),
                        anchors=4)


def jittered_beam(nx=4, ny=3, nz=3, seed=0, jitter=0.08):
    """make_beam_tets(nx, ny, nz, size=0.25) with every vertex moved by
    jitter * 0.25 * N(0, 1) per axis (np.random.RandomState(seed))."""
    mesh = make_beam_tets(nx, ny, nz, size=0.25)
    rng = np.random.RandomState(seed)
    mesh.vertices = mesh.vertices + jitter * 0.25 * rng.randn(
        *mesh.vertices.shape)
    return mesh


def jittered_system(dims=(8, 6, 5), cg=25, dtype=torch.float64,
                    device="cuda", fast=True) -> System:
    """The jittered beam (seed 0) pinned at vertices 0 and 1 (weight 1000),
    NeoHookean (mu 1e4, lam 2.5e4, 4 Newton iterations, 2 kg), falling
    onto a Floor, a Sphere and a Cylinder below it (the shapes of
    tests/test_banded.py:166-176): every branch of the banded kernel."""
    mesh = jittered_beam(*dims)
    n = mesh.n_vertices
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    mid = 0.5 * (lo + hi)
    s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                        dtype=dtype, device=device, cg_fixed_iters=cg,
                        lattice_fast_path=fast))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4, max_iters=4,
                                model="nh", backend="pallas"))
    s.add_force(StaticAnchor([0, 1], weight=1000.0))
    s.add_force(Collision([
        Floor(center=(0.0, float(lo[1]) - 0.45, 0.0)),
        Sphere(center=(float(mid[0]), float(lo[1]) - 0.25, float(mid[2])),
               radius=0.2),
        Cylinder(center=(float(lo[0]) + 0.1, float(lo[1]) - 0.2, 0.0),
                 radius=0.15),
    ], n_nodes=n))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s
