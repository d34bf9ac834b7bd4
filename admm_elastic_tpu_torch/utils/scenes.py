"""The workloads through the port's public API, for `chip_smoke.py` and
`profile_step`.

`tet100k`: a `make_beam_tets` beam with a StaticAnchor on the x=0 face,
gravity, and a kernel-backed HyperElasticTet (mu = lam = 1e5, 5 Newton
iterations) on the dia solver, dt 0.04, 10 ADMM iterations; with
`fast=True` it runs on the banded whole-timestep route
(`lattice_fast_path=True`), as `bench.py --preset tet100k` does, and with
`global_solver="dense"` on the dense inverse (as `bench.py --preset tet100k
--global-solver dense`, dense_max_nodes raised past its 22,386 nodes); with
`fast=True, global_solver="cg"` on the lattice whole-timestep route (the
banded kernel takes only the dia and ell modes, so the JAX package's chain
reaches the lattice kernel).

`arap100k`: tet100k's beam, anchors, gravity, masses and Settings with a
kernel-backed LinearTetStrain (stiffness 1e5) in place of the NeoHookean
tet: k = stiffness vol equals the NeoHookean scene's min(mu, lam) vol, so
the weights and A_hat are the same. No bench.py preset runs this model at
this size (plinko's LinearTetStrain mesh, horse759, is not in the repo);
it is the port's full-width workload of the corotational tet. With
`relaxation` != 1 it runs the unfused pipeline; with `fast=True` the banded
kernel's arap mode.

`cloth100k`: the windyflag physics of `bench.py --preset cloth100k` on a
225 x 225 `make_plane_grid` sheet: kernel-backed LimitedTriangleStrain,
Bend, 26 StaticAnchors on the top edge, gravity and WindForce, dia solver;
with `fast=True` on the cloth whole-timestep route, with
`global_solver="cg"` (and fast=False) on the matrix-free CG of the unfused
pipeline. `small_cloth` is the 8 x 6 sheet of the cloth parity tests.

`tet100k_sharded`: tet100k's scene on the sharded banded stepper at one
device (`parallel/banded_spmd.py`): `tet100k(budget, fast=True)`, then
`sharded_banded_from_system` with solver "cg" (a `budget`-iteration
Jacobi-PCG per solve) or "cheb" (`budget` Chebyshev iterations; the bounds
from a host Lanczos at construction, seconds at this size).

`jittered_beam` is the randomly perturbed beam of the banded parity tests:
no constant-offset stencil survives the jitter, while the numbering stays
banded.

`delaunay100k`: `bench.py --preset delaunay100k`, a tet mesh of arbitrary
topology: the Delaunay tetrahedralisation of a jittered 37 x 22 x 20 grid
of points (16,280 nodes, 100,852 tets), whose A_hat has 73 diagonals in its
numbering, so it runs on the ell solver (`cg_backend` xla, fused or
kernel) or, with `fast=True`, on the banded route with the ELL matvec.
`small_delaunay` is the 7 x 5 x 4 mesh of tests/test_uell.py."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.banded import BandedStepper
from ..core.system import Settings, System
from ..geometry import extract_hinges, make_beam_tets, make_plane_grid
from ..models import (Bend, Collision, Cylinder, ExplicitForce, Floor,
                      HyperElasticTet, LimitedTriangleStrain, LinearTetStrain,
                      Sphere, StaticAnchor, WindForce)


def beam_system(dims, size, total_mass, cg, dtype=torch.float32,
                device="cuda", fast=False, arap=False,
                **settings) -> System:
    """An anchored beam under gravity: NeoHookean tets (mu = lam = 1e5, 5
    Newton iterations) or, with arap=True, LinearTetStrain (stiffness 1e5),
    kernel-backed; dia solver unless `settings` say otherwise."""
    beam = make_beam_tets(*dims, size=size)
    n = beam.n_vertices
    s = System(Settings(**{
        "timestep_s": 0.04, "admm_iters": 10, "verbose": 0, "dtype": dtype,
        "device": device, "global_solver": "dia", "cg_fixed_iters": cg,
        "lattice_fast_path": fast, **settings}))
    s.add_nodes(beam.vertices, np.full(n, total_mass / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    if arap:
        s.add_force(LinearTetStrain(beam.tets, stiffness=1e5,
                                    backend="pallas"))
    else:
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                    model="nh", backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def tet100k(cg, dtype=torch.float32, fast=False,
            global_solver="dia") -> System:
    """The repo's headline workload (bench.py build_tet100k): 40 x 25 x 20
    cells x 5 = 100,000 tets, 22,386 nodes, 50 kg, cell size 0.05 m.
    global_solver="dense" raises dense_max_nodes past n, as bench.py does
    (the inverse is 2.0 GB in f32); cg is then unused."""
    return beam_system((40, 25, 20), 0.05, 50.0, cg, dtype, fast=fast,
                       global_solver=global_solver, dense_max_nodes=1 << 30)


def tet100k_sharded(solver="cg", budget=75, dtype=torch.float32):
    """The ShardedBandedStepper of tet100k (see the module docstring)."""
    from ..parallel import sharded_banded_from_system

    spmd, _ = sharded_banded_from_system(tet100k(budget, dtype, fast=True),
                                         solver=solver, cheb_iters=budget)
    return spmd


def arap100k(cg, dtype=torch.float32, relaxation=1.0,
             fast=False) -> System:
    """tet100k with LinearTetStrain(stiffness=1e5) in place of the
    NeoHookean tet, on the dia solver (see the module docstring)."""
    return beam_system((40, 25, 20), 0.05, 50.0, cg, dtype, fast=fast,
                       arap=True, relaxation=relaxation)


def cloth_system(nx, ny, cg, dtype=torch.float32, device="cuda", fast=True,
                 wind=(4.0, 0.0, 1.0), anchors=None, **settings) -> System:
    """A make_plane_grid(nx, ny) sheet with bench.py build_cloth100k's
    physics and Settings (unless `settings` say otherwise): 0.5 kg,
    LimitedTriangleStrain(100, 0.95, 1.05), Bend(20), StaticAnchors on the
    top edge (every len(top)//24-th vertex, or the first `anchors`),
    gravity and WindForce(wind)."""
    mesh = make_plane_grid(nx, ny)
    n = mesh.n_vertices
    s = System(Settings(**{
        "timestep_s": 0.04, "admm_iters": 10, "verbose": 0, "dtype": dtype,
        "device": device, "global_solver": "dia", "cg_fixed_iters": cg,
        "cg_backend": "fused", "preconditioner": "jacobi",
        "lattice_fast_path": fast, **settings}))
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


def cloth100k(cg, dtype=torch.float32, fast=True,
              global_solver="dia") -> System:
    """bench.py build_cloth100k: 225 x 225 quads, 51,076 nodes, 101,250
    triangles, 151,425 hinges, 26 anchors, wind (4, 0, 1)."""
    return cloth_system(225, 225, cg, dtype, fast=fast,
                        global_solver=global_solver)


def small_cloth(dtype=torch.float64, device="cuda", fast=True,
                **settings) -> System:
    """The 8 x 6 sheet of tests/test_cloth_fast.py: the same physics with
    4 anchors, wind (1.5, 0, 0.4) (the cloth100k wind makes so coarse a
    sheet diverge) and 30 CG iterations."""
    return cloth_system(8, 6, 30, dtype, device, fast, wind=(1.5, 0.0, 0.4),
                        anchors=4, **settings)


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
                        dtype=dtype, device=device, global_solver="dia",
                        cg_fixed_iters=cg, lattice_fast_path=fast))
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


def delaunay_mesh(nx=7, ny=5, nz=4, jitter=0.3, seed=0, scale=0.1,
                  emax=None):
    """Delaunay tets over the nx x ny x nz integer grid moved by
    U(-jitter, jitter) per axis (np.random.default_rng(seed)) and scaled;
    tets whose longest edge reaches emax (default 2.2 scale) are dropped,
    and the orientation is fixed. Returns (points (n,3), tets (E,4))."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    pts *= scale
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    longest = np.linalg.norm(pp[:, :, None, :] - pp[:, None, :, :],
                             axis=-1).max(axis=(1, 2))
    tets = tets[longest < (2.2 * scale if emax is None else emax)]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    return pts, tets


def delaunay_system(pts, tets, total_mass, stiffness, anchor_dx, cg,
                    dtype=torch.float32, device="cuda", fast=True,
                    cg_backend="xla") -> System:
    """A tet mesh on the ell solver: StaticAnchors at x < min x +
    anchor_dx, NeoHookean tets (mu = lam = stiffness, 5 Newton iterations,
    kernel-backed), gravity, dt 0.04, 10 ADMM iterations."""
    n = len(pts)
    s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                        dtype=dtype, device=device, global_solver="ell",
                        cg_fixed_iters=cg, cg_backend=cg_backend,
                        preconditioner="jacobi", lattice_fast_path=fast))
    s.add_nodes(pts, np.full(n, total_mass / n))
    s.add_force(StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + anchor_dx)))
    s.add_force(HyperElasticTet(tets, mu=stiffness, lam=stiffness,
                                max_iters=5, model="nh", backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    if fast:
        assert isinstance(s._stepper, BandedStepper), type(s._stepper)
        assert s._stepper.cfg.matrix == "ell"
    return s


def delaunay100k(cg, dtype=torch.float32, fast=True, cg_backend="xla",
                 device="cuda") -> System:
    """bench.py build_delaunay100k: 50 kg, mu = lam = 1e5, anchors within
    half a grid spacing of the minimum x. bench's general route
    (--no-lattice) builds its tets with the default backend='xla', which
    the port does not have; here they are kernel-backed (the same prox
    through nh_local_step_fused). The banded route ignores the backend."""
    pts, tets = (a.copy() for a in _delaunay100k_mesh())
    return delaunay_system(pts, tets, 50.0, 1e5, 0.5 * 0.05, cg, dtype,
                           device, fast, cg_backend)


@functools.cache
def _delaunay100k_mesh():
    """The tetrahedralisation takes seconds: made once per process; callers
    take copies."""
    return delaunay_mesh(37, 22, 20, scale=0.05, emax=0.11)


def small_delaunay(cg=25, dtype=torch.float64, device="cuda", fast=True,
                   cg_backend="xla") -> System:
    """tests/test_uell.py's scene: its 7 x 5 x 4 mesh (140 nodes), 2 kg,
    mu = lam = 1e4, anchors at the minimum x."""
    pts, tets = delaunay_mesh()
    return delaunay_system(pts, tets, 2.0, 1e4, 1e-3, cg, dtype, device,
                           fast, cg_backend)
