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
reaches the lattice kernel); with `amg=True` on the banded route with the
in-kernel geometric multigrid (`bench.py --preset tet100k --amg`).
`small_mg_beam` is the 6 x 5 x 4 beam of the multigrid tests.

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
pipeline; with `amg=True` on the cloth route with the in-kernel 2D
multigrid (bench.py build_cloth100k(amg=True), its matched row). `small_cloth`
is the 8 x 6 sheet of the cloth parity tests.

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
`small_delaunay` is the 7 x 5 x 4 mesh of tests/test_uell.py. With
`amg=True` delaunay100k is `bench.py --preset delaunay100k --amg`: the
banded route with the in-kernel algebraic multigrid (16,280 -> 3,696 ->
501 dofs), bench's 6 V-cycle PCG iterations a solve; with `fast=False`
the general ell route (xla) with the aggregation AMG. `small_uamg` is the
10 x 7 x 6 Delaunay mesh of tests/test_uamg.py (420 nodes) on the
algebraic multigrid route.

`sweep64`: `bench.py --preset sweep64` (bench_sweep): 64 drops of one
beam with varied stiffness, the scenario sweep (`core/sweep.py`) on the
ell solver (bench's) or dia. The armadillo mesh bench names is not in the
repo, so the preset's own fallback stands in: make_beam_tets(10, 8, 7,
size=0.1), 792 nodes, 2,800 tets. `jittered_sweep` is a small sweep of
the jittered beam for the card checks: stiffness, optionally anchor
weights and a floor, in either matrix form and model.

`banded_spd` is a random banded SPD system of any size in both the dia and
the ELL form, for the CG solves at sizes no mesh gives (fewer rows than a
cluster has CTAs, a last slab cut short, slabs too large for shared
memory); `renumbered_ell` gives an ELL system a random numbering, whose
rows reach across all of n."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.banded import BandedStepper
from ..core.solver import assemble_A_hat_dia, ell_apply
from ..core.system import Settings, System
from ..geometry import extract_hinges, make_beam_tets, make_plane_grid
from ..models import (Bend, Collision, Cylinder, ExplicitForce, Floor,
                      HyperElasticTet, LimitedTriangleStrain, LinearTetStrain,
                      Sphere, StaticAnchor, WindForce)

DT = 0.04  # every scene's timestep


def beam_system(dims, size, total_mass, cg, dtype=torch.float32,
                device="cuda", fast=False, arap=False,
                **settings) -> System:
    """An anchored beam under gravity: NeoHookean tets (mu = lam = 1e5, 5
    Newton iterations) or, with arap=True, LinearTetStrain (stiffness 1e5),
    kernel-backed; dia solver unless `settings` say otherwise."""
    vertices, tets = _beam_mesh(tuple(dims), size)
    n = vertices.shape[0]
    s = System(Settings(**{
        "timestep_s": 0.04, "admm_iters": 10, "verbose": 0, "dtype": dtype,
        "device": device, "global_solver": "dia", "cg_fixed_iters": cg,
        "lattice_fast_path": fast, **settings}))
    s.add_nodes(vertices.copy(), np.full(n, total_mass / n))
    s.add_force(StaticAnchor(np.flatnonzero(vertices[:, 0] < 1e-9)))
    if arap:
        s.add_force(LinearTetStrain(tets.copy(), stiffness=1e5,
                                    backend="pallas"))
    else:
        s.add_force(HyperElasticTet(tets.copy(), mu=1e5, lam=1e5,
                                    max_iters=5, model="nh",
                                    backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


@functools.cache
def _beam_mesh(dims, size):
    """make_beam_tets' (vertices, tets), made once per process (the scenes
    build the same beam many times); callers take copies."""
    beam = make_beam_tets(*dims, size=size)
    return beam.vertices, beam.tets


@functools.cache
def _sheet(nx, ny):
    """make_plane_grid's (vertices, faces) and their bend hinges, made once
    per process (extract_hinges walks the faces in Python, ~1 s at
    cloth100k); callers take copies."""
    mesh = make_plane_grid(nx, ny)
    return mesh.vertices, mesh.faces, extract_hinges(mesh.faces)


def tet100k(cg, dtype=torch.float32, fast=False,
            global_solver="dia", amg=False) -> System:
    """The repo's headline workload (bench.py build_tet100k): 40 x 25 x 20
    cells x 5 = 100,000 tets, 22,386 nodes, 50 kg, cell size 0.05 m.
    global_solver="dense" raises dense_max_nodes past n, as bench.py does
    (the inverse is 2.0 GB in f32); cg is then unused. amg=True is
    `bench.py --amg` (build_tet100k(amg=True)): the banded route with the
    in-kernel multigrid, cg V-cycle PCG iterations a solve (bench's 6)."""
    if amg:
        fast, global_solver = True, "dia"
    return beam_system((40, 25, 20), 0.05, 50.0, cg, dtype, fast=fast,
                       global_solver=global_solver, dense_max_nodes=1 << 30,
                       preconditioner="amg" if amg else "jacobi")


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
    vertices, faces, hinges = _sheet(nx, ny)
    n = vertices.shape[0]
    s = System(Settings(**{
        "timestep_s": 0.04, "admm_iters": 10, "verbose": 0, "dtype": dtype,
        "device": device, "global_solver": "dia", "cg_fixed_iters": cg,
        "cg_backend": "fused", "preconditioner": "jacobi",
        "lattice_fast_path": fast, **settings}))
    s.add_nodes(vertices.copy(), np.full(n, 0.5 / n))
    s.add_force(LimitedTriangleStrain(faces.copy(), 100.0, 0.95, 1.05,
                                      backend="pallas"))
    s.add_force(Bend(hinges.copy(), 20.0))
    top = np.flatnonzero(np.abs(vertices[:, 1] - vertices[:, 1].max())
                         < 1e-9)
    s.add_force(StaticAnchor(top[:: max(1, len(top) // 24)]
                             if anchors is None else top[:anchors]))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    s.add_explicit_force(WindForce(faces.copy(), direction=wind))
    assert s.initialize()
    return s


def cloth100k(cg, dtype=torch.float32, fast=True,
              global_solver="dia", amg=False) -> System:
    """bench.py build_cloth100k: 225 x 225 quads, 51,076 nodes, 101,250
    triangles, 151,425 hinges, 26 anchors, wind (4, 0, 1). amg=True is
    build_cloth100k(amg=True): the cloth route with the in-kernel 2D
    multigrid (ladder (2, 8)), cg V-cycle PCG iterations a solve (bench's
    8)."""
    return cloth_system(225, 225, cg, dtype, fast=fast or amg,
                        global_solver=global_solver,
                        preconditioner="amg" if amg else "jacobi")


def small_mg_beam(dtype=torch.float64, device="cuda", cg=8) -> System:
    """tet100k's physics on a 6 x 5 x 4 beam (210 nodes) on the banded
    route with the in-kernel multigrid (levels 210 -> 36 -> 8)."""
    return beam_system((6, 5, 4), 0.05, 50.0, cg, dtype, device, fast=True,
                       preconditioner="amg")


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


def stiffness_sweep(system, mus, model="nh", lam_ratio=2.5):
    """A sweep dict scaling the tet force's stiffness per scenario as
    HyperElasticTet would build it with mu = mus[s] (lam = lam_ratio mu, k
    = mu, weight = sqrt(k vol)); arap: LinearTetStrain's k and weight
    scaled by mus[s] / mus[0]."""
    tf = next(f for f in system.forces
              if isinstance(f, (HyperElasticTet, LinearTetStrain)))
    p = system._params_host[tf.name]
    E = len(p["indices"])
    mus = np.asarray(mus, np.float64)
    if model == "arap":
        scale = mus[:, None] / mus[0]
        return {(tf.name, "k"): np.broadcast_to(p["k"], (E,))[None] * scale,
                (tf.name, "weight"):
                    np.broadcast_to(p["weight"], (E,))[None] * np.sqrt(scale)}
    vols = np.asarray(p["weight"], np.float64) ** 2 / np.asarray(p["k"])
    return {(tf.name, "mu"): np.repeat(mus[:, None], E, axis=1),
            (tf.name, "lam"): np.repeat(lam_ratio * mus[:, None], E, axis=1),
            (tf.name, "k"): np.repeat(mus[:, None], E, axis=1),
            (tf.name, "weight"): np.sqrt(mus[:, None] * vols[None])}


def sweep64(n_scenarios=64, solver="ell", dtype=torch.float32,
            device="cuda"):
    """bench.py --preset sweep64 (bench_sweep): the beam stand-in (792
    nodes, 2,800 tets, 140 kg) hung from its 8 highest vertices, NeoHookean
    (5 Newton iterations) under gravity, dt 0.06, 10 ADMM iterations,
    cg12; scenario s has mu = lam = k = geomspace(3e4, 3e5, S)[s] and
    weights sqrt(mu vol). Returns the SweepStepper."""
    from ..core.sweep import sweep_from_system

    beam = make_beam_tets(10, 8, 7, size=0.1)
    verts = beam.vertices
    n = len(verts)
    s = System(Settings(timestep_s=0.06, admm_iters=10, verbose=0,
                        dtype=dtype, device=device, global_solver=solver,
                        cg_fixed_iters=12, cg_backend="fused"))
    s.add_nodes(verts, np.full(n, 140.0 / n))
    s.add_force(StaticAnchor(np.argsort(verts[:, 1])[-8:]))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    sweep = stiffness_sweep(s, np.geomspace(3e4, 3e5, n_scenarios),
                            lam_ratio=1.0)
    return sweep_from_system(s, sweep, n_scenarios)[0]


def jittered_sweep(n_scenarios=4, solver="dia", model="nh",
                   dtype=torch.float64, device="cuda", anchor_sweep=False,
                   floor=False, dims=(8, 6, 5), cg=25, admm=10,
                   collect=False):
    """A sweep of the jittered beam (seed 0) pinned at vertices 0 and 1
    (weight 1000), 2 kg, gravity, dt 0.04, `admm` ADMM iterations: stiffness
    mu over geomspace(4e3, 3e4, S) (`stiffness_sweep`; nh: 4 Newton
    iterations), with anchor_sweep the anchors' weight over
    geomspace(1000, 1e-6, S) (the last scenario all but released), with
    floor a Floor 0.3 below the beam. Returns the SweepStepper."""
    from ..core.sweep import sweep_from_system

    mesh = jittered_beam(*dims)
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=admm, verbose=0,
                        dtype=dtype, device=device, global_solver=solver,
                        cg_fixed_iters=cg, collect_residuals=collect))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    if model == "arap":
        s.add_force(LinearTetStrain(mesh.tets, stiffness=1e4,
                                    backend="pallas"))
    else:
        s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4,
                                    max_iters=4, model=model,
                                    backend="pallas"))
    anchor = s.add_force(StaticAnchor([0, 1], weight=1000.0))
    if floor:
        lo = float(mesh.vertices[:, 1].min())
        s.add_force(Collision([Floor(center=(0.0, lo - 0.3, 0.0))],
                              n_nodes=n))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    sweep = stiffness_sweep(s, np.geomspace(4e3, 3e4, n_scenarios), model)
    if anchor_sweep:
        sweep[(anchor.name, "weight")] = np.geomspace(1000.0, 1e-6,
                                                      n_scenarios)
    return sweep_from_system(s, sweep, n_scenarios)[0]


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
                    cg_backend="xla", amg=False, admm_iters=10) -> System:
    """A tet mesh on the ell solver: StaticAnchors at x < min x +
    anchor_dx, NeoHookean tets (mu = lam = stiffness, 5 Newton iterations,
    kernel-backed), gravity, dt 0.04, admm_iters ADMM iterations; amg:
    preconditioner="amg" (fast: the in-kernel algebraic multigrid, else
    the general route's AMG)."""
    n = len(pts)
    s = System(Settings(timestep_s=0.04, admm_iters=admm_iters, verbose=0,
                        dtype=dtype, device=device, global_solver="ell",
                        cg_fixed_iters=cg, cg_backend=cg_backend,
                        preconditioner="amg" if amg else "jacobi",
                        lattice_fast_path=fast))
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
        assert (s._stepper.cfg.mg is not None) == amg
    elif amg:
        assert "amg" in s.params["_solver"]
    return s


def delaunay100k(cg, dtype=torch.float32, fast=True, cg_backend="xla",
                 device="cuda", amg=False) -> System:
    """bench.py build_delaunay100k: 50 kg, mu = lam = 1e5, anchors within
    half a grid spacing of the minimum x. bench's general route
    (--no-lattice) builds its tets with the default backend='xla', which
    the port does not have; here they are kernel-backed (the same prox
    through nh_local_step_fused). The banded route ignores the backend.
    amg=True is build_delaunay100k(amg=True): cg algebraic-V-cycle PCG
    iterations a solve (bench's 6), in the banded kernel (fast) or on the
    general route's AMG."""
    pts, tets = (a.copy() for a in _delaunay100k_mesh())
    return delaunay_system(pts, tets, 50.0, 1e5, 0.5 * 0.05, cg, dtype,
                           device, fast, cg_backend, amg)


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


def small_uamg(cg=8, dtype=torch.float64, device="cuda", fast=True) -> System:
    """tests/test_uamg.py's _delaunay_system scene under
    preconditioner="amg": its 10 x 7 x 6 mesh (420 nodes), 50 kg, mu = lam
    = 1e5, anchors within 0.025 m of the minimum x, 6 ADMM iterations; on
    the banded route's algebraic multigrid (levels 420 -> 112 -> 48), or
    with fast=False on the general route's AMG."""
    pts, tets = delaunay_mesh(10, 7, 6, scale=0.05, emax=0.11)
    return delaunay_system(pts, tets, 50.0, 1e5, 0.025, cg, dtype, device,
                           fast, amg=True, admm_iters=6)


def banded_spd(n, offsets=(1, 3, 7), dtype=torch.float64, device="cuda",
               seed=0) -> dict:
    """A random symmetric, diagonally dominant (so SPD) system of n rows
    (np.random.default_rng(seed)): the upper `offsets`' entries U(0.1, 1)
    with random signs, mirrored below; each main-diagonal entry 1 plus its
    row's absolute sum. Returns the solve's inputs: b and x0 N(0,1)
    (n,3), diag, the dia form (dia_vals (D,n) over the sorted offsets,
    zero past either end) and the ELL form (ell_idx, ell_vals (n,D): the
    same terms in offset order; a term outside the matrix holds the row's
    own index and 0, as core.solver.assemble_A_hat_ell pads)."""
    rng = np.random.default_rng(seed)
    offs = tuple(sorted({0, *offsets, *(-o for o in offsets)}))
    dia = np.zeros((len(offs), n))
    for o in offsets:
        m = max(n - o, 0)
        up = rng.uniform(0.1, 1.0, m) * rng.choice([-1.0, 1.0], m)
        dia[offs.index(o), :m] = up          # A[i, i+o]
        dia[offs.index(-o), n - m:] = up     # A[i+o, i]
    dia[offs.index(0)] = 1.0 + np.abs(dia).sum(0)
    rows = np.arange(n)
    cols = rows[:, None] + np.array(offs)[None, :]
    inside = (cols >= 0) & (cols < n)
    ell_idx = np.where(inside, cols, rows[:, None]).astype(np.int32)
    ell_vals = np.where(inside, dia.T, 0.0)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return {"b": t(rng.standard_normal((n, 3))),
            "x0": t(rng.standard_normal((n, 3))),
            "diag": t(dia[offs.index(0)]), "dia_vals": t(dia),
            "offsets": offs, "ell_idx": t(ell_idx, torch.int32),
            "ell_vals": t(ell_vals)}


def renumbered_ell(b, x0, diag, ell_idx, ell_vals, seed=0):
    """The same ELL system with its unknowns renumbered by a random
    permutation (np.random.default_rng(seed)), as a mesh numbered without
    regard to its band gives: row i of the result is row perm[i] of the
    input, its slots in the input's order. Returns (b, x0, diag, ell_idx,
    ell_vals, perm); its solution is the input's at [perm]."""
    n = b.shape[0]
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(n),
                           device=b.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=b.device)
    idx = inv[ell_idx[perm].long()].to(torch.int32).contiguous()
    return (b[perm].contiguous(), x0[perm].contiguous(),
            diag[perm].contiguous(), idx, ell_vals[perm].contiguous(), perm)


def dia_solve_inputs(s, dtype) -> tuple:
    """A dia System's first global solve from rest, as ADMM poses it: b =
    M x_rest + M dt^2 g, warm-started at x_rest. Returns the inputs of
    `cg_dia_solve` but its budget: (b, x0, diag, dia_vals, offsets)."""
    sv, dt = s.params["_solver"], s.settings.timestep_s
    x0 = s.state["x"].to(dtype)
    b = (s._masses_dev[:, None] * x0).to(dtype)
    b[:, 1] -= (s._masses_dev * 9.8 * dt * dt).to(dtype)
    return b, x0, sv["diag"].to(dtype), sv["dia_vals"].to(dtype), \
        s._dia_offsets


def ell_solve_inputs(s, dtype) -> tuple:
    """An ell System's A_hat and its first global solve from rest, as ADMM
    poses it: b = A x_rest + M dt^2 g, warm-started at x_rest. Returns
    (b, x0, diag, ell_idx, ell_vals)."""
    sv, dt = s.params["_solver"], s.settings.timestep_s
    idx, vals = sv["ell_idx"], sv["ell_vals"].to(dtype)
    x0 = s.state["x"].to(dtype)
    b = ell_apply(x0, idx, vals)
    b[:, 1] -= (s._masses_dev * 9.8 * dt * dt).to(dtype)
    return b, x0, sv["diag"].to(dtype), idx, vals


def long_beam_dia_inputs(cells_x, dtype=torch.float32, device="cuda"):
    """tet100k's beam made cells_x / 40 times longer (cells_x x 25 x 20
    cells of 0.05 m, 50 kg a 40 cells, the same 19 offsets) as a dia
    solve: its A_hat from the host assembly, as System.initialize makes
    it, and the first solve from rest. Returns (b, x0, diag, dia_vals,
    offsets)."""
    beam = make_beam_tets(cells_x, 25, 20, size=0.05)
    n = beam.n_vertices
    m = np.full(n, 50.0 * cells_x / 40 / n)
    anchor = StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9))
    tet = HyperElasticTet(beam.tets, 1e5, 1e5, max_iters=5,
                          backend="pallas")
    cparams = {"a": anchor.build(beam.vertices, m, DT)[0],
               "t": tet.build(beam.vertices, m, DT)[0]}
    offs, dia, diag = assemble_A_hat_dia(n, m, DT, cparams)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x0, mt = t(beam.vertices), t(m)
    b = mt[:, None] * x0
    b[:, 1] -= mt * 9.8 * DT * DT
    return b, x0, t(diag), t(dia).contiguous(), offs


def grid_mg_problem(nx, ny, dtype=torch.float64, device="cuda",
                    seed=0) -> dict:
    """A multigrid solve on an (nx+1) x (ny+1) planar grid: A = 4.5 I
    minus its 4 neighbours in the x-major numbering (the band's rows wrap
    at the grid's edges; SPD by diagonal dominance), its multigrid by the
    cloth kernel's ladder search (`core.cloth.ladder_mg`), b and x0
    N(0,1) (np.random.default_rng(seed)). Returns the arguments of
    `ops.kernels.mg.mg_dia_solve` but the budget: b, x0, dia_vals,
    offsets, planes, cfg."""
    import scipy.sparse as sp

    from ..core.cloth import ladder_mg
    from ..ops.kernels.mg import MGConfig, planes_from

    gx, gy = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1))
    verts = 0.1 * np.stack([gx.ravel(), gy.ravel(), 0 * gx.ravel()], 1)
    n = len(verts)
    offs = (-(nx + 1), -1, 0, 1, nx + 1)
    A = sp.diags([-1.0, -1.0, 4.5, -1.0, -1.0], offs, shape=(n, n)).tocsr()
    mg = ladder_mg(A, verts)
    dia = np.zeros((len(offs), n))
    for d, o in enumerate(offs):
        lo, hi = max(0, -o), min(n, n - o)
        dia[d, lo:hi] = A.diagonal(o)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return {"b": t(rng.standard_normal((n, 3))),
            "x0": t(rng.standard_normal((n, 3))), "dia_vals": t(dia),
            "offsets": offs, "planes": planes_from(mg, dtype, device),
            "cfg": MGConfig.of(mg)}
