"""`Settings.lattice_fast_path=True` picks the same route in the port as in
the JAX package: the banded, lattice or cloth whole-timestep kernel, or
the general route (JAX's system.py:899-942), on a table of small scenes.
Only `System.initialize` runs, on both sides; nothing is stepped. Plus the
`Settings` members of the JAX API (`local_backend`, `anderson_m`,
`parse_args`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.utils.scenes import delaunay_mesh

ROUTES = {"BandedStepper": "banded", "LatticeStepper": "lattice",
          "ClothStepper": "cloth"}


def _beam_scene(pkg, s, *, dims=(3, 2, 2), jitter=0.0, scramble=None,
                model="nh", mu=1e4, anchor_w=(1000.0,), floor=None,
                explicit_indices=None, backend="pallas"):
    mesh = pkg.geometry.make_beam_tets(*dims, size=0.25)
    verts, tets = mesh.vertices.copy(), np.asarray(mesh.tets)
    if jitter:
        verts += jitter * np.random.RandomState(0).randn(*verts.shape)
    if scramble is not None:
        perm = np.random.default_rng(scramble).permutation(len(verts))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        verts, tets = verts[perm], inv[tets]
    n = len(verts)
    m = pkg.models
    s.add_nodes(verts, np.full(n, 1.0 / n))
    if model == "arap":
        s.add_force(m.LinearTetStrain(tets, stiffness=mu, backend=backend))
    else:
        s.add_force(m.HyperElasticTet(tets, mu, 1e4, max_iters=3, model=model,
                                      backend=backend))
    left = np.flatnonzero(verts[:, 0] < verts[:, 0].min() + 1e-3)
    for q, w in enumerate(anchor_w):
        s.add_force(m.StaticAnchor(left[q::len(anchor_w)], weight=w))
    if floor is not None:
        shapes = [m.Floor(center=(0.0, -0.3, 0.0))]
        if floor == "floor+sphere":
            shapes.append(m.Sphere(center=(0.4, -0.5, 0.2), radius=0.1))
        s.add_force(m.Collision(shapes, n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0),
                                         indices=explicit_indices))


def _delaunay_scene(pkg, s):
    pts, tets = delaunay_mesh()
    m = pkg.models
    s.add_nodes(pts, np.full(len(pts), 2.0 / len(pts)))
    s.add_force(m.StaticAnchor(np.flatnonzero(pts[:, 0] < pts[:, 0].min()
                                              + 1e-3)))
    s.add_force(m.HyperElasticTet(tets, 1e4, 1e4, max_iters=3,
                                  backend="pallas"))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))


def _cloth_scene(pkg, s, per_elem=False, backend="pallas"):
    mesh = pkg.geometry.make_plane_grid(6, 4)
    n = mesh.n_vertices
    m = pkg.models
    stiff = (100.0 * (0.5 + np.random.RandomState(1).rand(len(mesh.faces)))
             if per_elem else 100.0)
    s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    s.add_force(m.LimitedTriangleStrain(mesh.faces, stiff, 0.95, 1.05,
                                        backend=backend))
    s.add_force(m.Bend(pkg.geometry.extract_hinges(mesh.faces), 20.0))
    s.add_force(m.StaticAnchor([0, 4]))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    s.add_explicit_force(m.WindForce(mesh.faces, direction=(1.5, 0, 0.4)))


# name: (scene builder, scene keyword arguments, Settings, the route)
SCENES = {
    "beam dia": (_beam_scene, {}, dict(global_solver="dia"), "banded"),
    "beam ell": (_beam_scene, {}, dict(global_solver="ell"), "banded"),
    "beam cg": (_beam_scene, {}, dict(global_solver="cg"), "lattice"),
    "beam auto (dense)": (_beam_scene, {}, {}, "lattice"),
    "beam cg stvk": (_beam_scene, dict(model="stvk"),
                     dict(global_solver="cg"), "lattice"),
    "arap dia": (_beam_scene, dict(model="arap"), dict(global_solver="dia"),
                 "banded"),
    "arap dense": (_beam_scene, dict(model="arap"),
                   dict(global_solver="dense"), "lattice"),
    "beam cg floor": (_beam_scene, dict(floor="floor"),
                      dict(global_solver="cg"), "lattice"),
    "beam cg floor+sphere": (_beam_scene, dict(floor="floor+sphere"),
                             dict(global_solver="cg"), "general"),
    "beam cg two anchor weights": (_beam_scene,
                                   dict(anchor_w=(1000.0, 500.0)),
                                   dict(global_solver="cg"), "general"),
    "beam cg no anchors": (_beam_scene, dict(anchor_w=()),
                           dict(global_solver="cg"), "general"),
    "beam cg kick subset": (_beam_scene, dict(explicit_indices=[0, 3]),
                            dict(global_solver="cg"), "general"),
    "beam dia kick subset": (_beam_scene, dict(explicit_indices=[0, 3]),
                             dict(global_solver="dia"), "general"),
    "beam cg relaxation": (_beam_scene, {},
                           dict(global_solver="cg", relaxation=1.6),
                           "general"),
    "scrambled beam cg": (_beam_scene, dict(scramble=1),
                          dict(global_solver="cg"), "lattice"),
    "scrambled beam dense": (_beam_scene, dict(scramble=2), {}, "lattice"),
    "jittered beam dia": (_beam_scene, dict(jitter=0.01),
                          dict(global_solver="dia"), "banded"),
    "jittered beam cg": (_beam_scene, dict(jitter=0.01),
                         dict(global_solver="cg"), "general"),
    "delaunay ell": (_delaunay_scene, {}, dict(global_solver="ell"),
                     "banded"),
    "delaunay cg": (_delaunay_scene, {}, dict(global_solver="cg"), "general"),
    "cloth dia": (_cloth_scene, {}, dict(global_solver="dia"), "cloth"),
    "cloth cg": (_cloth_scene, {}, dict(global_solver="cg"), "cloth"),
    "cloth per-element stiffness": (_cloth_scene, dict(per_elem=True),
                                    dict(global_solver="dia"), "general"),
    # the default backend='xla': the routes select by type, not backend
    "default beam dia": (_beam_scene, dict(backend="xla"),
                         dict(global_solver="dia"), "banded"),
    "default arap ell": (_beam_scene, dict(model="arap", backend="xla"),
                         dict(global_solver="ell"), "banded"),
    "default beam cg": (_beam_scene, dict(backend="xla"),
                        dict(global_solver="cg"), "lattice"),
    "default beam cg relaxation": (_beam_scene, dict(backend="xla"),
                                   dict(global_solver="cg", relaxation=1.6),
                                   "general"),
    "default cloth dia": (_cloth_scene, dict(backend="xla"),
                          dict(global_solver="dia"), "cloth"),
    "default cloth per-element stiffness": (
        _cloth_scene, dict(per_elem=True, backend="xla"),
        dict(global_solver="dia"), "general"),
}


def _route(pkg, name):
    scene, kw, settings = SCENES[name][:3]
    common = dict(timestep_s=0.04, admm_iters=3, verbose=0,
                  cg_fixed_iters=10, lattice_fast_path=True, **settings)
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **common))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                  **common))
    scene(pkg, s, **kw)
    assert s.initialize()
    stepper = s._lattice if pkg is aet else s._stepper
    return ROUTES[type(stepper).__name__] if stepper is not None else \
        "general", s


@pytest.mark.parametrize("name", list(SCENES))
def test_route_matches_jax(name):
    want = SCENES[name][3]
    got_jax, j = _route(aet, name)
    got, s = _route(pt, name)
    assert got_jax == want, f"the JAX package routes {name!r} to {got_jax}"
    assert got == want
    if got != "general":
        assert s._stepper.model == j._lattice.model
        np.testing.assert_array_equal(s._to_canon, j._to_canon)
        np.testing.assert_array_equal(s.x, j.x)


@pytest.mark.parametrize("name", ["beam dia", "arap dia", "beam cg",
                                  "cloth dia"])
def test_default_backend_builds_the_same_window(name):
    """A default-constructed (backend='xla') scene builds its
    whole-timestep stepper from the same host params as the
    pallas-constructed one: the same planes, bit for bit."""
    scene, kw, settings = SCENES[name][:3]
    runs = []
    for backend in ("pallas", "xla"):
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                  timestep_s=0.04, admm_iters=3, verbose=0,
                                  cg_fixed_iters=10, lattice_fast_path=True,
                                  **settings))
        scene(pt, s, **kw, backend=backend)
        assert s.initialize() and s._stepper is not None
        runs.append(s._stepper)
    a, b = runs
    assert a.planes.keys() == b.planes.keys()
    for k in a.planes:
        if isinstance(a.planes[k], torch.Tensor):
            assert torch.equal(a.planes[k], b.planes[k]), k


def test_general_note_printed(capsys):
    """Where no kernel qualifies, JAX's note at verbose >= 1."""
    s = pt.System(pt.Settings(dtype=torch.float64, device="cpu", verbose=1,
                              global_solver="cg", cg_fixed_iters=5,
                              lattice_fast_path=True))
    _delaunay_scene(pt, s)
    assert s.initialize() and s._stepper is None
    assert ("scene does not qualify for a whole-timestep fast path; using "
            "the general solver") in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["-dt", "0.01", "-v", "2", "-it", "7"],
    ["-it", "3", "-dt"],  # a flag without its value is skipped
    ["-help", "-v", "0"],
    [],
])
def test_settings_parse_args_matches_jax(argv, capsys):
    mine = pt.Settings().parse_args(list(argv))
    ref = aet.Settings().parse_args(list(argv))
    out = capsys.readouterr().out
    for name in ("timestep_s", "verbose", "admm_iters"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert isinstance(mine, pt.Settings)
    if "-help" in argv:
        assert out.count("-dt: time step (s)") == 2


def test_settings_api_members_match_jax():
    ps, js = pt.Settings(), aet.Settings()
    assert ps.local_backend == js.local_backend == "xla"
    assert ps.anderson_m == js.anderson_m == 5
    assert pt.Settings(anderson_m=0, local_backend="pallas").anderson_m == 0


@pytest.mark.parametrize("name", ["beam dia", "beam cg", "cloth dia"])
def test_cg_schedule_on_a_kernel_raises_in_both(name):
    """A (first, rest) cg_fixed_iters on a scene a kernel takes: the JAX
    steppers' int() of the tuple raises TypeError, the port raises
    NotImplementedError; on the general route both step it."""
    scene, kw, settings = SCENES[name][:3]
    for pkg, err in ((aet, TypeError), (pt, NotImplementedError)):
        common = dict(timestep_s=0.04, admm_iters=3, verbose=0,
                      cg_fixed_iters=(10, 5), lattice_fast_path=True,
                      **settings)
        s = (aet.System(aet.Settings(dtype=jnp.float64, **common))
             if pkg is aet else
             pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                   **common)))
        scene(pkg, s, **kw)
        with pytest.raises(err):
            s.initialize()


def test_settings_fields_in_jax_order():
    """JAX's Settings fields, in JAX's order, then the port's `device`:
    positional arguments mean the same in both packages."""
    import dataclasses

    jax_names = [f.name for f in dataclasses.fields(aet.Settings)]
    names = [f.name for f in dataclasses.fields(pt.Settings)]
    assert names == jax_names + ["device"]
    mine = pt.Settings(0.04, 10, 1, torch.float64, "dia")
    ref = aet.Settings(0.04, 10, 1, jnp.float64, "dia")
    assert mine.global_solver == ref.global_solver == "dia"
    assert mine.device == "cuda"
