"""The port's default (`backend="xla"`) element models against the JAX
package's, f64 on the CPU.

Part 1, the element steps: every model of the slice (HyperElasticTet nh
and stvk with both warm-start guards, LinearTetStrain, TetVolume,
LimitedTriangleStrain with limiting on and off, FungTriangle, TriArea,
Spring) built by both packages on the same mesh: the same params and
state keys and shapes, and `project_with_dual` on the same numpy inputs
from a seed (stretched, compressed and inverted elements) within 1e-10.
The JAX side runs op by op (`jax.disable_jit()`), as the port does.

Part 2, small Systems of default-constructed forces on every global mode
(dense, dia, ell with each cg_backend, matrix-free cg), over-relaxation
(on ell) and collected residuals (on dia), against the JAX System (compiled, one build per
scene, module-scoped) at 1e-8 over 4 steps, and `from_reference` carrying
a JAX System with xla forces into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.utils import from_reference

torch.set_num_threads(1)

TOL_ELEM = 1e-10
TOL = 1e-8
STEPS, SNAP = 4, 2


# ------------------------------------------------------------ element steps

def _tet_mesh(pkg):
    return pkg.geometry.make_beam_tets(2, 2, 1, size=0.5)


def _tri_mesh(pkg):
    return pkg.geometry.make_sym_plane(3, 2)


# name -> (mesh, constructor(models module, elements))
MODELS = {
    "nh": (_tet_mesh, lambda m, e: m.HyperElasticTet(e, 80.0, 120.0,
                                                     max_iters=3)),
    "nh-converged": (_tet_mesh, lambda m, e: m.HyperElasticTet(
        e, 80.0, 120.0, max_iters=10)),
    "stvk": (_tet_mesh, lambda m, e: m.HyperElasticTet(e, 80.0, 120.0,
                                                       max_iters=3,
                                                       model="stvk")),
    "arap": (_tet_mesh, lambda m, e: m.LinearTetStrain(e, 50.0)),
    "volume": (_tet_mesh, lambda m, e: m.TetVolume(e, 50.0, 0.9, 1.1)),
    "tri-limit": (_tri_mesh, lambda m, e: m.LimitedTriangleStrain(
        e, 100.0, 0.95, 1.05)),
    "tri-free": (_tri_mesh, lambda m, e: m.LimitedTriangleStrain(
        e, 100.0, 0.95, 1.05, strain_limiting=False)),
    "fung": (_tri_mesh, lambda m, e: m.FungTriangle(e, 10.0, max_iters=1)),
    "area": (_tri_mesh, lambda m, e: m.TriArea(e, 40.0, limit_min=0.9,
                                               limit_max=1.1)),
    "spring": (_tri_mesh, None),
}


def _force(pkg, name):
    mesh_of, make = MODELS[name]
    mesh = mesh_of(pkg)
    if name == "spring":
        edges = aet.geometry.unique_edges(np.asarray(mesh.faces))
        return mesh, pkg.models.Spring(edges, 30.0)
    elems = mesh.tets if hasattr(mesh, "tets") else mesh.faces
    return mesh, make(pkg.models, elems)


def _inputs(f, mesh, seed):
    """Deformed positions (random stretch plus noise; every fourth element
    of a tet mesh inverted by mirroring one vertex through its opposite
    face) and a random dual, as (x, u)."""
    rng = np.random.default_rng(seed)
    x = mesh.vertices @ np.diag([1.3, 0.8, 1.1]) + rng.normal(
        scale=0.05, size=mesh.vertices.shape)
    E = f.n_elements
    u = rng.normal(scale=0.05, size=(E, f.R, 3))
    return x, u


@pytest.mark.parametrize("name", list(MODELS))
def test_build_keys_and_shapes_are_jax(name):
    mesh, jf = _force(aet, name)
    _, pf = _force(pt, name)
    jp, js = jf.build(mesh.vertices, np.ones(len(mesh.vertices)), 0.04)
    pp, ps = pf.build(mesh.vertices, np.ones(len(mesh.vertices)), 0.04)
    assert sorted(jp) == sorted(pp) and sorted(js) == sorted(ps)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(pp[k]), np.asarray(jp[k]))
    for k in js:
        assert np.shape(ps[k]) == np.shape(js[k])
    assert np.shape(pf.dual_init()) == np.shape(jf.dual_init())
    assert not getattr(pf, "supports_fused_local_rhs", False)
    assert getattr(pf, "fused_out_buffers", None) is None
    assert getattr(pf, "project_out_buffers", None) is None


@pytest.mark.parametrize("name", list(MODELS))
def test_project_matches_jax(name):
    """Within 1e-10, but for "nh-converged" (1e-8): there the Newton
    reaches the minimum, where its monotone acceptance test meets ties of
    candidate values, and the operation that parts is XLA's log, which is
    not correctly rounded (it differs from torch's in the last ulp for
    ~0.3% of arguments): an ulp in the objective moves sigma* by ~2e-9.
    The Newton models run 3 iterations (Fung 1), short of the minimum,
    where they agree to 2e-16 (XLA's exp parts the Fung prox the same way
    at its minimum, tests/test_torch_newton.py)."""
    tol = 1e-8 if name == "nh-converged" else TOL_ELEM
    mesh, jf = _force(aet, name)
    _, pf = _force(pt, name)
    jp, js = jf.build(mesh.vertices, np.ones(len(mesh.vertices)), 0.04)
    pp, ps = pf.build(mesh.vertices, np.ones(len(mesh.vertices)), 0.04)
    x, u = _inputs(pf, mesh, 3)
    if name in ("nh", "nh-converged", "stvk"):
        # warm starts: near 1, a negative third component (flipped), all
        # collapsed (bumped to 1e-3), and a collapsed one with a negative
        # third component (flipped only)
        warm = np.random.default_rng(4).uniform(0.7, 1.3, size=(pf.n_elements,
                                                                3))
        warm[0:3, 2] *= -1.0
        warm[3:6] = 1e-4
        warm[6, :] = [1e-4, 2e-4, -1e-4]
        js = ps = {"sigma": warm}
    jparams = {k: jnp.asarray(np.asarray(v)) for k, v in jp.items()}
    pparams = {k: torch.as_tensor(np.asarray(v)) for k, v in pp.items()}
    Dxj = jf.compute_Dx(jparams, jnp.asarray(x))
    Dxp = pf.compute_Dx(pparams, torch.as_tensor(x))
    np.testing.assert_allclose(Dxp.numpy(), np.asarray(Dxj), rtol=1e-14,
                               atol=1e-14)
    with jax.disable_jit():
        zj, uj, sj = jf.project_with_dual(
            Dxj, jnp.asarray(u), jparams,
            {k: jnp.asarray(v) for k, v in js.items()})
    zp, up, sp = pf.project_with_dual(
        Dxp, torch.as_tensor(u), pparams,
        {k: torch.as_tensor(v) for k, v in ps.items()})
    for got, want in ((zp, zj), (up, uj), *((sp[k], sj[k]) for k in sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    rows_j = jf.rhs_contribution(jparams, zj, uj)
    rows_p = pf.rhs_contribution(pparams, zp, up)
    np.testing.assert_allclose(rows_p.numpy(), np.asarray(rows_j),
                               rtol=tol, atol=tol)
    if name in ("tri-limit", "area", "volume"):
        # the clamps are active somewhere
        assert np.abs(zp.numpy() - (Dxp + torch.as_tensor(u)).numpy()).max() \
            > 1e-3


def test_unknown_backend_raises():
    mesh = _tet_mesh(pt)
    m = pt.models
    for make in (lambda b: m.HyperElasticTet(mesh.tets, 1.0, 1.0, backend=b),
                 lambda b: m.LinearTetStrain(mesh.tets, 1.0, backend=b),
                 lambda b: m.LimitedTriangleStrain(mesh.tets[:, :3], 1.0,
                                                   backend=b)):
        assert make("xla").backend == "xla"
        with pytest.raises(ValueError, match="backend"):
            make("cuda")


# ----------------------------------------------------------------- Systems

def tet_scene(pkg, arap=False, floor=True, **settings):
    """A 3 x 2 x 2 beam (36 nodes, 60 tets) anchored at x = 0 under
    gravity: HyperElasticTet(mu = lam = 1e4, 3 Newton iterations) or,
    with arap=True, LinearTetStrain(1e4) and TetVolume(1e3); a Floor just
    under its lowest point."""
    mesh = pkg.geometry.make_beam_tets(3, 2, 2, size=0.1)
    n = mesh.n_vertices
    s = _system(pkg, settings)
    m = pkg.models
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    s.add_force(m.StaticAnchor(np.flatnonzero(mesh.vertices[:, 0] < 1e-9)))
    if arap:
        s.add_force(m.LinearTetStrain(mesh.tets, 1e4))
        s.add_force(m.TetVolume(mesh.tets, 1e3, 0.95, 1.05))
    else:
        s.add_force(m.HyperElasticTet(mesh.tets, 1e4, 1e4, max_iters=3))
    if floor:
        y = float(mesh.vertices[:, 1].min()) - 2e-3
        s.add_force(m.Collision([m.Floor(center=(0.0, y, 0.0))], n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def sheet_scene(pkg, **settings):
    """A make_sym_plane(4, 3) sheet: LimitedTriangleStrain, FungTriangle,
    TriArea, edge Springs, Bend, two anchors, gravity and wind."""
    mesh = pkg.geometry.make_sym_plane(4, 3)
    n = mesh.n_vertices
    s = _system(pkg, settings)
    m = pkg.models
    s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    s.add_force(m.LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
    s.add_force(m.FungTriangle(mesh.faces, 5.0, max_iters=3))
    s.add_force(m.TriArea(mesh.faces, 20.0, limit_min=0.9, limit_max=1.1))
    s.add_force(m.Spring(aet.geometry.unique_edges(np.asarray(mesh.faces)),
                         10.0))
    s.add_force(m.Bend(pkg.geometry.extract_hinges(mesh.faces), 20.0))
    s.add_force(m.StaticAnchor([0, 4]))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    s.add_explicit_force(m.WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
    assert s.initialize()
    return s


def _system(pkg, settings):
    common = dict(timestep_s=0.04, admm_iters=6, verbose=0, **settings)
    if pkg is aet:
        return aet.System(aet.Settings(dtype=jnp.float64, **common))
    return pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                 **common))


# name -> (scene, settings, the port's mode, port-only settings variants)
SCENES = {
    "tet-dense": (tet_scene, {}, "dense", ({},)),
    "tet-dia-residuals": (tet_scene, dict(global_solver="dia",
                                          cg_fixed_iters=25,
                                          collect_residuals=True),
                          "dia", ({},)),
    "arap-relax-ell": (tet_scene, dict(arap=True, global_solver="ell",
                                       cg_fixed_iters=25, relaxation=1.6),
                       "ell", tuple(dict(cg_backend=b)
                                    for b in ("xla", "fused", "kernel"))),
    "sheet-cg": (sheet_scene, dict(global_solver="cg", cg_tol=1e-12),
                 "cg", ({},)),
}


@pytest.fixture(scope="module", params=list(SCENES))
def reference(request):
    """The JAX run: SNAP steps, a snapshot of params/state, the rest."""
    build, settings, _, _ = SCENES[request.param]
    s = build(aet, **settings)
    for _ in range(SNAP):
        s.step()
    snap = (jax.device_get(s.params), jax.device_get(s.state))
    for _ in range(STEPS - SNAP):
        s.step()
    aux = jax.device_get(getattr(s, "last_aux", None))
    return request.param, snap, s.x.copy(), s.v.copy(), aux


def _close(s, x, v):
    dx, dv = np.abs(s.x - x).max(), np.abs(s.v - v).max()
    assert dx < TOL and dv < TOL / 0.04, (dx, dv)


def test_system_matches_jax(reference):
    name, _, x, v, aux = reference
    build, settings, mode, variants = SCENES[name]
    for extra in variants:
        s = build(pt, **settings, **extra)
        assert s._solver_mode == mode and s._stepper is None
        for _ in range(STEPS):
            s.step()
        _close(s, x, v)
        assert (s.x[:, 1] < s._x[:, 1] - 1e-5).any()
        if settings.get("collect_residuals"):
            for k in ("primal_residual", "dual_residual"):
                np.testing.assert_allclose(s.last_aux[k].numpy(),
                                           np.asarray(aux[k]), rtol=1e-6)


def test_carry_over_from_reference(reference):
    """from_reference loads a JAX System of xla forces as it is: JAX's
    params and state keys and shapes are the port's."""
    name, (params, state), x, v, _ = reference
    build, settings, _, _ = SCENES[name]
    s = build(pt, **settings)
    from_reference(s, params, state)
    assert s.elapsed_s == pytest.approx(SNAP * 0.04)
    s.run(STEPS - SNAP)
    _close(s, x, v)
