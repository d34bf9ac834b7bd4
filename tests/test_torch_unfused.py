"""The port's unfused ADMM pipeline against the JAX package's, f64 on the
CPU: the dense and cg global modes and over-relaxation, where every force
runs compute_Dx -> (blend) -> project_with_dual -> rhs_contribution, with
the Pallas-backed forces on their unfused kernels' plain twins
(nh_local_step, arap_local_step, tri_local_step) and the JAX package's
Pallas kernels in interpret mode; and LinearTetStrain on dia, which runs
fused (arap_local_step_fused).

Scenes: small anchored beams under gravity (NeoHookean with 2 Newton
iterations, or LinearTetStrain) and the 8 x 6 cloth of
tests/test_torch_cloth.py. Tolerance 1e-8 on x and v over 5 steps, the
bound of tests/test_torch_system.py (the packages sum the einsums and the
RHS in different orders: JAX's dense and cg modes scatter per force, the
port gathers through the incidence). Each JAX run is compiled once per
module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core.solver import assemble_A_hat as jax_assemble_A_hat
from admm_elastic_tpu_torch.utils import from_reference

torch.set_num_threads(1)

TOL = 1e-8
STEPS, SNAP = 5, 2


def beam(pkg, arap=False, floor=False, **settings):
    """A 4 x 2 x 2 beam (45 nodes, 80 tets) anchored at x = 0; NeoHookean
    (mu = lam = 1e5, 2 Newton iterations) or LinearTetStrain (1e5); with
    floor=True a Floor 0.5 mm below its lowest point, which the sagging
    free end reaches. Settings are the defaults but for `settings`."""
    mesh = pkg.geometry.make_beam_tets(4, 2, 2, size=0.05)
    n = mesh.n_vertices
    if pkg is aet:
        s = aet.System(aet.Settings(verbose=0, dtype=jnp.float64, **settings))
    else:
        s = pt.System(pt.Settings(verbose=0, dtype=torch.float64,
                                  device="cpu", **settings))
    m = pkg.models
    s.add_nodes(mesh.vertices, np.full(n, 1.0 / n))
    s.add_force(m.StaticAnchor(np.flatnonzero(mesh.vertices[:, 0] < 1e-9)))
    if arap:
        s.add_force(m.LinearTetStrain(mesh.tets, 1e5, backend="pallas"))
    else:
        s.add_force(m.HyperElasticTet(mesh.tets, 1e5, 1e5, max_iters=2,
                                      backend="pallas"))
    if floor:
        y = float(mesh.vertices[:, 1].min()) - 5e-4
        s.add_force(m.Collision([m.Floor(center=(0.0, y, 0.0))], n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def cloth(pkg, **settings):
    """tests/test_torch_cloth.py's 8 x 6 cloth: LimitedTriangleStrain,
    Bend, 4 anchors, gravity and wind, 30 CG iterations."""
    mesh = pkg.geometry.make_plane_grid(8, 6)
    n = mesh.n_vertices
    common = dict(timestep_s=0.04, admm_iters=10, verbose=0,
                  global_solver="dia", cg_fixed_iters=30, **settings)
    if pkg is aet:
        s = aet.System(aet.Settings(dtype=jnp.float64, **common))
    else:
        s = pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                  **common))
    m = pkg.models
    s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    s.add_force(m.LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05,
                                        backend="pallas"))
    s.add_force(m.Bend(pkg.geometry.extract_hinges(mesh.faces), 20.0))
    top = np.flatnonzero(np.abs(mesh.vertices[:, 1] - 1.0) < 1e-9)
    s.add_force(m.StaticAnchor(top[:4]))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    s.add_explicit_force(m.WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
    assert s.initialize()
    return s


# name -> (scene function, settings, the port's resolved mode)
SCENES = {
    # bare Settings(): 'auto' is 'dense' for 45 nodes
    "default-dense-floor": (beam, dict(floor=True), "dense"),
    "dense-refine2-arap": (beam, dict(arap=True, global_solver="dense",
                                      dense_refine_steps=2), "dense"),
    "cg-tol": (beam, dict(global_solver="cg", cg_tol=1e-12), "cg"),
    "cg-40-25": (beam, dict(global_solver="cg", cg_fixed_iters=(40, 25)),
                 "cg"),
    "relax-nh-dia": (beam, dict(global_solver="dia", cg_fixed_iters=25,
                                relaxation=1.6), "dia"),
    "relax-cloth-dia": (cloth, dict(relaxation=1.6), "dia"),
    # LinearTetStrain on dia runs fused (arap_local_step_fused)
    "arap-dia": (beam, dict(arap=True, global_solver="dia",
                            cg_fixed_iters=25), "dia"),
}


@pytest.fixture(scope="module", params=list(SCENES))
def reference(request):
    """The JAX run: SNAP steps, a snapshot of params/state, the rest."""
    build, settings, _ = SCENES[request.param]
    s = build(aet, **settings)
    for _ in range(SNAP):
        s.step()
    snap = (jax.device_get(s.params), jax.device_get(s.state))
    for _ in range(STEPS - SNAP):
        s.step()
    return request.param, snap, s.x.copy(), s.v.copy()


def _close(s, x, v):
    dx, dv = np.abs(s.x - x).max(), np.abs(s.v - v).max()
    assert dx < TOL and dv < TOL, (dx, dv)


def test_port_matches_jax(reference):
    name, _, x, v = reference
    build, settings, mode = SCENES[name]
    s = build(pt, **settings)
    assert s._solver_mode == mode and s._stepper is None
    for _ in range(STEPS):
        s.step()
    _close(s, x, v)
    assert np.isfinite(s.x).all() and (s.x[:, 1] < s._x[:, 1] - 1e-5).any()


def test_carry_over_from_reference(reference):
    """from_reference carries every mode: the dense inverse is the JAX
    one; the cg mode's solver arrays, which JAX does not keep, stay the
    port's."""
    name, (params, state), x, v = reference
    build, settings, mode = SCENES[name]
    s = build(pt, **settings)
    own = s.params["_solver"]
    from_reference(s, params, state)
    assert s.elapsed_s == pytest.approx(SNAP * 0.04)
    if mode == "dense":
        assert np.array_equal(s.params["_solver"]["A_inv"].numpy(),
                              np.asarray(params["_solver"]["A_inv"]))
    if mode == "cg":
        assert "_solver" not in params
        assert all(s.params["_solver"][k] is own[k] for k in own)
    s.run(STEPS - SNAP)
    _close(s, x, v)


def test_dense_inverse_matches_numpy():
    """The port inverts A_hat with torch.linalg.inv where the JAX package
    calls np.linalg.inv on the host: the same matrix to 1e-12 relative."""
    s = beam(pt, floor=True)
    cparams = {k: s._params_host[k] for k in s._constraint_names}
    want = np.linalg.inv(jax_assemble_A_hat(s.n_nodes, s.masses, 0.04,
                                            cparams))
    got = s.params["_solver"]["A_inv"].numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_cg_apply_and_diag_match_the_assembled_matrix():
    """The matrix-free A_hat (incidence sums) against the assembled one."""
    s = beam(pt, floor=True, global_solver="cg")
    cparams = {k: s._params_host[k] for k in s._constraint_names}
    A = jax_assemble_A_hat(s.n_nodes, s.masses, 0.04, cparams)
    y = np.random.default_rng(0).normal(size=(s.n_nodes, 3))
    sv = s.params["_solver"]
    got = pt.core.solver.A_hat_apply(
        torch.as_tensor(y), s._masses_dev, 0.04 ** 2, s._cparams(s.params),
        sv["inc_idx"])
    np.testing.assert_allclose(got.numpy(), A @ y, rtol=1e-13,
                               atol=1e-13 * np.abs(A @ y).max())
    np.testing.assert_allclose(sv["diag"].numpy(), np.diag(A), rtol=1e-14)


def test_routing_under_lattice_fast_path():
    """LinearTetStrain takes the banded kernel's arap mode in JAX: the
    port raises. Relaxation turns the fast paths off in JAX: the port
    steps the general route, bitwise."""
    with pytest.raises(NotImplementedError, match="arap"):
        beam(pt, arap=True, global_solver="dia", lattice_fast_path=True)
    runs = []
    for fast in (False, True):
        s = beam(pt, global_solver="dia", cg_fixed_iters=25, relaxation=1.6,
                 lattice_fast_path=fast)
        assert s._stepper is None
        s.run(3)
        runs.append((s.x, s.v))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
