"""The port's System against the JAX package's on the same scene: an
anchored 6x4x4 NeoHookean beam under gravity, dia global solver, Pallas
(JAX, interpret mode) vs plain PyTorch (port, CPU), f64.

Tolerance 1e-8 absolute on x and v: 50 prox solves with branchy line
searches amplify round-off from differing summation orders (ROADMAP's
oracle bound is ~1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.utils import from_reference

torch.set_num_threads(1)

TOL = 1e-8


def _build(pkg, cg_fixed_iters, model="nh", **settings):
    beam = pt.geometry.make_beam_tets(6, 4, 4, size=0.05)
    n = beam.n_vertices
    if pkg is aet:
        s = aet.System(aet.Settings(**{
            "timestep_s": 0.04, "admm_iters": 10, "verbose": 0,
            "dtype": jnp.float64, "global_solver": "dia",
            "cg_fixed_iters": cg_fixed_iters, **settings}))
    else:
        s = pt.System(pt.Settings(**{
            "timestep_s": 0.04, "admm_iters": 10, "verbose": 0,
            "dtype": torch.float64, "device": "cpu", "global_solver": "dia",
            "cg_fixed_iters": cg_fixed_iters, **settings}))
    s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    s.add_force(pkg.models.StaticAnchor(
        np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(pkg.models.HyperElasticTet(
        beam.tets, mu=1e5, lam=1e5, max_iters=5, model=model,
        backend="pallas"))
    s.add_explicit_force(pkg.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


@pytest.fixture(scope="module", params=[25, (75, 25)], ids=["cg25", "cg75-25"])
def reference(request):
    """The JAX run: 2 steps, a snapshot of params/state, 3 more steps."""
    s = _build(aet, request.param)
    for _ in range(2):
        s.step()
    snap = (jax.device_get(s.params), jax.device_get(s.state),
            s.x.copy(), s.v.copy())
    for _ in range(3):
        s.step()
    return request.param, snap, s.x.copy(), s.v.copy()


def test_slice_parity(reference):
    cg, _, x5, v5 = reference
    s = _build(pt, cg)
    for _ in range(5):
        s.step()
    assert np.abs(s.x - x5).max() < TOL, np.abs(s.x - x5).max()
    assert np.abs(s.v - v5).max() < TOL, np.abs(s.v - v5).max()
    assert np.isfinite(s.x).all()
    assert s.x[:, 1].min() < -1e-4  # the free end sagged


def test_carry_over_from_reference(reference):
    cg, (params, state, x2, v2), x5, v5 = reference
    s = _build(pt, cg)
    from_reference(s, params, state)
    assert np.array_equal(s.x, x2) and np.array_equal(s.v, v2)
    assert s.elapsed_s == pytest.approx(0.08)
    s.run(3)
    assert np.abs(s.x - x5).max() < TOL, np.abs(s.x - x5).max()
    assert np.abs(s.v - v5).max() < TOL, np.abs(s.v - v5).max()


def test_determinism_bitwise():
    """Two identical port runs are bitwise equal (twin of
    test_system.py::test_determinism_bitwise)."""
    def run():
        s = _build(pt, (30, 10), model="stvk")
        for _ in range(3):
            s.step()
        return s.x, s.v

    (xa, va), (xb, vb) = run(), run()
    assert np.array_equal(xa, xb) and np.array_equal(va, vb)


def test_anchors_hold_and_callbacks_run():
    s = _build(pt, 25)
    calls = []
    s.pre_step_callbacks.append(lambda sys_: calls.append(sys_.elapsed_s))
    anchored = np.flatnonzero(s._x[:, 0] < 1e-9)
    for _ in range(3):
        s.step()
    assert calls == pytest.approx([0.0, 0.04, 0.08])
    assert np.abs(s.x[anchored] - s._x[anchored]).max() < 1e-4
    assert np.isfinite(s.x).all() and np.isfinite(s.v).all()
    assert s.x[:, 1].min() < -1e-4  # the free end sagged


@pytest.mark.parametrize("bad", [
    # 'auto' resolves to 'dense' for this small beam
    dict(global_solver="auto", acceleration="anderson"),
    dict(lattice_fast_path=True, relaxation=1.5, acceleration="anderson"),
    dict(acceleration="anderson"),
])
def test_out_of_slice_settings_raise(bad):
    """Every global mode, relaxation, the residuals and the multigrids
    are ported; Anderson acceleration is not."""
    with pytest.raises(NotImplementedError):
        _build(pt, 25, **bad)


def test_general_amg_matches_jax():
    """preconditioner='amg' under 'ell' (the general route's aggregation
    AMG; this beam's 175 nodes fit its coarsest level, so the hierarchy is
    A_hat's inverse alone) runs and matches JAX over 3 steps of 3 ADMM
    iterations."""
    settings = dict(global_solver="ell", preconditioner="amg", admm_iters=3)
    j, s = _build(aet, 8, **settings), _build(pt, 8, **settings)
    assert s._solver_mode == "ell" and "amg" in s.params["_solver"]
    assert [m["n"] for m in j._amg_meta] == [s.n_nodes]
    for _ in range(3):
        j.step()
        s.step()
    assert np.abs(s.x - np.asarray(j.x)).max() < TOL
    assert np.abs(s.v - np.asarray(j.v)).max() < TOL / 0.04


def test_out_of_slice_models_and_devices_raise():
    beam = pt.geometry.make_beam_tets(1, 1, 1)
    # the default backend='xla' constructs and steps; an unknown backend
    # raises JAX's ValueError
    s = pt.System(pt.Settings(verbose=0, dtype=torch.float64, device="cpu"))
    s.add_nodes(beam.vertices, np.ones(beam.n_vertices))
    s.add_force(pt.models.StaticAnchor([0]))
    s.add_force(pt.models.HyperElasticTet(beam.tets, 1e5, 1e5))
    s.add_explicit_force(pt.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize() and s.forces[1].backend == "xla"
    s.step()
    assert np.isfinite(s.x).all() and s.x[1:, 1].min() < beam.vertices[:, 1].min()
    with pytest.raises(ValueError, match="backend"):
        pt.models.HyperElasticTet(beam.tets, 1e5, 1e5, backend="cuda")
    assert pt.Settings().device == "cuda"
    if not torch.cuda.is_available():
        s = pt.System(pt.Settings(verbose=0))
        s.add_nodes(beam.vertices, np.ones(beam.n_vertices))
        s.add_force(pt.models.StaticAnchor([0]))
        with pytest.raises(RuntimeError, match="cuda"):
            s.initialize()


@pytest.mark.parametrize("indices", [None, [0, 5, 5, 17]],
                         ids=["all", "subset-with-repeat"])
def test_explicit_force_matches_jax(indices):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(20, 3))
    ja = aet.models.ExplicitForce(direction=(0.5, -9.8, 1.0), indices=indices)
    pa = pt.models.ExplicitForce(direction=(0.5, -9.8, 1.0), indices=indices)
    want = np.asarray(ja.apply(0.04, None, jnp.asarray(v), None,
                               {k: jnp.asarray(a) for k, a in ja.build().items()}))
    got = pa.apply(0.04, None, torch.as_tensor(v), None,
                   {k: torch.as_tensor(np.asarray(a, np.float64) if k ==
                                       "direction" else np.asarray(a, np.int64))
                    for k, a in pa.build().items()})
    assert np.array_equal(got.numpy(), want)


def test_primal_piece_and_state_setters(reference):
    """ForceBatch.primal_piece of both forces against the JAX package on the
    carried-over duals, and the x/v setters feed the next step."""
    _, (params, state, _, _), _, _ = reference
    s = _build(pt, 25)
    from_reference(s, params, state)
    jforces = _build(aet, 25).forces
    rng = np.random.default_rng(4)
    for jf, pf in zip(jforces, s.forces):
        u_old = np.asarray(state["u"][jf.name])
        u_new = u_old + 1e-3 * rng.normal(size=u_old.shape)
        want = float(jf.primal_piece(
            {k: jnp.asarray(a) for k, a in params[jf.name].items()},
            jnp.asarray(u_new), jnp.asarray(u_old)))
        n_last = s.state["u"][pf.name].shape[-1]  # cuts the JAX padding

        def cut(a):
            return torch.as_tensor(np.array(a[..., :n_last]))

        got = float(pf.primal_piece(s.params[pf.name], cut(u_new),
                                    cut(u_old)))
        assert got == pytest.approx(want, rel=1e-12)
    x, v = s.x + 1e-3, s.v * 0.5
    s.x, s.v = x, v
    assert np.array_equal(s.x, x) and np.array_equal(s.v, v)
