"""The port's lattice whole-timestep route (core/lattice.py +
ops/kernels/lattice_step.py, plain twin on the CPU): its host tables and
detect_lattice against the JAX package's, its stepper against the JAX
`LatticeStepper` (Pallas interpret mode), and through `System` against the
port's general route, in the lattice's and in a scrambled numbering.

make_beam_tets(3, 2, 2, 0.25), f64. Tolerances:
- the tables: exact;
- against the JAX stepper: 1e-8 on x and v after one ADMM iteration, the
  slice parity bound of tests/test_torch_system.py (torch's CPU sqrt and
  XLA's log differ in the last bit on a fraction of a percent of inputs,
  and the Newton ladder turns that into up to ~3e-8 in sigma on tie
  elements); over 4 steps of 6 iterations rtol 1e-6 / atol 1e-8 on x and
  1e-5 / 1e-7 on v, the bounds of tests/test_torch_banded_ref.py. Each JAX
  run is compiled once per module (~10-20 s each in interpret mode), so
  three of the five carry the `slow` mark;
- through System against the port's general route: atol 2e-5 on x after
  4 steps, tests/test_lattice.py's bound (_lat_compare): the cg mode runs
  the same 25-iteration Jacobi-PCG matrix-free, and the dense mode solves
  exactly where the lattice kernel runs 25 iterations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core import lattice as jlat
from admm_elastic_tpu.ops.pallas import lattice_step as jls
from admm_elastic_tpu_torch.core import lattice as plat
from admm_elastic_tpu_torch.core.lattice import LatticeStepper
from admm_elastic_tpu_torch.ops.kernels import lattice_step as pls
from admm_elastic_tpu_torch.utils import lattice_from_reference

torch.set_num_threads(1)

DIMS, SIZE = (3, 2, 2), 0.25


def _beam():
    return pt.geometry.make_beam_tets(*DIMS, SIZE)


def test_tables_match_jax():
    assert pls._EVEN == tuple(map(tuple, jls._EVEN))
    assert pls._ODD == tuple(map(tuple, jls._ODD))
    assert pls._CORNER_DIJK == tuple(map(tuple, jls._CORNER_DIJK))
    for gy, gz in ((3, 3), (26, 21)):
        assert plat.corner_offsets(gy, gz) == jls.corner_offsets(gy, gz)
    for size in (SIZE, 0.05):
        mine, ref = plat.group_tables(size), jls.group_tables(size)
        assert len(mine) == len(ref) == 10
        for (c, p, cp, vol), (jc, jp, jcp, jvol) in zip(mine, ref):
            assert c == jc and p == jp and vol == jvol
            assert np.array_equal(cp, jcp)
    # the kernel's index arithmetic is make_beam_tets' numbering
    idx, grp, inc = pls.lattice_tables(DIMS)
    assert np.array_equal(idx.T, _beam().tets)
    assert np.array_equal(grp, [5 * ((c // 4 + c // 2 % 2 + c % 2) % 2) + s
                                for c in range(12) for s in range(5)])


def _scrambled(verts, tets, seed):
    perm = np.random.default_rng(seed).permutation(len(verts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return verts[perm], inv[tets]


def _detect_case(name):
    beam = pt.geometry.make_beam_tets(4, 3, 2, size=0.3)
    verts = beam.vertices + np.array([1.5, -2.0, 0.25])
    tets = np.asarray(beam.tets)
    if name == "canonical":
        return verts, tets
    sverts, stets = _scrambled(verts, tets, 0)
    if name == "scrambled":
        return sverts, stets
    if name == "stretched":
        sverts = sverts.copy()
        sverts[:, 0] *= 1.7
        return sverts, stets
    if name == "jittered":
        return verts + 0.01 * np.random.RandomState(1).randn(*verts.shape), tets
    # non-beam: cell 0 (even) split as an odd cell
    tets = tets.copy()
    tets[:5] = np.asarray(plat.corner_offsets(4, 3))[np.asarray(pls._ODD)]
    return verts, tets


@pytest.mark.parametrize("name", ["canonical", "scrambled", "stretched",
                                  "jittered", "non-beam"])
def test_detect_lattice_matches_jax(name):
    verts, tets = _detect_case(name)
    mine, ref = plat.detect_lattice(verts, tets), jlat.detect_lattice(
        verts, tets)
    assert (mine is None) == (ref is None)
    assert (mine is not None) == (name in ("canonical", "scrambled"))
    if mine is not None:
        assert mine[:4] == ref[:4]
        assert np.array_equal(mine[4], ref[4])
        assert np.array_equal(mine[5], ref[5])


# ------------------------------------------------ against the JAX stepper

# name: (stepper keyword arguments, admm iterations)
STEPPERS = {
    "nh": (dict(mu=1e4, lam=1e4), 1),
    "nh-lam4mu": (dict(mu=2.5e3, lam=1e4), 6),
    "stvk": (dict(mu=100.0, lam=400.0, model="stvk"), 6),
    "arap": (dict(mu=1e4, lam=1e4, model="arap"), 6),
    "floor": (dict(mu=1e4, lam=1e4, floor_y=0.02), 6),
}
STEPS = 4


def _stepper_args(name):
    kw, admm = STEPPERS[name]
    beam = _beam()
    n = beam.n_vertices
    kw = dict(kw)
    mu, lam = kw.pop("mu"), kw.pop("lam")
    return ((*DIMS, SIZE, np.full(n, 1.0 / n), mu, lam,
             np.flatnonzero(beam.vertices[:, 0] < 1e-9)),
            dict(dt=0.04, admm_iters=admm, cg_iters=25, **kw))


# each JAX stepper compiles for ~10-20 s in interpret mode: nh (with the
# one-iteration check) and arap, the lattice's own ARAP mix, run in the
# default selection; the other three carry the slow mark
SLOW = ("nh-lam4mu", "stvk", "floor")


@pytest.fixture(scope="module", params=[
    pytest.param(name, marks=pytest.mark.slow) if name in SLOW else name
    for name in STEPPERS])
def jax_stepper(request):
    """The JAX stepper's x, v after each step, and its state after 2."""
    args, kw = _stepper_args(request.param)
    st = jlat.LatticeStepper(*args, dtype=jnp.float64, **kw)
    xs, vs, snap = [], [], None
    for step in range(STEPS):
        st.step()
        xs.append(np.asarray(st.x))
        vs.append(np.asarray(st.v))
        if step == 1:
            snap = jax.device_get(st.state)
    return request.param, xs, vs, snap


def _port_stepper(name):
    args, kw = _stepper_args(name)
    return LatticeStepper(*args, dtype=torch.float64, device="cpu", **kw)


def test_matches_jax_stepper(jax_stepper):
    name, xs, vs, _ = jax_stepper
    st = _port_stepper(name)
    for step in range(STEPS):
        st.step()
        if step == 0 and STEPPERS[name][1] == 1:
            assert np.abs(st.x - xs[0]).max() < 1e-8, np.abs(st.x - xs[0]).max()
            assert np.abs(st.v - vs[0]).max() < 1e-8, np.abs(st.v - vs[0]).max()
    np.testing.assert_allclose(st.x, xs[-1], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(st.v, vs[-1], rtol=1e-5, atol=1e-7)
    assert st.x[:, 1].min() < _beam().vertices[:, 1].min() + (
        0.02 if name == "floor" else -1e-4)


def test_carry_over_from_jax_stepper(jax_stepper):
    """The JAX state after 2 steps, loaded by lattice_from_reference, then
    one step on each side."""
    name, xs, vs, snap = jax_stepper
    st = _port_stepper(name)
    lattice_from_reference(st, snap)
    np.testing.assert_array_equal(st.x, np.asarray(snap["x"])[:, :36].T)
    assert float(st.state["t"]) == pytest.approx(0.08)
    if name != "arap":  # arap leaves the warm start alone
        assert not np.array_equal(st.state["warm"].numpy(), np.ones((3, 60)))
    st.step()
    np.testing.assert_allclose(st.x, xs[2], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(st.v, vs[2], rtol=1e-5, atol=1e-7)
    if name == "floor":
        assert np.abs(st.state["cu"].numpy()).max() > 0  # the floor acted


# ------------------------------------------------------ through System


def _system(verts, tets, fast, model="nh", mu=1e4, lam=1e4, floor_y=None,
            global_solver="cg"):
    """tests/test_lattice.py _lat_system on the port, CPU f64."""
    m = pt.models
    s = pt.System(pt.Settings(
        timestep_s=0.04, admm_iters=6, verbose=0, dtype=torch.float64,
        device="cpu", global_solver=global_solver, cg_fixed_iters=25,
        lattice_fast_path=fast))
    n = len(verts)
    s.add_nodes(verts, np.full(n, 1.0 / n))
    s.add_force(m.StaticAnchor(np.flatnonzero(verts[:, 0] < 1e-9)))
    if model == "arap":
        s.add_force(m.LinearTetStrain(tets, stiffness=mu, backend="pallas"))
    else:
        s.add_force(m.HyperElasticTet(tets, mu, lam, max_iters=5, model=model,
                                      backend="pallas"))
    if floor_y is not None:
        s.add_force(m.Collision([m.Floor(center=(0, floor_y, 0))],
                                n_nodes=n))
    s.add_explicit_force(m.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


LAT_COMPARE = {
    "nh": dict(),
    "nh-lam4mu": dict(mu=2.5e3, lam=1e4),
    "stvk": dict(model="stvk", mu=100.0, lam=400.0),
    "arap": dict(model="arap"),
    "floor": dict(floor_y=-0.3),
    "scrambled": dict(scramble=True),
}


@pytest.mark.parametrize("mode", ["cg", "auto"])
@pytest.mark.parametrize("name", list(LAT_COMPARE))
def test_lattice_route_matches_general(name, mode):
    """tests/test_lattice.py::_lat_compare: the lattice route against the
    general route ('auto' resolves to 'dense' on 36 nodes)."""
    kw = dict(LAT_COMPARE[name])
    beam = _beam()
    verts, tets = beam.vertices, np.asarray(beam.tets)
    if kw.pop("scramble", False):
        verts, tets = _scrambled(verts, tets, 1)
    gen = _system(verts, tets, False, global_solver=mode, **kw)
    fast = _system(verts, tets, True, global_solver=mode, **kw)
    assert gen._stepper is None
    assert isinstance(fast._stepper, LatticeStepper)
    assert fast._solver_mode == ("cg" if mode == "cg" else "dense")
    for _ in range(4):
        gen.step()
        fast.step()
    assert np.isfinite(fast.x).all()
    np.testing.assert_allclose(fast.x, gen.x, atol=2e-5)
    assert fast.x[:, 1].min() < verts[:, 1].min() - 1e-4


def test_setters_and_windows_in_the_callers_numbering():
    """System.x/v read and write in the caller's numbering; run(12) is one
    10-step launch and two single steps; repeats are bitwise."""
    beam = _beam()
    verts, tets = _scrambled(beam.vertices, np.asarray(beam.tets), 3)
    a = _system(verts, tets, True)
    b = _system(verts, tets, True)
    cid = a._to_canon
    assert not np.array_equal(cid, np.arange(len(verts)))
    np.testing.assert_array_equal(a.x, verts)
    rng = np.random.RandomState(0)
    newx = verts + 0.01 * rng.randn(*verts.shape)
    newv = 0.1 * rng.randn(*verts.shape)
    for s in (a, b):
        s.x, s.v = newx, newv
    np.testing.assert_array_equal(a.x, newx)
    np.testing.assert_array_equal(a.v, newv)
    np.testing.assert_array_equal(a._stepper.x[cid], newx)
    for _ in range(12):
        a.step()
    b.run(12)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.v, b.v)
    assert float(b._stepper.state["t"]) == pytest.approx(0.48)


def test_wrapper_routing_and_checks():
    """CPU tensors take the twin; another device raises; shapes, dtypes and
    the configuration are checked."""
    st = _port_stepper("floor")
    got = pls.lattice_rollout(st.state, st.planes, st.cfg, 2)
    want = pls.lattice_rollout_reference(st.state, st.planes, st.cfg, 2)
    for k in pls.STATE:
        assert torch.equal(got[k], want[k]), k
    assert pls.lattice_rollout.launches == 0  # no kernel on the CPU
    meta = {k: t.to("meta") for k, t in st.state.items()}
    mplanes = {k: t.to("meta") for k, t in st.planes.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        pls.lattice_rollout(meta, mplanes, st.cfg, 1)
    with pytest.raises(ValueError, match="u"):
        pls.lattice_rollout(dict(st.state, u=st.state["u"][:, :-1]),
                            st.planes, st.cfg, 1)
    with pytest.raises(ValueError, match="dia"):
        pls.lattice_rollout(st.state, dict(st.planes,
                                           dia=st.planes["dia"].float()),
                            st.cfg, 1)
    with pytest.raises(ValueError, match="model"):
        dataclasses.replace(st.cfg, model="fung")
    with pytest.raises(ValueError, match="12"):
        dataclasses.replace(st.cfg, cp=st.cfg.cp[:9])
