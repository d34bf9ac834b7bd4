"""The port's cloth: LimitedTriangleStrain, Bend and WindForce on the
general route against the JAX package's general route, the cloth
whole-timestep route (`lattice_fast_path=True`, core/cloth.py +
ops/kernels/cloth_step.py, plain twin on the CPU) against the port's
general route and against the JAX package's `ClothStepper` (Pallas
interpret mode), plus routing, determinism and the wrapper's checks.

make_plane_grid cloths of tests/test_cloth_fast.py, f64. Tolerances:
- port general vs JAX general, 5 steps: 1e-8 on x and v (the slice
  parity bound of tests/test_torch_system.py; the two packages sum the
  einsums and the RHS in different orders);
- port cloth vs port general: 1e-12 on x (the same projection code, the
  Pallas kernel's summation order against the general route's: round-off,
  as tests/test_cloth_fast.py holds the JAX routes);
- port cloth twin vs the JAX cloth kernel after a 10-step window: 1e-8 on
  x and v."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core.cloth import ClothStepper as JaxClothStepper
from admm_elastic_tpu_torch.core.cloth import ClothStepper
from admm_elastic_tpu_torch.core.solver import dia_apply
from admm_elastic_tpu_torch.ops.kernels import cloth_step as pcs
from admm_elastic_tpu_torch.utils import cloth_from_reference, from_reference

torch.set_num_threads(1)

TOL = 1e-8


def cloth(pkg, fast, *, nx=8, ny=6, wind=True, bend=True, anchors=True,
          iters=10, cg=30, stiff=100.0, lim=(0.95, 1.05), bend_k=20.0,
          anchor_w=1000.0,
          n_anchors=4, gravity=(0, -9.8, 0), wind_dir=(1.5, 0, 0.4),
          scramble=None, **settings):
    """tests/test_cloth_fast.py's _cloth_system, for pkg in (aet, pt)."""
    mesh = pkg.geometry.make_plane_grid(nx, ny)
    n = mesh.n_vertices
    verts, faces = mesh.vertices, mesh.faces
    if scramble is not None:
        perm = np.random.RandomState(scramble).permutation(n)
        verts = verts[perm]
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        faces = inv[faces]
    if pkg is aet:
        s = aet.System(aet.Settings(
            timestep_s=0.04, admm_iters=iters, verbose=0, dtype=jnp.float64,
            global_solver="dia", cg_fixed_iters=cg, lattice_fast_path=fast,
            **settings))
    else:
        s = pt.System(pt.Settings(
            timestep_s=0.04, admm_iters=iters, verbose=0, dtype=torch.float64,
            device="cpu", cg_fixed_iters=cg, lattice_fast_path=fast,
            **settings))
    m = pkg.models
    s.add_nodes(verts, np.full(n, 0.5 / n))
    s.add_force(m.LimitedTriangleStrain(faces, stiff, *lim, backend="pallas"))
    if bend:
        s.add_force(m.Bend(pkg.geometry.extract_hinges(faces), bend_k))
    if anchors:
        top = np.flatnonzero(np.abs(verts[:, 1] - 1.0) < 1e-9)
        s.add_force(m.StaticAnchor(top[:n_anchors], weight=anchor_w))
    s.add_explicit_force(m.ExplicitForce(direction=gravity))
    if wind:
        s.add_explicit_force(m.WindForce(faces, direction=wind_dir))
    assert s.initialize()
    return s


# test_cloth_fast.py:70-145: full physics; minimal; anchor-free; engaged
# asymmetric limits, nondefault anchor weight, skewed gravity, off-axis
# wind. That file's wind (4, 1, -2.5) drives this light cloth to NaN within
# 6 steps in both packages (its assert_allclose passes NaN against NaN);
# (0.6, 0.15, -0.4) keeps it finite with the 1.02 limit engaged.
VARIANTS = {
    "full": (dict(), 5),
    "no-wind-no-bend": (dict(wind=False, bend=False), 5),
    "no-anchors": (dict(anchors=False, wind=False), 3),
    "adversarial": (dict(nx=7, ny=5, iters=8, stiff=35.0, lim=(0.6, 1.02),
                         bend_k=3.5, anchor_w=77.0, n_anchors=3,
                         gravity=(0.3, -9.8, 0.1),
                         wind_dir=(0.6, 0.15, -0.4)), 6),
}


def _stepper(s):
    assert isinstance(s._stepper, ClothStepper), "cloth route not engaged"
    assert s._stepper.model == "cloth"
    return s._stepper


@pytest.fixture(scope="module")
def jax_general():
    """The JAX general route: 2 steps, a snapshot of params/state, 3 more."""
    s = cloth(aet, False)
    s.run(2)
    snap = (jax.device_get(s.params), jax.device_get(s.state),
            s.x.copy(), s.v.copy())
    s.run(3)
    return snap, s.x.copy(), s.v.copy()


def test_general_route_matches_jax(jax_general):
    _, x5, v5 = jax_general
    s = cloth(pt, False)
    assert s._stepper is None
    s.run(5)
    assert np.abs(s.x - x5).max() < TOL, np.abs(s.x - x5).max()
    assert np.abs(s.v - v5).max() < TOL, np.abs(s.v - v5).max()
    assert np.abs(s.x - s._x).max() > 1e-2  # gravity and wind moved it


def test_general_carry_over_from_jax(jax_general):
    (params, state, x2, v2), x5, v5 = jax_general
    s = cloth(pt, False)
    from_reference(s, params, state)
    assert np.array_equal(s.x, x2) and np.array_equal(s.v, v2)
    s.run(3)
    assert np.abs(s.x - x5).max() < TOL, np.abs(s.x - x5).max()
    assert np.abs(s.v - v5).max() < TOL, np.abs(s.v - v5).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cloth_route_matches_general(variant):
    kw, steps = VARIANTS[variant]
    gen = cloth(pt, False, **kw)
    fast = cloth(pt, True, **kw)
    _stepper(fast)
    for _ in range(steps):
        gen.step()
        fast.step()
        np.testing.assert_allclose(fast.x, gen.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fast.v, gen.v, rtol=0, atol=1e-10)
    assert np.isfinite(gen.x).all()
    assert np.abs(gen.x - gen._x).max() > 1e-3


@pytest.fixture(scope="module")
def jax_cloth():
    """The JAX cloth kernel (interpret mode): 2 steps, a snapshot of its
    state, then one 10-step window."""
    s = cloth(aet, True)
    assert isinstance(s._lattice, JaxClothStepper)
    assert np.array_equal(s._to_canon, np.arange(s.n_nodes))
    s.run(2)
    snap = jax.device_get(s._lattice.state)
    s.run(10)
    return snap, np.asarray(s.x), np.asarray(s.v)


def test_cloth_twin_matches_jax_kernel(jax_cloth):
    snap, x12, v12 = jax_cloth
    s = cloth(pt, True)
    st = _stepper(s)
    cloth_from_reference(st, snap)
    assert float(st.state["t"]) == pytest.approx(0.08)
    assert np.abs(st.state["tu"].numpy()).max() > 0  # real duals carried
    assert np.abs(st.state["hu"].numpy()).max() > 0
    s.run(10)
    assert np.abs(s.x - x12).max() < TOL, np.abs(s.x - x12).max()
    assert np.abs(s.v - v12).max() < TOL, np.abs(s.v - v12).max()


def test_groups_match_jax():
    """The same stencil groups, in the same order, as the JAX stepper."""
    st = _stepper(cloth(pt, True))
    js = cloth(aet, True)._lattice
    assert [g[1] for g in st.groups] == [g[1] for g in js.groups]
    assert [g[0] for g in st.groups] == [g[0] for g in js.groups]
    assert st.wind_groups == [w[0] for w in js.wind_groups]
    assert st.cfg.dia_offs == js.dia_offs


@pytest.mark.parametrize("bad", [
    dict(scramble=7),
    dict(preconditioner="amg"),
    dict(cg=(30, 10)),
    dict(stiff=100.0 * (0.5 + np.random.RandomState(1).rand(96))),
], ids=["scrambled", "amg", "cg-schedule", "per-element-stiffness"])
def test_out_of_slice_cloths_raise(bad):
    """JAX renumbers a scrambled grid and falls back to its general route
    for per-element constants; the port raises for both rather than run
    something else."""
    with pytest.raises(NotImplementedError):
        cloth(pt, True, **bad)


def test_routing():
    assert isinstance(cloth(pt, True)._stepper, ClothStepper)
    assert cloth(pt, False)._stepper is None
    faces = pt.geometry.make_plane_grid(2, 2).faces
    with pytest.raises(NotImplementedError, match="xla"):
        pt.models.LimitedTriangleStrain(faces, 1.0)  # backend='xla'
    with pytest.raises(NotImplementedError, match="amg"):
        cloth(pt, False, preconditioner="amg")
    # cg_backend is ignored under dia, as in the JAX package
    s = cloth(pt, True, cg_backend="fused")
    assert isinstance(s._stepper, ClothStepper)


def test_run_windows_equal_steps():
    """run(12) = one 10-step launch + 2 single steps."""
    a = cloth(pt, True, nx=6, ny=5)
    b = cloth(pt, True, nx=6, ny=5)
    for _ in range(12):
        a.step()
    b.run(12)
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=1e-13)
    assert float(_stepper(b).state["t"]) == pytest.approx(0.48)


@pytest.mark.parametrize("fast", [False, True], ids=["general", "cloth"])
def test_bitwise_repeat(fast):
    def run():
        s = cloth(pt, fast, nx=6, ny=5)
        s.run(3)
        return s.x, s.v

    (xa, va), (xb, vb) = run(), run()
    assert np.array_equal(xa, xb) and np.array_equal(va, vb)


def test_setters_and_gated_anchor_dual():
    s = cloth(pt, True, nx=5, ny=4)
    ref = cloth(pt, False, nx=5, ny=4)
    rng = np.random.RandomState(0)
    newx = s._x + 0.01 * rng.randn(*s._x.shape)
    for sys_ in (s, ref):
        sys_.x = newx
        sys_.v = 0.1 * np.ones_like(newx)
    np.testing.assert_array_equal(s.x, newx)
    s.run(4)
    ref.run(4)
    np.testing.assert_allclose(s.x, ref.x, rtol=0, atol=1e-12)
    # the dual of an unanchored vertex stays exactly 0 (the kernel's gate)
    st = _stepper(s)
    free = st.planes["aw2"] == 0
    assert torch.count_nonzero(st.state["au"][free]) == 0
    assert torch.count_nonzero(st.state["au"][~free]) > 0


def test_wrapper_routing_and_checks():
    """CPU tensors take the twin; another device raises; shapes and dtypes
    are checked."""
    st = _stepper(cloth(pt, True, nx=5, ny=4))
    got = pcs.cloth_rollout(st.state, st.planes, st.cfg, 2)
    want = pcs.cloth_rollout_reference(st.state, st.planes, st.cfg, 2)
    for k in pcs.STATE:
        assert torch.equal(got[k], want[k]), k
    assert pcs.cloth_rollout.launches == 0  # no kernel on the CPU
    meta = {k: t.to("meta") for k, t in st.state.items()}
    mplanes = {k: t.to("meta") for k, t in st.planes.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        pcs.cloth_rollout(meta, mplanes, st.cfg, 1)
    bad = dict(st.planes, inc=st.planes["inc"].long())
    with pytest.raises(ValueError, match="inc"):
        pcs.cloth_rollout(st.state, bad, st.cfg, 1)
    bad = dict(st.state, tu=st.state["tu"][:, 1:])
    with pytest.raises(ValueError, match="tgrp|tu"):
        pcs.cloth_rollout(bad, st.planes, st.cfg, 1)


def test_sym_dia_apply_matches_full_dia():
    """The symmetric half-storage matvec against the full dia matvec of
    the general route on the same A_hat."""
    s = cloth(pt, True)
    st = _stepper(s)
    y = torch.as_tensor(np.random.default_rng(3).normal(size=(s.n_nodes, 3)))
    got = pcs.sym_dia_apply(y, st.cfg.dia_offs, st.planes["dia"])
    want = dia_apply(y, s._dia_offsets, s.params["_solver"]["dia_vals"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_wind_force_matches_jax(seed):
    """WindForce.apply (fixed-order incidence sum) against the JAX
    package's (segment_sum), on a randomly deformed and moving grid."""
    rng = np.random.default_rng(seed)
    mesh = pt.geometry.make_plane_grid(6, 4)
    x = mesh.vertices + 0.1 * rng.normal(size=mesh.vertices.shape)
    v = rng.normal(size=x.shape)
    ja = aet.models.WindForce(mesh.faces, direction=(1.5, -0.5, 0.4))
    pa = pt.models.WindForce(mesh.faces, direction=(1.5, -0.5, 0.4))
    jp = {k: jnp.asarray(a) for k, a in ja.build().items()}
    want = np.asarray(ja.apply(0.04, jnp.asarray(x), jnp.asarray(v), None, jp))
    pp = {k: torch.as_tensor(a) if k != "direction" else torch.as_tensor(a)
          for k, a in pa.build(mesh.n_vertices).items()}
    pp["tris"], pp["inc"] = pp["tris"].long(), pp["inc"].long()
    got = pa.apply(0.04, torch.as_tensor(x), torch.as_tensor(v), None, pp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    assert np.abs(want - v).max() > 1e-3
    with pytest.raises(ValueError, match="node count"):
        pa.build()
