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
- port cloth vs port general: 1e-12 on x (the same projection code and
  the same dia matrix, the Pallas kernel's summation order of the RHS
  against the general route's, and the cluster solve's order of the dots
  against torch.sum: round-off, as tests/test_cloth_fast.py holds the JAX
  routes);
- port cloth twin vs the JAX cloth kernel after a 10-step window: 1e-8 on
  x and v (the JAX kernel's matvec mirrors a half-stored A, the port's
  adds A's diagonals in offset order);
- the twin's solve against `pcg_fixed_inv` with `cluster_dot` over the
  System's own diagonals: bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core.cloth import ClothStepper as JaxClothStepper
from admm_elastic_tpu_torch.core.cloth import ClothStepper
from admm_elastic_tpu_torch.core.solver import dia_apply, pcg_fixed_inv
from admm_elastic_tpu_torch.ops.kernels import cloth_step as pcs
from admm_elastic_tpu_torch.ops.kernels.cg_step import cluster_dot
from admm_elastic_tpu_torch.utils import cloth_from_reference, from_reference

torch.set_num_threads(1)

TOL = 1e-8


def cloth(pkg, fast, *, nx=8, ny=6, wind=True, bend=True, anchors=True,
          iters=10, cg=30, stiff=100.0, lim=(0.95, 1.05), bend_k=20.0,
          anchor_w=1000.0,
          n_anchors=4, gravity=(0, -9.8, 0), wind_dir=(1.5, 0, 0.4),
          scramble=None, backend="pallas", **settings):
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
            device="cpu", global_solver="dia", cg_fixed_iters=cg,
            lattice_fast_path=fast,
            **settings))
    m = pkg.models
    s.add_nodes(verts, np.full(n, 0.5 / n))
    s.add_force(m.LimitedTriangleStrain(faces, stiff, *lim, backend=backend))
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
    # the JAX kernel stores A's diagonals at offsets >= 0 only; the port
    # keeps all of them, at their signed offsets
    assert tuple(o for o in st.cfg.dia_offs if o >= 0) == js.dia_offs
    assert st.cfg.dia_offs == tuple(-o for o in reversed(st.cfg.dia_offs))


@pytest.mark.parametrize("bad", [
    dict(scramble=7),
    dict(scramble=7, preconditioner="amg"),
    dict(cg=(30, 10)),
    dict(stiff=100.0 * (0.5 + np.random.RandomState(1).rand(96))),
], ids=["scrambled", "amg", "cg-schedule", "per-element-stiffness"])
def test_out_of_slice_cloths_raise(bad):
    """JAX renumbers a scrambled grid onto its cloth kernel (under 'amg'
    too, with its multigrid), which the port does not do: it raises.
    Per-element constants qualify for no kernel in
    either numbering, so JAX steps its general route, and so does the
    port, bitwise as with the fast path off."""
    if "stiff" in bad:
        runs = []
        for fast in (True, False):
            s = cloth(pt, fast, **bad)
            assert s._stepper is None
            s.run(2)
            runs.append(s.x)
        assert np.array_equal(runs[0], runs[1])
        return
    with pytest.raises(NotImplementedError):
        cloth(pt, True, **bad)


def test_routing():
    assert isinstance(cloth(pt, True)._stepper, ClothStepper)
    assert cloth(pt, False)._stepper is None
    # the default backend='xla' constructs and steps (on the cloth kernel,
    # which selects by type); an unknown backend raises JAX's ValueError
    faces = pt.geometry.make_plane_grid(2, 2).faces
    assert pt.models.LimitedTriangleStrain(faces, 1.0).backend == "xla"
    with pytest.raises(ValueError, match="backend"):
        pt.models.LimitedTriangleStrain(faces, 1.0, backend="cuda")
    s = cloth(pt, True, backend="xla")
    assert isinstance(s._stepper, ClothStepper)
    s.run(2)
    assert np.isfinite(s.x).all()
    # a scrambled sheet reaches the renumbered fallback, which rebuilds the
    # force with its backend; where JAX would renumber, the port raises
    with pytest.raises(NotImplementedError, match="renumbering"):
        cloth(pt, True, scramble=0, backend="xla", reorder="none")
    # 'amg' engages the cloth kernel's multigrid; without the fast path
    # it raises JAX's ValueError (tests/test_torch_mg.py holds the rest)
    assert cloth(pt, True, preconditioner="amg")._stepper.cfg.mg is not None
    with pytest.raises(ValueError, match="amg"):
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


def _sym_dia_apply(y, offs, half):
    """A y for a symmetric A stored at offsets >= 0 only (half[d,i] = A[i,
    i+off]), the JAX cloth kernel's storage, in its order: per diagonal,
    the upper term, then the mirrored lower term."""
    n = y.shape[0]
    out = torch.zeros_like(y)
    for d, off in enumerate(offs):
        w = half[d][:, None]
        if off == 0:
            out = out + w * y
        elif off < n:
            out[: n - off] = out[: n - off] + w[: n - off] * y[off:]
            out[off:] = out[off:] + w[: n - off] * y[: n - off]
    return out


def test_sym_dia_apply_matches_full_dia():
    """The cloth route's matrix, all of A's diagonals at their signed
    offsets, against the JAX kernel's symmetric half storage (its offsets
    >= 0, each term mirrored): the same A y to round-off."""
    s = cloth(pt, True)
    st = _stepper(s)
    offs, dia = st.cfg.dia_offs, st.planes["dia"]
    half = [d for d, o in enumerate(offs) if o >= 0]
    y = torch.as_tensor(np.random.default_rng(3).normal(size=(s.n_nodes, 3)))
    want = _sym_dia_apply(y, [offs[d] for d in half], dia[half])
    got = dia_apply(y, offs, dia)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    assert not torch.equal(got, want)  # the two orders differ in the bits


def test_cloth_matrix_is_the_general_routes():
    """The cloth route keeps the general route's own diagonals, offsets
    and D^-1, bitwise."""
    s = cloth(pt, False)
    st = _stepper(cloth(pt, True))
    sv = s.params["_solver"]
    assert st.cfg.dia_offs == tuple(s._dia_offsets)
    assert torch.equal(st.planes["dia"], sv["dia_vals"])
    assert torch.equal(st.planes["invd"], 1.0 / sv["diag"])


def test_cloth_twin_solve_is_cluster_pcg(monkeypatch):
    """Each ADMM iteration's solve in the twin is `pcg_fixed_inv` with
    `cluster_dot` over the System's own diagonals, from x, D^-1 as stored:
    bitwise."""
    s = cloth(pt, False, nx=5, ny=4)
    sv = s.params["_solver"]
    st = _stepper(cloth(pt, True, nx=5, ny=4))
    calls = []

    def spy(A, b, x0, inv, n_iters, dot):
        x = pcg_fixed_inv(A, b, x0, inv, n_iters, dot)
        calls.append((b, x0, inv, n_iters, dot, x))
        return x

    monkeypatch.setattr(pcs, "pcg_fixed_inv", spy)
    state = {k: st.state[k] for k in pcs.STATE}
    out = pcs.cloth_rollout_reference(state, st.planes, st.cfg, 2)
    assert len(calls) == 2 * st.cfg.admm_iters
    for b, x0, inv, n_iters, dot, x in calls:
        assert dot is cluster_dot and n_iters == st.cfg.cg_iters == 30
        want = pcg_fixed_inv(
            lambda y: dia_apply(y, s._dia_offsets, sv["dia_vals"]), b, x0,
            1.0 / sv["diag"], n_iters, cluster_dot)
        assert torch.equal(x, want)
    assert torch.equal(out["x"], calls[-1][-1])


def test_setters_take_effect_between_windows():
    """Positions and velocities set between windows are the ones the next
    window steps from (the stepper copies them into its state)."""
    st = _stepper(cloth(pt, True, nx=5, ny=4, wind=False, iters=3, cg=5))
    st.run(10)
    x = st.x + 0.01 * np.random.default_rng(0).standard_normal(st.x.shape)
    v = np.full_like(x, 0.05)
    st.set_positions(x)
    st.set_velocities(v)
    assert np.array_equal(st.x, x) and np.array_equal(st.v, v)
    start = {k: st.state[k].clone() for k in pcs.STATE}
    st.run(10)
    want = pcs.cloth_rollout_reference(start, st.planes, st.cfg, 10)
    for k in pcs.STATE:
        assert torch.equal(st.state[k], want[k]), k
    assert np.isfinite(st.x).all() and np.abs(st.x - x).max() > 1e-3


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
