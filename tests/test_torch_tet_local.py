"""The port's plain ARAP (corotational) tet local steps against the JAX
package's Pallas kernels (`arap_local_step_fused`, `arap_local_step`) in
f64, and the port's wrappers, plans, `out=` buffers and the System's two
sets of them on the general route.

The inputs are random selector planes and positions, a quarter of them
inverted, plus elements whose F is set exactly (positions zero, so F = u):
F = 0, rank 1, rank 2, scaled rotations and reflections (F^T F isotropic:
every Jacobi rotation has apq = 0 and sign(0) = 0), diagonal F with
repeated entries (ties in the sorting network), and collapsed F (1e-9).
The port's fused entry gathers from positions x through the tets, so it
takes the gathered positions (12,E) of the JAX kernel as a mesh whose
elements share no vertex (`_unshared`: vertex 4e+k holds element e's
corner k), and its (4E,3) rows are held against JAX's row planes (12,E)
laid out as rows (`flat_rows`).

Two comparisons, as tests/test_torch_nh_local.py makes them:
- the Pallas kernel body evaluated by JAX one operation at a time
  (`jax.disable_jit()`, array-backed refs) against the plain version given
  the same correctly rounded sqrt: bitwise equal on every element;
- the interpret-mode kernel (`interpret=True`, jitted, so XLA may contract
  multiply-adds) against the plain version as it is: within 1e-12
  absolute (every value here is below 100 in magnitude), except on the
  rank-1 elements. There the closest rotation is not unique: Gram-Schmidt
  of F V leaves a second column of round-off size, whose test against the
  tolerance flips with the last bit. For them both answers must be proper
  rotations that agree on F's range (R F^T F), which determines them up to
  that freedom."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops.pallas import tet_local as jtet
from admm_elastic_tpu.ops.pallas.tet_local import BLOCK
from admm_elastic_tpu_torch.ops.kernels import _build
from admm_elastic_tpu_torch.ops.kernels import nh_local as pnh
from admm_elastic_tpu_torch.ops.kernels import tet_local as ptet
from admm_elastic_tpu_torch.ops.segment import flat_rows

torch.set_num_threads(1)

E = 1024
N_SPECIAL = 64  # elements with F set exactly, at the front
RANK1 = np.arange(8, 16)  # of them, the rank-1 ones


def _special_F(rng):
    """(N_SPECIAL, 3, 3) exact deformation gradients."""
    F = []
    for _ in range(8):
        F.append(np.zeros((3, 3)))
    for _ in range(8):  # rank 1
        F.append(np.outer(rng.normal(size=3), rng.normal(size=3)))
    for _ in range(8):  # rank 2
        a, b = rng.normal(size=(2, 3))
        F.append(np.stack([a, b, 2.0 * a - b], axis=1))
    for i in range(16):  # scaled signed permutations: F^T F = c^2 I
        P = np.eye(3)[rng.permutation(3)] * rng.choice([-1.0, 1.0], 3)
        F.append(2.0 ** (i % 4 - 1) * P)
    for i in range(16):  # diagonal with repeated entries
        d = [1.0, 1.0, 2.0] if i % 2 else [0.5, 3.0, 3.0]
        F.append(np.diag(rng.permutation(d) * (-1.0 if i % 4 == 3 else 1.0)))
    for _ in range(8):  # collapsed
        F.append(1e-9 * rng.normal(size=(3, 3)))
    return np.asarray(F)


def _inputs(seed):
    """(xg12, u9, cp12, w2, k): a quarter of the random elements inverted
    (cp[8:12] negated flips F's third column), duals 0.1 N(0,1)."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(12, E))
    cp = rng.normal(size=(12, E))
    cp[8:12, N_SPECIAL: N_SPECIAL + E // 4] *= -1.0
    u = 0.1 * rng.normal(size=(9, E))
    w2 = rng.uniform(0.5, 2.0, E)
    k = rng.uniform(0.5, 5.0, E)
    xg[:, :N_SPECIAL] = 0.0
    u[:, :N_SPECIAL] = _special_F(rng).reshape(N_SPECIAL, 9).T  # 3a+b
    return xg, u, cp, w2, k


def _dx(xg, cp):
    """dx[3a+b] = sum_k cp[4b+k] xg[3k+a] (exact zeros where xg is)."""
    return np.einsum("bke,kae->abe", cp.reshape(3, 4, E),
                     xg.reshape(4, 3, E)).reshape(9, E)


def _unfused(ins):
    xg, u, cp, w2, k = ins
    return _dx(xg, cp), u, w2, k


def _unshared(xg):
    """Positions (4E,3) and int32 tets (E,4) whose gather is xg (12,E):
    vertex 4e+k holds xg[3k:3k+3, e]."""
    n = xg.shape[1]
    return (np.ascontiguousarray(xg.T.reshape(4 * n, 3)),
            np.arange(4 * n, dtype=np.int32).reshape(n, 4))


def _fused(ins):
    """The port's fused arguments (x, tets, u9, cp12, w2, k) of the JAX
    kernel's (xg12, u9, cp12, w2, k), as tensors."""
    xg, u, cp, w2, k = ins
    return [torch.as_tensor(a) for a in (*_unshared(xg), u, cp, w2, k)]


def _rows(planes):
    """JAX's row planes (12,E) as the port's (4E,3) rows."""
    return flat_rows([torch.as_tensor(np.array(planes))]).numpy()


class _Ref:
    """An array standing in for a Pallas ref: reads give jnp arrays,
    writes land in numpy."""

    def __init__(self, a):
        self.a = np.array(a, dtype=np.float64)

    def __getitem__(self, i):
        return jnp.asarray(self.a[i])

    def __setitem__(self, i, v):
        self.a[i] = np.asarray(v)


class _TorchWithRoundedSqrt:
    """torch, with sqrt correctly rounded (as XLA's is)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sqrt(x):
        return torch.from_numpy(np.sqrt(x.numpy()))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_plain_is_the_kernel_body_bitwise(fused, monkeypatch):
    ins = _inputs(1)
    if fused:
        refs = [_Ref(a) for a in ins[:3]] + [_Ref(a[None]) for a in ins[3:]]
        want = [_Ref(np.zeros((n, E))) for n in (9, 9, 12)]
        body, plain = jtet._make_arap_fused_kernel(False), \
            ptet.arap_local_step_fused_reference
        args = _fused(ins)
    else:
        refs = [_Ref(a) for a in _unfused(ins)[:2]] + [
            _Ref(a[None]) for a in _unfused(ins)[2:]]
        want = [_Ref(np.zeros((9, E))) for _ in range(2)]
        body, plain = jtet._arap_kernel, ptet.arap_local_step_reference
        args = [torch.as_tensor(a) for a in _unfused(ins)]
    with jax.disable_jit():
        body(*refs, *want)
    monkeypatch.setattr(pnh, "torch", _TorchWithRoundedSqrt())
    monkeypatch.setattr(ptet, "torch", _TorchWithRoundedSqrt())
    got = plain(*args)
    for w, g in zip((*(w.a for w in want[:2]), *(
            _rows(w.a) if fused else w.a for w in want[2:])), got):
        d = np.abs(g.numpy() - w)
        assert np.array_equal(g.numpy(), w), (
            f"{int((d > 0).sum())} values differ, max {d.max():.3g}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_plain_matches_pallas_interpret(fused):
    assert E % BLOCK == 0
    ins = _inputs(2)
    if fused:
        ref = jtet.arap_local_step_fused(*(jnp.asarray(a) for a in ins),
                                         interpret=True)
        ref = (*ref[:2], _rows(ref[2]))
        out = ptet.arap_local_step_fused(*_fused(ins))
    else:
        args = _unfused(ins)
        ref = jtet.arap_local_step(*(jnp.asarray(a) for a in args),
                                   interpret=True)
        out = ptet.arap_local_step(*(torch.as_tensor(a) for a in args))
    assert len(ref) == len(out)
    unique = np.ones(E, bool)
    unique[RANK1] = False
    for r, o in zip(ref, out):
        r, o = np.asarray(r), o.numpy()
        assert o.shape == r.shape and np.isfinite(o).all()
        assert np.abs(r).max() < 100.0
        # planes: element e is column e; rows: element e is rows 4e..4e+3
        keep = (np.s_[:, unique] if o.shape[1] == E
                else np.s_[np.repeat(unique, 4)])
        np.testing.assert_allclose(o[keep], r[keep], rtol=0, atol=1e-12)
    # rank 1: z = (k R + w2 F) / (w2 + k) with R proper, on F's range alike
    xg, u, cp, w2, k = ins
    F = (_dx(xg, cp) + u)[:, RANK1].T.reshape(-1, 3, 3)
    FtF = np.einsum("eki,ekj->eij", F, F)
    Rs = []
    for z in (np.asarray(ref[0]), out[0].numpy()):
        z = z[:, RANK1].T.reshape(-1, 3, 3)
        c = (w2 + k)[RANK1, None, None]
        R = (z * c - w2[RANK1, None, None] * F) / k[RANK1, None, None]
        np.testing.assert_allclose(np.einsum("eij,eik->ejk", R, R),
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
        Rs.append(np.einsum("eij,ejk->eik", R, FtF))
    np.testing.assert_allclose(Rs[1], Rs[0], rtol=0, atol=1e-12)


def test_rotations_are_proper_and_exact_where_known():
    """R is a proper rotation everywhere (the fallbacks complete F = 0 and
    rank-deficient F to one); a scaled signed permutation with det > 0 is
    its own rotation up to the scale, and z is then exact."""
    xg, u, cp, w2, k = _inputs(3)
    dx = torch.as_tensor(_dx(xg, cp))
    f = [dx[p] + torch.as_tensor(u)[p] for p in range(9)]
    R = torch.stack(ptet._polar_rotation(f)).numpy().T.reshape(E, 3, 3)
    np.testing.assert_allclose(np.einsum("eij,eik->ejk", R, R),
                               np.broadcast_to(np.eye(3), (E, 3, 3)),
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    F = u[:, 24:40].T.reshape(16, 3, 3)
    proper = np.linalg.det(F) > 0
    scale = np.abs(F).max(axis=(1, 2))
    np.testing.assert_allclose(R[24:40][proper],
                               F[proper] / scale[proper, None, None],
                               atol=1e-15)


def test_wrappers_checks_and_cpu_route():
    ins = _fused(_inputs(5))
    un = [torch.as_tensor(a) for a in _unfused(_inputs(5))]
    ptet.arap_local_step_fused.launches = 0
    ptet.arap_local_step.launches = 0
    for x, y in zip(ptet.arap_local_step_fused(*ins),
                    ptet.arap_local_step_fused_reference(*ins)):
        assert torch.equal(x, y)
    for x, y in zip(ptet.arap_local_step(*un),
                    ptet.arap_local_step_reference(*un)):
        assert torch.equal(x, y)
    # the CPU route is the plain version and counts no kernel launch
    assert ptet.arap_local_step_fused.launches == 0
    assert ptet.arap_local_step.launches == 0
    bad = list(ins)
    bad[2] = ins[2][:, :-1]
    with pytest.raises(ValueError, match="u9"):
        ptet.arap_local_step_fused(*bad)
    bad = list(ins)
    bad[0] = ins[0][:-1]
    with pytest.raises(ValueError, match="vertices"):
        ptet.arap_local_step_fused(*bad)
    bad = list(un)
    bad[3] = un[3].float()
    with pytest.raises(ValueError, match="k"):
        ptet.arap_local_step(*bad)
    bad = list(un)
    bad[0] = un[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        ptet.arap_local_step(*bad)
    # emit_z: the same outputs, the rows 6 wide, columns 3:6 w2 D^T z
    a = ptet.arap_local_step_fused(*ins)
    *same, rows6 = ptet.arap_local_step_fused(*ins, emit_z=True)
    assert all(torch.equal(x, y) for x, y in zip(same, a))
    assert rows6.shape == (4 * E, 6) and torch.equal(rows6[:, :3], a[2])
    want = ins[4] * torch.einsum("rke,jre->kje", ins[3].reshape(3, 4, E),
                                 a[0].reshape(3, 3, E)).reshape(12, E)
    torch.testing.assert_close(rows6[:, 3:].reshape(E, 12).T, want,
                               rtol=1e-13, atol=1e-13)
    for fn, args in ((ptet.arap_local_step_fused, ins),
                     (ptet.arap_local_step, un)):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*(t.to("meta") for t in args))


@pytest.mark.parametrize("emit_z", [False, True], ids=["rows", "emit_z"])
def test_fused_twin_is_the_gathered_path_bitwise(emit_z):
    """The fused twin from x and the tets equals, bit for bit, the path it
    replaced on a beam of shared vertices: the gather (12,E) the force
    made, the Pallas layout's twin, then flat_rows."""
    from admm_elastic_tpu_torch.geometry import make_beam_tets
    from admm_elastic_tpu_torch.models import LinearTetStrain

    rng = np.random.default_rng(7)
    beam = make_beam_tets(4, 3, 2, size=0.25)
    f = LinearTetStrain(beam.tets, 1e4, backend="pallas")
    params, _ = f.build(beam.vertices, None, 0.04)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    x = torch.as_tensor(beam.vertices + 0.05 * rng.normal(size=(
        beam.n_vertices, 3)))
    En = f.n_elements
    u = torch.as_tensor(0.05 * rng.normal(size=(9, En)))
    consts = (p["coeff_p"], p["w2"], p["k"])
    xg = x[p["indices"]].reshape(En, 12).T.contiguous()
    old = ptet._fused_planes(xg, u, *consts, emit_z=emit_z)
    new = ptet.arap_local_step_fused(x, p["indices"], u, *consts,
                                     emit_z=emit_z)
    for g, w in zip(new, (*old[:2], flat_rows(old[2:]))):
        assert g.shape == w.shape and torch.equal(g, w)


def test_plan_rebuilds_when_a_param_is_replaced():
    """A replaced constant gets a new plan (and the replaced one's bits);
    unchanged constants keep theirs."""
    ins = _fused(_inputs(6))
    first = ptet.arap_local_step_fused(*ins)
    key = ("arap_local_step_fused", *map(id, ins[3:]), id(ins[1]))
    plan = _build._PLANS[key]
    ptet.arap_local_step_fused(*ins)
    assert _build._PLANS[key] is plan
    args = [*ins[:5], 2.0 * ins[5]]
    got = ptet.arap_local_step_fused(*args)
    key2 = ("arap_local_step_fused", *map(id, args[3:]), id(args[1]))
    assert _build._PLANS[key2] is not plan
    assert not plan.serves(dict(zip(("cp12", "w2", "k", "tets"),
                                    (*args[3:], args[1]))))
    assert not torch.equal(got[0], first[0])
    for x, y in zip(got, ptet.arap_local_step_fused_reference(*args)):
        assert torch.equal(x, y)
    dx, u, w2, k = (torch.as_tensor(a) for a in _unfused(_inputs(6)))
    ptet.arap_local_step(dx, u, w2, k)
    step = _build._PLANS[("arap_local_step", id(w2), id(k))]
    ptet.arap_local_step(dx, u, w2, k)
    assert _build._PLANS[("arap_local_step", id(w2), id(k))] is step
    args[5] = args[5][:-1]  # a replacement of the wrong shape
    with pytest.raises(ValueError, match="k"):
        ptet.arap_local_step_fused(*args)


def test_out_buffers():
    """out= buffers get the outputs' bits in place; one of the wrong shape,
    or that overlaps an input or another output, raises."""
    ins = _fused(_inputs(8))
    un = [torch.as_tensor(a) for a in _unfused(_inputs(8))]
    for fn, args, iu in ((ptet.arap_local_step_fused, ins, 2),
                         (ptet.arap_local_step, un, 1)):
        want = fn(*args)
        out = tuple(torch.empty_like(w) for w in want)
        got = fn(*args, out=out)
        assert all(g is o and torch.equal(g, w)
                   for g, o, w in zip(got, out, want))
        call = list(args)
        call[iu] = u_in = args[iu].clone()
        with pytest.raises(ValueError, match="overlaps"):
            fn(*call, out=(out[0], u_in, *out[2:]))
        with pytest.raises(ValueError, match="overlaps"):
            fn(*args, out=(out[0], out[0], *out[2:]))
        with pytest.raises(ValueError, match="out"):
            fn(*args, out=(out[0][:, :-1], *out[1:]))
    with pytest.raises(ValueError, match="overlaps"):  # rows onto cp12
        ptet.arap_local_step_fused(*ins, out=(
            torch.empty_like(ins[2]), torch.empty_like(ins[2]),
            ins[3].view(4 * E, 3)))
    with pytest.raises(ValueError, match="out"):  # 3-wide rows, emit_z
        ptet.arap_local_step_fused(*ins, emit_z=True, out=tuple(
            torch.empty_like(w) for w in ptet.arap_local_step_fused(*ins)))


@pytest.mark.parametrize("case", ["arap-dia", "arap-relax1.6",
                                  "nh-relax1.6"])
def test_system_out_sets_are_bitwise(case, monkeypatch):
    """The general route hands its tet forces' element steps two sets of
    buffers in turn (the fused step on dia, the unfused one under
    over-relaxation): the same bits over 3 steps as new tensors each call,
    and no tensor of the state is a buffer of a set."""
    from admm_elastic_tpu_torch.models import HyperElasticTet, LinearTetStrain
    from admm_elastic_tpu_torch.utils.scenes import beam_system

    model, route = case.split("-")
    entry = "fused" if route == "dia" else "project"
    relax = 1.0 if route == "dia" else 1.6

    def run():
        s = beam_system((3, 2, 2), 0.1, 1.0, 8, torch.float64, "cpu",
                        arap=model == "arap", admm_iters=4,
                        relaxation=relax)
        s.run(3)
        return s

    def state(s):
        return [s.state["x"], s.state["v"], *s.state["u"].values(),
                *(t for st in s.state["forces"].values()
                  for t in st.values())]

    s = run()
    assert {k[1] for k in s._out_sets} == {entry}
    bufs = [t for sets in s._out_sets.values() for one in sets
            for t in one]
    assert len(bufs) == {"arap-dia": 6, "arap-relax1.6": 4,
                         "nh-relax1.6": 6}[case]
    ptrs = {t.untyped_storage().data_ptr() for t in bufs}
    assert not any(t.untyped_storage().data_ptr() in ptrs for t in state(s))
    cls = HyperElasticTet if model == "nh" else LinearTetStrain
    monkeypatch.setattr(cls, f"{entry}_out_buffers", None)
    fresh = run()
    assert not fresh._out_sets
    for a, b in zip(state(s), state(fresh)):
        assert torch.equal(a, b)
