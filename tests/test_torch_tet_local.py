"""The port's plain ARAP (corotational) tet local steps against the JAX
package's Pallas kernels (`arap_local_step_fused`, `arap_local_step`) in
f64.

The inputs are random selector planes and positions, a quarter of them
inverted, plus elements whose F is set exactly (positions zero, so F = u):
F = 0, rank 1, rank 2, scaled rotations and reflections (F^T F isotropic:
every Jacobi rotation has apq = 0 and sign(0) = 0), diagonal F with
repeated entries (ties in the sorting network), and collapsed F (1e-9).

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
from admm_elastic_tpu_torch.ops.kernels import nh_local as pnh
from admm_elastic_tpu_torch.ops.kernels import tet_local as ptet

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
        args = ins
    else:
        args = _unfused(ins)
        refs = [_Ref(a) for a in args[:2]] + [_Ref(a[None]) for a in args[2:]]
        want = [_Ref(np.zeros((9, E))) for _ in range(2)]
        body, plain = jtet._arap_kernel, ptet.arap_local_step_reference
    with jax.disable_jit():
        body(*refs, *want)
    monkeypatch.setattr(pnh, "torch", _TorchWithRoundedSqrt())
    monkeypatch.setattr(ptet, "torch", _TorchWithRoundedSqrt())
    got = plain(*(torch.as_tensor(a) for a in args))
    for w, g in zip(want, got):
        d = np.abs(g.numpy() - w.a)
        assert np.array_equal(g.numpy(), w.a), (
            f"{int((d > 0).sum())} values differ, max {d.max():.3g}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_plain_matches_pallas_interpret(fused):
    assert E % BLOCK == 0
    ins = _inputs(2)
    if fused:
        ref = jtet.arap_local_step_fused(*(jnp.asarray(a) for a in ins),
                                         interpret=True)
        out = ptet.arap_local_step_fused(*(torch.as_tensor(a) for a in ins))
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
        np.testing.assert_allclose(o[:, unique], r[:, unique], rtol=0,
                                   atol=1e-12)
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
    ins = [torch.as_tensor(a) for a in _inputs(5)]
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
    bad[1] = ins[1][:, :-1]
    with pytest.raises(ValueError, match="u9"):
        ptet.arap_local_step_fused(*bad)
    bad = list(un)
    bad[3] = un[3].float()
    with pytest.raises(ValueError, match="k"):
        ptet.arap_local_step(*bad)
    bad = list(un)
    bad[0] = un[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        ptet.arap_local_step(*bad)
    # emit_z: the same outputs, then the rows of w2 D^T z
    a = ptet.arap_local_step_fused(*ins)
    *same, cz = ptet.arap_local_step_fused(*ins, emit_z=True)
    assert all(torch.equal(x, y) for x, y in zip(same, a))
    E = ins[0].shape[1]
    want = ins[3] * torch.einsum("rke,jre->kje", ins[2].reshape(3, 4, E),
                                 a[0].reshape(3, 3, E)).reshape(12, E)
    torch.testing.assert_close(cz, want, rtol=1e-13, atol=1e-13)
    for fn, args in ((ptet.arap_local_step_fused, ins),
                     (ptet.arap_local_step, un)):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*(t.to("meta") for t in args))
