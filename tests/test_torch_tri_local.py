"""The port's plain fused triangle-strain local step against the JAX
package's Pallas kernel (`tri_local_step_fused`) in f64.

The inputs are random selector planes and positions, plus elements whose F
is set exactly (positions zero, so F = u): rank 1, isotropic F^T F (scaled
axis pairs), a zero column, F = 0, and dyadic F whose strain-limited
columns land exactly on lmin or lmax (w2 = 1, k = 3, so 1/(w2 + k) = 0.25
and z is exact). Strain limiting on and off.

Two comparisons, as tests/test_torch_nh_local.py makes them:
- the Pallas kernel body evaluated by JAX one operation at a time
  (`jax.disable_jit()`, array-backed refs) against the plain version given
  the same correctly rounded sqrt: bitwise equal on every element;
- the interpret-mode kernel (`interpret=True`, jitted, so XLA may contract
  multiply-adds) against the plain version as it is: within 1e-12
  absolute (every value here is below 100 in magnitude; the largest
  difference is ~2e-14)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops.pallas import tri_local as jtri
from admm_elastic_tpu.ops.pallas.tet_local import BLOCK
from admm_elastic_tpu_torch.ops.kernels import tri_local as ptri

torch.set_num_threads(1)

E = 1024
N_SPECIAL = 96  # elements with F set exactly, at the front


def _special_F(rng):
    """(N_SPECIAL, 3, 2) exact deformation gradients and (w2, k, lmin,
    lmax) for them: 16 rank-1, 16 isotropic, 16 zero-column, 8 zero, 40 on
    the clamp bounds."""
    F, w2, k, lmin, lmax = [], [], [], [], []
    eye = np.eye(3)
    for i in range(16):  # rank 1: column 1 = s * column 0
        a = rng.normal(size=3)
        F.append(np.stack([a, (1.0 + i) * 0.5 * a], axis=1))
    for i in range(16):  # isotropic: orthogonal columns of equal norm
        p, q = rng.choice(3, size=2, replace=False)
        c = 2.0 ** rng.integers(-2, 3)
        F.append(np.stack([c * eye[p], (-1) ** i * c * eye[q]], axis=1))
    for i in range(16):  # one zero column
        col = rng.normal(size=3)
        z = np.zeros(3)
        F.append(np.stack([col, z] if i % 2 else [z, col], axis=1))
    for _ in range(8):
        F.append(np.zeros((3, 2)))
    n_rand = len(F)
    w2 += list(rng.uniform(0.5, 2.0, n_rand))
    k += list(rng.uniform(0.5, 5.0, n_rand))
    lmin += list(rng.uniform(0.5, 1.0, n_rand))
    lmax += list(rng.uniform(1.0, 2.0, n_rand))
    for i in range(40):  # z = (3 U V^T + F) / 4 is exact: column norm
        p, q = rng.choice(3, size=2, replace=False)
        c = 2.0 ** rng.integers(-1, 3)  # (3 + c) / 4 per column
        F.append(np.stack([c * eye[p], -c * eye[q]], axis=1))
        l = (3.0 + c) / 4.0
        w2.append(1.0)
        k.append(3.0)
        # on lmin, on lmax, just inside both, just outside both
        lmin.append([l, l * 0.5, np.nextafter(l, 0), l * 1.01][i % 4])
        lmax.append([l * 2.0, l, np.nextafter(l, 9), l * 1.02][i % 4])
    return np.asarray(F), [np.asarray(a) for a in (w2, k, lmin, lmax)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(9, E))
    cp = rng.normal(size=(6, E))
    u = 0.1 * rng.normal(size=(6, E))
    w2 = rng.uniform(0.5, 2.0, E)
    k = rng.uniform(0.5, 5.0, E)
    # bounds around each element's column norms, so the clamp engages on
    # both sides for some elements and not at all for others
    dx = np.einsum("bke,kae->abe", cp.reshape(2, 3, E), xg.reshape(3, 3, E))
    cn = np.linalg.norm(dx + u.reshape(3, 2, E), axis=0)  # (2,E)
    lmin = cn.min(0) * rng.uniform(0.7, 1.1, E)
    lmax = np.maximum(cn.max(0) * rng.uniform(0.9, 1.3, E), lmin)
    F, (sw2, sk, slmin, slmax) = _special_F(rng)
    s = slice(0, N_SPECIAL)
    xg[:, s] = 0.0
    u[:, s] = F.reshape(N_SPECIAL, 6).T  # plane 2a+b = F[a, b]
    w2[s], k[s], lmin[s], lmax[s] = sw2, sk, slmin, slmax
    return xg, u, cp, w2, k, lmin, lmax


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


@pytest.mark.parametrize("limiting", [True, False], ids=["limiting", "plain"])
def test_plain_is_the_kernel_body_bitwise(limiting, monkeypatch):
    ins = _inputs(1)
    refs = [_Ref(a) for a in ins[:3]] + [_Ref(a[None]) for a in ins[3:]]
    want = [_Ref(np.zeros((n, E))) for n in (6, 6, 9)]
    with jax.disable_jit():
        jtri._make_tri_fused_kernel(limiting, False)(*refs, *want)
    monkeypatch.setattr(ptri, "torch", _TorchWithRoundedSqrt())
    got = ptri.tri_local_step_fused_reference(
        *(torch.as_tensor(a) for a in ins), limiting=limiting)
    for name, w, g in zip(("z6", "u6'", "contrib9"), want, got):
        d = np.abs(g.numpy() - w.a)
        assert np.array_equal(g.numpy(), w.a), (
            f"{name}: {int((d > 0).sum())} values differ, max {d.max():.3g}")


@pytest.mark.parametrize("limiting", [True, False], ids=["limiting", "plain"])
def test_plain_matches_pallas_interpret(limiting):
    assert E % BLOCK == 0
    ins = _inputs(2)
    ref = jtri.tri_local_step_fused(*(jnp.asarray(a) for a in ins),
                                    interpret=True, limiting=limiting)
    out = ptri.tri_local_step_fused(*(torch.as_tensor(a) for a in ins),
                                    limiting=limiting)
    for r, o in zip(ref, out):
        r, o = np.asarray(r), o.numpy()
        assert o.shape == r.shape and np.isfinite(o).all()
        assert np.abs(r).max() < 100.0
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)


def test_clamp_branches_are_exercised():
    """The special elements reach every branch they were built for: the
    exact-bound columns tie (no scaling), the others clamp."""
    xg, u, cp, w2, k, lmin, lmax = (torch.as_tensor(a) for a in _inputs(2))
    z, _, _ = ptri.tri_local_step_fused(xg, u, cp, w2, k, lmin, lmax)
    zn = np.linalg.norm(z.numpy().reshape(3, 2, E), axis=0)  # (2,E)
    s = slice(N_SPECIAL - 40, N_SPECIAL)
    l_unclamped = (3.0 + np.abs(u.numpy()[:, s]).max(0)) / 4.0
    kind = np.arange(40) % 4
    for c in range(2):
        # on a bound or just inside: untouched
        keep = kind < 3
        assert np.array_equal(zn[c, s][keep], l_unclamped[keep])
        # just below lmin: raised to it
        np.testing.assert_allclose(zn[c, s][~keep], lmin.numpy()[s][~keep],
                                   rtol=1e-15)
    # rank-1, zero-column and zero F take the fallback second axis (p1 is
    # round-off); it still completes an orthonormal pair
    f = [u[p, :56] for p in range(6)]
    (u0, u1), _ = ptri._svd32(f, torch.finfo(torch.float64).eps)
    deg = np.r_[0:16, 32:56]
    u0 = torch.stack(u0).numpy()[:, deg]
    u1 = torch.stack(u1).numpy()[:, deg]
    np.testing.assert_allclose(np.linalg.norm(u1, axis=0), 1.0, rtol=1e-15)
    np.testing.assert_allclose(np.einsum("ae,ae->e", u0, u1), 0.0, atol=1e-15)
    # F = 0: both fallbacks, ties broken with <= towards x, then y
    assert np.array_equal(u0[:, -8:], np.tile([[1.0], [0.0], [0.0]], 8))
    assert np.array_equal(u1[:, -8:], np.tile([[0.0], [1.0], [0.0]], 8))


def test_wrapper_checks_and_cpu_route():
    ins = [torch.as_tensor(a) for a in _inputs(5)]
    ptri.tri_local_step_fused.launches = 0
    a = ptri.tri_local_step_fused(*ins, limiting=False)
    b = ptri.tri_local_step_fused_reference(*ins, limiting=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the CPU route is the plain version and counts no kernel launch
    assert ptri.tri_local_step_fused.launches == 0
    bad = list(ins)
    bad[1] = ins[1][:, :-1]
    with pytest.raises(ValueError, match="u6"):
        ptri.tri_local_step_fused(*bad)
    bad = list(ins)
    bad[4] = ins[4].float()
    with pytest.raises(ValueError, match="k"):
        ptri.tri_local_step_fused(*bad)
    bad = list(ins)
    bad[0] = ins[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        ptri.tri_local_step_fused(*bad)
    with pytest.raises(NotImplementedError):
        ptri.tri_local_step_fused(*ins, emit_z=True)
    meta = [t.to("meta") for t in ins]
    with pytest.raises(RuntimeError, match="no kernel"):
        ptri.tri_local_step_fused(*meta)
