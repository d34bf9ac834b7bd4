"""The port's `ops/svd.py` against the JAX package's, f64 on the CPU: every
function on the same numpy inputs from a seed, the port's batched tensors
against JAX's `jax.vmap` of the single-matrix function, run op by op.

Inputs: random matrices, inverted ones (det < 0), rank 2, rank 1 and rank
0, repeated and near-repeated singular values, tiny and huge scales. The
two packages run the same branch-free operations in the same order, so the
factors agree one by one, not only in product: within 1e-12 of the
matrix's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops import svd as jsvd
from admm_elastic_tpu_torch.ops import svd as psvd

torch.set_num_threads(1)

TOL = 1e-12


def _mats(shape, seed):
    """Random, inverted, degenerate and badly scaled matrices of `shape`
    ((3, 3) or (3, 2))."""
    rng = np.random.default_rng(seed)
    r, c = shape
    mats = [rng.normal(size=shape) for _ in range(48)]
    flip = np.diag([1.0, 1.0, -1.0])
    mats += [flip @ rng.normal(size=shape) for _ in range(8)]  # inverted
    a, b = rng.normal(size=(2, r)), rng.normal(size=(2, c))
    q, _ = np.linalg.qr(rng.normal(size=(r, r)))
    p, _ = np.linalg.qr(rng.normal(size=(c, c)))

    def with_sigma(s):
        return q[:, :c] @ np.diag(s) @ p.T if r > c or True else None

    mats += [
        np.zeros(shape),                                  # rank 0
        np.outer(a[0], b[0]),                             # rank 1
        np.outer(a[0], b[0]) + np.outer(a[1], b[1]),      # rank 2
        np.eye(r)[:, :c],
        1e-8 * rng.normal(size=shape),
        1e8 * rng.normal(size=shape),
        q[:, :c] @ np.diag([2.0, 2.0, 1.0][:c]) @ p.T,    # repeated
        q[:, :c] @ np.diag([1.0, 1.0 + 1e-9, 0.5][:c]) @ p.T,  # near-repeated
        q[:, :c] @ np.diag([1.0, 1e-12, 1e-13][:c]) @ p.T,     # near rank 1
    ]
    return np.stack(mats)


def _scale(F):
    return np.abs(F).max(axis=tuple(range(1, F.ndim))) + 1.0


def _close(got, want, scale, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).reshape(len(scale), -1).max(axis=1) / scale
    assert err.max() <= tol, (err.max(), int(err.argmax()))


def test_eigh_sym3x3():
    F = _mats((3, 3), 0)
    A = np.einsum("nji,njk->nik", F, F)
    wj, Vj = jax.vmap(jsvd.eigh_sym3x3)(jnp.asarray(A))
    wp, Vp = psvd.eigh_sym3x3(torch.as_tensor(A))
    scale = _scale(A)
    _close(wp, wj, scale)
    _close(Vp, Vj, np.ones(len(A)))


def test_svd3x3_oriented():
    F = _mats((3, 3), 1)
    Uj, sj, Vj = jax.vmap(jsvd.svd3x3_oriented)(jnp.asarray(F))
    Up, sp, Vp = psvd.svd3x3_oriented(torch.as_tensor(F))
    scale = _scale(F)
    _close(sp, sj, scale)
    _close(Up, Uj, np.ones(len(F)))
    _close(Vp, Vj, np.ones(len(F)))
    # the oriented semantics: sign(s2) = sign(det F), proper rotations
    dets = np.linalg.det(F)
    s = sp.numpy()
    assert np.all((np.sign(s[:, 2]) == np.sign(dets)) | (np.abs(dets) < 1e-20))
    assert np.allclose(np.linalg.det(Up.numpy()), 1.0, atol=1e-9)


def test_polar_project():
    F = _mats((3, 3), 2)
    Rj = jax.vmap(jsvd.polar_project)(jnp.asarray(F))
    Rp = psvd.polar_project(torch.as_tensor(F))
    _close(Rp, Rj, np.ones(len(F)))


def test_eigh_sym2x2():
    F = _mats((3, 2), 3)
    A = np.einsum("nji,njk->nik", F, F)
    wj, Vj = jax.vmap(jsvd.eigh_sym2x2)(jnp.asarray(A))
    wp, Vp = psvd.eigh_sym2x2(torch.as_tensor(A))
    _close(wp, wj, _scale(A))
    _close(Vp, Vj, np.ones(len(A)))


def test_svd3x2():
    F = _mats((3, 2), 4)
    Uj, sj, Vj = jax.vmap(jsvd.svd3x2)(jnp.asarray(F))
    Up, sp, Vp = psvd.svd3x2(torch.as_tensor(F))
    scale = _scale(F)
    _close(sp, sj, scale)
    _close(Up, Uj, np.ones(len(F)))
    _close(Vp, Vj, np.ones(len(F)))


@pytest.mark.parametrize("fn", ["_det3", "_orthogonal_to"])
def test_helpers(fn):
    rng = np.random.default_rng(5)
    if fn == "_det3":
        M = _mats((3, 3), 5)
        want = jax.vmap(jsvd._det3)(jnp.asarray(M))
        _close(psvd._det3(torch.as_tensor(M)), want, _scale(M) ** 3)
        return
    u = rng.normal(size=(64, 3))
    u[:8] = np.eye(3)[rng.integers(0, 3, 8)]  # ties of |u| components
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    want = jax.vmap(jsvd._orthogonal_to)(jnp.asarray(u))
    got = psvd._orthogonal_to(torch.as_tensor(u))
    _close(got, want, np.ones(len(u)))
    assert np.abs(np.einsum("ij,ij->i", got.numpy(), u)).max() < 1e-15
