"""The port's Chebyshev pieces against the JAX package's, f64 on the CPU:
`parallel/cheb.py` (schedule and spectral bounds) and the plain twin of
`cheb_dia_chunk` against the JAX Pallas kernel in interpret mode, on the
A_hat of an anchored 6x4x4 beam laid out as (R,128) planes with flat
index = vertex index (pad lanes zero).

Tolerances: the schedule is the same host arithmetic, so bitwise; the
bounds 1e-10 relative (the same scipy Lanczos from the same start, on the
same matrix assembled in the same order); the chunk 1e-12 relative to the
largest entry (the same recurrence; the matvec sums the diagonals in the
same order, and XLA may contract products into FMAs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops.pallas.cheb_dia import cheb_dia_chunk as jax_chunk
from admm_elastic_tpu.parallel import cheb as jcheb
from admm_elastic_tpu_torch.core import solver as psolver
from admm_elastic_tpu_torch.geometry import make_beam_tets
from admm_elastic_tpu_torch.models import HyperElasticTet, StaticAnchor
from admm_elastic_tpu_torch.ops.kernels import cheb_dia as pcheb
from admm_elastic_tpu_torch.parallel import cheb as pc

torch.set_num_threads(1)
LANES = 128


def _operator():
    """(offsets, dia (D,n), diag (n,)) of an anchored beam's A_hat."""
    beam = make_beam_tets(6, 4, 4, size=0.05)
    n = beam.n_vertices
    m = np.full(n, 1.0 / n)
    anchor = StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9))
    tet = HyperElasticTet(beam.tets, 1e5, 1e5, backend="pallas")
    cparams = {"a": anchor.build(beam.vertices, m, 0.04)[0],
               "t": tet.build(beam.vertices, m, 0.04)[0]}
    return psolver.assemble_A_hat_dia(n, m, 0.04, cparams)


def _planes(a, rows):
    """(..., n) -> (..., rows, 128), zero pad lanes."""
    out = np.zeros(a.shape[:-1] + (rows * LANES,))
    out[..., :a.shape[-1]] = a
    return out.reshape(a.shape[:-1] + (rows, LANES))


@pytest.mark.parametrize("k,lmin,lmax", [
    (180, 0.0123, 1.987), (2, 0.3, 1.2), (1, 0.3, 1.2), (0, 0.3, 1.2),
    (7, 0.5, 0.5)])  # the last: delta = 0, the Richardson schedule
def test_coefficients_bitwise(k, lmin, lmax):
    want = jcheb.cheb_coefficients(k, lmin, lmax)
    got = pc.cheb_coefficients(k, lmin, lmax)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and np.array_equal(g, w)


def test_dia_bounds_match_jax():
    offs, dia, diag = _operator()
    R = -(-dia.shape[1] // LANES)
    want = jcheb.dia_operator_bounds(_planes(dia, R), offs)
    got = pc.dia_operator_bounds(dia, offs)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert 0 < got[0] < got[1]
    # the ELL form of the same operator has the same spectrum
    A = np.zeros((dia.shape[1],) * 2)
    for d, off in enumerate(offs):
        i = np.arange(max(0, -off), min(len(diag), len(diag) - off))
        A[i, i + off] = dia[d, i]
    K = max(int((A != 0).sum(1).max()), 1)
    idx = np.tile(np.arange(len(diag))[:, None], (1, K))
    vals = np.zeros((len(diag), K))
    for i in range(len(diag)):
        nz = np.flatnonzero(A[i])
        idx[i, :len(nz)], vals[i, :len(nz)] = nz, A[i, nz]
    np.testing.assert_allclose(pc.ell_operator_bounds(idx, vals, diag), want,
                               rtol=1e-6)


def test_cheb_solve_reference_matches_jax():
    offs, dia, diag = _operator()
    n = len(diag)
    rng = np.random.default_rng(3)
    b, x0 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    bounds = pc.dia_operator_bounds(dia, offs)

    def A(y):
        return psolver.dia_apply(torch.as_tensor(y), offs,
                                 torch.as_tensor(dia)).numpy()

    args = (A, lambda r: r / diag[:, None], b, x0, 30, *bounds)
    np.testing.assert_array_equal(pc.cheb_solve_reference(*args),
                                  jcheb.cheb_solve_reference(*args))


@pytest.mark.parametrize("n_it,first,last", [
    (0, True, False), (1, False, False), (7, False, True), (7, True, True)])
def test_chunk_twin_matches_pallas_interpret(n_it, first, last):
    offs, dia, diag = _operator()
    n = len(diag)
    R = -(-n // LANES)
    rng = np.random.default_rng(n_it + 10 * first + 100 * last)
    b, x, z, d = (rng.normal(size=(n, 3)) for _ in range(4))
    lmin, lmax = pc.dia_operator_bounds(dia, offs)
    inv_theta, c1, c2 = pc.cheb_coefficients(40, lmin, lmax)
    c1, c2 = c1[5:5 + n_it], c2[5:5 + n_it]
    invd = 1.0 / diag
    kw = dict(n_it=n_it, first=first, last=last, inv_theta=inv_theta)

    def vec(a):
        return jnp.asarray(_planes(a.T, R).reshape(3 * R, LANES))

    want = jax_chunk(vec(b), vec(x), vec(z), vec(d),
                     jnp.asarray(_planes(invd, R)),
                     jnp.asarray(_planes(dia, R).reshape(-1, LANES)),
                     jnp.asarray(c1), jnp.asarray(c2),
                     offsets=tuple(offs), interpret=True, **kw)
    t = [torch.as_tensor(a) for a in (b, x, z, d, invd, dia,
                                      c1 if n_it else np.zeros(1),
                                      c2 if n_it else np.zeros(1))]
    got = pcheb.cheb_dia_chunk(*t, offsets=offs, **kw)
    for name, g, w in zip("xzd", got, want):
        w = np.asarray(w).reshape(3, R * LANES)[:, :n].T
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-12, f"{name}: relative error {err:.3g}"
    if first:  # z was recomputed from b and x, not passed through
        assert not np.allclose(got[1].numpy(), z)


def test_wrapper_checks_and_cpu_route():
    offs, dia, diag = _operator()
    n = len(diag)
    rng = np.random.default_rng(0)
    b, x = (torch.as_tensor(rng.normal(size=(n, 3))) for _ in range(2))
    invd, dia = torch.as_tensor(1.0 / diag), torch.as_tensor(dia)
    c = torch.full((3,), 0.5, dtype=torch.float64)
    kw = dict(offsets=offs, n_it=3, first=True, last=True, inv_theta=0.7)
    pcheb.cheb_dia_chunk.launches = 0
    got = pcheb.cheb_dia_chunk(b, x, b, b, invd, dia, c, c, **kw)
    want = pcheb.cheb_dia_chunk_reference(b, x, b, b, invd, dia, c, c, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert pcheb.cheb_dia_chunk.launches == 0  # the twin ran, no kernel
    with pytest.raises(ValueError, match="c1"):
        pcheb.cheb_dia_chunk(b, x, b, b, invd, dia, c[:2], c, **kw)
    with pytest.raises(ValueError, match="dia"):
        pcheb.cheb_dia_chunk(b, x, b, b, invd, dia[:-1], c, c, **kw)
    with pytest.raises(ValueError, match="invd"):
        pcheb.cheb_dia_chunk(b, x, b, b, invd.float(), dia, c, c, **kw)
