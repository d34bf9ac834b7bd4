"""The port's copied host code (numpy/scipy) is array-equal to the JAX
package's: procedural beam, tet rest basis, dia assembly, RHS incidence."""

import numpy as np
import pytest
import torch

from admm_elastic_tpu.core import solver as jsolver
from admm_elastic_tpu.geometry import make_beam_tets as jax_beam
from admm_elastic_tpu.models import tet as jtet
from admm_elastic_tpu_torch.core import solver as psolver
from admm_elastic_tpu_torch.geometry import make_beam_tets as port_beam
from admm_elastic_tpu_torch.models import tet as ptet

torch.set_num_threads(1)

SIZES = [(1, 1, 1, 1.0), (3, 2, 2, 1.0), (6, 4, 4, 0.05), (5, 3, 7, 0.2)]


@pytest.mark.parametrize("nx,ny,nz,size", SIZES)
def test_make_beam_tets_equal(nx, ny, nz, size):
    a, b = jax_beam(nx, ny, nz, size=size), port_beam(nx, ny, nz, size=size)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.tets, b.tets)
    assert a.tets.dtype == b.tets.dtype and b.n_tets == 5 * nx * ny * nz


def _scene_params(nx, ny, nz, size):
    """Anchor + tet selector params of a beam, built by the JAX package's
    own builders (numpy)."""
    beam = jax_beam(nx, ny, nz, size=size)
    n = beam.n_vertices
    B, vol = jtet.build_tet_basis(beam.vertices, beam.tets)
    tp = jtet._tet_selector_params(beam.tets, B)
    tp["weight"] = np.sqrt(1e5 * vol)
    anchored = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
    ap = {"indices": anchored[:, None].astype(np.int32),
          "coeff": np.ones((len(anchored), 1, 1)),
          "weight": np.full(len(anchored), 1000.0)}
    return n, np.full(n, 1.0 / n), {"c0_StaticAnchor": ap,
                                     "c1_HyperElasticTet": tp}


@pytest.mark.parametrize("nx,ny,nz,size", SIZES)
def test_build_tet_basis_equal(nx, ny, nz, size):
    beam = jax_beam(nx, ny, nz, size=size)
    Ba, va = jtet.build_tet_basis(beam.vertices, beam.tets)
    Bb, vb = ptet.build_tet_basis(beam.vertices, beam.tets)
    assert np.array_equal(Ba, Bb) and np.array_equal(va, vb)
    pa = jtet._tet_selector_params(beam.tets, Ba)
    pb = ptet._tet_selector_params(beam.tets, Bb)
    assert np.array_equal(pa["coeff"], pb["coeff"])
    assert np.array_equal(pa["indices"], pb["indices"])
    # the port's coefficient planes are the JAX ones without block padding
    het = jtet.HyperElasticTet(beam.tets, 1e5, 1e5, backend="pallas")
    cp_jax = het._coeff_planes(pa)
    cp_port = ptet._coeff_planes(pb)
    assert np.array_equal(cp_jax[:, : beam.n_tets], cp_port)


@pytest.mark.parametrize("nx,ny,nz,size", SIZES)
def test_assemble_A_hat_dia_equal(nx, ny, nz, size):
    n, m, cparams = _scene_params(nx, ny, nz, size)
    oa, da, ga = jsolver.assemble_A_hat_dia(n, m, 0.04, cparams)
    ob, db, gb = psolver.assemble_A_hat_dia(n, m, 0.04, cparams)
    assert oa == ob
    assert np.array_equal(da, db) and np.array_equal(ga, gb)


@pytest.mark.parametrize("nx,ny,nz,size", SIZES)
def test_assemble_transpose_incidence_equal(nx, ny, nz, size):
    n, _, cparams = _scene_params(nx, ny, nz, size)
    order = list(cparams)
    ia, ta = jsolver.assemble_transpose_incidence(n, cparams, order)
    ib, tb = psolver.assemble_transpose_incidence(n, cparams, order)
    assert ta == tb and np.array_equal(ia, ib) and ia.dtype == ib.dtype


def test_dia_apply_and_gather_match_jax():
    """The plain torch dia matvec and incidence gather against the JAX
    package's, in f64."""
    import jax.numpy as jnp

    n, m, cparams = _scene_params(4, 3, 3, 0.05)
    offs, dia, _ = psolver.assemble_A_hat_dia(n, m, 0.04, cparams)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3))
    ya = np.asarray(jsolver.dia_apply(jnp.asarray(x), offs, jnp.asarray(dia)))
    yb = psolver.dia_apply(torch.as_tensor(x), offs, torch.as_tensor(dia))
    np.testing.assert_allclose(yb.numpy(), ya, rtol=1e-13, atol=1e-13)

    inc, total = psolver.assemble_transpose_incidence(n, cparams,
                                                      list(cparams))
    flat = np.concatenate([rng.normal(size=(total, 3)), np.zeros((1, 3))])
    ga = np.asarray(jsolver.transpose_gather_apply(jnp.asarray(flat),
                                                   jnp.asarray(inc)))
    gb = psolver.transpose_gather_apply(torch.as_tensor(flat),
                                        torch.as_tensor(inc, dtype=torch.int64))
    np.testing.assert_allclose(gb.numpy(), ga, rtol=1e-13, atol=1e-13)
