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


# ---- the cloth slice's copies


GRIDS = [(1, 1, 1.0), (3, 2, 1.0), (8, 6, 1.0), (7, 5, 0.3), (25, 20, 2.0)]


@pytest.mark.parametrize("nx,ny,size", GRIDS)
def test_make_plane_grid_and_connectivity_equal(nx, ny, size):
    from admm_elastic_tpu.geometry import connectivity as jconn
    from admm_elastic_tpu.geometry import make_plane_grid as jax_grid
    from admm_elastic_tpu_torch.geometry import connectivity as pconn
    from admm_elastic_tpu_torch.geometry import make_plane_grid as port_grid

    a, b = jax_grid(nx, ny, size=size), port_grid(nx, ny, size=size)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.faces, b.faces) and a.faces.dtype == b.faces.dtype
    assert b.n_faces == 2 * nx * ny and b.n_vertices == (nx + 1) * (ny + 1)
    # (the JAX package's numpy paths: these meshes are below its native
    # thresholds)
    for name in ("unique_edges", "across_edge", "extract_hinges"):
        want = getattr(jconn, name)(a.faces)
        got = getattr(pconn, name)(b.faces)
        assert np.array_equal(want, got) and want.dtype == got.dtype, name


@pytest.mark.parametrize("nx,ny,size", GRIDS)
def test_build_tri_basis_and_bend_alpha_equal(nx, ny, size):
    from admm_elastic_tpu.geometry import extract_hinges, make_plane_grid
    from admm_elastic_tpu.models import bend as jbend
    from admm_elastic_tpu.models import triangle as jtri
    from admm_elastic_tpu_torch.models import bend as pbend
    from admm_elastic_tpu_torch.models import triangle as ptri

    mesh = make_plane_grid(nx, ny, size=size)
    # a bent sheet, so the hinge weights are not all the flat ones
    x = mesh.vertices.copy()
    x[:, 2] = 0.2 * np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])
    Ba, aa = jtri.build_tri_basis(x, mesh.faces)
    Bb, ab = ptri.build_tri_basis(x, mesh.faces)
    assert np.array_equal(Ba, Bb) and np.array_equal(aa, ab)
    pa = jtri._tri_selector_params(mesh.faces, Ba)
    pb = ptri._tri_selector_params(mesh.faces, Bb)
    assert all(np.array_equal(pa[k], pb[k]) for k in ("indices", "coeff"))
    lts = jtri.LimitedTriangleStrain(mesh.faces, 100.0, backend="pallas")
    cp_jax = lts._coeff_planes(pa)
    assert np.array_equal(cp_jax[:, : mesh.n_faces], ptri._coeff_planes(pb))

    hinges = extract_hinges(mesh.faces)
    if len(hinges) == 0:
        return
    ja, _ = jbend.Bend(hinges, 20.0).build(x, None, 0.04)
    jb, _ = pbend.Bend(hinges, 20.0).build(x, None, 0.04)
    for k in ("indices", "coeff", "weight", "stiffness", "alpha"):
        assert np.array_equal(ja[k], jb[k]), k


@pytest.mark.parametrize("nx,ny", [(5, 4), (8, 6), (30, 20)])
def test_group_constant_offsets_equal(nx, ny):
    from admm_elastic_tpu.core import cloth as jcloth
    from admm_elastic_tpu.geometry import extract_hinges, make_plane_grid
    from admm_elastic_tpu_torch.core import cloth as pcloth

    mesh = make_plane_grid(nx, ny)
    hinges = extract_hinges(mesh.faces)
    dup = np.vstack([mesh.faces, mesh.faces[:1]])
    rng = np.random.default_rng(0)
    scrambled = rng.permutation(mesh.n_vertices)[mesh.faces]
    for idx in (mesh.faces, hinges, dup, scrambled):
        ga = jcloth.group_constant_offsets(idx)
        gb = pcloth.group_constant_offsets(idx)
        assert (ga is None) == (gb is None)
        if ga is None:
            continue
        assert len(ga) == len(gb)
        for (oa, ea, ba), (ob, eb, bb) in zip(ga, gb):
            assert oa == ob
            assert np.array_equal(ea, eb) and np.array_equal(ba, bb)
    assert len(pcloth.group_constant_offsets(mesh.faces)) == 2
    assert len(pcloth.group_constant_offsets(hinges)) == 3
    assert pcloth.group_constant_offsets(dup) is None
