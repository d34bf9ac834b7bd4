"""The port's ELL pieces against the JAX package's, f64, on the small
Delaunay mesh of tests/test_uell.py (140 nodes, A_hat with more than 48
diagonals): host assembly and grid detection array-equal; the ELL matvec,
the tolerance PCG, the fused CG update and its fixed-iteration solve, and
the ELL CG kernel's plain twin within 1e-12 of the JAX functions (the
Pallas kernels in interpret mode). Only summation orders differ (the
twins add in the CUDA kernels' order, `cluster_dot`). CG
amplifies such differences: on this A_hat they stay below 2e-14 relative
for 20 fixed iterations and reach ~5e-12 at 25, so the fixed-budget
comparisons run 1 and 20.

The hand-written kernels are held to these twins on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.core import lattice as jlattice
from admm_elastic_tpu.core import solver as jsolver
from admm_elastic_tpu.ops.pallas.cg_ell import cg_ell_solve as jax_cg_ell
from admm_elastic_tpu.ops.pallas.cg_step import cg_update as jax_cg_update
from admm_elastic_tpu.ops.pallas.cg_step import (
    pcg_solve_fixed_fused as jax_fused)
from admm_elastic_tpu_torch.core import lattice as plattice
from admm_elastic_tpu_torch.core import solver as psolver
from admm_elastic_tpu_torch.geometry import make_beam_tets, make_plane_grid
from admm_elastic_tpu_torch.models import HyperElasticTet, StaticAnchor
from admm_elastic_tpu_torch.ops.kernels import cg_dia as pcg_dia
from admm_elastic_tpu_torch.ops.kernels import cg_ell as pcg_ell
from admm_elastic_tpu_torch.ops.kernels import cg_step as pcg_step
from admm_elastic_tpu_torch.utils.scenes import (banded_spd, delaunay_mesh,
                                                 renumbered_ell)

torch.set_num_threads(1)

TOL = 1e-12


def _cparams(pts, tets, m, dt=0.04):
    anchor = StaticAnchor(np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 1e-3))
    tet = HyperElasticTet(tets, 1e4, 1e4, backend="pallas")
    return {"a": anchor.build(pts, m, dt)[0], "t": tet.build(pts, m, dt)[0]}


@pytest.fixture(scope="module")
def problem():
    """The mesh's A_hat in ELL form and the first global solve of a step
    from rest, as ADMM poses it: b = A x_rest plus the gravity kick's M dt^2
    g, warm-started at x_rest (randomly perturbed by 1e-3 m)."""
    pts, tets = delaunay_mesh()
    n = len(pts)
    m = np.full(n, 2.0 / n)
    cparams = _cparams(pts, tets, m)
    idx, vals, diag = psolver.assemble_A_hat_ell(n, m, 0.04, cparams)
    b = psolver._assemble_A_hat_csr(n, m, 0.04, cparams) @ pts
    b[:, 1] -= m * 9.8 * 0.04 ** 2
    x0 = pts + 1e-3 * np.random.default_rng(11).normal(size=(n, 3))
    return dict(n=n, m=m, cparams=cparams, idx=idx, vals=vals, diag=diag,
                b=b, x0=x0)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


@pytest.mark.parametrize("mesh", ["delaunay", "beam"])
def test_assemble_A_hat_ell_matches_jax(problem, mesh):
    if mesh == "delaunay":
        n, m, cparams = problem["n"], problem["m"], problem["cparams"]
    else:
        beam = make_beam_tets(4, 3, 3, size=0.05)
        n = beam.n_vertices
        m = np.full(n, 1.0 / n)
        cparams = _cparams(beam.vertices, beam.tets, m)
    got = psolver.assemble_A_hat_ell(n, m, 0.04, cparams)
    want = jsolver.assemble_A_hat_ell(n, m, 0.04, cparams)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if mesh == "delaunay":
        assert jsolver.assemble_A_hat_dia(n, m, 0.04, cparams) is None


def _grids():
    beam = make_beam_tets(5, 4, 3, size=0.1)
    perm = np.random.default_rng(0).permutation(beam.n_vertices)
    sheet = make_plane_grid(6, 4)
    return {"scrambled-beam": beam.vertices[perm],
            "plane": sheet.vertices,
            "delaunay": delaunay_mesh()[0],
            "tiny": np.eye(3)}


@pytest.mark.parametrize("name", list(_grids()))
def test_detect_grid_numbering_matches_jax(name):
    v = _grids()[name]
    got = plattice.detect_grid_numbering(v)
    want = jlattice.detect_grid_numbering(v)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert (want is None) == (name in ("delaunay", "tiny"))


def test_ell_apply_matches_jax(problem):
    p = problem
    got = psolver.ell_apply(*_t(p["x0"], p["idx"], p["vals"])).numpy()
    want = jsolver.ell_apply(jnp.asarray(p["x0"]), jnp.asarray(p["idx"]),
                             jnp.asarray(p["vals"]))
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("tol", [1e-4, 1e-13])
def test_pcg_solve_matches_jax(problem, tol):
    """The tolerance loop takes as many iterations as JAX's while_loop (8
    and 105 here). Tolerances between these stop in CG's superlinear
    phase, whose iterates carry a summation-order difference of 1e-16 up
    to ~1e-7 relative before they converge again; these two do not."""
    p = problem
    b, x0, idx, vals, diag = _t(p["b"], p["x0"], p["idx"], p["vals"],
                                p["diag"])
    x, it = psolver.pcg_solve(lambda y: psolver.ell_apply(y, idx, vals), b,
                              x0, diag, tol, 250)
    jb, jx0, jidx, jvals, jdiag = (jnp.asarray(p[k]) for k in
                                   ("b", "x0", "idx", "vals", "diag"))
    jxs, jit = jsolver.pcg_solve(lambda y: jsolver.ell_apply(y, jidx, jvals),
                                 jb, jx0, jdiag, tol, 250)
    assert it == int(jit) and 0 < it < 250
    assert _rel(x.numpy(), jxs) < TOL


def _update_inputs(problem):
    p = problem
    rng = np.random.default_rng(5)
    n = p["n"]
    x, r, q = (rng.normal(size=(n, 3)) for _ in range(3))
    Ap = psolver.ell_apply(*_t(q, p["idx"], p["vals"])).numpy()
    return x, r, q, 0.7, Ap, 1.0 / p["diag"]


def test_cg_update_twin_matches_pallas_interpret(problem):
    x, r, q, rz, Ap, invd = _update_inputs(problem)
    got = pcg_step.cg_update(*_t(x, r, q, np.array(rz), Ap, invd))
    want = jax_cg_update(*(jnp.asarray(a.T) for a in (x, r, q)),
                         jnp.full((1, 1), rz), jnp.asarray(Ap.T),
                         jnp.asarray(invd[None, :]), interpret=True)
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g.numpy(), np.asarray(w).T) < TOL
    rz, want_rz = float(got[3]), float(want[3][0, 0])
    assert abs(rz - want_rz) <= TOL * abs(rz)
    assert pcg_step.cg_update.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("n_iters", [1, 20])
def test_pcg_solve_fixed_fused_matches_jax(problem, n_iters):
    p = problem
    b, x0, idx, vals, diag = _t(p["b"], p["x0"], p["idx"], p["vals"],
                                p["diag"])
    got = pcg_step.pcg_solve_fixed_fused(
        lambda y: psolver.ell_apply(y, idx, vals), b, x0, diag, n_iters)
    jidx, jvals = jnp.asarray(p["idx"]), jnp.asarray(p["vals"])
    want = jax_fused(lambda y: jsolver.ell_apply(y, jidx, jvals),
                     jnp.asarray(p["b"]), jnp.asarray(p["x0"]),
                     jnp.asarray(p["diag"]), n_iters, interpret=True)
    assert _rel(got.numpy(), want) < TOL
    assert np.abs(got.numpy() - p["x0"]).max() > 1e-4  # the solve moved


@pytest.mark.parametrize("n_iters", [1, 20])
def test_cg_ell_twin_matches_pallas_interpret(problem, n_iters):
    p = problem
    args = _t(p["b"], p["x0"], p["diag"], p["idx"], p["vals"])
    got = pcg_ell.cg_ell_solve(*args, n_iters).numpy()
    want = jax_cg_ell(*(jnp.asarray(p[k]) for k in
                        ("b", "x0", "diag", "idx", "vals")), n_iters,
                      interpret=True)
    assert _rel(got, want) < TOL
    assert np.abs(got - p["x0"]).max() > 1e-4


def test_cg_ell_twin_zero_iterations_give_x0(problem):
    """0 iterations give x0 itself."""
    p = problem
    args = _t(p["b"], p["x0"], p["diag"], p["idx"], p["vals"])
    assert torch.equal(pcg_ell.cg_ell_solve_reference(*args, 0), args[1])


def test_renumbered_system_has_the_solution_renumbered(problem):
    """`scenes.renumbered_ell` is the same system in another numbering:
    its solution is the input's at [perm] (TOL: the sums' order moves with
    the rows), and its rows reach across the matrix."""
    p = problem
    args = _t(p["b"], p["x0"], p["diag"], p["idx"], p["vals"])
    *renumbered, perm = renumbered_ell(*args, seed=3)
    want = pcg_ell.cg_ell_solve(*args, 20)[perm]
    got = pcg_ell.cg_ell_solve(*renumbered, 20)
    assert _rel(got.numpy(), want.numpy()) < TOL
    assert pcg_ell.bandwidth(renumbered[3]) > p["n"] // 2


@pytest.mark.parametrize("n", [11, 37, 1003])
def test_cg_ell_twin_is_the_dia_twin_on_a_band(n):
    """On a banded system given in both forms (`scenes.banded_spd`) the
    two twins add the same terms in the same order: bitwise equal, for n
    below the cluster size and not a multiple of it."""
    s = banded_spd(n, device="cpu", seed=n)
    for k in (0, 1, 25):
        got = pcg_ell.cg_ell_solve(s["b"], s["x0"], s["diag"], s["ell_idx"],
                                   s["ell_vals"], k)
        want = pcg_dia.cg_dia_solve(s["b"], s["x0"], s["diag"],
                                    s["dia_vals"], s["offsets"], k)
        assert torch.equal(got, want)
    assert float((got - s["x0"]).abs().max()) > 1e-3  # the solve moved


def test_bandwidth_is_the_reach_of_a_row(problem):
    """The ELL kernel's window size: the largest |column - row|, kept
    until the index tensor changes."""
    idx = torch.as_tensor(problem["idx"])
    want = int(np.abs(problem["idx"] - np.arange(problem["n"])[:, None]).max())
    assert pcg_ell.bandwidth(idx) == want > 0
    idx[0, 0] = problem["n"] - 1
    assert pcg_ell.bandwidth(idx) == problem["n"] - 1


def test_slot_major_is_kept_until_the_matrix_changes(problem):
    """The kernel's (K,n) copy of an ELL array: made once, made again
    after the array changes in place."""
    vals = torch.as_tensor(problem["vals"]).clone()
    first = pcg_ell.slot_major(vals)
    assert torch.equal(first, vals.t()) and first.is_contiguous()
    assert pcg_ell.slot_major(vals) is first
    vals[0, 0] += 1.0
    again = pcg_ell.slot_major(vals)
    assert again is not first and torch.equal(again, vals.t())


def test_wrappers_check_and_route(problem):
    """CPU tensors take the twins; other devices and bad inputs raise."""
    p = problem
    b, x0, diag, idx, vals = _t(p["b"], p["x0"], p["diag"], p["idx"],
                                p["vals"])
    pcg_ell.cg_ell_solve.launches = 0
    x = pcg_ell.cg_ell_solve(b, x0, diag, idx, vals, 3)
    assert torch.equal(x, pcg_ell.cg_ell_solve_reference(b, x0, diag, idx,
                                                         vals, 3))
    assert torch.equal(pcg_ell.cg_ell_solve(b, x0, diag, idx, vals, 0), x0)
    assert pcg_ell.cg_ell_solve.launches == 0
    with pytest.raises(ValueError, match="ell_idx"):
        pcg_ell.cg_ell_solve(b, x0, diag, idx.long(), vals, 3)
    with pytest.raises(ValueError, match="ell_vals"):
        pcg_ell.cg_ell_solve(b, x0, diag, idx, vals[:, :-1], 3)
    with pytest.raises(RuntimeError, match="no kernel"):
        pcg_ell.cg_ell_solve(*(t.to("meta") for t in (b, x0, diag, idx,
                                                        vals)), 3)
    x, r, q, rz, Ap, invd = _update_inputs(problem)
    ins = _t(x, r, q, np.array(rz), Ap, invd)
    with pytest.raises(ValueError, match="inv_diag"):
        pcg_step.cg_update(*ins[:5], ins[5][:-1])
    with pytest.raises(ValueError, match="rz"):
        pcg_step.cg_update(*ins[:3], torch.ones(2, dtype=torch.float64),
                           *ins[4:])
    with pytest.raises(RuntimeError, match="no kernel"):
        pcg_step.cg_update(*(t.to("meta") for t in ins))
