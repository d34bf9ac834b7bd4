"""The port's plain dia Jacobi-PCG against the JAX package's Pallas kernel
(`cg_dia_solve`, interpret mode) in f64, on the A_hat of an anchored beam.

Tolerance: rtol 1e-10 against the largest entry of the solution. Both
sides sum the dots over all 3n values in one alpha/beta; only the
summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops.pallas.cg_dia import cg_dia_solve as jax_cg
from admm_elastic_tpu_torch.core import solver as psolver
from admm_elastic_tpu_torch.geometry import make_beam_tets
from admm_elastic_tpu_torch.models import HyperElasticTet, StaticAnchor
from admm_elastic_tpu_torch.ops.kernels import cg_dia as pcg

torch.set_num_threads(1)


def _system():
    beam = make_beam_tets(6, 4, 4, size=0.05)
    n = beam.n_vertices
    m = np.full(n, 1.0 / n)
    anchor = StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9))
    tet = HyperElasticTet(beam.tets, 1e5, 1e5, backend="pallas")
    cparams = {"a": anchor.build(beam.vertices, m, 0.04)[0],
               "t": tet.build(beam.vertices, m, 0.04)[0]}
    offs, dia, diag = psolver.assemble_A_hat_dia(n, m, 0.04, cparams)
    rng = np.random.default_rng(11)
    b = rng.normal(size=(n, 3))
    x0 = beam.vertices + 0.01 * rng.normal(size=(n, 3))
    return offs, dia, diag, b, x0


@pytest.mark.parametrize("n_iters", [1, 25, 75])
def test_plain_matches_pallas_interpret(n_iters):
    offs, dia, diag, b, x0 = _system()
    ref = np.asarray(jax_cg(jnp.asarray(b), jnp.asarray(x0), jnp.asarray(diag),
                            jnp.asarray(dia), offs, n_iters, interpret=True))
    out = pcg.cg_dia_solve(*(torch.as_tensor(a) for a in (b, x0, diag, dia)),
                           offs, n_iters).numpy()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 1e-10, f"n_iters={n_iters}: relative error {err:.3g}"
    # the solve moved: the comparison is not of x0 with itself
    assert np.abs(out - x0).max() > 1e-3


def test_wrapper_checks_and_cpu_route():
    offs, dia, diag, b, x0 = (a if isinstance(a, tuple) else torch.as_tensor(a)
                              for a in _system())
    pcg.cg_dia_solve.launches = 0
    x = pcg.cg_dia_solve(b, x0, diag, dia, offs, 3)
    assert torch.equal(x, pcg.cg_dia_solve_reference(b, x0, diag, dia, offs, 3))
    assert torch.equal(pcg.cg_dia_solve(b, x0, diag, dia, offs, 0), x0)
    assert pcg.cg_dia_solve.launches == 0
    with pytest.raises(ValueError, match="dia_vals"):
        pcg.cg_dia_solve(b, x0, diag, dia[:-1], offs, 3)
    with pytest.raises(ValueError, match="x0"):
        pcg.cg_dia_solve(b, x0.float(), diag, dia, offs, 3)
    with pytest.raises(ValueError, match="diagonals"):
        many = tuple(range(pcg.MAX_DIAGONALS + 1))
        pcg.cg_dia_solve(b, x0, diag, torch.zeros(len(many), b.shape[0],
                                                  dtype=b.dtype), many, 3)
