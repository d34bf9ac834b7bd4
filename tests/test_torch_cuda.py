"""Hand-written kernels against their plain twins on a CUDA device: those of
the ell routes, and the element steps of the unfused pipeline and of
LinearTetStrain. Every case is marked `cuda` and skips without a card. This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (tests/conftest.py sets JAX up, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The twins of cg_update and cg_ell_solve add in the kernels' order
(`chain_dot`, `ell_apply_by_slot`), so the kernels must repeat them
bitwise; the banded kernel's CG reduces in another order than its twin,
so its window compares at chip_smoke.py's 1e-8 (f64). The element steps
(nh_local_step, tri_local_step, arap_local_step_fused, arap_local_step)
are built without FMA contraction and use correctly rounded sqrt and
division, as their twins do on the card: bitwise."""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.core import solver
from admm_elastic_tpu_torch.ops.kernels import (banded_step, cg_ell, cg_step,
                                                nh_local, tet_local,
                                                tri_local)
from admm_elastic_tpu_torch.utils.scenes import small_delaunay

DTYPES = [torch.float64, torch.float32]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(dtype):
    """The small Delaunay mesh's A_hat (ELL) and its first solve from rest:
    b = A x_rest + M dt^2 g, warm start x_rest."""
    s = small_delaunay(25, dtype, "cuda", fast=False)
    sv = s.params["_solver"]
    x0 = s.state["x"]
    b = solver.ell_apply(x0, sv["ell_idx"], sv["ell_vals"])
    b[:, 1] -= s._masses_dev * 9.8 * 0.04 ** 2
    return b, x0, sv["diag"], sv["ell_idx"], sv["ell_vals"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cg_update_kernel_is_its_twin(dtype):
    _cuda()
    b, x0, diag, idx, vals = _problem(dtype)
    inv = 1.0 / diag
    r = b - solver.ell_apply(x0, idx, vals)
    p = inv[:, None] * r
    ins = (x0, r, p, cg_step.chain_dot(r, p), solver.ell_apply(p, idx, vals),
           inv)
    n0 = cg_step.cg_update.launches
    got = cg_step.cg_update(*ins)
    assert cg_step.cg_update.launches == n0 + 1
    for g, w in zip(got, cg_step.cg_update_reference(*ins)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [25, 75])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cg_ell_kernel_is_its_twin(dtype, n_iters):
    _cuda()
    args = (*_problem(dtype), n_iters)
    got = cg_ell.cg_ell_solve(*args)
    assert torch.equal(got, cg_ell.cg_ell_solve(*args))
    assert torch.equal(got, cg_ell.cg_ell_solve_reference(*args))
    assert float((got - args[1]).abs().max()) > 1e-4  # the solve moved


@pytest.mark.cuda
def test_banded_ell_kernel_matches_twin():
    _cuda()
    st = small_delaunay(25, torch.float64, "cuda", fast=True)._stepper
    assert st.cfg.matrix == "ell"
    got = banded_step.banded_rollout(st.state, st.planes, st.cfg, 10)
    want = banded_step.banded_rollout_reference(st.state, st.planes, st.cfg,
                                                10)
    assert float((got["x"] - want["x"]).abs().max()) < 1e-8
    assert np.isfinite(got["x"].cpu().numpy()).all()


def _element_inputs(planes, vectors, dtype, device, seed=0, E=4096):
    """Random (P, E) planes and positive (E,) vectors; the first plane set
    gets a quarter of its elements sign-flipped on its last third of rows
    (inverted F) and 64 elements zeroed (degenerate F)."""
    rng = np.random.default_rng(seed)
    ins = [rng.normal(size=(r, E)) for r in planes]
    p0 = ins[0]
    p0[-(p0.shape[0] // 3):, : E // 4] *= -1.0
    p0[:, E // 4: E // 4 + 64] = 0.0
    ins += [rng.uniform(0.5, 2.0, E) for _ in range(vectors)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in ins]


ELEMENT_STEPS = {
    "nh_local_step": (nh_local.nh_local_step,
                      nh_local.nh_local_step_reference, (9, 9, 3), 3),
    "tri_local_step": (tri_local.tri_local_step,
                       tri_local.tri_local_step_reference, (6, 6), 4),
    "arap_local_step_fused": (tet_local.arap_local_step_fused,
                              tet_local.arap_local_step_fused_reference,
                              (12, 9, 12), 2),
    "arap_local_step": (tet_local.arap_local_step,
                        tet_local.arap_local_step_reference, (9, 9), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ELEMENT_STEPS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_element_step_kernel_is_its_twin(dtype, name):
    dev = _cuda()
    kernel, twin, planes, vectors = ELEMENT_STEPS[name]
    ins = _element_inputs(planes, vectors, dtype, dev)
    n0 = kernel.launches
    got = kernel(*ins)
    assert kernel.launches == n0 + 1
    for g, w in zip(got, twin(*ins)):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
