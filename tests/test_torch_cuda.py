"""Hand-written kernels against their plain twins on a CUDA device: those of
the ell routes, the element steps of the unfused pipeline and of
LinearTetStrain, the lattice kernel, the banded kernel's arap mode, and
the sharded banded stepper's local phase (banded_local_rhs) and Chebyshev
chunk (cheb_dia_chunk). Every case is marked `cuda` and skips without a card. This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (tests/conftest.py sets JAX up, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The twins of cg_update and cg_ell_solve add in the kernels' order
(`chain_dot`, `ell_apply_by_slot`), so the kernels must repeat them
bitwise; the banded kernel's CG reduces in another order than its twin,
so its window compares at chip_smoke.py's 1e-8 (f64), as do the lattice
kernel's and the banded arap mode's. The element steps
(nh_local_step, tri_local_step, arap_local_step_fused, arap_local_step)
are built without FMA contraction and use correctly rounded sqrt and
division, as their twins do on the card: bitwise. banded_local_rhs runs
the banded kernel's element and vertex phases (1e-12 relative in f64,
1e-4 in f32: a last-bit difference may move a Newton tie); cheb_dia_chunk
repeats its twin's arithmetic in its order (1e-12 / 1e-5 relative)."""

import dataclasses

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.core import solver
from admm_elastic_tpu_torch.core.lattice import LatticeStepper
from admm_elastic_tpu_torch.ops.kernels import (_build, banded_local,
                                                banded_step, cg_ell, cg_step,
                                                cheb_dia, lattice_step,
                                                nh_local, tet_local,
                                                tri_local)
from admm_elastic_tpu_torch.parallel.cheb import (cheb_coefficients,
                                                  dia_operator_bounds)
from admm_elastic_tpu_torch.utils.scenes import (beam_system, jittered_system,
                                                 small_delaunay)

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


# name: LatticeStepper keyword arguments
LATTICES = {
    "nh": dict(),
    "stvk": dict(model="stvk", mu=100.0, lam=400.0),
    "arap": dict(model="arap"),
    "floor": dict(floor_y=0.02),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LATTICES))
def test_lattice_kernel_matches_twin(name):
    """One 10-step launch on a 4 x 3 x 3 beam against the twin on the card
    (1e-8, f64), repeated bitwise."""
    dev = _cuda()
    kw = {"mu": 1e4, "lam": 1e4, **LATTICES[name]}
    beam_n = 5 * 4 * 4
    st = LatticeStepper(4, 3, 3, 0.25, np.full(beam_n, 1.0 / beam_n),
                        kw.pop("mu"), kw.pop("lam"), np.arange(12),
                        admm_iters=6, cg_iters=25, dtype=torch.float64,
                        device=dev, **kw)
    n0 = lattice_step.lattice_rollout.launches
    got = lattice_step.lattice_rollout(st.state, st.planes, st.cfg, 10)
    again = lattice_step.lattice_rollout(st.state, st.planes, st.cfg, 10)
    assert lattice_step.lattice_rollout.launches == n0 + 2
    want = lattice_step.lattice_rollout_reference(st.state, st.planes,
                                                  st.cfg, 10)
    assert float((got["x"] - want["x"]).abs().max()) < 1e-8
    for k in lattice_step.STATE:
        assert torch.equal(got[k], again[k]), k
        assert bool(torch.isfinite(got[k]).all()), k


@pytest.mark.cuda
def test_banded_arap_kernel_matches_twin():
    """The arap mode on a 4 x 3 x 3 beam (dia): one 10-step launch against
    the twin on the card (1e-8, f64)."""
    dev = _cuda()
    st = beam_system((4, 3, 3), 0.25, 2.0, 25, torch.float64, "cuda",
                     fast=True, arap=True)._stepper
    assert st.cfg.model == "arap" and st.device == dev
    got = banded_step.banded_rollout(st.state, st.planes, st.cfg, 10)
    want = banded_step.banded_rollout_reference(st.state, st.planes, st.cfg,
                                                10)
    assert float((got["x"] - want["x"]).abs().max()) < 1e-8
    assert torch.equal(got["warm"], st.state["warm"])  # arap leaves it


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-300)
               for g, w in zip(got, want))


def _local_inputs(model, dtype, dev):
    """The jittered 4 x 3 x 3 beam's banded stepper (anchors, floor,
    sphere, cylinder; arap: a LinearTetStrain beam) with x moved by
    0.02 m N(0,1) and random duals, so that every branch runs."""
    if model == "arap":
        st = beam_system((4, 3, 3), 0.25, 2.0, 25, dtype, "cuda", fast=True,
                         arap=True)._stepper
    else:
        st = jittered_system((4, 3, 3), 25, dtype, "cuda")._stepper
        if model == "stvk":
            st.cfg = dataclasses.replace(st.cfg, model="stvk")
    rng = np.random.default_rng(5)

    def noise(shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=dtype, device=dev)

    x = st.state["x"] + noise(st.state["x"].shape, 0.02)
    E = st.n_elements
    return st, (x, noise(x.shape, 0.01), noise(x.shape, 0.01),
                noise((9, E), 0.01), st.state["warm"] + 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["nh", "stvk", "arap"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_local_kernel_matches_twin(dtype, model):
    dev = _cuda()
    st, ins = _local_inputs(model, dtype, dev)
    n0 = banded_local.banded_local_rhs.launches
    got = banded_local.banded_local_rhs(*ins, st.planes, st.cfg)
    again = banded_local.banded_local_rhs(*ins, st.planes, st.cfg)
    assert banded_local.banded_local_rhs.launches == n0 + 2
    want = banded_local.banded_local_rhs_reference(*ins, st.planes, st.cfg)
    assert _rel(got, want) < (1e-12 if dtype == torch.float64 else 1e-4)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_it,first,last", [
    (0, True, False), (1, False, False), (7, False, True), (40, True, True)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cheb_dia_kernel_matches_twin(dtype, n_it, first, last):
    """The chunk on the jittered 4 x 3 x 3 beam's A_hat: init-only, a
    middle chunk, a last chunk and a whole 41-iteration solve."""
    dev = _cuda()
    st = jittered_system((4, 3, 3), 25, dtype, "cuda")._stepper
    dia, offs = st.planes["dia"], st.cfg.dia_offs
    inv_theta, c1, c2 = cheb_coefficients(
        41, *dia_operator_bounds(dia.double().cpu().numpy(), offs))
    rng = np.random.default_rng(n_it)
    b, x, z, d = (torch.as_tensor(rng.standard_normal(st.state["x"].shape),
                                  dtype=dtype, device=dev) for _ in range(4))
    c1, c2 = (torch.as_tensor(c if n_it else np.zeros(1), dtype=dtype,
                              device=dev) for c in (c1[:max(n_it, 1)],
                                                    c2[:max(n_it, 1)]))
    args = (b, x, z, d, st.planes["invd"], dia, c1, c2)
    kw = dict(offsets=offs, n_it=n_it, first=first, last=last,
              inv_theta=inv_theta)
    n0 = cheb_dia.cheb_dia_chunk.launches
    got = cheb_dia.cheb_dia_chunk(*args, **kw)
    again = cheb_dia.cheb_dia_chunk(*args, **kw)
    assert cheb_dia.cheb_dia_chunk.launches == n0 + 2
    want = cheb_dia.cheb_dia_chunk_reference(*args, **kw)
    assert _rel(got, want) < (1e-12 if dtype == torch.float64 else 1e-5)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_wrappers_raise_without_their_build(monkeypatch):
    """No fallback: on a CUDA tensor a wrapper whose library cannot be
    built raises; it never runs its twin instead."""
    dev = _cuda()
    st, ins = _local_inputs("nh", torch.float32, dev)

    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load_library", missing)
    with pytest.raises(RuntimeError, match="nvcc"):
        banded_local.banded_local_rhs(*ins, st.planes, st.cfg)
    x = ins[0]
    c = torch.zeros(1, dtype=x.dtype, device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        cheb_dia.cheb_dia_chunk(x, x, x, x, st.planes["invd"],
                                st.planes["dia"], c, c,
                                offsets=st.cfg.dia_offs, n_it=0, first=True,
                                last=True, inv_theta=1.0)
