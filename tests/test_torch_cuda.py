"""Hand-written kernels against their plain twins on a CUDA device: those of
the ell routes, the element steps of the unfused pipeline and of
LinearTetStrain, the banded, lattice and cloth whole-timestep windows, and
the sharded banded stepper's local phase (banded_local_rhs) and Chebyshev
chunk (cheb_dia_chunk). Every case is marked `cuda` and skips without a card. This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (tests/conftest.py sets JAX up, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The twins of cg_update, cg_dia_solve and cg_ell_solve add in the
kernels' order (`cluster_dot`, `dia_apply`, `ell_apply_by_slot`), so the
kernels must repeat them bitwise, cg_update (one launch on one cluster)
at delaunay100k's n and where a thread holds several rows, the two
cluster solves at any n (`scenes.banded_spd`: fewer rows than CTAs, a
last slab cut short, windows too large for shared memory, a random
numbering). The banded, lattice and cloth windows (element kernel,
vertex kernel, the cluster solve, every ADMM iteration) repeat their
twins bitwise too, in every mode, and a stepper's CUDA graph replays the
same bits as the window's eager launches. The element steps
(nh_local_step_fused, nh_local_step, tri_local_step,
arap_local_step_fused, arap_local_step) are built without FMA contraction
and use correctly rounded sqrt and division, as their twins do on the
card: bitwise (the hyperelastic pair also at E = 1, 1,000 and 100,003,
nh and stvk, the ARAP pair at E = 7, 1,000 and 100,003, on a mesh and on
unshared vertices, the fused ones with and without emit_z and into out=
buffers). banded_local_rhs runs
the banded kernel's element and vertex phases (1e-12 relative in f64,
1e-4 in f32: a last-bit difference may move a Newton tie); cheb_dia_chunk
repeats its twin's arithmetic in its order, bitwise in both layouts of its
cluster. The multigrid mode of the cluster solve (mg_dia_solve, the
V-cycle of csrc/mg_vcycle.cuh) and the banded and cloth windows in that
mode repeat their twins (ops/kernels/mg.py) bitwise too, as do the
algebraic multigrid mode (uamg_ell_solve, the aggregation V-cycle) and the
banded window's ELL mode on it (ops/kernels/uamg.py); the general route's
aggregation AMG (plain PyTorch) stays within 1e-8 of its CPU run. So do the
residual modes: the fused element kernels' emit_z block, the windows'
"primal" and "full" residuals (summed in the order of
ops/kernels/residuals.py; the state the same bits as without them) and
banded_local_rhs's collect."""

import dataclasses

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.core import solver
from admm_elastic_tpu_torch.core.lattice import LatticeStepper
from admm_elastic_tpu_torch.ops.kernels import (_build, banded_local,
                                                banded_step, cg_dia, cg_ell,
                                                cg_step, cheb_dia,
                                                cloth_step, lattice_step, mg,
                                                nh_local, tet_local,
                                                tri_local, uamg)
from admm_elastic_tpu_torch.parallel.banded_spmd import (
    sharded_banded_from_system)
from admm_elastic_tpu_torch.parallel.cheb import (cheb_coefficients,
                                                  dia_operator_bounds)
from admm_elastic_tpu_torch.utils import profile_step, scenes
from admm_elastic_tpu_torch.utils.scenes import (banded_spd, beam_system,
                                                 cloth_system,
                                                 grid_mg_problem,
                                                 jittered_system,
                                                 small_cloth, small_delaunay,
                                                 small_mg_beam, small_uamg)

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
    ins = (x0, r, p, cg_step.cluster_dot(r, p),
           solver.ell_apply(p, idx, vals), inv)
    n0 = cg_step.cg_update.launches
    got = cg_step.cg_update(*ins)
    assert cg_step.cg_update.launches == n0 + 1
    for g, w in zip(got, cg_step.cg_update_reference(*ins)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16280, 100003])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cg_update_is_one_cluster_launch(dtype, n):
    """cg_update on random vectors at delaunay100k's n (one row a thread)
    and at 100,003 (6 or 7 rows a thread, 2 kept in registers): bitwise to
    its twin, also with each output written over its own input; one
    device op, a kernel, a call."""
    dev = _cuda()
    rng = np.random.default_rng(n)

    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x, r, p, Ap = (vec(rng.standard_normal((n, 3))) for _ in range(4))
    ins = (x, r, p, vec(0.7), Ap, vec(rng.uniform(0.5, 2.0, n)))
    want = cg_step.cg_update_reference(*ins)
    for g, w in zip(cg_step.cg_update(*ins), want):
        assert torch.equal(g, w)
    over = tuple(t.clone() for t in ins)
    cg_step.cg_update(*over, out=over[:4])
    for g, w in zip(over[:4], want):
        assert torch.equal(g, w)
    ops = profile_step.call_ops(lambda: cg_step.cg_update(*ins))
    assert ops == {"device_ops_per_call": 1.0, "kinds": ["kernel"]}
    with pytest.raises(ValueError, match="out"):
        cg_step.cg_update(*ins, out=(x, r, p[:-1], ins[3]))


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
@pytest.mark.parametrize("n_iters", [25, 75])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cg_dia_kernel_is_its_twin(dtype, n_iters):
    """The 6 x 4 x 4 beam's first global solve (175 rows: the last slab
    cut short), one launch, bitwise to the twin and to itself."""
    _cuda()
    s = beam_system((6, 4, 4), 0.05, 1.0, 25, dtype, "cuda")
    sv, x0, m = s.params["_solver"], s.state["x"], s._masses_dev
    b = m[:, None] * x0
    b[:, 1] -= m * 9.8 * 0.04 ** 2
    args = (b, x0, sv["diag"], sv["dia_vals"], s._dia_offsets, n_iters)
    n0 = cg_dia.cg_dia_solve.launches
    got = cg_dia.cg_dia_solve(*args)
    assert cg_dia.cg_dia_solve.launches == n0 + 1
    assert torch.equal(got, cg_dia.cg_dia_solve(*args))
    assert torch.equal(got, cg_dia.cg_dia_solve_reference(*args))
    assert not torch.equal(got, x0)


def _band_args(s, kind, n_iters):
    if kind == "dia":
        return (s["b"], s["x0"], s["diag"], s["dia_vals"], s["offsets"],
                n_iters)
    return (s["b"], s["x0"], s["diag"], s["ell_idx"], s["ell_vals"], n_iters)


SOLVES = {"dia": cg_dia, "ell": cg_ell}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 37, 1003, 40000])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cluster_solves_at_any_n(dtype, n):
    """Both solves on a banded SPD system at n below the cluster size, not
    a multiple of it, and 40,000 rows (f64: the windows do not fit in
    shared memory): bitwise to their twins, to each other and to themselves;
    0 iterations return x0."""
    dev = _cuda()
    s = banded_spd(n, dtype=dtype, device=dev, seed=n)
    out = {}
    for kind, mod in SOLVES.items():
        solve = getattr(mod, f"cg_{kind}_solve")
        for k in (0, 25):
            args = _band_args(s, kind, k)
            got = solve(*args)
            assert torch.equal(got, solve(*args))
            assert torch.equal(got, getattr(
                mod, f"cg_{kind}_solve_reference")(*args))
            out[(kind, k)] = got
        assert torch.equal(out[(kind, 0)], s["x0"])
    assert torch.equal(out[("dia", 25)], out[("ell", 25)])
    assert bool(torch.isfinite(out[("dia", 25)]).all())


@pytest.mark.cuda
def test_cluster_solve_set_up_outlives_smaller_ones():
    """A solve set up at 1,003 rows, then one of 37 rows (less shared
    memory a CTA), then the first again, eagerly and inside a CUDA graph
    capture: a size once set up stays launchable."""
    dev = _cuda()
    big, small = (_band_args(banded_spd(n, dtype=torch.float64, device=dev,
                                        seed=n), "dia", 25)
                  for n in (1003, 37))
    want = cg_dia.cg_dia_solve(*big)
    cg_dia.cg_dia_solve(*small)
    assert torch.equal(cg_dia.cg_dia_solve(*big), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cg_dia.cg_dia_solve(*big)
    graph.replay()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cluster_solve_in_the_shared_layout(dtype):
    """A 20,000-row band renumbered at random: its rows reach across the
    matrix, no window fits in shared memory, and the ELL solve keeps one p
    in global memory (the shared layout), bitwise to its twin and to
    itself, and at [perm] within 1e-4 (f32) or 1e-10 (f64) of the same
    system in its band numbering."""
    dev = _cuda()
    s = banded_spd(20000, dtype=dtype, device=dev, seed=5)
    args = _band_args(s, "ell", 25)
    *renumbered, perm = scenes.renumbered_ell(*args[:5], seed=5)
    plan = cg_step.cluster_plan(20000, dtype, cg_ell.bandwidth(renumbered[3]),
                                0)
    assert not plan["vectors_in_smem"] and plan["scratch"] > 0
    got = cg_ell.cg_ell_solve(*renumbered, 25)
    assert torch.equal(got, cg_ell.cg_ell_solve(*renumbered, 25))
    assert torch.equal(got, cg_ell.cg_ell_solve_reference(*renumbered, 25))
    want = cg_ell.cg_ell_solve(*args)[perm]
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < (1e-10 if dtype == torch.float64 else 1e-4)


def _window_is_its_twin(run, twin, keys, st, planes, cfg, steps):
    """A window (run: banded_rollout, lattice_rollout or cloth_rollout) from
    the
    stepper's state, twice, and its twin: bitwise, finite. Returns the
    window's state."""
    n0 = run.launches
    got = run(st.state, planes, cfg, steps)
    again = run(st.state, planes, cfg, steps)
    assert run.launches == n0 + 2
    want = twin(st.state, planes, cfg, steps)
    for k in keys:
        assert bool(torch.isfinite(got[k]).all()), k
        assert torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["nh", "stvk", "arap"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_window_is_its_twin(dtype, model):
    """The jittered 8 x 6 x 5 beam (floor, sphere, cylinder) with vertex
    0's anchor released, one 10-step window of every mode: bitwise; the
    released anchor's dual stays exactly 0."""
    _cuda()
    st = jittered_system(dtype=dtype)._stepper
    planes = dict(st.planes, aw2=st.planes["aw2"].clone())
    planes["aw2"][0] = 0.0
    cfg = dataclasses.replace(st.cfg, model=model)
    got = _window_is_its_twin(banded_step.banded_rollout,
                              banded_step.banded_rollout_reference,
                              banded_step.STATE, st, planes, cfg, 10)
    assert torch.count_nonzero(got["au"][0]) == 0
    assert torch.count_nonzero(got["cu"]) > 0, "shapes engaged"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_ell_kernel_matches_twin(dtype):
    """The 140-node Delaunay mesh on the ELL rows: one 10-step window,
    bitwise."""
    _cuda()
    st = small_delaunay(25, dtype, "cuda", fast=True)._stepper
    assert st.cfg.matrix == "ell"
    _window_is_its_twin(banded_step.banded_rollout,
                        banded_step.banded_rollout_reference,
                        banded_step.STATE, st, st.planes, st.cfg, 10)


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


def _unshared(ins):
    """A fused tet step's inputs (xg12, then the rest) with the gathered
    positions xg12 (12,E) as positions (4E,3) and int32 tets (E,4) of
    vertices no two elements share: vertex 4e+k holds xg12[3k:3k+3, e]."""
    xg, *rest = ins
    E = xg.shape[1]
    return [xg.T.reshape(4 * E, 3).contiguous(),
            torch.arange(4 * E, dtype=torch.int32,
                         device=xg.device).view(E, 4), *rest]


# name: (kernel, twin, planes, vectors, the gathered positions as a mesh)
ELEMENT_STEPS = {
    "nh_local_step": (nh_local.nh_local_step,
                      nh_local.nh_local_step_reference, (9, 9, 3), 3, False),
    "tri_local_step": (tri_local.tri_local_step,
                       tri_local.tri_local_step_reference, (6, 6), 4, False),
    "arap_local_step_fused": (tet_local.arap_local_step_fused,
                              tet_local.arap_local_step_fused_reference,
                              (12, 9, 12), 2, True),
    "arap_local_step": (tet_local.arap_local_step,
                        tet_local.arap_local_step_reference, (9, 9), 2,
                        False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ELEMENT_STEPS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_element_step_kernel_is_its_twin(dtype, name):
    dev = _cuda()
    kernel, twin, planes, vectors, mesh = ELEMENT_STEPS[name]
    ins = _element_inputs(planes, vectors, dtype, dev)
    if mesh:
        ins = _unshared(ins)
    n0 = kernel.launches
    got = kernel(*ins)
    assert kernel.launches == n0 + 1
    for g, w in zip(got, twin(*ins)):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


def _nh_inputs(E, dtype, dev, seed=0):
    """Both hyperelastic entries' inputs at E elements: positions of
    E // 4 + 4 vertices and random tets over them (so inverted and
    near-degenerate elements; 64 collapsed to one vertex when E > 128),
    random selector planes, duals, warm starts (a negative third component
    in an eighth), mu, lam = 4 mu, k = min(mu, lam), w2; and Dx of the
    unfused entry. Returns (fused arguments, unfused arguments)."""
    rng = np.random.default_rng(seed)
    n = E // 4 + 4
    tets = rng.integers(0, n, size=(E, 4)).astype(np.int32)
    if E > 128:
        tets[E // 2: E // 2 + 64] = tets[E // 2: E // 2 + 64, :1]
    warm = rng.uniform(0.5, 1.5, size=(3, E))
    warm[2, : E // 8] *= -1.0
    mu = rng.uniform(1e4, 1e5, E)
    fl = [rng.normal(size=(n, 3)), rng.normal(size=(9, E)) * 0.1, warm,
          rng.normal(size=(12, E)), mu, 4.0 * mu, mu,
          rng.uniform(0.5, 2.0, E)]
    t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in fl]
    x, u, warm, cp, mu, lam, k, w2 = t
    tets = torch.as_tensor(tets, device=dev)
    return ((x, tets, u, warm, cp, mu, lam, k, w2),
            (_dx_of(x, tets, cp), u, warm, mu, lam, k))


def _dx_of(x, tets, cp):
    """Dx planes (9,E) of the selector planes on the tets' vertices."""
    E = tets.shape[0]
    xg = x[tets.long()].reshape(E, 4, 3)
    return torch.einsum("bke,eka->abe", cp.reshape(3, 4, E),
                        xg).reshape(9, E).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 1000, 100003])
@pytest.mark.parametrize("emit_z", [False, True], ids=["rows", "emit_z"])
@pytest.mark.parametrize("model", ["nh", "stvk"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_nh_fused_kernel_is_its_twin(dtype, model, emit_z, E):
    """nh_local_step_fused (the kernel gathers from x through the tets and
    writes (4E,3) or (4E,6) rows) bitwise to its twin, a partial block and
    a last warp of few elements included; with emit_z the other outputs
    the same bits as without."""
    dev = _cuda()
    fused, _ = _nh_inputs(E, dtype, dev)
    n0 = nh_local.nh_local_step_fused.launches
    m0 = nh_local.nh_local_step_fused.residual_launches
    got = nh_local.nh_local_step_fused(*fused, model=model, emit_z=emit_z)
    assert nh_local.nh_local_step_fused.launches == n0 + 1
    assert nh_local.nh_local_step_fused.residual_launches == m0 + emit_z
    want = nh_local.nh_local_step_fused_reference(*fused, model=model,
                                                  emit_z=emit_z)
    assert got[3].shape == (4 * E, 6 if emit_z else 3)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    if emit_z:
        off = nh_local.nh_local_step_fused(*fused, model=model)
        assert all(torch.equal(g, o) for g, o in zip(got[:3], off[:3]))
        assert torch.equal(got[3][:, :3], off[3])


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 1000, 100003])
@pytest.mark.parametrize("model", ["nh", "stvk"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_nh_step_kernel_is_its_twin(dtype, model, E):
    dev = _cuda()
    _, step = _nh_inputs(E, dtype, dev)
    n0 = nh_local.nh_local_step.launches
    got = nh_local.nh_local_step(*step, model=model)
    assert nh_local.nh_local_step.launches == n0 + 1
    for g, w in zip(got, nh_local.nh_local_step_reference(*step,
                                                          model=model)):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_nh_out_buffers_on_the_card():
    """out= buffers get the kernel's bits; one that aliases an input, or
    another output, raises before any launch."""
    dev = _cuda()
    fused, step = _nh_inputs(1000, torch.float32, dev)
    want = nh_local.nh_local_step_fused(*fused)
    out = tuple(torch.empty_like(w) for w in want)
    got = nh_local.nh_local_step_fused(*fused, out=out)
    assert all(g is o and torch.equal(g, w)
               for g, o, w in zip(got, out, want))
    n0 = nh_local.nh_local_step_fused.launches
    with pytest.raises(ValueError, match="overlaps"):
        nh_local.nh_local_step_fused(*fused, out=(out[0], fused[2],
                                                  *out[2:]))
    with pytest.raises(ValueError, match="overlaps"):  # rows onto cp12
        nh_local.nh_local_step_fused(
            *fused, out=(*out[:3], fused[4].view(4000, 3)))
    with pytest.raises(ValueError, match="overlaps"):
        nh_local.nh_local_step_fused(*fused, out=(out[0], out[0], *out[2:]))
    assert nh_local.nh_local_step_fused.launches == n0
    sout = tuple(torch.empty_like(w) for w in want[:3])
    got = nh_local.nh_local_step(*step, out=sout)
    assert all(g is o for g, o in zip(got, sout))
    assert all(torch.equal(g, w) for g, w in zip(
        got, nh_local.nh_local_step_reference(*step)))
    with pytest.raises(ValueError, match="overlaps"):
        nh_local.nh_local_step(*step, out=(sout[0], step[1], sout[2]))


def _arap_inputs(E, dtype, dev, form, seed=0):
    """Both ARAP entries' inputs at E elements: the fused entry's on
    "mesh", positions of E // 4 + 4 vertices and random tets over them (so
    inverted and near-degenerate elements; 64 collapsed to one vertex when
    E > 128), or on "unshared", `_element_inputs`' gathered positions
    (inverted and zeroed elements) as vertices no two elements share;
    random selector planes, duals, w2 and k. Returns (fused arguments,
    the unfused entry's on their Dx)."""
    if form == "unshared":
        xg, u, cp, w2, k = _element_inputs((12, 9, 12), 2, dtype, dev,
                                           seed=seed, E=E)
        x, tets = _unshared([xg])
    else:
        rng = np.random.default_rng(seed)
        n = E // 4 + 4
        tets = rng.integers(0, n, size=(E, 4)).astype(np.int32)
        if E > 128:
            tets[E // 2: E // 2 + 64] = tets[E // 2: E // 2 + 64, :1]
        x, u, cp, w2, k = (torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in (rng.normal(size=(n, 3)),
                                     0.1 * rng.normal(size=(9, E)),
                                     rng.normal(size=(12, E)),
                                     rng.uniform(0.5, 2.0, E),
                                     rng.uniform(0.5, 5.0, E)))
        tets = torch.as_tensor(tets, device=dev)
    return (x, tets, u, cp, w2, k), (_dx_of(x, tets, cp), u, w2, k)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [7, 1000, 100003])
@pytest.mark.parametrize("form", ["mesh", "unshared"])
@pytest.mark.parametrize("emit_z", [False, True], ids=["rows", "emit_z"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_arap_fused_kernel_is_its_twin(dtype, emit_z, form, E):
    """arap_local_step_fused (the kernel gathers from x through the tets
    and writes (4E,3) or (4E,6) rows) bitwise to its twin, on a mesh and
    on unshared vertices, a last warp of few elements and a grid of fewer
    than 32 included; with emit_z the other outputs the same bits as
    without."""
    dev = _cuda()
    fused, _ = _arap_inputs(E, dtype, dev, form)
    fn = tet_local.arap_local_step_fused
    n0, m0 = fn.launches, fn.residual_launches
    got = fn(*fused, emit_z=emit_z)
    assert fn.launches == n0 + 1 and fn.residual_launches == m0 + emit_z
    want = tet_local.arap_local_step_fused_reference(*fused, emit_z=emit_z)
    assert got[2].shape == (4 * E, 6 if emit_z else 3)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    if emit_z:
        off = fn(*fused)
        assert all(torch.equal(g, o) for g, o in zip(got[:2], off[:2]))
        assert torch.equal(got[2][:, :3], off[2])


@pytest.mark.cuda
@pytest.mark.parametrize("E", [7, 1000, 100003])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_arap_step_kernel_is_its_twin(dtype, E):
    dev = _cuda()
    _, step = _arap_inputs(E, dtype, dev, "mesh")
    n0 = tet_local.arap_local_step.launches
    got = tet_local.arap_local_step(*step)
    assert tet_local.arap_local_step.launches == n0 + 1
    for g, w in zip(got, tet_local.arap_local_step_reference(*step)):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_arap_out_buffers_on_the_card(dtype):
    """Two sets of out= buffers used in turn, as the System uses them (the
    outputs of one call the inputs of the next), get the twin's bits;
    one that aliases an input, or another output, raises before any
    launch. The fused call is one device op in a CUDA graph."""
    dev = _cuda()
    fused, step = _arap_inputs(1000, dtype, dev, "mesh")
    for fn, twin, args, iu in (
            (tet_local.arap_local_step_fused,
             tet_local.arap_local_step_fused_reference, fused, 2),
            (tet_local.arap_local_step, tet_local.arap_local_step_reference,
             step, 1)):
        sets = [tuple(torch.empty_like(w) for w in fn(*args))
                for _ in range(2)]
        args = list(args)
        for i in range(4):
            want = twin(*args)
            got = fn(*args, out=sets[i % 2])
            assert all(g is o and torch.equal(g, w)
                       for g, o, w in zip(got, sets[i % 2], want))
            args[iu] = got[1]  # the next call's duals
        n0 = fn.launches
        out = sets[0]
        with pytest.raises(ValueError, match="overlaps"):
            fn(*args, out=(out[0], args[iu], *out[2:]))
        with pytest.raises(ValueError, match="overlaps"):
            fn(*args, out=(out[0], out[0], *out[2:]))
        assert fn.launches == n0
    ops = profile_step.call_ops(
        lambda: tet_local.arap_local_step_fused(*fused))
    assert ops == {"device_ops_per_call": 1.0, "kinds": ["kernel"]}


# name: LatticeStepper keyword arguments
LATTICES = {
    "nh": dict(),
    "stvk": dict(model="stvk", mu=100.0, lam=400.0),
    "arap": dict(model="arap"),
    "floor": dict(floor_y=0.02),
}


def _small_lattice(name, dtype, dev):
    kw = {"mu": 1e4, "lam": 1e4, **LATTICES[name]}
    beam_n = 5 * 4 * 4
    return LatticeStepper(4, 3, 3, 0.25, np.full(beam_n, 1.0 / beam_n),
                          kw.pop("mu"), kw.pop("lam"), np.arange(12),
                          admm_iters=6, cg_iters=25, dtype=dtype,
                          device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LATTICES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_lattice_kernel_matches_twin(name, dtype):
    """One 10-step window on a 4 x 3 x 3 beam against the twin on the
    card: bitwise, repeated bitwise."""
    dev = _cuda()
    st = _small_lattice(name, dtype, dev)
    _window_is_its_twin(lattice_step.lattice_rollout,
                        lattice_step.lattice_rollout_reference,
                        lattice_step.STATE, st, st.planes, st.cfg, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_arap_kernel_matches_twin(dtype):
    """The arap mode on a 4 x 3 x 3 beam (dia): one 10-step window,
    bitwise; the warm start untouched."""
    dev = _cuda()
    st = beam_system((4, 3, 3), 0.25, 2.0, 25, dtype, "cuda",
                     fast=True, arap=True)._stepper
    assert st.cfg.model == "arap" and st.device == dev
    got = _window_is_its_twin(banded_step.banded_rollout,
                              banded_step.banded_rollout_reference,
                              banded_step.STATE, st, st.planes, st.cfg, 10)
    assert torch.equal(got["warm"], st.state["warm"])  # arap leaves it


@pytest.mark.cuda
@pytest.mark.parametrize("limiting", [True, False], ids=["limited", "free"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cloth_window_is_its_twin(dtype, limiting):
    """The 8 x 6 sheet (wind, bend, anchors) with one anchor released, one
    10-step window with strain limiting on and off: bitwise, its 3 + 3
    admm_iters launches a step; the released anchor's dual stays exactly
    0."""
    _cuda()
    st = small_cloth(dtype)._stepper
    assert st.n_elements[1] > 0 and st.planes["widx"].shape[1] > 0
    planes = dict(st.planes, aw2=st.planes["aw2"].clone())
    released = int(torch.nonzero(planes["aw2"])[0])
    planes["aw2"][released] = 0.0
    cfg = dataclasses.replace(st.cfg, limiting=limiting)
    ops = cloth_step.cloth_rollout.ops
    got = _window_is_its_twin(cloth_step.cloth_rollout,
                              cloth_step.cloth_rollout_reference,
                              cloth_step.STATE, st, planes, cfg, 10)
    assert cloth_step.cloth_rollout.ops == ops + 2 * 10 * (
        3 + 3 * cfg.admm_iters)
    assert torch.count_nonzero(got["au"][released]) == 0
    assert torch.count_nonzero(got["au"]) > 0


@pytest.mark.cuda
def test_cloth_capture_after_a_smaller_one():
    """A 60 x 60 cloth's windows captured after the 8 x 6 sheet's (whose
    solve takes less shared memory a CTA), then the small one's replayed
    again: both bitwise to eager launches (the solve's shared-memory
    attribute only grows)."""
    _cuda()
    small = small_cloth(torch.float64)._stepper
    big = cloth_system(60, 60, 25, torch.float64, "cuda")._stepper
    run = cloth_step.cloth_rollout
    for st in (small, big, small):
        start = {k: st.state[k].clone() for k in cloth_step.STATE}
        st.run(10)
        want = run(start, st.planes, st.cfg, 10)
        for k in cloth_step.STATE:
            assert torch.equal(st.state[k], want[k]), k


STEPPERS = {
    "banded": (lambda dt: jittered_system(dtype=dt)._stepper,
               banded_step.banded_rollout, banded_step.STATE),
    "cloth": (lambda dt: small_cloth(dt)._stepper,
              cloth_step.cloth_rollout, cloth_step.STATE),
    "banded mg": (lambda dt: small_mg_beam(dt)._stepper,
                  banded_step.banded_rollout, banded_step.STATE),
    "cloth mg": (lambda dt: small_cloth(dt, preconditioner="amg")._stepper,
                 cloth_step.cloth_rollout, cloth_step.STATE),
    "banded ell": (lambda dt: small_delaunay(25, dt, "cuda",
                                             fast=True)._stepper,
                   banded_step.banded_rollout, banded_step.STATE),
    "banded uamg": (lambda dt: small_uamg(8, dt)._stepper,
                    banded_step.banded_rollout, banded_step.STATE),
    "lattice": (lambda dt: _small_lattice("floor", dt, "cuda"),
                lattice_step.lattice_rollout, lattice_step.STATE),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STEPPERS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_graph_replay_is_eager_launches(name, dtype):
    """A stepper's step and 10-step run (one CUDA graph replay each, one
    submission a window) against the same windows launched eagerly from
    the same state: bitwise."""
    _cuda()
    make, run, keys = STEPPERS[name]
    st = make(dtype)
    start = {k: st.state[k].clone() for k in keys}
    n0 = run.launches
    st.step()
    st.run(10)
    assert run.launches == n0 + 2
    want = run(run(start, st.planes, st.cfg, 1), st.planes, st.cfg, 10)
    for k in keys:
        assert torch.equal(st.state[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STEPPERS))
def test_setters_take_effect_after_capture(name):
    """Positions and velocities set after the windows were captured are
    the ones the next replay steps from."""
    _cuda()
    make, run, keys = STEPPERS[name]
    st = make(torch.float64)
    st.run(10)  # captures the 1- and 10-step windows
    x = st.x + 0.01 * np.random.default_rng(0).standard_normal(st.x.shape)
    v = np.full_like(x, 0.05)
    st.set_positions(x)
    st.set_velocities(v)
    assert np.array_equal(st.x, x) and np.array_equal(st.v, v)
    start = {k: st.state[k].clone() for k in keys}
    st.run(10)
    want = run(start, st.planes, st.cfg, 10)
    for k in keys:
        assert torch.equal(st.state[k], want[k]), k


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
    with pytest.raises(ValueError, match="out"):
        banded_local.banded_local_rhs(*ins, st.planes, st.cfg, out=ins[:4])
    for g, a in zip(got, again):
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_it,first,last", [
    (0, True, False), (1, False, False), (7, False, True), (40, True, True)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cheb_dia_kernel_matches_twin(dtype, n_it, first, last):
    """The chunk on the jittered 4 x 3 x 3 beam's A_hat: init-only, a
    middle chunk, a last chunk and a whole 41-iteration solve; bitwise to
    its twin and to itself (the WINDOW layout)."""
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
    plan = cheb_dia.cheb_plan(b.shape[0], dtype, offs)
    assert plan["vectors_in_smem"]
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g, w)


def _band(*offsets):
    """The diagonals of `banded_spd(n, offsets)`."""
    return tuple(sorted({0, *offsets, *(-o for o in offsets)}))


def _wide_cheb_chunk(n, offsets, dtype, dev, n_it, first, last):
    """A chunk on `banded_spd(n, offsets)` from its 40-iteration schedule:
    bitwise to its twin and to itself."""
    s = banded_spd(n, offsets=offsets, dtype=dtype, device=dev)
    offs = s["offsets"]
    inv_theta, c1, c2 = cheb_coefficients(
        40, *dia_operator_bounds(s["dia_vals"].double().cpu().numpy(), offs))
    rng = np.random.default_rng(n_it)
    z, d = (torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype,
                            device=dev) for _ in range(2))
    c1, c2 = (torch.as_tensor(c[:max(n_it, 1)], dtype=dtype, device=dev)
              for c in (c1, c2))
    args = (s["b"], s["x0"], z, d, 1.0 / s["diag"], s["dia_vals"], c1, c2)
    kw = dict(offsets=offs, n_it=n_it, first=first, last=last,
              inv_theta=inv_theta)
    got = cheb_dia.cheb_dia_chunk(*args, **kw)
    again = cheb_dia.cheb_dia_chunk(*args, **kw)
    want = cheb_dia.cheb_dia_chunk_reference(*args, **kw)
    for g, a, w in zip(got, again, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, a)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_it,first,last", [
    (0, True, False), (7, False, False), (39, True, True)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cheb_dia_kernel_in_the_shared_layout(dtype, n_it, first, last):
    """The chunk on a 20,000-row band reaching 9,000 rows (no window fits
    in shared memory: d in global memory, a cluster barrier an iteration):
    init-only, a middle chunk and a whole 40-iteration solve, bitwise to
    its twin and to itself."""
    dev = _cuda()
    plan = cheb_dia.cheb_plan(20000, dtype, _band(1, 3, 7, 9000))
    assert not plan["vectors_in_smem"] and plan["matrix_in_smem"]
    _wide_cheb_chunk(20000, (1, 3, 7, 9000), dtype, dev, n_it, first, last)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offsets,dtype,window", [
    (40000, (1, 3, 7, 600), torch.float32, True),
    (60000, (1, 3, 7, 9000), torch.float64, False)],
    ids=["window", "shared"])
def test_cheb_dia_kernel_with_the_matrix_in_global_memory(n, offsets, dtype,
                                                          window):
    """Slabs whose diagonals do not fit in shared memory beside the
    vectors, in either layout: a whole 40-iteration solve and a middle
    chunk, bitwise to the twin and to itself."""
    dev = _cuda()
    plan = cheb_dia.cheb_plan(n, dtype, _band(*offsets))
    assert plan["vectors_in_smem"] == window and not plan["matrix_in_smem"]
    for n_it, first, last in ((39, True, True), (7, False, False)):
        _wide_cheb_chunk(n, offsets, dtype, dev, n_it, first, last)


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
    with pytest.raises(RuntimeError, match="nvcc"):
        banded_step.banded_rollout(st.state, st.planes, st.cfg, 1)
    with pytest.raises(RuntimeError, match="nvcc"):
        st.step()  # the stepper's window: no twin on a CUDA tensor
    x = ins[0]
    c = torch.zeros(1, dtype=x.dtype, device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        cheb_dia.cheb_dia_chunk(x, x, x, x, st.planes["invd"],
                                st.planes["dia"], c, c,
                                offsets=st.cfg.dia_offs, n_it=0, first=True,
                                last=True, inv_theta=1.0)


def _stepper_mg_problem(st, dtype):
    """A multigrid stepper's matrix and planes, b N(0,1), x0 its state."""
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (st.n_nodes, 3)), dtype=dtype, device="cuda")
    return {"b": b, "x0": st.state["x"], "dia_vals": st.planes["dia"],
            "offsets": st.cfg.dia_offs, "planes": st.planes,
            "cfg": st.cfg.mg}


MG_PROBLEMS = {
    "beam": lambda dt: _stepper_mg_problem(small_mg_beam(dt)._stepper, dt),
    "sheet": lambda dt: _stepper_mg_problem(
        small_cloth(dt, preconditioner="amg")._stepper, dt),
    "grid 20x15": lambda dt: grid_mg_problem(20, 15, dt),
    # 90,601 rows, ladder (4, 16) (16 corners a transfer); in f64 the
    # slab's diagonals do not fit in shared memory
    "grid 300x300": lambda dt: grid_mg_problem(300, 300, dt),
    # 63,001 rows, ladder (2, 8), 1,024 coarsest dofs: the CTA's rows of
    # A2^-1 do not fit, nor in f64 the diagonals
    "grid 250x250": lambda dt: grid_mg_problem(250, 250, dt),
}
# what the solve's plan keeps in shared memory for each problem: the
# slab's fine diagonals, the CTA's rows of A2^-1 (every layout it can
# pick appears)
MG_RESIDENT = {("grid 300x300", torch.float64): {"a2inv"},
               ("grid 250x250", torch.float64): set(),
               ("grid 250x250", torch.float32): {"matrix"}}


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 8])
@pytest.mark.parametrize("name", list(MG_PROBLEMS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_mg_solve_kernel_is_its_twin(dtype, name, n_iters):
    """The multigrid mode of the cluster solve against its twin: bitwise,
    twice the same, 0 iterations give x0 back, in each layout its plan
    picks (MG_RESIDENT; both parts resident where it names none)."""
    _cuda()
    p = MG_PROBLEMS[name](dtype)
    args = (p["b"], p["x0"], p["dia_vals"], p["offsets"], p["planes"],
            p["cfg"], n_iters)
    n0 = mg.mg_dia_solve.launches
    got = mg.mg_dia_solve(*args)
    again = mg.mg_dia_solve(*args)
    assert mg.mg_dia_solve.launches == n0 + 2
    want = mg.mg_dia_solve_reference(*args)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again) and torch.equal(got, want)
    if n_iters == 0:
        assert torch.equal(got, p["x0"])
    plan = uamg.solve_plan(p["b"].shape[0], len(p["offsets"]),
                           uamg.host_struct(p["planes"], p["cfg"]), dtype)
    resident = {k for k in ("matrix", "a2inv") if plan[f"{k}_in_smem"]}
    assert resident == MG_RESIDENT.get((name, dtype), {"matrix", "a2inv"})
    # the fine stages fused where a slab takes more than two passes of a
    # CTA's 1,024 threads (grid 250x250 and 300x300)
    assert plan["fused"] == (-(-p["b"].shape[0] // 16) > 2 * 1024)
    assert plan["cluster_barriers_per_iteration"] == (5 if plan["fused"]
                                                      else 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_mg_window_is_its_twin(dtype):
    """The 6 x 5 x 4 beam on the banded window's multigrid mode, one
    10-step window: bitwise."""
    _cuda()
    st = small_mg_beam(dtype)._stepper
    assert st.cfg.mg is not None
    _window_is_its_twin(banded_step.banded_rollout,
                        banded_step.banded_rollout_reference,
                        banded_step.STATE, st, st.planes, st.cfg, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cloth_mg_window_is_its_twin(dtype):
    """The 8 x 6 sheet on the cloth window's multigrid mode, one 10-step
    window: bitwise."""
    _cuda()
    st = small_cloth(dtype, preconditioner="amg")._stepper
    assert st.cfg.mg is not None
    _window_is_its_twin(cloth_step.cloth_rollout,
                        cloth_step.cloth_rollout_reference,
                        cloth_step.STATE, st, st.planes, st.cfg, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tet100k", "cloth100k"])
def test_mg_windows_every_step_is_the_twins(name):
    """tet100k and cloth100k at mg8 in f32, 20 graph replays of one step,
    each held bitwise to the twin from the same state: a race shows as a
    step that now and then disagrees (the solve once read its staged
    matrix rows before every thread of its CTA had written them)."""
    _cuda()
    make = scenes.tet100k if name == "tet100k" else scenes.cloth100k
    st = make(8, torch.float32, amg=True)._stepper
    run = (banded_step if name == "tet100k" else cloth_step)
    for step in range(20):
        start = {k: st.state[k].clone() for k in run.STATE}
        st.step()
        want = (run.banded_rollout_reference if name == "tet100k"
                else run.cloth_rollout_reference)(start, st.planes, st.cfg, 1)
        for k in run.STATE:
            assert torch.equal(st.state[k], want[k]), (step, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_uamg_solve_kernel_is_its_twin(dtype, n_iters):
    """The algebraic multigrid mode of the cluster solve on the small uAMG
    scene's own matrix and planes, b N(0,1), from its state: bitwise to
    the twin, twice the same, 0 iterations give x0 back. Its plan keeps
    the rows of A2^-1 in shared memory (ELL rows stream from L2), as at
    delaunay100k."""
    _cuda()
    st = small_uamg(8, dtype)._stepper
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (st.n_nodes, 3)), dtype=dtype, device="cuda")
    args = (b, st.state["x"], st.planes["ell_idx"], st.planes["ell_vals"],
            st.planes, st.cfg.mg, n_iters)
    n0 = uamg.uamg_ell_solve.launches
    got = uamg.uamg_ell_solve(*args)
    again = uamg.uamg_ell_solve(*args)
    assert uamg.uamg_ell_solve.launches == n0 + 2
    want = uamg.uamg_ell_solve_reference(*args)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again) and torch.equal(got, want)
    if n_iters == 0:
        assert torch.equal(got, st.state["x"])
    plan = uamg.solve_plan(st.n_nodes, 0, uamg.host_struct(st.planes,
                                                           st.cfg.mg), dtype)
    assert not plan["matrix_in_smem"] and plan["a2inv_in_smem"]
    assert plan["cluster_barriers_per_iteration"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_uamg_window_steps_are_the_twins(dtype):
    """The small uAMG scene on the banded window's ELL mode with the
    algebraic multigrid: a 10-step window bitwise, then 20 graph replays
    of one step, each held bitwise to the twin from the same state."""
    _cuda()
    st = small_uamg(8, dtype)._stepper
    _window_is_its_twin(banded_step.banded_rollout,
                        banded_step.banded_rollout_reference,
                        banded_step.STATE, st, st.planes, st.cfg, 10)
    for step in range(20):
        start = {k: st.state[k].clone() for k in banded_step.STATE}
        st.step()
        want = banded_step.banded_rollout_reference(start, st.planes, st.cfg,
                                                    1)
        for k in banded_step.STATE:
            assert torch.equal(st.state[k], want[k]), (step, k)


@pytest.mark.cuda
def test_general_amg_route_card_vs_cpu():
    """The general route's aggregation AMG (small_uamg(fast=False)), f64,
    5 steps: the card within 1e-8 of the CPU run, and two card runs
    bitwise the same."""
    _cuda()

    def run(device):
        s = small_uamg(8, torch.float64, device, fast=False)
        assert s._stepper is None and "amg" in s.params["_solver"]
        s.run(5)
        return s.x, s.v

    xc, _ = run("cpu")
    (x1, v1), (x2, v2) = run("cuda"), run("cuda")
    assert np.abs(x1 - xc).max() < 1e-8
    assert np.array_equal(x1, x2) and np.array_equal(v1, v2)


# the fused element steps' emit_z mode: (kernel, twin, planes, vectors,
# the gathered positions as a mesh); nh_local_step_fused's is tested with
# its entry above
EMIT_Z = {
    "arap_local_step_fused": (tet_local.arap_local_step_fused,
                              tet_local.arap_local_step_fused_reference,
                              (12, 9, 12), 2, True),
    "tri_local_step_fused": (tri_local.tri_local_step_fused,
                             tri_local.tri_local_step_fused_reference,
                             (9, 6, 6), 4, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EMIT_Z))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_emit_z_kernel_is_its_twin(dtype, name):
    """The z block and every other output bitwise to the twin's, and the
    other outputs bitwise to the launch without emit_z (the ARAP step's
    rows are 6 wide with it, the triangle step's z rows a block more)."""
    dev = _cuda()
    kernel, twin, planes, vectors, mesh = EMIT_Z[name]
    ins = _element_inputs(planes, vectors, dtype, dev)
    if mesh:
        ins = _unshared(ins)
    n0 = kernel.residual_launches
    got = kernel(*ins, emit_z=True)
    assert kernel.residual_launches == n0 + 1
    for g, w in zip(got, twin(*ins, emit_z=True)):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    off = kernel(*ins)
    assert all(torch.equal(g[..., :o.shape[-1]], o)
               for g, o in zip(got, off))


# the collecting windows: stepper maker, wrapper, twin, state keys
COLLECTING = {
    "banded": (lambda dt: jittered_system(dtype=dt)._stepper, banded_step),
    "banded arap": (lambda dt: beam_system((4, 3, 3), 0.25, 2.0, 25, dt,
                                           "cuda", fast=True,
                                           arap=True)._stepper, banded_step),
    "banded ell": (lambda dt: small_delaunay(25, dt, "cuda",
                                             fast=True)._stepper,
                   banded_step),
    "banded mg": (lambda dt: small_mg_beam(dt)._stepper, banded_step),
    "banded uamg": (lambda dt: small_uamg(8, dt)._stepper, banded_step),
    "cloth": (lambda dt: small_cloth(dt)._stepper, cloth_step),
    "cloth mg": (lambda dt: small_cloth(dt, preconditioner="amg")._stepper,
                 cloth_step),
}


def _rollout(mod):
    if mod is banded_step:
        return mod.banded_rollout, mod.banded_rollout_reference
    return mod.cloth_rollout, mod.cloth_rollout_reference


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["primal", "full"])
@pytest.mark.parametrize("name", list(COLLECTING))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_window_residuals_are_the_twins(dtype, name, collect):
    """A 10-step window in a residual mode: its residuals and state bitwise
    to the twin's, its state bitwise to the window without collection."""
    _cuda()
    make, mod = COLLECTING[name]
    run, twin = _rollout(mod)
    st = make(dtype)
    cfg = dataclasses.replace(st.cfg, collect=collect)
    n0 = run.residual_launches
    got = run(st.state, st.planes, cfg, 10)
    assert run.residual_launches == n0 + 1
    want = twin(st.state, st.planes, cfg, 10)
    off = run(st.state, st.planes, dataclasses.replace(cfg, collect=None), 10)
    res = ["primal"] + (["dual"] if collect == "full" else [])
    for k in res:
        assert got[k].shape == (10, st.cfg.admm_iters)
        assert bool(torch.isfinite(got[k]).all()) and bool(
            (got[k] > 0).any())
    for k in (*mod.STATE, *res):
        assert torch.equal(got[k], want[k]), k
    for k in mod.STATE:
        assert torch.equal(got[k], off[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["primal", True])
@pytest.mark.parametrize("name", list(COLLECTING))
def test_collecting_graph_replay_is_eager_launches(name, collect):
    """A collecting stepper's graphs (a step, a 10-step run) against the
    eager windows: state and the host copies of the residuals bitwise;
    switching collection off recaptures and steps on the same state."""
    _cuda()
    make, mod = COLLECTING[name]
    run, _ = _rollout(mod)
    st = make(torch.float64)
    st.run(10)  # windows captured without collection
    st.collect_residuals = collect
    start = {k: st.state[k].clone() for k in mod.STATE}
    st.step()
    one = (st.last_primal, st.last_dual)
    st.run(10)
    w1 = run(start, st.planes, st.cfg, 1)
    w10 = run({k: w1[k] for k in mod.STATE}, st.planes, st.cfg, 10)
    for k in mod.STATE:
        assert torch.equal(st.state[k], w10[k]), k
    assert np.array_equal(one[0], w1["primal"].cpu().numpy())
    assert np.array_equal(st.last_primal, w10["primal"].cpu().numpy())
    if collect is True:
        assert np.array_equal(one[1], w1["dual"].cpu().numpy())
        assert np.array_equal(st.last_dual, w10["dual"].cpu().numpy())
    else:
        assert st.last_dual is None
    st.collect_residuals = False
    start = {k: st.state[k].clone() for k in mod.STATE}
    st.run(10)
    want = run(start, st.planes, st.cfg, 10)
    assert st.last_primal is None
    for k in mod.STATE:
        assert torch.equal(st.state[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tet100k", "cloth100k"])
def test_collecting_windows_every_step_is_the_twins(name):
    """tet100k and cloth100k at cg25 in f32 collecting both residuals: 20
    graph replays of one step, each held bitwise to the twin from the
    same state (state and residuals)."""
    _cuda()
    make = scenes.tet100k if name == "tet100k" else scenes.cloth100k
    kw = {"fast": True} if name == "tet100k" else {}
    st = make(25, torch.float32, **kw)._stepper
    mod = banded_step if name == "tet100k" else cloth_step
    _, twin = _rollout(mod)
    st.collect_residuals = True
    for step in range(20):
        start = {k: st.state[k].clone() for k in mod.STATE}
        st.step()
        want = twin(start, st.planes, st.cfg, 1)
        for k in mod.STATE:
            assert torch.equal(st.state[k], want[k]), (step, k)
        assert np.array_equal(st.last_primal, want["primal"].cpu().numpy())
        assert np.array_equal(st.last_dual, want["dual"].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["nh", "stvk", "arap"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_banded_local_collect_is_its_twin(dtype, model):
    """banded_local_rhs with collect: r2 and every output bitwise to the
    twin; the outputs bitwise to the call without collect."""
    dev = _cuda()
    st, ins = _local_inputs(model, dtype, dev)
    n0 = banded_local.banded_local_rhs.residual_launches
    got = banded_local.banded_local_rhs(*ins, st.planes, st.cfg,
                                        collect=True)
    assert banded_local.banded_local_rhs.residual_launches == n0 + 1
    want = banded_local.banded_local_rhs_reference(*ins, st.planes, st.cfg,
                                                   collect=True)
    off = banded_local.banded_local_rhs(*ins, st.planes, st.cfg)
    assert got[-1].shape == () and float(got[-1]) > 0.0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, o in zip(got, off):
        assert torch.equal(g, o)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["dia", "ell"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_sharded_steps_are_the_plain_composition(dtype, scene):
    """The sharded stepper at one device on the card, pallas backend
    (banded_local_rhs writing its two alternating sets of buffers, then the
    cluster solve), against its xla backend (the plain composition) on the
    same card: 3 steps, every state tensor bitwise after each."""
    _cuda()
    s = (jittered_system((4, 3, 3), 25, dtype, "cuda") if scene == "dia"
         else small_delaunay(25, dtype, "cuda"))
    kern, _ = sharded_banded_from_system(s)
    plain, _ = sharded_banded_from_system(s, backend="xla")
    assert kern.backend == "pallas"
    n0 = banded_local.banded_local_rhs.launches
    for step in range(3):
        kern.step()
        plain.step()
        for k in ("x", "v", "u", "warm", "au", "cu"):
            assert torch.equal(kern.state[k], plain.state[k]), (step, k)
    assert banded_local.banded_local_rhs.launches == n0 + 3 * kern.admm_iters


# the small sweeps of the card checks (scenes.jittered_sweep: 3 scenarios,
# 4 ADMM iterations of cg10, which keeps the twin's host-bound dots few)
SWEEPS = {
    "dia nh": {"solver": "dia"},
    "ell nh": {"solver": "ell"},
    "dia arap anchors floor": {"solver": "dia", "model": "arap",
                               "anchor_sweep": True, "floor": True},
    "ell stvk anchors floor": {"solver": "ell", "model": "stvk",
                               "anchor_sweep": True, "floor": True},
}


def _sweep(dtype=torch.float64, **kw):
    return scenes.jittered_sweep(3, dtype=dtype, cg=10, admm=4, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SWEEPS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_sweep_window_is_its_twin(dtype, name):
    """A sweep of 3 jittered beams, one 3-step window: bitwise to its
    twin, and each scenario bitwise to a single-scenario window fed that
    scenario's planes from its state."""
    _cuda()
    sw = _sweep(dtype, **SWEEPS[name])
    keys = banded_step.STATE
    got = banded_step.banded_rollout(sw.state, sw.planes, sw.cfg, 3)
    want = banded_step.banded_rollout_reference(sw.state, sw.planes, sw.cfg,
                                                3)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    for s in range(sw.n_scen):
        one = sw.scenario(s)
        single = banded_step.banded_rollout(one.state, one.planes, one.cfg, 3)
        for k in keys:
            assert torch.equal(single[k], got[k][s]), (s, k)
    assert float((got["x"][0] - got["x"][-1]).abs().max()) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["primal", "full"])
@pytest.mark.parametrize("solver", ["dia", "ell"])
def test_sweep_residuals_are_the_twins(solver, collect):
    """The sweep window's residual modes in f64: (S, n_steps, admm_iters)
    residuals and state bitwise to the twin; the state bitwise to the
    window without collection."""
    _cuda()
    sw = _sweep(solver=solver, anchor_sweep=True, floor=True)
    cfg = dataclasses.replace(sw.cfg, collect=collect)
    got = banded_step.banded_rollout(sw.state, sw.planes, cfg, 2)
    want = banded_step.banded_rollout_reference(sw.state, sw.planes, cfg, 2)
    off = banded_step.banded_rollout(sw.state, sw.planes, sw.cfg, 2)
    assert got["primal"].shape == (3, 2, cfg.admm_iters)
    for k in (*banded_step.STATE, "primal",
              *(("dual",) if collect == "full" else ())):
        assert torch.equal(got[k], want[k]), k
    for k in banded_step.STATE:
        assert torch.equal(got[k], off[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dia", "ell"])
def test_sweep_graph_steps_are_the_twins(solver):
    """A SweepStepper's graph replays in f32, one step at a time for 5
    steps, each bitwise to the twin from the same state; a 10-step run is
    one submission."""
    _cuda()
    sw = _sweep(torch.float32, solver=solver)
    keys = banded_step.STATE
    for step in range(5):
        start = {k: sw.state[k].clone() for k in keys}
        sw.step()
        want = banded_step.banded_rollout_reference(start, sw.planes, sw.cfg,
                                                    1)
        for k in keys:
            assert torch.equal(sw.state[k], want[k]), (step, k)
    n0 = banded_step.banded_rollout.launches
    sw.run(10)
    assert banded_step.banded_rollout.launches == n0 + 1


# the default element backend ('xla', plain PyTorch): small scenes on the
# card against their CPU runs, f64. The hyperelastic beam runs 2 Newton
# iterations, short of the minimum, where the packages' last-ulp
# differences in exp, log and sqrt cannot meet a tie of candidate values
XLA_SCENES = {
    "nh beam dia": lambda d: beam_system(
        (4, 3, 3), 0.05, 1.0, 25, torch.float64, d, backend="xla"),
    "arap beam dense": lambda d: beam_system(
        (4, 3, 3), 0.05, 1.0, None, torch.float64, d, arap=True,
        global_solver="dense", backend="xla"),
    "cloth 8x6 cg": lambda d: small_cloth(torch.float64, d, fast=False,
                                          global_solver="cg",
                                          backend="xla"),
}


def _xla_nh_two_iterations(s):
    for f in s.forces:
        if hasattr(f, "max_iters"):
            f.max_iters = 2
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(XLA_SCENES))
def test_xla_backend_on_the_card_matches_cpu(name):
    """A default-constructed scene steps on the card within 1e-10 of its
    CPU run (f64, 5 steps) on the general route, and launches no element
    kernel."""
    _cuda()
    runs = []
    for device in ("cpu", "cuda"):
        s = _xla_nh_two_iterations(XLA_SCENES[name](device))
        assert s._stepper is None
        assert all(getattr(f, "backend", "xla") == "xla" for f in s.forces)
        n0 = nh_local.nh_local_step_fused.launches + \
            tet_local.arap_local_step.launches + \
            tri_local.tri_local_step.launches
        s.run(5)
        assert n0 == nh_local.nh_local_step_fused.launches + \
            tet_local.arap_local_step.launches + \
            tri_local.tri_local_step.launches
        runs.append(s.x)
    assert np.isfinite(runs[1]).all()
    assert np.abs(runs[1] - runs[0]).max() < 1e-10


@pytest.mark.cuda
def test_xla_backend_leaves_no_tensor_off_the_card():
    """The default backend's step on the card copies nothing to the host
    and synchronises with it nowhere (torch's sync debug mode raises on
    either), and every tensor of its state and params stays on the card."""
    _cuda()
    s = _xla_nh_two_iterations(XLA_SCENES["nh beam dia"]("cuda"))
    s.step()  # the solve's one-time set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.run(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    def tensors(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from tensors(v)
        elif isinstance(tree, torch.Tensor):
            yield tree

    assert all(t.is_cuda for t in tensors(s.state))
    assert all(t.is_cuda for t in tensors(s.params))
