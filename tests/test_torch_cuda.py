"""Hand-written kernels against their plain twins on a CUDA device: those of
the ell routes, the element steps of the unfused pipeline and of
LinearTetStrain, the banded and lattice whole-timestep windows, and the
sharded banded stepper's local phase (banded_local_rhs) and Chebyshev
chunk (cheb_dia_chunk). Every case is marked `cuda` and skips without a card. This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed (tests/conftest.py sets JAX up, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The twins of cg_update, cg_dia_solve and cg_ell_solve add in the
kernels' order (`chain_dot`, `cluster_dot`, `dia_apply`,
`ell_apply_by_slot`), so the kernels must repeat them bitwise, the two
cluster solves at any n (`scenes.banded_spd`: fewer rows than CTAs, a
last slab cut short, windows too large for shared memory, a random
numbering). The banded and lattice windows (element kernel, vertex
kernel, the cluster solve, every ADMM iteration) repeat their twins
bitwise too, in every mode, and a stepper's CUDA graph replays the same
bits as the window's eager launches. The element steps
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
                                                banded_step, cg_dia, cg_ell,
                                                cg_step, cheb_dia,
                                                lattice_step, nh_local,
                                                tet_local, tri_local)
from admm_elastic_tpu_torch.parallel.cheb import (cheb_coefficients,
                                                  dia_operator_bounds)
from admm_elastic_tpu_torch.utils import scenes
from admm_elastic_tpu_torch.utils.scenes import (banded_spd, beam_system,
                                                 jittered_system,
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
    """A window (run: banded_rollout or lattice_rollout) from the
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


STEPPERS = {
    "banded": (lambda dt: jittered_system(dtype=dt)._stepper,
               banded_step.banded_rollout, banded_step.STATE),
    "banded ell": (lambda dt: small_delaunay(25, dt, "cuda",
                                             fast=True)._stepper,
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
