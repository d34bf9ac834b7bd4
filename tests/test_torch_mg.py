"""The in-kernel geometric multigrid of the banded and cloth windows
(`preconditioner="amg"`): the port's host builder (core/mg.py), its plain
V-cycle and PCG (ops/kernels/mg.py, the kernel's twin), the two windows'
multigrid routes and their routing, against the JAX package, f64, CPU.

Tolerances:
- planes and V-cycle against JAX's `build_grid_mg` and `vcycle_np`:
  1e-12 (the same numpy hierarchy; the V-cycle's sums in another order);
- the twins' V-cycle PCG against a numpy PCG on `vcycle_np`: 1e-12;
- the banded MG route after 4 steps within 1e-5 m of the port's exact
  (dense) route, where Jacobi at the same budget is not (as
  tests/test_mg_kernel.py holds JAX's);
- the routes against JAX's MG routes (Pallas interpret mode, one System
  per window, module-scoped), 2 steps: 1e-8 (tests/test_torch_banded_ref.py
  on the banded route's Newton ties; the cloth kernels' matvecs add the
  diagonals in different orders);
- routing: JAX's route, or JAX's errors word for word; under 'dia' with
  relaxation (the kernels off) both packages build the general AMG and
  step the Jacobi dia solve: x within 1e-8 of JAX's, and bitwise the
  port's Jacobi route."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core import mg as jmg
from admm_elastic_tpu_torch.core import mg as pmg
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu_torch.core.cloth import (MG_LADDERS, MG_MAX_NP2,
                                               ClothStepper, ladder_mg)
from admm_elastic_tpu_torch.core.solver import _assemble_A_hat_csr, dia_apply
from admm_elastic_tpu_torch.ops.kernels import mg as kmg
from admm_elastic_tpu_torch.utils.scenes import beam_system
from test_torch_cloth import cloth
from test_torch_routing import ROUTES, SCENES
from torch_banded_scenes import build

torch.set_num_threads(1)

TOL = 1e-12
ROUTE_TOL = 1e-8


def _sheet(nx, ny):
    """A planar grid's vertices and an SPD matrix on them: the cloth
    scene's own A_hat on small sheets."""
    s = cloth(pt, False, nx=nx, ny=ny, wind=False)
    return s._x, _A(s)


def _A(s):
    """A System's A_hat (CSR) from its host parameters."""
    cp = {k: s._params_host[k] for k in s._constraint_names}
    return _assemble_A_hat_csr(s.n_nodes, s._m, s.settings.timestep_s, cp)


@pytest.fixture(scope="module")
def beam():
    s = beam_system((6, 5, 4), 0.05, 50.0, None, torch.float64,
                    device="cpu")
    return s._x, _A(s), (2, 4), jmg.NP2_ROWS


@pytest.fixture(scope="module")
def sheet():
    x, A = _sheet(8, 6)
    return x, A, (2, 4), MG_MAX_NP2


@pytest.fixture(scope="module", params=["beam", "sheet"])
def grid(request, beam, sheet):
    """(vertices, A, ladder, JAX np2_rows, port MG, JAX planes, meta)."""
    x, A, ladder, np2 = {"beam": beam, "sheet": sheet}[request.param]
    n_pad = -(-len(x) // 1024) * 1024
    jp, jm = jmg.build_grid_mg(A, x, n_pad, min_nodes=0,
                               level_strides=ladder, np2_rows=np2)
    mine = pmg.build_grid_mg(A, x, ladder, max_coarse=np2 * jmg.LANES)
    return x, A, n_pad, mine, jp, jm


def _jax_pack(planes, meta, x):
    """`vcycle_np`'s pack (core/mg.py:391-403): two lane gathers and the
    row-range sums."""
    x2 = x.reshape(-1, jmg.LANES)
    out = np.zeros((meta["np2_rows"], jmg.LANES))
    for w, ranges in ((0, meta["rangesA"]), (1, meta["rangesB"])):
        g = planes["pack_mask"][w] * np.take_along_axis(
            x2, planes["pack_idx"][w].astype(np.int64), axis=1)
        for cr, (lo, hi) in enumerate(ranges):
            if hi > lo:
                out[cr] += g[lo:hi].sum(0)
    return out.ravel()


def test_planes_match_jax(grid):
    """Offsets, level-1 values, omega D^-1, the corner masks and the
    coarsest inverse equal JAX's (its pad columns 0); JAX's pack is r2 at
    rp2 and its MXU blocks hold the same inverse."""
    x, _, n_pad, mine, jp, jm = grid
    n = len(x)
    assert mine["levels"] == jm["levels"]
    for k in ("l1_offs", "t0_offs", "t1_offs"):
        assert mine[k] == jm[k], k
    for k in ("l1_vals", "t0_masks", "t1_masks", "om_invd0", "om_invd1"):
        np.testing.assert_allclose(mine[k], jp[k][..., :n], rtol=0,
                                   atol=TOL, err_msg=k)
        assert not np.asarray(jp[k][..., n:]).any(), k
    assert mine["om_invd0"].max() > 0 and mine["om_invd1"].max() > 0
    nc2 = jm["nc2"]
    rp2 = _jax_pack(jp, jm, np.arange(n_pad) + 1.0)[:nc2] - 1
    np.testing.assert_array_equal(mine["rp2"], rp2)
    np2 = jm["np2_rows"]
    B = jp["a2inv_blocks"].reshape(np2, np2, jmg.LANES, jmg.LANES)
    a2 = B.transpose(1, 3, 0, 2).reshape(np2 * jmg.LANES, -1)
    np.testing.assert_allclose(mine["a2inv"], a2[:nc2, :nc2], rtol=0,
                               atol=TOL * np.abs(a2).max())


def _fine(A, n, n_pad):
    """A's diagonals: offsets and (D, n_pad) values, 0 past n (JAX's
    planes; the port's are the first n columns)."""
    coo = A.tocoo()
    offs = np.unique(coo.col - coo.row)
    vals = np.zeros((len(offs), n_pad))
    np.add.at(vals, (np.searchsorted(offs, coo.col - coo.row), coo.row),
              coo.data)
    return tuple(int(o) for o in offs), vals


def test_vcycle_matches_jax(grid):
    """The twin's V-cycle on three columns equals `vcycle_np` on each, and
    is symmetric and positive."""
    x, A, n_pad, mine, jp, jm = grid
    n = len(x)
    offs, vals = _fine(A, n, n_pad)
    planes = kmg.planes_from(mine, torch.float64, "cpu")
    cfg = kmg.MGConfig.of(mine)
    fine = torch.as_tensor(vals[:, :n])

    def V(r):
        return kmg.vcycle(torch.as_tensor(r), lambda y: dia_apply(y, offs,
                                                                 fine),
                          planes, cfg).numpy()

    rng = np.random.default_rng(0)
    r = rng.standard_normal((n, 3))
    z = V(r)
    for c in range(3):
        rp = np.zeros(n_pad)
        rp[:n] = r[:, c]
        want = jmg.vcycle_np(jp, jm, offs, vals, rp)
        np.testing.assert_allclose(z[:, c], want[:n], rtol=0,
                                   atol=TOL * np.abs(want).max())
    s = rng.standard_normal((n, 3))
    a, b = np.sum(V(s) * r), np.sum(s * z)
    assert abs(a - b) < 1e-10 * max(abs(a), 1.0)
    assert np.sum(r * z) > 0


def test_pcg_matches_numpy(grid):
    """`mg_dia_solve_reference` (the windows' solve twin) against a numpy
    PCG on `vcycle_np`, 8 iterations from a nonzero start."""
    x, A, n_pad, mine, jp, jm = grid
    n = len(x)
    offs, vals = _fine(A, n, n_pad)
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((n, 3))
    b = A @ xt
    x0 = xt + 0.1 * rng.standard_normal((n, 3))
    got = kmg.mg_dia_solve(
        torch.as_tensor(b), torch.as_tensor(x0),
        torch.as_tensor(np.ascontiguousarray(vals[:, :n])),
        offs, kmg.planes_from(mine, torch.float64, "cpu"),
        kmg.MGConfig.of(mine), 8).numpy()

    def V(r):
        out = np.zeros_like(r)
        for c in range(3):
            rp = np.zeros(n_pad)
            rp[:n] = r[:, c]
            out[:, c] = jmg.vcycle_np(jp, jm, offs, vals, rp)[:n]
        return out

    xs = x0.copy()
    r = b - A @ xs
    z = V(r)
    p, rz = z, np.sum(r * z)
    for _ in range(8):
        Ap = A @ p
        alpha = rz / np.sum(p * Ap)
        xs = xs + alpha * p
        r = r - alpha * Ap
        z = V(r)
        rzn = np.sum(r * z)
        p, rz = z + (rzn / rz) * p, rzn
    np.testing.assert_allclose(got, xs, rtol=0, atol=TOL)
    assert np.abs(got - xt).max() < 1e-3 * np.abs(x0 - xt).max()


def test_ladder_matches_jax():
    """The cloth kernel's ladder search takes JAX's choice: the first of
    MG_LADDERS whose coarsest level fits 8 x 128 dofs ((2, 4) on a small
    sheet; (2, 8) once (2, 4)'s 33 x 33 coarsest is too large)."""
    import scipy.sparse as sp

    for (nx, ny), want in (((8, 6), (2, 4)), ((129, 129), (2, 8))):
        gx, gy = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1))
        verts = np.stack([gx.ravel(), gy.ravel(), 0 * gx.ravel()], 1) * 0.1
        n = len(verts)
        lap = sp.diags([-1.0, -1.0, 4.5, -1.0, -1.0],
                       [-(nx + 1), -1, 0, 1, nx + 1], shape=(n, n)).tocsr()
        got = ladder_mg(lap, verts)
        assert got["level_strides"] == want
        jax_pick = next(ld for ld in MG_LADDERS if jmg.build_grid_mg(
            lap, verts, -(-n // 1024) * 1024, min_nodes=0, level_strides=ld,
            np2_rows=MG_MAX_NP2) is not None)
        assert jax_pick == want


def test_banded_mg_tracks_exact_solve():
    """The banded MG route at 8 iterations stays within 1e-5 m of the
    exact (dense) route for 4 steps; Jacobi at the same budget does not
    (tests/test_mg_kernel.py:102-129, without the residuals)."""
    def beam(**kw):
        return beam_system((10, 8, 7), 0.05, 50.0, 8, torch.float64,
                           device="cpu", admm_iters=8, **kw)

    mg = beam(fast=True, preconditioner="amg")
    jac = beam(fast=True)
    exact = beam(global_solver="dense")
    assert mg._stepper.cfg.mg is not None and jac._stepper.cfg.mg is None
    assert exact._solver_mode == "dense"
    worst_mg = worst_jac = 0.0
    for _ in range(4):
        for s in (mg, jac, exact):
            s.step()
        worst_mg = max(worst_mg, np.abs(mg.x - exact.x).max())
        worst_jac = max(worst_jac, np.abs(jac.x - exact.x).max())
    assert worst_mg < 1e-5, worst_mg
    assert worst_jac > 1e-5, worst_jac


# ------------------------------------------------ the routes against JAX

def _jax_banded_beam():
    return build(aet, aet.geometry.make_beam_tets(6, 5, 4, size=0.05),
                 fast=True, cg=None, preconditioner="amg")


@pytest.fixture(scope="module")
def jax_banded():
    s = _jax_banded_beam()
    assert s._lattice._mg_meta_static is not None
    s.run(2)
    return np.asarray(s.x), np.asarray(s.v)


@pytest.fixture(scope="module")
def jax_cloth():
    s = cloth(aet, True, preconditioner="amg", cg=None)
    assert s._lattice._mg_meta_static is not None
    s.run(2)
    return np.asarray(s.x), np.asarray(s.v), s._lattice.mg_levels


def test_banded_route_matches_jax(jax_banded):
    x, v = jax_banded
    s = build(pt, pt.geometry.make_beam_tets(6, 5, 4, size=0.05), fast=True,
              cg=None, preconditioner="amg")
    st = s._stepper
    assert isinstance(st, BandedStepper) and st.cfg.cg_iters == 8
    assert st.cfg.mg is not None and st.mg_levels == (210, 36, 8)
    s.run(2)
    assert np.abs(s.x - x).max() < ROUTE_TOL
    assert np.abs(s.v - v).max() < ROUTE_TOL / s.settings.timestep_s


def test_cloth_route_matches_jax(jax_cloth):
    x, v, levels = jax_cloth
    s = cloth(pt, True, preconditioner="amg", cg=None)
    st = s._stepper
    assert isinstance(st, ClothStepper) and st.cfg.cg_iters == 10
    assert st.cfg.mg is not None and st.mg_levels == tuple(levels)
    s.run(2)
    assert np.abs(s.x - x).max() < ROUTE_TOL
    assert np.abs(s.v - v).max() < ROUTE_TOL


# ---------------------------------------------------------------- routing

AMG = dict(preconditioner="amg")
# name: (the routing table's scene, Settings over it, JAX's outcome,
# the port's): a route, or an exception class
AMG_SCENES = {
    "beam dia": ("beam dia", AMG, "banded", "banded"),
    "cloth dia": ("cloth dia", AMG, "cloth", "cloth"),
    "jittered beam dia": ("jittered beam dia", AMG, ValueError, ValueError),
    "beam dense": ("beam auto (dense)", AMG, ValueError, ValueError),
    "beam cg": ("beam cg", AMG, ValueError, ValueError),
    "beam dia no fast path": ("beam dia", dict(AMG, lattice_fast_path=False),
                              ValueError, ValueError),
    "beam ell fused no fast path": (
        "beam ell", dict(AMG, lattice_fast_path=False, cg_backend="fused"),
        ValueError, ValueError),
    "beam ell (algebraic MG)": ("beam ell", AMG, "banded", "banded"),
    "beam ell xla no fast path (general AMG)": (
        "beam ell", dict(AMG, lattice_fast_path=False), "general",
        "general"),
    "beam dia relaxation (general AMG)": (
        "beam dia", dict(AMG, relaxation=1.6), "general", "general"),
    "beam dia relaxation fused": (
        "beam dia", dict(AMG, relaxation=1.6, cg_backend="fused"),
        ValueError, ValueError),
}


def _scene(pkg, name, extra):
    """A routing-table scene (tests/test_torch_routing.py) with `extra`
    Settings, not initialized."""
    scene, kw, settings = SCENES[name][:3]
    common = {**dict(timestep_s=0.04, admm_iters=3, verbose=0,
                     cg_fixed_iters=10, lattice_fast_path=True),
              **settings, **extra}
    s = (aet.System(aet.Settings(dtype=jnp.float64, **common)) if pkg is aet
         else pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                    **common)))
    scene(pkg, s, **kw)
    return s


def _outcome(pkg, name, extra):
    """The route of a routing-table scene with `extra` Settings, or the
    exception initialize raises: (route or class, message)."""
    s = _scene(pkg, name, extra)
    try:
        s.initialize()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    stepper = s._lattice if pkg is aet else s._stepper
    return (ROUTES[type(stepper).__name__] if stepper is not None
            else "general"), None


@pytest.mark.parametrize("name", list(AMG_SCENES))
def test_amg_routing_matches_jax(name):
    scene, extra, want_jax, want = AMG_SCENES[name]
    got_jax, msg_jax = _outcome(aet, scene, extra)
    got, msg = _outcome(pt, scene, extra)
    assert got_jax == want_jax, msg_jax
    assert got == want, msg
    if want is ValueError:
        assert msg == msg_jax


def test_dia_relaxation_amg_runs_jacobi():
    """JAX's quirk, kept: 'dia' + relaxation + 'amg' builds the general
    AMG (the kernels are off, so its fallback) and steps the Jacobi dia
    solve. x within 1e-8 of JAX's after 3 steps, and bitwise the port's
    run of the same scene under 'jacobi'."""
    extra = dict(AMG, relaxation=1.6)
    runs = [_scene(aet, "beam dia", extra), _scene(pt, "beam dia", extra),
            _scene(pt, "beam dia", dict(extra, preconditioner="jacobi"))]
    for s in runs:
        s.initialize()
        s.run(3)
    j, s, jac = runs
    assert j._amg_meta is not None and "amg" in s.params["_solver"]
    assert "amg" not in jac.params["_solver"]
    assert np.abs(s.x - np.asarray(j.x)).max() < ROUTE_TOL
    assert np.array_equal(s.x, jac.x)


def test_lattice_skipped_under_amg(monkeypatch):
    """With the banded kernel out of the way, a beam takes the lattice
    kernel under Jacobi, and under 'amg' (the lattice kernel has no
    multigrid) JAX's ValueError, in both packages."""
    import admm_elastic_tpu.core.banded as jb
    import admm_elastic_tpu_torch.core.system as ps

    monkeypatch.setattr(jb, "banded_from_system", lambda system: None)
    monkeypatch.setattr(ps, "banded_from_system", lambda system: None)
    assert _outcome(aet, "beam dia", {})[0] == "lattice"
    assert _outcome(pt, "beam dia", {})[0] == "lattice"
    got_jax, msg_jax = _outcome(aet, "beam dia", AMG)
    got, msg = _outcome(pt, "beam dia", AMG)
    assert got_jax is got is ValueError and msg == msg_jax
