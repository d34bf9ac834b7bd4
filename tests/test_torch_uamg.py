"""The in-kernel algebraic multigrid of the banded window's ELL mode
(`preconditioner="amg"` under `global_solver="ell"`): the port's host
hierarchy (core/uamg.py), its plain V-cycle and PCG (ops/kernels/uamg.py, the
kernel's twin) and the banded-ELL uAMG route, against the JAX package,
f64, CPU.

Tolerances:
- the fine layout's positions, the aggregates of both levels: equal;
- A1 1e-12, A2^-1 1e-10, omega D^-1 of both levels 1e-12, relative to
  each array's largest magnitude (the same numpy arithmetic; A2^-1 through
  an inverse of a matrix whose condition spreads round-off);
- the twin's V-cycle against `vcycle_np` on the uell layout (JAX's fine
  matvec, vectors mapped through the positions): 1e-12 relative (the same
  cycle, its sums in other orders), and symmetric to 1e-10;
- the route against JAX's uell BandedStepper with its in-kernel algebraic
  multigrid (Pallas interpret mode, once per module, ~35 s), 3 steps: x
  within 1e-8 (tests/test_torch_banded_ref.py's tolerance on the banded
  route's Newton ties)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from admm_elastic_tpu.core import uamg as ju
from admm_elastic_tpu.core.uell import LANES, uell_matvec_np
from admm_elastic_tpu_torch.core import uamg as pu
from admm_elastic_tpu_torch.core.amg import _csr_to_ell
from admm_elastic_tpu_torch.ops.kernels import uamg as ku
from admm_elastic_tpu_torch.ops.kernels.cg_ell import ell_apply_by_slot
from admm_elastic_tpu_torch.ops.kernels.cg_step import cluster_dot
from admm_elastic_tpu_torch.utils.scenes import small_uamg
from test_uamg import _delaunay_system, problem  # noqa: F401 (fixture)

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(scope="module")
def built(problem):  # noqa: F811
    """The port's hierarchy of test_uamg.py's 14 x 9 x 8 Delaunay graph
    matrix, and JAX's level-2 aggregates recomputed by its own functions
    from its level-1 ones."""
    A, pos = problem["A"], problem["positions"]
    mine = pu.build_uamg(A, problem["pts"])
    agg, nc1 = ju.aggregate_capped(ju._strength_graph(A, 0.08), 8)
    c_of = ju._rank_by_leader(agg, nc1, pos)[agg]
    P1 = sp.csr_matrix((np.ones(len(c_of)), (np.arange(len(c_of)), c_of)),
                       shape=(len(c_of), nc1))
    A1 = (P1.T @ A @ P1).tocsr()
    A1.sum_duplicates()
    agg2, nc2 = ju.aggregate_capped(ju._strength_graph(A1, 0.08), 8)
    cpos = np.arange(nc1) + np.arange(nc1) // 8
    c2_of = ju._rank_by_leader(agg2, nc2, cpos)[agg2]
    return mine, dict(c_of=c_of, c2_of=c2_of, A1=A1, cpos=cpos)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def test_hierarchy_matches_jax(problem, built):  # noqa: F811
    """Positions, the aggregates of both levels, A1, A2^-1, omega D^-1."""
    mine, want = built
    planes, meta = problem["planes"], problem["meta"]
    assert mine["levels"] == meta["levels"]
    np.testing.assert_array_equal(mine["positions"], problem["positions"])
    np.testing.assert_array_equal(mine["c0"], want["c_of"])
    np.testing.assert_array_equal(mine["c1"], want["c2_of"])
    n, nc1, nc2 = mine["levels"]
    # member lists: every dof once, ascending within its aggregate
    for c, m, size in ((mine["c0"], mine["m1"], n),
                       (mine["c1"], mine["m2"], nc1)):
        real = m < size
        assert np.array_equal(np.sort(m[real]), np.arange(size))
        assert (c[m[real]] == np.broadcast_to(np.arange(m.shape[1]),
                                              m.shape)[real]).all()
        assert (np.diff(np.where(real, m, size), axis=0) >= 0).all()
    A1 = np.zeros((nc1, nc1))
    rows = np.broadcast_to(np.arange(nc1), mine["l1_idx"].shape)
    np.add.at(A1, (rows, mine["l1_idx"]), mine["l1_vals"])
    assert _rel(A1, want["A1"].toarray()) < TOL
    np2 = meta["np2"]
    B = planes["a2inv_blocks"].reshape(np2, np2, LANES, LANES)
    a2 = B.transpose(1, 3, 0, 2).reshape(np2 * LANES, -1)[:nc2, :nc2]
    assert _rel(mine["a2inv"], a2) < 1e-10
    assert _rel(mine["om_invd0"],
                planes["om_invd0"].ravel()[problem["positions"]]) < TOL
    assert _rel(mine["om_invd1"],
                planes["om_invd1"].ravel()[want["cpos"]]) < TOL


def test_vcycle_matches_jax(problem, built):  # noqa: F811
    """The twin's V-cycle on three columns against `vcycle_np` on each,
    with JAX's uell fine matvec, the vectors mapped through the
    positions; and symmetric, <V r, s> = <r, V s>, and positive."""
    mine, _ = built
    A, pos = problem["A"], problem["positions"]
    packed = problem["packed"]
    Nf = packed["n_pad"] // LANES
    vmask = np.zeros(Nf * LANES)
    vmask[pos] = 1.0

    def mv(x2):
        return (vmask * uell_matvec_np(packed, x2.ravel())).reshape(Nf, LANES)

    ell = tuple(torch.as_tensor(a) for a in _csr_to_ell(A))
    planes = ku.planes_from(mine, torch.float64, "cpu")

    def V(r):
        return ku.vcycle(torch.as_tensor(r),
                         lambda y: ell_apply_by_slot(y, *ell), planes).numpy()

    rng = np.random.default_rng(0)
    r = rng.standard_normal((A.shape[0], 3))
    z = V(r)
    for c in range(3):
        rp = np.zeros(Nf * LANES)
        rp[pos] = r[:, c]
        want = ju.vcycle_np(problem["planes"], problem["meta"], mv,
                            rp.reshape(Nf, LANES)).ravel()[pos]
        assert _rel(z[:, c], want) < TOL
    s = rng.standard_normal(r.shape)
    a, b = np.sum(V(s) * r), np.sum(s * z)
    assert abs(a - b) < 1e-10 * abs(a)
    assert np.sum(r * z) > 0


def test_solve_twin_is_its_pcg(problem, built):  # noqa: F811
    """`uamg_ell_solve` on CPU tensors is `pcg_fixed_uamg` with the ELL
    matvec slot by slot and `cluster_dot` (bitwise), and 8 iterations
    bring x0 1000 times closer to the solution."""
    mine, _ = built
    A = problem["A"]
    ell_idx, ell_vals = (torch.as_tensor(a) for a in _csr_to_ell(A))
    planes = ku.planes_from(mine, torch.float64, "cpu")
    cfg = ku.UAMGConfig.of(mine)
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((A.shape[0], 3))
    b = torch.as_tensor(A @ xt)
    x0 = torch.as_tensor(xt + 0.1 * rng.standard_normal(xt.shape))
    got = ku.uamg_ell_solve(b, x0, ell_idx, ell_vals, planes, cfg, 8)
    want = ku.pcg_fixed_uamg(lambda y: ell_apply_by_slot(y, ell_idx,
                                                         ell_vals),
                             b, x0, planes, 8, cluster_dot)
    assert torch.equal(got, want)
    assert (np.abs(got.numpy() - xt).max()
            < 1e-3 * np.abs(x0.numpy() - xt).max())
    with pytest.raises(ValueError, match="ua_m1"):
        ku.uamg_ell_solve(b, x0, ell_idx, ell_vals,
                          {**planes, "ua_m1": planes["ua_m1"][:, :-1]}, cfg,
                          8)


@pytest.mark.parametrize("which", ["no coarsening", "coarsest too large"])
def test_hierarchy_raises_jax_errors(which):
    """JAX's ValueErrors: a diagonal matrix (no strong connection, no
    coarsening), and a coarsest level that stops shrinking above the
    limit (lowered to 1 here)."""
    if which == "no coarsening":
        A = sp.diags(np.full(64, 2.0)).tocsr()
        verts = np.random.default_rng(0).standard_normal((64, 3))
        with pytest.raises(ValueError, match="no coarsening progress"):
            pu.build_uamg(A, verts)
    else:
        # two disconnected 1-D chains: aggregation stops at 2 dofs
        n = 40
        lap = sp.diags([-1.0, 2.05, -1.0], [-1, 0, 1], shape=(n, n)).tolil()
        lap[n // 2 - 1, n // 2] = lap[n // 2, n // 2 - 1] = 0.0
        verts = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], 1) * 0.1
        with pytest.raises(ValueError, match="coarsest level does not fit"):
            pu.build_uamg(lap.tocsr(), verts, coarse_max=1)


@pytest.fixture(scope="module")
def jax_route():
    s = _delaunay_system(global_solver="ell", lattice_fast_path=True,
                         preconditioner="amg", cg_fixed_iters=8)
    assert s._lattice._uamg_meta_static is not None
    s.run(3)
    return np.asarray(s.x), np.asarray(s.v), s._lattice._uamg_meta_static


def test_route_matches_jax(jax_route):
    """The banded-ELL uAMG route (the window's twin) against JAX's uell
    kernel with its in-kernel algebraic multigrid, 3 steps."""
    x, v, _ = jax_route
    s = small_uamg(device="cpu")
    st = s._stepper
    assert st.cfg.cg_iters == 8 and isinstance(st.cfg.mg, ku.UAMGConfig)
    s.run(3)
    assert np.abs(s.x - x).max() < 1e-8
    assert np.abs(s.v - v).max() < 1e-8 / s.settings.timestep_s
