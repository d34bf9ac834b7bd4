"""The general route's aggregation AMG (`preconditioner="amg"` under
`global_solver="ell"` with the xla CG backend, and the fallback where no
in-kernel multigrid engages): the port's hierarchy and V-cycle
(core/amg.py) and the System route against the JAX package, f64, CPU.

Tolerances:
- the hierarchy (aggregates, ELL rows, D^-1, lmax, level sizes): equal,
  the coarsest inverse 1e-10 relative (the same numpy arithmetic);
- the V-cycle: 1e-12 relative (the restriction's sums in another order
  than segment_sum's);
- the route on a 1,200-node Delaunay mesh (a real two-level hierarchy:
  1200 -> 181), 2 steps of 3 ADMM iterations, kernel-backed tets on both
  sides (tests/test_torch_delaunay.py): x within 1e-8, at a fixed budget,
  with cg_tol, and through the fallback (a scene the banded kernel
  rejects under lattice_fast_path=True)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu.core import amg as ja
from admm_elastic_tpu_torch.core import amg as pa
from admm_elastic_tpu_torch.utils.scenes import delaunay_mesh
from test_uamg import problem  # noqa: F401 (fixture)

torch.set_num_threads(1)

PTS, TETS = delaunay_mesh(12, 10, 10, scale=0.05, emax=0.11)


@pytest.fixture(scope="module")
def hierarchies(problem):  # noqa: F811
    """Both packages' hierarchies of test_uamg.py's graph matrix, cut at
    100 dofs so that it has two coarse levels."""
    A = problem["A"]
    return A, pa.build_amg(A, coarse_max=100), ja.build_amg(A, coarse_max=100)


def test_build_matches_jax(hierarchies):
    _, (mine, meta), (theirs, jmeta) = hierarchies
    assert meta == jmeta and len(meta) == 3
    for lv, jv, m in zip(mine[:-1], theirs[:-1], meta):
        for k in ("ell_idx", "ell_vals", "inv_diag", "agg", "lmax"):
            np.testing.assert_array_equal(lv[k], jv[k], err_msg=k)
        real = lv["members"] < m["n"]
        assert np.array_equal(np.sort(lv["members"][real]), np.arange(m["n"]))
        owner = np.broadcast_to(np.arange(m["nc"])[:, None], real.shape)
        assert (lv["agg"][lv["members"][real]] == owner[real]).all()
    a, b = mine[-1]["A_inv"], theirs[-1]["A_inv"]
    assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


def test_vcycle_matches_jax(hierarchies):
    """make_vcycle on three columns, and symmetric."""
    _, (mine, meta), (theirs, jmeta) = hierarchies
    levels = pa.levels_to_device(mine, torch.float64, "cpu")
    V = pa.make_vcycle(meta)
    jV = ja.make_vcycle(jmeta)
    jlevels = tuple({k: jnp.asarray(v) for k, v in lv.items()}
                    for lv in theirs)
    rng = np.random.default_rng(0)
    r = rng.standard_normal((len(mine[0]["agg"]), 3))
    z = V(levels, torch.as_tensor(r)).numpy()
    want = np.asarray(jV(jlevels, jnp.asarray(r)))
    assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()
    s = rng.standard_normal(r.shape)
    a = np.sum(V(levels, torch.as_tensor(s)).numpy() * r)
    b = np.sum(s * z)
    assert abs(a - b) < 1e-10 * abs(a) and np.sum(r * z) > 0


def _system(pkg, indices=None, **settings):
    """The 1,200-node mesh: anchors within 0.025 m of the minimum x,
    kernel-backed NeoHookean tets (mu = lam = 1e5), gravity (on `indices`
    only, when given), ell + amg, 3 ADMM iterations."""
    n = len(PTS)
    common = dict(timestep_s=0.04, admm_iters=3, verbose=0,
                  global_solver="ell", preconditioner="amg", **settings)
    s = (aet.System(aet.Settings(dtype=jnp.float64, **common)) if pkg is aet
         else pt.System(pt.Settings(dtype=torch.float64, device="cpu",
                                    **common)))
    s.add_nodes(PTS, np.full(n, 50.0 / n))
    s.add_force(pkg.models.StaticAnchor(
        np.flatnonzero(PTS[:, 0] < PTS[:, 0].min() + 0.025)))
    s.add_force(pkg.models.HyperElasticTet(TETS, mu=1e5, lam=1e5,
                                           max_iters=5, model="nh",
                                           backend="pallas"))
    s.add_explicit_force(pkg.models.ExplicitForce(direction=(0, -9.8, 0),
                                                  indices=indices))
    assert s.initialize()
    return s


ROUTES = {
    "fixed budget": dict(cg_fixed_iters=8),
    "cg_tol": dict(cg_fixed_iters=None, cg_tol=1e-10),
    # an ExplicitForce with indices keeps the banded kernel off
    "fallback": dict(cg_fixed_iters=8, lattice_fast_path=True,
                     indices=np.arange(len(PTS))),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_matches_jax(name):
    j = _system(aet, **ROUTES[name])
    s = _system(pt, **ROUTES[name])
    assert j._lattice is None and j._amg_meta is not None
    assert s._stepper is None and "amg" in s.params["_solver"]
    assert [lv["agg"].shape[0] for lv in s.params["_solver"]["amg"][:-1]] \
        == [m["n"] for m in j._amg_meta[:-1]] == [1200]
    j.run(2)
    s.run(2)
    assert np.abs(s.x - np.asarray(j.x)).max() < 1e-8
    assert np.abs(s.v - np.asarray(j.v)).max() < 1e-8 / 0.04
