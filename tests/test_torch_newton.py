"""The port's `ops/newton.py` and the closed-form prox derivatives of
`models/tet.py` against the JAX package's, f64 on the CPU.

The JAX side is `jax.vmap` of its single-element functions run op by op
(`jax.disable_jit()`), the same operations the port runs on its batch, so
the two agree to 1e-12 (bit for bit in practice). Compiled, XLA fuses
multiply-adds, and where the Newton stalls on a tie of candidate values
(its monotone acceptance test) an ulp moves sigma* by up to 1e-8; the
golden-file test (tests/test_torch_golden.py) says more. The port matches
XLA's fused multiply-adds where JAX runs them in eager mode too (its dots
of small matrices, `jnp.cross`, `jnp.linalg.norm`), so what parts the two
here is only XLA's transcendental functions, which are not correctly
rounded.

Also: the closed-form gradients and Hessians against torch.func, the
monotone candidate ladder, and the nh, stvk and Fung proxes against
scipy's L-BFGS-B, as tests/test_prox.py holds JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize as scipy_minimize

from admm_elastic_tpu.models import tet as jtet
from admm_elastic_tpu.models import triangle as jtri
from admm_elastic_tpu.ops import newton as jnewton
from admm_elastic_tpu_torch.models import tet as ptet
from admm_elastic_tpu_torch.models import triangle as ptri
from admm_elastic_tpu_torch.ops import newton as pnewton

torch.set_num_threads(1)

TOL = 1e-12
T = torch.as_tensor
ENERGIES = {"nh": (jtet.nh_energy, ptet.nh_energy, jtet.nh_grad_hess,
                   ptet.nh_grad_hess),
            "stvk": (jtet.stvk_energy, ptet.stvk_energy, jtet.stvk_grad_hess,
                     ptet.stvk_grad_hess)}


def _centers(n, seed):
    """Prox centers spanning stretch, compression and inversion."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.1, 3.0, size=(n, 3))
    s0[:4] = [[1.0, 1.0, 1.0], [2.5, 0.7, 1.1], [0.3, 0.2, 0.25],
              [1.4, 1.0, -0.8]]
    return s0


def test_ladders_are_jax():
    assert pnewton._ALPHAS == jnewton._ALPHAS
    assert pnewton._GRAD_ALPHAS == jnewton._GRAD_ALPHAS


@pytest.mark.parametrize("n", [2, 3])
def test_solve_spd(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(64, n, n))
    H = np.einsum("eij,ekj->eik", M, M)
    H[:4] = 0.0  # singular: the det guard
    H[4] = np.diag([1.0, 1e-20, 1.0][:n])
    g = rng.normal(size=(64, n))
    damp = rng.uniform(0.0, 1e-3, 64)
    damp[:2] = 0.0
    want = jax.vmap(jnewton._solve_spd)(jnp.asarray(H), jnp.asarray(g),
                                        jnp.asarray(damp))
    got = pnewton._solve_spd(T(H), T(g), T(damp))
    scale = np.abs(np.asarray(want)).max(axis=1) + 1.0
    assert (np.abs(got.numpy() - np.asarray(want)).max(axis=1)
            / scale).max() <= TOL


def _jax_tet_prox(model, x0, s0, mu, lam, k, iters):
    energy, _, grad_hess, _ = ENERGIES[model]

    def one(x0, s0, mu, lam, k):
        def obj(s):
            return energy(s, mu, lam) + 0.5 * k * jnp.sum((s - s0) ** 2)
        return jnewton.newton_minimize(
            obj, x0, iters, floor=1e-8,
            grad_fn=lambda s: grad_hess(s, mu, lam, k, s0)[0],
            hess_fn=lambda s: grad_hess(s, mu, lam, k, s0)[1])

    with jax.disable_jit():
        return np.asarray(jax.vmap(one)(*map(jnp.asarray,
                                             (x0, s0, mu, lam, k))))


def _port_objective(model):
    energy = ENERGIES[model][1]

    def obj(sig, mu, lam, k, s0):
        return energy(sig, mu, lam) + 0.5 * k * torch.sum((sig - s0) ** 2,
                                                          dim=-1)
    return obj


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_newton_closed_form_matches_jax(model):
    """The hyperelastic tets' prox: closed-form derivatives, floor 1e-8,
    warm starts near and far (1 and 5 iterations)."""
    n = 32
    s0 = _centers(n, 0)
    rng = np.random.default_rng(1)
    x0 = np.abs(s0) * rng.uniform(0.8, 1.2, size=(n, 3))
    x0[:8] = 1.0
    mu = rng.uniform(50.0, 200.0, n)
    lam = rng.uniform(50.0, 400.0, n)
    k = np.minimum(mu, lam)
    for iters in (1, 5):
        want = _jax_tet_prox(model, x0, s0, mu, lam, k, iters)
        got = pnewton.newton_minimize(
            _port_objective(model), T(x0), iters, floor=1e-8,
            params=(T(mu), T(lam), T(k), T(s0)),
            grad_hess_fn=ENERGIES[model][3])
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("iters,tol", [(2, TOL), (6, 1e-8)])
def test_newton_ad_default_matches_jax(iters, tol):
    """The automatic derivatives (torch.func against jax.grad / jacfwd)
    on the Fung prox, through make_batched_newton. Two iterations agree to
    1e-12. Six converge, and there the operation that parts is XLA's exp,
    which is not correctly rounded (it differs from torch's and numpy's in
    the last ulp for ~15% of arguments): the objective's values differ by
    an ulp, and where the Newton's monotone acceptance test meets a tie of
    candidate values at the minimum, the two stop up to ~1e-8 apart (the
    square root of the rounding unit: the objective is flat to within
    rounding over that distance of its minimum)."""
    rng = np.random.default_rng(2)
    s0 = rng.uniform(0.5, 1.6, size=(24, 2))
    mu = rng.uniform(5.0, 20.0, 24)

    def one(s0, mu):
        def obj(sig):
            return jtri.fung_energy(sig, mu, 1.0) + 0.5 * mu * jnp.sum(
                (sig - s0) ** 2)
        return jnewton.newton_minimize(obj, s0, iters, floor=1e-8)

    with jax.disable_jit():
        want = np.asarray(jax.vmap(one)(jnp.asarray(s0), jnp.asarray(mu)))
    solve = pnewton.make_batched_newton(ptri._fung_objective, iters,
                                        floor=1e-8)
    got = solve(T(s0), T(mu), T(mu), T(s0))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_closed_form_grad_hess_match_ad(model):
    """nh_grad_hess / stvk_grad_hess equal torch.func's derivatives of the
    prox objective, and JAX's closed forms."""
    rng = np.random.default_rng(7)
    sig = rng.uniform(0.2, 3.0, size=(16, 3))
    sig0 = rng.uniform(0.2, 3.0, size=(16, 3))
    mu, lam, k = (np.full(16, v) for v in (123.0, 77.0, 50.0))
    params = (T(mu), T(lam), T(k), T(sig0))
    obj = _port_objective(model)
    g_ad = torch.func.vmap(torch.func.grad(obj))(T(sig), *params)
    H_ad = torch.func.vmap(torch.func.jacfwd(torch.func.grad(obj)))(
        T(sig), *params)
    g, H = ENERGIES[model][3](T(sig), *params)
    np.testing.assert_allclose(g.numpy(), g_ad.numpy(), rtol=1e-10)
    np.testing.assert_allclose(H.numpy(), H_ad.numpy(), rtol=1e-10,
                               atol=1e-9)
    gj, Hj = jax.vmap(ENERGIES[model][2])(*map(jnp.asarray,
                                               (sig, mu, lam, k, sig0)))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=TOL)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=TOL, atol=TOL)


def test_newton_monotone_and_positive():
    """Never increases the objective; never leaves the positive domain."""
    rng = np.random.default_rng(3)
    s0 = rng.uniform(-2, 4, size=(64, 3))
    mu = lam = k = torch.full((64,), 1e5, dtype=torch.float64)
    obj = _port_objective("nh")
    params = (mu, lam, k, T(s0))
    x0 = torch.ones(64, 3, dtype=torch.float64)
    prev = obj(x0, *params)
    for iters in range(1, 9):
        out = pnewton.newton_minimize(obj, x0, iters, params=params)
        f = obj(out, *params)
        assert bool(torch.all(out > 0)) and bool(torch.all(torch.isfinite(out)))
        assert bool(torch.all(f <= prev + 1e-9))
        prev = f


def _scipy(obj, x0, n):
    res = scipy_minimize(obj, x0, method="L-BFGS-B",
                         bounds=[(1e-10, None)] * n,
                         options={"maxiter": 200, "ftol": 1e-16,
                                  "gtol": 1e-12})
    return res.x


@pytest.mark.parametrize("model", ["nh", "stvk", "fung"])
def test_prox_matches_scipy(model):
    """The batched Newton lands on scipy's minimizers of the actual
    objectives (tests/test_prox.py's centers and tolerances)."""
    if model == "fung":
        s0 = np.array([[1.0, 1.0], [1.4, 0.8], [0.6, 0.5]])
        mu = np.full(3, 10.0)
        got = pnewton.newton_minimize(
            ptri._fung_objective, T(s0), 25,
            params=(T(mu), T(mu), T(s0))).numpy()
        for i in range(3):
            def f(s):
                return float(ptri._fung_objective(T(s), T(mu[i]), T(mu[i]),
                                                  T(s0[i])))
            np.testing.assert_allclose(got[i], _scipy(f, s0[i], 2),
                                       rtol=5e-4, atol=5e-5)
        return
    s0 = _centers(15, 0)
    n = len(s0)
    mu = lam = k = np.full(n, 100.0)
    obj = _port_objective(model)
    got = pnewton.newton_minimize(
        obj, torch.ones(n, 3, dtype=torch.float64), 25,
        params=(T(mu), T(lam), T(k), T(s0))).numpy()
    for i in range(n):
        def f(s):
            return float(obj(T(s), T(mu[i]), T(lam[i]), T(k[i]), T(s0[i])))
        np.testing.assert_allclose(got[i], _scipy(f, np.ones(3), 3),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"{model} prox center {s0[i]}")
