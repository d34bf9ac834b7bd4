"""Fixed-iteration safeguarded Newton for batched proximal sub-problems:
the JAX package's `ops/newton.py` in PyTorch, the prox solver of the
default (`backend="xla"`) hyperelastic models.

The reference minimizes per-element proximal objectives over 2-3 singular
values with L-BFGS + More-Thuente line search (cppoptlib
lbfgssolver.h:43-144). This is the JAX package's replacement: a damped
Newton iteration with a fixed, branch-free backtracking schedule:

  * gradient and Hessian in closed form where the caller has them, else
    by automatic differentiation (`torch.func.grad`, `jacfwd` under
    `vmap`, as JAX's `jax.grad` / `jacfwd`);
  * Levenberg damping + steepest-descent fallback when the Newton direction
    is not a descent direction;
  * the candidate steps of `_ALPHAS` and `_GRAD_ALPHAS` evaluated as one
    (E, 8, n) batch, the first best objective wins, never moving to a
    worse point (monotone);
  * domain guard x > floor enforced by clamping (the reference uses +inf
    barrier values, TetForce.cpp:229).

Every element is solved at once on a leading axis: x (E, n). The
objective `value_fn(x, *params)` is one element's, written with
operations that broadcast over leading axes (x[..., i], sums over the last
axis): it is called on x (E, n) with params (E, ...), on the candidates
(E, 8, n) with params (E, 1, ...), and, under `torch.func.vmap`, on one
element for the automatic derivatives.
"""

from __future__ import annotations

import functools

import torch

#: Newton-direction backtracking schedule. The deep tail matters: with an
#: ill-conditioned Hessian (tiny eigenvalue, large gradient) the Newton step
#: can be ~100x too long, and a schedule stopping at 1/16 leaves every
#: candidate worse than x — the iterate then never moves at all (caught by
#: the L-BFGS oracle of the JAX package's tests).
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 1.0 / 64.0, 1.0 / 256.0)
#: scaled gradient-step candidates always evaluated alongside the Newton
#: candidates — guarantees progress even when the Newton direction is
#: useless at every scale
_GRAD_ALPHAS = (1.0, 0.0625)


@functools.lru_cache(maxsize=None)
def _ladders(dtype, device):
    """_ALPHAS and _GRAD_ALPHAS as (1, C, 1) tensors, made once per dtype
    and device (a copy from the host, which a step then never makes)."""
    def t(values):
        return torch.tensor(values, dtype=dtype, device=device)[None, :, None]
    return t(_ALPHAS), t(_GRAD_ALPHAS)


def _solve_spd(H, g, damp):
    """Solve (H + damp I) d = g for tiny n (2 or 3) by the explicit inverse
    (adjugate): H (E, n, n), g (E, n), damp (E,). The matrix-vector
    product runs as XLA's dot does, a fused multiply-add chain."""
    from .svd import _cross, _dot, _matmul

    n = H.shape[-1]
    A = H + damp[:, None, None] * torch.eye(n, dtype=H.dtype, device=H.device)
    tiny = torch.finfo(H.dtype).tiny * 1e3
    if n == 2:
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        inv = torch.stack([torch.stack([A[:, 1, 1], -A[:, 0, 1]], dim=1),
                           torch.stack([-A[:, 1, 0], A[:, 0, 0]], dim=1)],
                          dim=1)
    else:
        # n == 3: adjugate, rows = cofactor columns
        a0, a1, a2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
        c0 = _cross(a1, a2)
        det = _dot(a0, c0)
        inv = torch.stack([c0, _cross(a2, a0), _cross(a0, a1)], dim=1)
    det = torch.where(torch.abs(det) < tiny, 1.0, det)
    return _matmul(inv, g[:, :, None])[:, :, 0] / det[:, None]


def newton_minimize(value_fn, x0, iters: int, floor: float = 1e-10,
                    grad_hess_fn=None, params=()):
    """Minimize value_fn(x, *params) from x0 (E, n) with `iters`
    damped-Newton steps per element; returns the final iterates (E, n).

    value_fn must be differentiable on x > floor; x is clamped to the
    domain between steps. grad_hess_fn((E, n), *params) -> (gradients
    (E, n), Hessians (E, n, n)) takes the place of the JAX function's
    grad_fn / hess_fn in one call, for closed forms that share their
    terms; by default both come from automatic differentiation of
    value_fn per element (torch.func's grad, and jacfwd of it, under
    vmap)."""
    if grad_hess_fn is None:
        grad = torch.func.grad(value_fn)
        grad_fn = torch.func.vmap(grad)
        hess_fn = torch.func.vmap(torch.func.jacfwd(grad))

        def grad_hess_fn(x, *p):
            return grad_fn(x, *p), hess_fn(x, *p)

    alphas, galphas = _ladders(x0.dtype, x0.device)
    # the params of one element against its candidates
    cparams = tuple(p.unsqueeze(1) for p in params)
    rows = torch.arange(x0.shape[0], device=x0.device)

    x = torch.clamp_min(x0, floor)
    for _ in range(iters):
        g, H = grad_hess_fn(x, *params)
        # Levenberg damping scaled to the Hessian magnitude keeps the solve
        # stable when H is indefinite far from the optimum
        hnorm = torch.abs(H).amax(dim=(1, 2))
        damp = 1e-6 * (hnorm + 1.0)
        d = _solve_spd(H, -g, damp)
        # fall back to (scaled) steepest descent if not a descent direction
        descent = torch.sum(d * g, dim=1) < 0.0
        gscale = (1.0 / (hnorm + 1.0))[:, None]
        d = torch.where(descent[:, None], d, -g * gscale)

        cand_n = x[:, None, :] + alphas * d[:, None, :]
        cand_g = x[:, None, :] - galphas * (g * gscale)[:, None, :]
        cand = torch.clamp_min(torch.cat([cand_n, cand_g], dim=1), floor)
        vals = value_fn(cand, *cparams)
        vals = torch.where(torch.isfinite(vals), vals, torch.inf)
        best = torch.argmin(vals, dim=1)
        improved = vals[rows, best] < value_fn(x, *params)
        x = torch.where(improved[:, None], cand[rows, best], x)
    return x


def make_batched_newton(value_fn_of_params, iters: int, floor: float = 1e-10):
    """A batched solver (x0 (E, n), *params each (E, ...)) -> (E, n) of
    value_fn_of_params(x, *params), one element's objective (see the
    module docstring)."""

    def solve(x0, *params):
        return newton_minimize(value_fn_of_params, x0, iters, floor,
                               params=params)

    return solve
