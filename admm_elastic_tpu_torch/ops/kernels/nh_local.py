"""Hyperelastic tet local step: hand-written CUDA kernels + plain twins.

Counterpart of `admm_elastic_tpu/ops/pallas/nh_local.py`, both entries.
Per element:

    F      = Dx + u          (fused: Dx = sum_k cp * x[tet[k]])
    U,s,V  = oriented SVD(F)               (signed s2; proper rotations)
    sigma* = argmin psi(sigma) + k/2 ||sigma - s||^2   (damped Newton)
    z      = U diag(sigma*) V^T,   u' = u + Dx - z
    rows[4e+k, j]   = w2 * sum_r cp[4r+k] * (z - u')[3j+r]   (fused only)
    rows[4e+k, 3+j] = w2 * sum_r cp[4r+k] * z[3j+r]          (emit_z only)

`nh_local_step_fused` takes the positions x (n,3) and the tets (E,4),
gathers each element's vertices itself and emits the RHS rows (4E,3) in
the layout the System's incidence gather reads (the dia/ell route) and,
with `emit_z`, (4E,6) rows whose columns 3:6 are w2 D^T z (the dual
residual's, `Settings(collect_residuals=True)`); `nh_local_step` takes Dx
(the unfused pipeline of the dense and cg global modes and of
over-relaxation). Layout: plane-major cp12 (12,E); dx9, u9, z9 (9,E);
warm (3,E); mu, lam, k, w2 (E,). No padding: E is any size. The Pallas
kernel's own layout (gathered positions and row planes (12,E)) is
`_fused_planes`, which the JAX comparisons call.

Each wrapper checks its constant inputs (the selector planes, the
materials, the tets) once per force, dtype and device
(`_build.ElementPlan`, which keeps their pointers and the C entry), then
only the state in one expression a call; both take optional `out=`
buffers. It launches its kernel (`csrc/nh_local.cu`) for CUDA tensors and
runs its `_reference` twin, a straight transcription of the Pallas math,
for CPU tensors. It never falls back from one to the other.
"""

from __future__ import annotations

import torch

from ..segment import flat_rows
from . import _build

_SWEEPS = 6
SIGMA_FLOOR = 1e-8
# Newton backtracking with a deep tail + always-on scaled gradient-step
# candidates; the order is part of the algorithm (first best wins)
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 1.0 / 64.0, 1.0 / 256.0)
_GRAD_ALPHAS = (1.0, 0.0625)
_MODELS = {"nh": 0, "stvk": 1}


def _jacobi_cs(app, aqq, apq, eps):
    small = torch.abs(apq) < eps
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _svd_columns(f, eps):
    """f: 9 planes of F (row-major). Returns (U cols, V cols, s) where
    U/V are 3 lists of 3 arrays (columns) and s = (s0,s1,s2) signed."""
    U, cols, (b0, b1), matvec = _svd_factors(f, eps)
    b2 = matvec(2)
    u0, u1, u2 = U
    s = (
        u0[0] * b0[0] + u0[1] * b0[1] + u0[2] * b0[2],
        u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2],
        u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2],
    )
    return U, cols, s


def _svd_factors(f, eps):
    """The rotations of the oriented SVD of F: (U cols, V cols, (F V_0,
    F V_1), matvec), where matvec(c) = F V_c. The Pallas kernels compute
    the same in one function (nh_local._svd_columns, and without the
    singular values tet_local._polar_rotation)."""

    def col(c):
        return (f[c], f[3 + c], f[6 + c])

    def dotc(ca, cb):
        a, b = col(ca), col(cb)
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    a00, a11, a22 = dotc(0, 0), dotc(1, 1), dotc(2, 2)
    a01, a02, a12 = dotc(0, 1), dotc(0, 2), dotc(1, 2)
    scale = torch.clamp_min(
        torch.maximum(torch.maximum(torch.abs(a00), torch.abs(a11)),
                      torch.abs(a22)), 1.0
    )
    a00, a11, a22 = a00 / scale, a11 / scale, a22 / scale
    a01, a02, a12 = a01 / scale, a02 / scale, a12 / scale

    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def rot_cols(p, q, c, s):
        for r in range(3):
            vp, vq = v[r][p], v[r][q]
            v[r][p] = c * vp - s * vq
            v[r][q] = s * vp + c * vq

    for _ in range(_SWEEPS):
        c, s = _jacobi_cs(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a11, a01, a02, a12 = n00, n11, zero, n02, n12
        rot_cols(0, 1, c, s)
        c, s = _jacobi_cs(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a22, a02, a01, a12 = n00, n22, zero, n01, n12
        rot_cols(0, 2, c, s)
        c, s = _jacobi_cs(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a11, a22, a12, a01, a02 = n11, n22, zero, n01, n02
        rot_cols(1, 2, c, s)

    w = [a00, a11, a22]
    cols = [[v[0][c], v[1][c], v[2][c]] for c in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        for r in range(3):
            ci, cj = cols[i][r], cols[j][r]
            cols[i][r] = torch.where(swap, cj, ci)
            cols[j][r] = torch.where(swap, ci, cj)

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    det = (
        cols[0][0] * (cols[1][1] * cols[2][2] - cols[1][2] * cols[2][1])
        - cols[1][0] * (cols[0][1] * cols[2][2] - cols[0][2] * cols[2][1])
        + cols[2][0] * (cols[0][1] * cols[1][2] - cols[0][2] * cols[1][1])
    )
    sflip = torch.where(det < 0, -1.0, 1.0)
    for r in range(3):
        cols[2][r] = cols[2][r] * sflip

    def matvec(ci):
        vc = cols[ci]
        return [
            f[0] * vc[0] + f[1] * vc[1] + f[2] * vc[2],
            f[3] * vc[0] + f[4] * vc[1] + f[5] * vc[2],
            f[6] * vc[0] + f[7] * vc[1] + f[8] * vc[2],
        ]

    b0, b1 = matvec(0), matvec(1)

    def norm3(x):
        return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])

    n0 = norm3(b0)
    tol = eps * 16.0 * (torch.sqrt(torch.clamp_min(w[0] * scale, 0.0)) + eps)
    ok0 = n0 > tol
    inv0 = 1.0 / torch.where(ok0, n0, 1.0)
    u0 = [torch.where(ok0, b0[kk] * inv0, 1.0 if kk == 0 else 0.0)
          for kk in range(3)]

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    p1 = [b1[kk] - d01 * u0[kk] for kk in range(3)]
    n1 = norm3(p1)
    ok1 = n1 > tol
    inv1 = 1.0 / torch.where(ok1, n1, 1.0)
    au = [torch.abs(u0[0]), torch.abs(u0[1]), torch.abs(u0[2])]
    use_x = (au[0] <= au[1]) & (au[0] <= au[2])
    use_y = (~use_x) & (au[1] <= au[2])
    ax = [
        torch.where(use_x, 1.0, zero),
        torch.where(use_y, 1.0, zero),
        torch.where(use_x | use_y, 0.0, one),
    ]
    dax = ax[0] * u0[0] + ax[1] * u0[1] + ax[2] * u0[2]
    fb = [ax[kk] - dax * u0[kk] for kk in range(3)]
    fbn = norm3(fb)
    fb = [fb[kk] / torch.where(fbn > 0, fbn, 1.0) for kk in range(3)]
    u1 = [torch.where(ok1, p1[kk] * inv1, fb[kk]) for kk in range(3)]

    u2 = [
        u0[1] * u1[2] - u0[2] * u1[1],
        u0[2] * u1[0] - u0[0] * u1[2],
        u0[0] * u1[1] - u0[1] * u1[0],
    ]
    return [u0, u1, u2], cols, (b0, b1), matvec


def _prox(s1, s2, s3, k, c1, c2, c3):
    d1, d2, d3 = s1 - c1, s2 - c2, s3 - c3
    return 0.5 * k * (d1 * d1 + d2 * d2 + d3 * d3)


def _stvk_value(s1, s2, s3, mu, lam, k, c1, c2, c3):
    """StVK prox objective (TetForce.cpp:269-278)."""
    e1 = 0.5 * (s1 * s1 - 1.0)
    e2 = 0.5 * (s2 * s2 - 1.0)
    e3 = 0.5 * (s3 * s3 - 1.0)
    tr = e1 + e2 + e3
    psi = mu * (e1 * e1 + e2 * e2 + e3 * e3) + 0.5 * lam * tr * tr
    val = psi + _prox(s1, s2, s3, k, c1, c2, c3)
    return torch.where((s1 > 0) & (s2 > 0) & (s3 > 0), val, 3.4e38)


def _nh_value(s1, s2, s3, mu, lam, k, c1, c2, c3):
    """NH prox objective; 3.4e38 for non-positive sigma."""
    det = s1 * s2 * s3
    pos = det > 0
    logdet = torch.log(torch.where(pos, det, 1.0))
    I1 = s1 * s1 + s2 * s2 + s3 * s3
    psi = 0.5 * mu * (I1 - 2.0 * logdet - 3.0) + 0.5 * lam * logdet * logdet
    val = psi + _prox(s1, s2, s3, k, c1, c2, c3)
    return torch.where(pos & (s1 > 0) & (s2 > 0) & (s3 > 0), val, 3.4e38)


def _newton_hyper(s0, warm, mu, lam, k, iters, model):
    """Damped Newton on 3 singular values, all elements at once."""
    c1, c2, c3 = s0  # prox centers (signed SVD values)
    x1, x2, x3 = warm
    value_fn = _nh_value if model == "nh" else _stvk_value

    floor = SIGMA_FLOOR
    x1 = torch.clamp_min(x1, floor)
    x2 = torch.clamp_min(x2, floor)
    x3 = torch.clamp_min(x3, floor)

    for _ in range(iters):
        if model == "nh":
            inv1, inv2, inv3 = 1.0 / x1, 1.0 / x2, 1.0 / x3
            logdet = torch.log(x1 * x2 * x3)
            g1 = mu * (x1 - inv1) + lam * logdet * inv1 + k * (x1 - c1)
            g2 = mu * (x2 - inv2) + lam * logdet * inv2 + k * (x2 - c2)
            g3 = mu * (x3 - inv3) + lam * logdet * inv3 + k * (x3 - c3)
            h11 = mu * (1.0 + inv1 * inv1) + (lam - lam * logdet) * inv1 * inv1 + k
            h22 = mu * (1.0 + inv2 * inv2) + (lam - lam * logdet) * inv2 * inv2 + k
            h33 = mu * (1.0 + inv3 * inv3) + (lam - lam * logdet) * inv3 * inv3 + k
            h12 = lam * inv1 * inv2
            h13 = lam * inv1 * inv3
            h23 = lam * inv2 * inv3
        else:
            ss = x1 * x1 + x2 * x2 + x3 * x3
            g1 = mu * x1 * (x1 * x1 - 1.0) + 0.5 * lam * (ss - 3.0) * x1 + k * (x1 - c1)
            g2 = mu * x2 * (x2 * x2 - 1.0) + 0.5 * lam * (ss - 3.0) * x2 + k * (x2 - c2)
            g3 = mu * x3 * (x3 * x3 - 1.0) + 0.5 * lam * (ss - 3.0) * x3 + k * (x3 - c3)
            base = 0.5 * lam * (ss - 3.0) + k
            h11 = mu * (3.0 * x1 * x1 - 1.0) + base + lam * x1 * x1
            h22 = mu * (3.0 * x2 * x2 - 1.0) + base + lam * x2 * x2
            h33 = mu * (3.0 * x3 * x3 - 1.0) + base + lam * x3 * x3
            h12 = lam * x1 * x2
            h13 = lam * x1 * x3
            h23 = lam * x2 * x3
        hmax = torch.maximum(
            torch.maximum(torch.abs(h11), torch.abs(h22)),
            torch.maximum(torch.abs(h33), torch.maximum(
                torch.abs(h12), torch.maximum(torch.abs(h13), torch.abs(h23)))),
        )
        damp = 1e-6 * (hmax + 1.0)
        h11 = h11 + damp
        h22 = h22 + damp
        h33 = h33 + damp
        # symmetric 3x3 solve via adjugate
        cof11 = h22 * h33 - h23 * h23
        cof12 = h13 * h23 - h12 * h33
        cof13 = h12 * h23 - h13 * h22
        det = h11 * cof11 + h12 * cof12 + h13 * cof13
        det = torch.where(torch.abs(det) > 1e-30, det, 1.0)
        cof22 = h11 * h33 - h13 * h13
        cof23 = h12 * h13 - h11 * h23
        cof33 = h11 * h22 - h12 * h12
        d1 = -(cof11 * g1 + cof12 * g2 + cof13 * g3) / det
        d2 = -(cof12 * g1 + cof22 * g2 + cof23 * g3) / det
        d3 = -(cof13 * g1 + cof23 * g2 + cof33 * g3) / det
        # steepest-descent fallback if not a descent direction
        descent = d1 * g1 + d2 * g2 + d3 * g3 < 0.0
        gscale = 1.0 / (hmax + 1.0)
        d1 = torch.where(descent, d1, -g1 * gscale)
        d2 = torch.where(descent, d2, -g2 * gscale)
        d3 = torch.where(descent, d3, -g3 * gscale)

        f_best = value_fn(x1, x2, x3, mu, lam, k, c1, c2, c3)
        b1, b2, b3 = x1, x2, x3

        def try_step(s1, s2, s3, f_best, b1, b2, b3):
            t1 = torch.clamp_min(s1, floor)
            t2 = torch.clamp_min(s2, floor)
            t3 = torch.clamp_min(s3, floor)
            fv = value_fn(t1, t2, t3, mu, lam, k, c1, c2, c3)
            better = fv < f_best
            return (
                torch.where(better, fv, f_best),
                torch.where(better, t1, b1),
                torch.where(better, t2, b2),
                torch.where(better, t3, b3),
            )

        for a in _ALPHAS:
            f_best, b1, b2, b3 = try_step(
                x1 + a * d1, x2 + a * d2, x3 + a * d3, f_best, b1, b2, b3
            )
        for a in _GRAD_ALPHAS:
            f_best, b1, b2, b3 = try_step(
                x1 - a * g1 * gscale, x2 - a * g2 * gscale,
                x3 - a * g3 * gscale, f_best, b1, b2, b3,
            )
        x1, x2, x3 = b1, b2, b3
    return x1, x2, x3


def _warm_guard(warm):
    """Warm-start guards (TetForce.cpp:339-347): flip a negative third
    component, ELSE (third was non-negative) bump a collapsed start."""
    w1, w2 = warm[0], warm[1]
    neg3 = warm[2] < 0.0
    w3 = torch.abs(warm[2])
    collapsed = (~neg3) & (
        (torch.abs(w1) < 1e-3) & (torch.abs(w2) < 1e-3) & (torch.abs(w3) < 1e-3)
    )
    return (torch.where(collapsed, 1e-3, w1), torch.where(collapsed, 1e-3, w2),
            torch.where(collapsed, 1e-3, w3))


def _hyper_body(dx, uu, warm, mu, lam, k, iters, model):
    """The element step both kernels share: dx and uu lists of 9 planes ->
    (z planes, u' planes, warm_new (3,E))."""
    f = [dx[p] + uu[p] for p in range(9)]
    eps = torch.finfo(f[0].dtype).eps
    U, V, s = _svd_columns(f, eps)
    x1, x2, x3 = _newton_hyper(s, _warm_guard(warm), mu, lam, k, iters, model)
    sig = (x1, x2, x3)
    z_planes, u_planes = [], []
    for r in range(3):
        for c in range(3):
            z = (
                U[0][r] * sig[0] * V[0][c]
                + U[1][r] * sig[1] * V[1][c]
                + U[2][r] * sig[2] * V[2][c]
            )
            z_planes.append(z)
            u_planes.append(uu[3 * r + c] + dx[3 * r + c] - z)
    return z_planes, u_planes, torch.stack([x1, x2, x3])


def rows_of(cp, planes, k_count, r_count, w2):
    """The rows w2 D^T y of the fused kernels, from the plane values y
    (plane r_count j + r) and the selector planes cp (plane k_count r +
    k): row 3k+j = w2 * sum_r cp[k_count r + k] y[r_count j + r], the
    terms added in order of r."""
    out = []
    for kk in range(k_count):
        for j in range(3):
            acc = cp[kk] * planes[r_count * j]
            for r in range(1, r_count):
                acc = acc + cp[k_count * r + kk] * planes[r_count * j + r]
            out.append(w2 * acc)
    return out


def _fused_planes(xg12, u9, warm, cp12, mu, lam, k, w2, iters=5,
                  model="nh", emit_z=False):
    """The fused step on gathered positions in the Pallas kernel's own
    layout: xg12 (12,E) with plane 3k+a = x[tet[e,k], a] in; (z9, u9_new,
    warm_new, contrib12[, contribz12]) out, row plane 3k+j of element e
    the row 4e+k's column j. The JAX comparisons call it on their inputs;
    `nh_local_step_fused_reference` gathers and lays its rows out."""
    xg = [xg12[p] for p in range(12)]
    cp = [cp12[p] for p in range(12)]
    dx = []
    for a in range(3):
        for b in range(3):
            acc = cp[4 * b] * xg[a]
            for kk in range(1, 4):
                acc = acc + cp[4 * b + kk] * xg[3 * kk + a]
            dx.append(acc)
    z_planes, u_planes, warm_new = _hyper_body(
        dx, [u9[p] for p in range(9)], warm, mu, lam, k, iters, model)
    zu = [z_planes[p] - u_planes[p] for p in range(9)]
    out = (torch.stack(z_planes), torch.stack(u_planes), warm_new,
           torch.stack(rows_of(cp, zu, 4, 3, w2)))
    if emit_z:
        out += (torch.stack(rows_of(cp, z_planes, 4, 3, w2)),)
    return out


def nh_local_step_fused_reference(x, tets, u9, warm, cp12, mu, lam, k, w2,
                                  iters=5, model="nh", emit_z=False):
    """Plain PyTorch version of the fused kernel, same signature and
    outputs: (z9, u9_new, warm_new, rows), rows (4E,3), or (4E,6) with
    emit_z. It gathers the positions, runs `_fused_planes` and lays the
    rows out: the gather and the layout move values and change no bits."""
    E = tets.shape[0]
    z9, u9_new, warm_new, *blocks = _fused_planes(
        x[tets.long()].reshape(E, 12).T, u9, warm, cp12, mu, lam, k, w2,
        iters=iters, model=model, emit_z=emit_z)
    return z9, u9_new, warm_new, flat_rows(blocks)


def nh_local_step_reference(dx9, u9, warm, mu, lam, k, iters=5, model="nh"):
    """Plain PyTorch version of the unfused kernel, same signature and
    outputs: (z9, u9_new, warm_new)."""
    z_planes, u_planes, warm_new = _hyper_body(
        [dx9[p] for p in range(9)], [u9[p] for p in range(9)], warm, mu, lam,
        k, iters, model)
    return torch.stack(z_planes), torch.stack(u_planes), warm_new


def nh_local_step_fused(x, tets, u9, warm, cp12, mu, lam, k, w2, iters=5,
                        model="nh", emit_z=False, out=None):
    """Fused local step + RHS rows from the positions x (n,3) and the tets
    (E,4) (integers; the kernel reads them in int32, converted once).
    Returns (z9, u9_new, warm_new, rows): rows (4E,3), row 4e+k the
    element's D^T W^2 (z - u') row for its vertex k; with emit_z (4E,6),
    columns 3:6 the rows of D^T W^2 z (the other outputs are the same bits
    either way). `out`: optional buffers of those four outputs to write
    instead of new ones, none of them overlapping an input."""
    if model not in _MODELS:
        raise ValueError(f"unknown hyperelastic model {model!r}")
    plan = _build.element_plan("nh_local_step_fused",
                               {"cp12": cp12, "mu": mu, "lam": lam, "k": k,
                                "w2": w2}, tets)
    E = plan.E
    if not (x.dim() == 2 and x.shape[1] == 3 and x.shape[0] > plan.vmax
            and u9.shape == (9, E) and warm.shape == (3, E)
            and x.dtype is u9.dtype is warm.dtype is plan.dtype
            and x.get_device() == u9.get_device() == warm.get_device()
            == plan.index and x.is_contiguous() and u9.is_contiguous()
            and warm.is_contiguous()):
        if x.dim() == 2 and x.shape[0] <= plan.vmax:
            raise ValueError(f"x: {x.shape[0]} vertices, the tets reach "
                             f"vertex {plan.vmax}")
        plan.check_state({"x": (x, (len(x) if x.dim() else 0, 3)),
                          "u9": (u9, (9, E)), "warm": (warm, (3, E))})
    shapes = ((9, E), (9, E), (3, E), (4 * E, 6 if emit_z else 3))
    if plan.fn is None:
        return plan.twin(out, shapes, (x, u9, warm),
                         lambda: nh_local_step_fused_reference(
                             x, tets, u9, warm, cp12, mu, lam, k, w2,
                             iters=iters, model=model, emit_z=emit_z))
    outs = plan.outputs(out, shapes, (x, u9, warm))
    _build.check(plan.fn(x.data_ptr(), plan.tets_ptr, u9.data_ptr(),
                         warm.data_ptr(), *plan.ptrs,
                         *(o.data_ptr() for o in outs), E, int(iters),
                         _MODELS[model], int(emit_z), _build.stream_ptr(x)),
                 "nh_local_step_fused")
    nh_local_step_fused.launches += 1
    nh_local_step_fused.residual_launches += bool(emit_z)
    return outs


nh_local_step_fused.launches = 0
#: the launches of its emit_z mode (a count within `launches`)
nh_local_step_fused.residual_launches = 0


def nh_local_step(dx9, u9, warm, mu, lam, k, iters=5, model="nh", out=None):
    """Unfused local step from Dx. Returns (z9, u9_new, warm_new). `out`:
    optional buffers of those three outputs to write instead of new ones,
    none of them overlapping an input."""
    if model not in _MODELS:
        raise ValueError(f"unknown hyperelastic model {model!r}")
    plan = _build.element_plan("nh_local_step",
                               {"mu": mu, "lam": lam, "k": k})
    E = plan.E
    if not (dx9.shape == u9.shape == (9, E) and warm.shape == (3, E)
            and dx9.dtype is u9.dtype is warm.dtype is plan.dtype
            and dx9.get_device() == u9.get_device() == warm.get_device()
            == plan.index and dx9.is_contiguous() and u9.is_contiguous()
            and warm.is_contiguous()):
        plan.check_state({"dx9": (dx9, (9, E)), "u9": (u9, (9, E)),
                          "warm": (warm, (3, E))})
    shapes = ((9, E), (9, E), (3, E))
    if plan.fn is None:
        return plan.twin(out, shapes, (dx9, u9, warm),
                         lambda: nh_local_step_reference(
                             dx9, u9, warm, mu, lam, k, iters=iters,
                             model=model))
    outs = plan.outputs(out, shapes, (dx9, u9, warm))
    _build.check(plan.fn(dx9.data_ptr(), u9.data_ptr(), warm.data_ptr(),
                         *plan.ptrs, *(o.data_ptr() for o in outs), E,
                         int(iters), _MODELS[model], _build.stream_ptr(dx9)),
                 "nh_local_step")
    nh_local_step.launches += 1
    return outs


nh_local_step.launches = 0
