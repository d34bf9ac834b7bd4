"""Fused hyperelastic tet local step: hand-written CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/nh_local.py`
(`nh_local_step_fused`). Per element:

    F      = sum_k cp * xg + u             (selector apply on gathered x)
    U,s,V  = oriented SVD(F)               (signed s2; proper rotations)
    sigma* = argmin psi(sigma) + k/2 ||sigma - s||^2   (damped Newton)
    z      = U diag(sigma*) V^T,   u' = u + Dx - z
    contrib[3k+j] = w2 * sum_r cp[4r+k] * (z - u')[3j+r]

Layout: plane-major xg12, cp12, contrib12 (12,E); u9, z9 (9,E); warm (3,E);
mu, lam, k, w2 (E,). No padding: E is any size.

`nh_local_step_fused` launches the kernel (`csrc/nh_local.cu`) for CUDA
tensors and runs `nh_local_step_fused_reference`, a straight transcription
of the Pallas math, for CPU tensors. It never falls back from one to the
other.
"""

from __future__ import annotations

import torch

from . import _build

_SWEEPS = 6
SIGMA_FLOOR = 1e-8
# Newton backtracking with a deep tail + always-on scaled gradient-step
# candidates; the order is part of the algorithm (first best wins)
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 1.0 / 64.0, 1.0 / 256.0)
_GRAD_ALPHAS = (1.0, 0.0625)
_MODELS = {"nh": 0, "stvk": 1}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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

    b0, b1, b2 = matvec(0), matvec(1), matvec(2)

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
    U = [u0, u1, u2]
    s = (
        u0[0] * b0[0] + u0[1] * b0[1] + u0[2] * b0[2],
        u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2],
        u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2],
    )
    return U, cols, s


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


def nh_local_step_fused_reference(xg12, u9, warm, cp12, mu, lam, k, w2,
                                  iters=5, model="nh"):
    """Plain PyTorch version of the fused kernel, same signature and
    outputs: (z9, u9_new, warm_new, contrib12)."""
    xg = [xg12[p] for p in range(12)]
    cp = [cp12[p] for p in range(12)]
    dx = []
    for a in range(3):
        for b in range(3):
            acc = cp[4 * b] * xg[a]
            for kk in range(1, 4):
                acc = acc + cp[4 * b + kk] * xg[3 * kk + a]
            dx.append(acc)
    uu = [u9[p] for p in range(9)]
    f = [dx[p] + uu[p] for p in range(9)]
    eps = torch.finfo(xg12.dtype).eps
    U, V, s = _svd_columns(f, eps)
    x1, x2, x3 = _newton_hyper(s, _warm_guard(warm), mu, lam, k, iters, model)
    warm_new = torch.stack([x1, x2, x3])

    sig = (x1, x2, x3)
    z_planes, u_planes, zu = [], [], [None] * 9
    for r in range(3):
        for c in range(3):
            z = (
                U[0][r] * sig[0] * V[0][c]
                + U[1][r] * sig[1] * V[1][c]
                + U[2][r] * sig[2] * V[2][c]
            )
            un = uu[3 * r + c] + dx[3 * r + c] - z
            z_planes.append(z)
            u_planes.append(un)
            zu[3 * r + c] = z - un

    contrib = []
    for kk in range(4):
        for j in range(3):
            acc = cp[kk] * zu[3 * j]
            for r in range(1, 3):
                acc = acc + cp[4 * r + kk] * zu[3 * j + r]
            contrib.append(w2 * acc)
    return (torch.stack(z_planes), torch.stack(u_planes), warm_new,
            torch.stack(contrib))


def _check(xg12, u9, warm, cp12, mu, lam, k, w2):
    E = xg12.shape[1] if xg12.dim() == 2 else -1
    shapes = {"xg12": (xg12, (12, E)), "u9": (u9, (9, E)),
              "warm": (warm, (3, E)), "cp12": (cp12, (12, E)),
              "mu": (mu, (E,)), "lam": (lam, (E,)), "k": (k, (E,)),
              "w2": (w2, (E,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != xg12.device or t.dtype != xg12.dtype:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {xg12.dtype} on "
                f"{xg12.device}"
            )
    if xg12.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {xg12.dtype}")
    return E


def nh_local_step_fused(xg12, u9, warm, cp12, mu, lam, k, w2, iters=5,
                        model="nh", emit_z=False):
    """Fused local step + RHS contribution. Returns
    (z9, u9_new, warm_new, contrib12)."""
    if emit_z:
        raise NotImplementedError(
            "emit_z (dual-residual rows) belongs to collect_residuals, "
            "which is not ported yet"
        )
    if model not in _MODELS:
        raise ValueError(f"unknown hyperelastic model {model!r}")
    E = _check(xg12, u9, warm, cp12, mu, lam, k, w2)
    if xg12.device.type == "cpu":
        return nh_local_step_fused_reference(xg12, u9, warm, cp12, mu, lam,
                                             k, w2, iters=iters, model=model)
    if xg12.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xg12.device}")
    ins = [xg12, u9, warm, cp12, mu, lam, k, w2]
    z9 = torch.empty_like(ins[1])
    unew = torch.empty_like(ins[1])
    warm_new = torch.empty_like(ins[2])
    contrib = torch.empty_like(ins[0])
    fn = getattr(_build.load_library(), "nh_local_step_fused_"
                 + _SUFFIX[xg12.dtype])
    err = fn(*(t.data_ptr() for t in ins + [z9, unew, warm_new, contrib]),
             E, int(iters), _MODELS[model], _build.stream_ptr(xg12))
    _build.check(err, "nh_local_step_fused")
    nh_local_step_fused.launches += 1
    return z9, unew, warm_new, contrib


nh_local_step_fused.launches = 0

