"""Fused triangle-strain (cloth) local step: hand-written CUDA kernel +
plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/tri_local.py`
(`tri_local_step_fused`). Per element:

    F      = sum_k cp * xg + u              (3x2, selector on gathered x)
    U,s,V  = closed-form SVD(F)             (2x2 eig of F^T F + safe
                                             orthonormalization of F V)
    z      = (k U V^T + w2 F) / (w2 + k),   column norms clamped into
                                            [lmin, lmax] when limiting
    u'     = F - z
    contrib[3k+j] = w2 * sum_r cp[3r+k] * (z - u')[2j+r]

Layout: plane-major xg9, contrib9 (9,E) with plane 3k+a = x[face[e,k], a];
u6, z6, cp6 (6,E) with plane 2a+b = F_{a,b} and plane 3b+k = coeff[e,b,k];
w2, k, lmin, lmax (E,). No padding: E is any size.

`tri_local_step_fused` launches the kernel (`csrc/tri_local.cu`) for CUDA
tensors and runs `tri_local_step_fused_reference`, a straight transcription
of the Pallas math in its evaluation order, for CPU tensors. It never falls
back from one to the other. `_svd32` and `_tri_body` are shared with the
cloth kernel's twin (`ops/kernels/cloth_step.py`), as `csrc/tri.cuh` is
shared by the two kernels.
"""

from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _norm3(x):
    return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])


def _svd32(f, eps):
    """f: 6 planes of F (3x2, plane 2a+b). Returns (U, V): U = [u0, u1]
    lists of 3 arrays, V = [v0, v1] lists of 2 (s0 >= s1 >= 0; no
    orientation handling is needed for a 3x2 factor)."""

    def dotc(ba, bb):
        return f[ba] * f[bb] + f[2 + ba] * f[2 + bb] + f[4 + ba] * f[4 + bb]

    a00, a11, a01 = dotc(0, 0), dotc(1, 1), dotc(0, 1)
    tr = a00 + a11
    diff = a00 - a11
    rad = torch.sqrt(diff * diff + 4.0 * a01 * a01)
    w0 = 0.5 * (tr + rad)
    c1x, c1y = w0 - a11, a01
    c2x, c2y = a01, w0 - a00
    n1 = c1x * c1x + c1y * c1y
    n2 = c2x * c2x + c2y * c2y
    use1 = n1 >= n2
    vx = torch.where(use1, c1x, c2x)
    vy = torch.where(use1, c1y, c2y)
    nn = torch.sqrt(torch.maximum(n1, n2))
    ok = nn > eps * torch.clamp_min(tr, 1.0)
    inv = 1.0 / torch.where(ok, nn, 1.0)
    c = torch.where(ok, vx * inv, 1.0)
    s_ = torch.where(ok, vy * inv, 0.0)
    v0 = [c, s_]
    v1 = [-s_, c]
    s0 = torch.sqrt(torch.clamp_min(w0, 0.0))

    def matvec(v):
        return [f[0] * v[0] + f[1] * v[1], f[2] * v[0] + f[3] * v[1],
                f[4] * v[0] + f[5] * v[1]]

    b0 = matvec(v0)
    b1 = matvec(v1)
    tol = eps * 16.0 * (s0 + eps)
    n0 = _norm3(b0)
    ok0 = n0 > tol
    inv0 = 1.0 / torch.where(ok0, n0, 1.0)
    u0 = [torch.where(ok0, b0[a] * inv0, 1.0 if a == 0 else 0.0)
          for a in range(3)]

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    p1 = [b1[a] - d01 * u0[a] for a in range(3)]
    np1 = _norm3(p1)
    ok1 = np1 > tol
    inv1 = 1.0 / torch.where(ok1, np1, 1.0)
    # fallback axis least aligned with u0
    au = [torch.abs(u0[0]), torch.abs(u0[1]), torch.abs(u0[2])]
    use_x = (au[0] <= au[1]) & (au[0] <= au[2])
    use_y = (~use_x) & (au[1] <= au[2])
    zero, one = torch.zeros_like(a00), torch.ones_like(a00)
    ax = [torch.where(use_x, 1.0, zero), torch.where(use_y, 1.0, zero),
          torch.where(use_x | use_y, 0.0, one)]
    dax = ax[0] * u0[0] + ax[1] * u0[1] + ax[2] * u0[2]
    fb = [ax[a] - dax * u0[a] for a in range(3)]
    fbn = _norm3(fb)
    fb = [fb[a] / torch.where(fbn > 0, fbn, 1.0) for a in range(3)]
    u1 = [torch.where(ok1, p1[a] * inv1, fb[a]) for a in range(3)]
    return [u0, u1], [v0, v1]


def _tri_body(f, w2, k, denom, lmin, lmax, limiting):
    """F planes -> z planes (strain-limited mix); denom = 1/(w2 + k) as the
    caller forms it."""
    eps = torch.finfo(f[0].dtype).eps
    U, V = _svd32(f, eps)
    z = [None] * 6
    for a in range(3):
        for b in range(2):
            t = U[0][a] * V[0][b] + U[1][a] * V[1][b]
            z[2 * a + b] = (k * t + w2 * f[2 * a + b]) * denom
    if limiting:
        # clamp column norms into [lmin, lmax] (TriangleForce.cpp:100-107)
        for b in range(2):
            l = _norm3([z[b], z[2 + b], z[4 + b]])
            safe = torch.clamp_min(l, 1e-6)
            scale = torch.where(l < lmin, lmin / safe,
                                torch.where(l > lmax, lmax / safe, 1.0))
            for a in range(3):
                z[2 * a + b] = z[2 * a + b] * scale
    return z


def tri_local_step_fused_reference(xg9, u6, cp6, w2, k, lmin, lmax,
                                   limiting=True):
    """Plain PyTorch version of the fused kernel, same signature and
    outputs: (z6, u6_new, contrib9)."""
    xg = [xg9[p] for p in range(9)]
    cp = [cp6[p] for p in range(6)]
    f = []
    for a in range(3):
        for b in range(2):
            acc = cp[3 * b] * xg[a]
            for kk in range(1, 3):
                acc = acc + cp[3 * b + kk] * xg[3 * kk + a]
            f.append(acc + u6[2 * a + b])
    z = _tri_body(f, w2, k, 1.0 / (w2 + k), lmin, lmax, limiting)
    u_new, zu = [], []
    for p in range(6):
        u_new.append(f[p] - z[p])
        zu.append(z[p] - u_new[-1])  # = 2z - F
    contrib = [w2 * (cp[kk] * zu[2 * j] + cp[3 + kk] * zu[2 * j + 1])
               for kk in range(3) for j in range(3)]
    return torch.stack(z), torch.stack(u_new), torch.stack(contrib)


def _check(xg9, u6, cp6, w2, k, lmin, lmax):
    E = xg9.shape[1] if xg9.dim() == 2 else -1
    shapes = {"xg9": (xg9, (9, E)), "u6": (u6, (6, E)), "cp6": (cp6, (6, E)),
              "w2": (w2, (E,)), "k": (k, (E,)), "lmin": (lmin, (E,)),
              "lmax": (lmax, (E,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != xg9.device or t.dtype != xg9.dtype:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {xg9.dtype} on "
                f"{xg9.device}"
            )
    if xg9.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {xg9.dtype}")
    return E


def tri_local_step_fused(xg9, u6, cp6, w2, k, lmin, lmax, limiting=True,
                         emit_z=False):
    """Fused local step + RHS contribution. Returns (z6, u6_new,
    contrib9)."""
    if emit_z:
        raise NotImplementedError(
            "emit_z (dual-residual rows) belongs to collect_residuals, "
            "which is not ported yet"
        )
    E = _check(xg9, u6, cp6, w2, k, lmin, lmax)
    if xg9.device.type == "cpu":
        return tri_local_step_fused_reference(xg9, u6, cp6, w2, k, lmin, lmax,
                                              limiting=limiting)
    if xg9.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {xg9.device}")
    ins = [xg9, u6, cp6, w2, k, lmin, lmax]
    z6 = torch.empty_like(u6)
    unew = torch.empty_like(u6)
    contrib = torch.empty_like(xg9)
    fn = getattr(_build.load_library(), "tri_local_step_fused_"
                 + _SUFFIX[xg9.dtype])
    err = fn(*(t.data_ptr() for t in ins + [z6, unew, contrib]), E,
             int(bool(limiting)), _build.stream_ptr(xg9))
    _build.check(err, "tri_local_step_fused")
    tri_local_step_fused.launches += 1
    return z6, unew, contrib


tri_local_step_fused.launches = 0
