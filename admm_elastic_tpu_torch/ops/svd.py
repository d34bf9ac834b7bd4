"""Branch-free batched small SVDs: the JAX package's `ops/svd.py` in
PyTorch, the SVD of the default (`backend="xla"`) element models.

The reference computes per-element 3x3 / 3x2 SVDs with Eigen's JacobiSVD
(TetForce.cpp:80-102, TriangleForce.cpp:90). This is the JAX package's
fixed-iteration formulation of it: cyclic-Jacobi eigendecomposition of
F^T F followed by a safe orthonormalization of F V.

`svd3x3_oriented` reproduces the reference's `oriented_svd` semantics
(TetForce.cpp:88-100): U and V are proper rotations (det=+1) and any
reflection is absorbed into the sign of the LAST singular value, so
sigma = (s0, s1, s2) with s0 >= s1 >= |s2| and sign(s2) = sign(det F).

Every function takes a leading element axis ((E, 3, 3) in, (E, 3) and
(E, 3, 3) out) and runs the same operations, in the same order, as the
JAX function under `jax.vmap`: elementwise tensor operations over all
elements at once, no data-dependent control flow and no loop over
elements. The Pallas-kernel twins (`ops/kernels/tri_local.py`,
`nh_local.py`) transcribe other algorithms and are not used here.

Where XLA evaluates an operation as fused multiply-adds (its small matrix
products, `jnp.cross` and `jnp.linalg.norm`, which JAX compiles as units),
so does this module (`_fma`, `torch.addcmul`: one rounding), in XLA's
order; `jnp.dot` of two vectors rounds each product. Square roots are
correctly rounded (`_sqrt`). So on the CPU the factors agree with JAX's
bit for bit but for the last ulps of `atan2` / `cos` / `sin`.
"""

from __future__ import annotations

import torch

_JACOBI_SWEEPS = 6  # 6 cyclic sweeps drive off-diagonals below fp64 roundoff for 3x3


def _fma(a, b, c):
    """a * b + c with one rounding."""
    return torch.addcmul(c, a, b)


def _sqrt(x):
    """Correctly rounded square root. The CPU's torch.sqrt is 1 ulp off
    for ~1% of inputs; of it and its two neighbours this keeps the one
    with the smallest exact residual |x - r^2| (one fused multiply-add)."""
    r = torch.sqrt(x)
    if r.device.type != "cpu":
        return r
    best = torch.abs(_fma(-r, r, x))
    for c in (torch.nextafter(r, torch.full_like(r, torch.inf)),
              torch.nextafter(r, torch.zeros_like(r))):
        e = torch.abs(_fma(-c, c, x))
        r, best = torch.where(e < best, c, r), torch.minimum(e, best)
    return r


def _matmul(A, B):
    """Batched (E, m, K) @ (E, K, n), each entry a fused multiply-add
    chain over K in order, as XLA's dot."""
    acc = A[:, :, 0, None] * B[:, None, 0, :]
    for k in range(1, A.shape[2]):
        acc = _fma(A[:, :, k, None], B[:, None, k, :], acc)
    return acc


def _jacobi_rotation(app, aqq, apq, eps):
    """(c, s) of the Jacobi rotation annihilating apq. Branch-free."""
    small = torch.abs(apq) < eps
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    t = torch.sign(tau) / (torch.abs(tau) + _sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / _sqrt(1.0 + t * t)
    s = t * c
    return c, s


def eigh_sym3x3(A: torch.Tensor):
    """Eigendecomposition of symmetric 3x3s (E, 3, 3) by fixed-sweep cyclic
    Jacobi.

    Returns (w (E, 3), V (E, 3, 3)): eigenvalues descending, the columns of
    V the eigenvectors, A = V diag(w) V^T. det(V) = +1 is NOT guaranteed
    (columns are permuted for sorting); callers needing a rotation fix the
    sign themselves."""
    eps = torch.finfo(A.dtype).tiny * 1e3
    scale = torch.clamp_min(torch.abs(A).amax(dim=(1, 2)), 1.0)
    # symmetric state: diagonal (a00,a11,a22) + off-diagonals (a01,a02,a12)
    a00, a11, a22 = A[:, 0, 0] / scale, A[:, 1, 1] / scale, A[:, 2, 2] / scale
    a01, a02, a12 = A[:, 0, 1] / scale, A[:, 0, 2] / scale, A[:, 1, 2] / scale
    zero = torch.zeros_like(a00)
    # v[:, row, col], the rotations applied to its columns
    v = torch.eye(3, dtype=A.dtype, device=A.device).expand(
        A.shape[0], 3, 3).clone()

    def rot_cols(p, q, c, s):
        vp, vq = v[:, :, p], v[:, :, q]
        c, s = c[:, None], s[:, None]
        new_p, new_q = c * vp - s * vq, s * vp + c * vq
        v[:, :, p], v[:, :, q] = new_p, new_q

    for _ in range(_JACOBI_SWEEPS):
        # (p,q) = (0,1)
        c, s = _jacobi_rotation(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a11, a01, a02, a12 = n00, n11, zero, n02, n12
        rot_cols(0, 1, c, s)
        # (p,q) = (0,2)
        c, s = _jacobi_rotation(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a22, a02, a01, a12 = n00, n22, zero, n01, n12
        rot_cols(0, 2, c, s)
        # (p,q) = (1,2)
        c, s = _jacobi_rotation(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a11, a22, a12, a01, a02 = n11, n22, zero, n01, n02
        rot_cols(1, 2, c, s)

    w = [a00 * scale, a11 * scale, a22 * scale]
    # descending sort of (eigenvalue, eigenvector column) pairs by a
    # 3-element sorting network of where-swaps, as the JAX package
    cols = [v[:, :, c] for c in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        swap = swap[:, None]
        cols[i], cols[j] = (torch.where(swap, cols[j], cols[i]),
                            torch.where(swap, cols[i], cols[j]))

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    return torch.stack(w, dim=1), torch.stack(cols, dim=2)


def _dot(a, b):
    """Row-wise dot products of (E, 3) vectors, summed in index order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    """Row-wise cross products of (E, 3) vectors (jnp.cross's formula,
    its first product fused into the difference)."""
    return torch.stack([_fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        _fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        _fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


def _norm(v):
    """Row-wise Euclidean norms of (E, 3) vectors: the squares summed in
    order as a fused multiply-add chain."""
    sq = _fma(v[:, 2], v[:, 2], _fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))
    return _sqrt(sq)


def _safe_normalize(v, fallback, eps):
    """v / |v| row by row where |v| > eps, else the fallback row."""
    n = _norm(v)
    safe = n > eps
    return torch.where(safe[:, None], v / torch.where(safe, n, 1.0)[:, None],
                       fallback), safe


def _det3(M):
    """Elementwise 3x3 determinants, (E, 3, 3) -> (E,)."""
    return _dot(M[:, :, 0], _cross(M[:, :, 1], M[:, :, 2]))


def _axis(i, like):
    """The i-th unit vector in like's dtype and device."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i]


def _orthogonal_to(u):
    """A unit vector orthogonal to each unit row of u, branch-free."""
    # pick the axis least aligned with u via where-chains, project, normalize
    au = torch.abs(u)
    use_x = (au[:, 0] <= au[:, 1]) & (au[:, 0] <= au[:, 2])
    use_y = (~use_x) & (au[:, 1] <= au[:, 2])
    ax = torch.where(use_x[:, None], _axis(0, u),
                     torch.where(use_y[:, None], _axis(1, u), _axis(2, u)))
    w = ax - _dot(ax, u)[:, None] * u
    return w / _norm(w)[:, None]


def svd3x3_oriented(F: torch.Tensor):
    """Oriented SVDs of (E, 3, 3): F = U diag(s) V^T with det U = det V = +1.

    s is sorted s0 >= s1 >= |s2|; s2 < 0 iff det F < 0 (inverted element).
    Safe for rank-deficient and zero F (returns identity factors)."""
    eps = torch.finfo(F.dtype).eps
    w, V = eigh_sym3x3(_matmul(F.transpose(1, 2), F))
    # make V a proper rotation: flip the last column if reflected
    flip = torch.where(_det3(V) < 0, -1.0, 1.0).to(F.dtype)
    V = V * torch.stack([torch.ones_like(flip), torch.ones_like(flip), flip],
                        dim=1)[:, None, :]

    B = _matmul(F, V)  # columns b_i = s_i * u_i
    norm_scale = _sqrt(torch.clamp_min(w[:, 0], 0.0)) + eps
    tol = eps * 16.0 * norm_scale

    b0, b1, b2 = B[:, :, 0], B[:, :, 1], B[:, :, 2]
    u0, _ = _safe_normalize(b0, _axis(0, F), tol)
    b1p = b1 - _dot(u0, b1)[:, None] * u0
    u1, _ = _safe_normalize(b1p, _orthogonal_to(u0), tol)
    u2 = _cross(u0, u1)
    U = torch.stack([u0, u1, u2], dim=2)
    # signed: s2 negative iff det F < 0
    s = torch.stack([_dot(u0, b0), _dot(u1, b1), _dot(u2, b2)], dim=1)
    return U, s, V


def polar_project(F: torch.Tensor):
    """The nearest proper rotation (det +1) to each F of (E, 3, 3): the
    reference's LinearTetStrain projection (TetForce.cpp:137-143), U V^T
    with the oriented factors."""
    U, _, V = svd3x3_oriented(F)
    return _matmul(U, V.transpose(1, 2))


def eigh_sym2x2(A: torch.Tensor):
    """Closed-form eigendecompositions of symmetric 2x2s (E, 2, 2);
    eigenvalues descending, V orthogonal (columns may be permuted for
    sorting, so det may be -1)."""
    a, b, d = A[:, 0, 0], A[:, 0, 1], A[:, 1, 1]
    half_tr = 0.5 * (a + d)
    half_diff = 0.5 * (a - d)
    rad = _sqrt(half_diff * half_diff + b * b)
    w = torch.stack([half_tr + rad, half_tr - rad], dim=1)
    theta = 0.5 * torch.atan2(2.0 * b, a - d)
    c, s = torch.cos(theta), torch.sin(theta)
    V = torch.stack([torch.stack([c, -s], dim=1),
                     torch.stack([s, c], dim=1)], dim=1)
    # ensure column order matches descending eigenvalues
    swap = (a * c * c + 2 * b * c * s + d * s * s
            < a * s * s - 2 * b * c * s + d * c * c)
    V = torch.where(swap[:, None, None], V.flip(2), V)
    return w, V


def svd3x2(F: torch.Tensor):
    """Thin SVDs of (E, 3, 2): F = U diag(s) V^T, U (E, 3, 2) orthonormal
    columns, V (E, 2, 2), s0 >= s1 >= 0: the JacobiSVD thin-U semantics of
    the triangle forces (TriangleForce.cpp:90-93)."""
    eps = torch.finfo(F.dtype).eps
    w, V = eigh_sym2x2(_matmul(F.transpose(1, 2), F))
    s = _sqrt(torch.clamp_min(w, 0.0))
    B = _matmul(F, V)
    tol = eps * 16.0 * (s[:, 0] + eps)
    b0, b1 = B[:, :, 0], B[:, :, 1]
    u0, _ = _safe_normalize(b0, _axis(0, F), tol)
    b1p = b1 - _dot(u0, b1)[:, None] * u0
    u1, _ = _safe_normalize(b1p, _orthogonal_to(u0), tol)
    U = torch.stack([u0, u1], dim=2)
    # s with signs from the projection (>= 0 up to roundoff)
    s = torch.stack([_dot(u0, b0), _dot(u1, b1)], dim=1)
    return U, s, V
