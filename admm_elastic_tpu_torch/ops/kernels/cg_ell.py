"""Fixed-iteration Jacobi-PCG with an ELL gather matvec: hand-written CUDA
kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cg_ell.py` (`cg_ell_solve`).
Solves A_hat X = B, X and B of shape (n,3), A_hat given in padded ELL form
(`ell_idx` (n,K) int32 column indices, `ell_vals` (n,K) values,
`core.solver.assemble_A_hat_ell`) and its main diagonal `diag` (n,) for the
Jacobi preconditioner: the global solve of a tet mesh of any topology.

`cg_ell_solve` runs the whole solve through `csrc/cg_ell.cu` for CUDA
tensors (one launch on one thread-block cluster, `csrc/cluster_pcg.cuh`,
whose windows `bandwidth` sizes, reading the matrix slot-major,
`slot_major`) and `cg_ell_solve_reference` for CPU tensors. It never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from ...core.solver import pcg_fixed_inv
from .cg_step import cluster_dot, cluster_solve

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def ell_apply_by_slot(x, ell_idx, ell_vals):
    """`core.solver.ell_apply` with the K slots added one at a time, in
    slot order, as the kernels' rows add them (csrc/cg_ell.cu,
    csrc/ell.cuh)."""
    out = torch.zeros_like(x)
    for term in (ell_vals[:, :, None] * x[ell_idx]).unbind(1):
        out = out + term
    return out


def cg_ell_solve_reference(b, x0, diag, ell_idx, ell_vals, n_iters,
                           inverse=False):
    """Plain PyTorch version: pcg_fixed_inv around the ELL matvec, with
    every sum in the kernel's order (`cluster_dot`), so the kernel repeats
    it bitwise. inverse: diag holds D^-1 itself."""
    inv = diag if inverse else 1.0 / diag
    return pcg_fixed_inv(lambda y: ell_apply_by_slot(y, ell_idx, ell_vals),
                         b, x0, inv, n_iters, dot=cluster_dot)


def _check(b, x0, diag, ell_idx, ell_vals):
    n = b.shape[0] if b.dim() == 2 else -1
    K = ell_idx.shape[-1] if ell_idx.dim() == 2 else -1
    if b.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {b.dtype}")
    shapes = {"b": (b, (n, 3), b.dtype), "x0": (x0, (n, 3), b.dtype),
              "diag": (diag, (n,), b.dtype),
              "ell_idx": (ell_idx, (n, K), torch.int32),
              "ell_vals": (ell_vals, (n, K), b.dtype)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != b.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {b.device}")
    if K < 1:
        raise ValueError("ell_idx: no slots")
    return n, K


def _kept(t, key, make):
    """make(t), kept on the tensor under `key` while it is unchanged (its
    version counter): one computation a matrix, not one a solve."""
    got = getattr(t, key, None)
    if got is None or got[0] != t._version:
        got = (t._version, make(t))
        setattr(t, key, got)
    return got[1]


def bandwidth(ell_idx):
    """max |ell_idx[i, k] - i|: how far a row of the matrix reaches, which
    sizes the kernel's windows. One reduction and read-back per index
    tensor, kept while it is unchanged."""
    def reach(idx):
        rows = torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device)
        return int((idx - rows[:, None]).abs().max())
    return _kept(ell_idx, "_cluster_reach", reach)


def slot_major(t):
    """The (K,n) copy of an (n,K) ELL array that the kernel reads (a
    warp's 32 rows of one slot are one line), kept while t is unchanged;
    (S,K,n) of a sweep's (S,n,K) values."""
    return _kept(t, "_slot_major",
                 lambda a: a.transpose(-2, -1).contiguous())


def cg_ell_solve(b, x0, diag, ell_idx, ell_vals, n_iters, inverse=False):
    """Solve A x = b with n_iters Jacobi-PCG iterations. b, x0: (n,3);
    diag: (n,) A's diagonal, or with inverse=True its inverse D^-1;
    ell_idx: (n,K) int32; ell_vals: (n,K)."""
    _check(b, x0, diag, ell_idx, ell_vals)
    if b.device.type == "cpu":
        return cg_ell_solve_reference(b, x0, diag, ell_idx, ell_vals,
                                      int(n_iters), inverse)
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    ptrs = [t.data_ptr() for t in (b, x0, diag, slot_major(ell_idx),
                                   slot_major(ell_vals))]
    x = cluster_solve("cg_ell_solve", b, ptrs, ell_idx.shape[1],
                      bandwidth(ell_idx), 0, n_iters, inverse)
    cg_ell_solve.launches += 1
    return x


cg_ell_solve.launches = 0
