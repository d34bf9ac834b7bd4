"""Fixed-iteration Jacobi-PCG with a sparse-DIAgonal matvec: hand-written
CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cg_dia.py` (`cg_dia_solve`).
Solves A_hat X = B, X and B of shape (n,3), A_hat given by its diagonals
(`dia_vals` (D,n), static `offsets`) and its main diagonal `diag` (n,)
for the Jacobi preconditioner. Out-of-range diagonal entries are zero
(`core.solver.assemble_A_hat_dia` ensures it).

`cg_dia_solve` runs the whole solve through `csrc/cg_dia.cu` for CUDA
tensors (one launch on one thread-block cluster, `csrc/cluster_pcg.cuh`)
and `cg_dia_solve_reference` for CPU tensors. It never falls back from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.solver import dia_apply, pcg_fixed_inv
from .cg_step import cluster_dot, cluster_solve

MAX_DIAGONALS = 48  # the kernel's offset table (csrc/dia.cuh)


def cg_dia_solve_reference(b, x0, diag, dia_vals, offsets, n_iters,
                           inverse=False):
    """Plain PyTorch version: pcg_fixed_inv around dia_apply, with its
    dots in the kernel's order (`cluster_dot`), so the kernel repeats it
    bitwise. inverse: diag holds D^-1 itself."""
    inv = diag if inverse else 1.0 / diag
    return pcg_fixed_inv(lambda y: dia_apply(y, offsets, dia_vals), b, x0,
                         inv, n_iters, dot=cluster_dot)


def _check(b, x0, diag, dia_vals, offsets):
    n = b.shape[0] if b.dim() == 2 else -1
    D = len(offsets)
    shapes = {"b": (b, (n, 3)), "x0": (x0, (n, 3)), "diag": (diag, (n,)),
              "dia_vals": (dia_vals, (D, n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != b.device or t.dtype != b.dtype:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {b.dtype} on "
                f"{b.device}"
            )
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {b.dtype}")
    if not 1 <= D <= MAX_DIAGONALS:
        raise ValueError(f"{D} diagonals; the kernel takes 1..{MAX_DIAGONALS}")
    return n


def cg_dia_solve(b, x0, diag, dia_vals, offsets, n_iters, inverse=False):
    """Solve A x = b with n_iters Jacobi-PCG iterations. b, x0: (n,3);
    diag: (n,) A's diagonal, or with inverse=True its inverse D^-1;
    dia_vals: (D,n); offsets: tuple of D ints."""
    offsets = tuple(int(o) for o in offsets)
    _check(b, x0, diag, dia_vals, offsets)
    if b.device.type == "cpu":
        return cg_dia_solve_reference(b, x0, diag, dia_vals, offsets,
                                      int(n_iters), inverse)
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    offs = (ctypes.c_int * len(offsets))(*offsets)
    ptrs = [t.data_ptr() for t in (b, x0, diag, dia_vals)]
    x = cluster_solve("cg_dia_solve", b, [*ptrs, ctypes.addressof(offs)],
                      len(offsets), max(abs(o) for o in offsets),
                      len(offsets), n_iters, inverse)
    cg_dia_solve.launches += 1
    return x


cg_dia_solve.launches = 0
