"""Fixed-iteration Jacobi-PCG with a sparse-DIAgonal matvec: hand-written
CUDA kernels + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cg_dia.py` (`cg_dia_solve`).
Solves A_hat X = B, X and B of shape (n,3), A_hat given by its diagonals
(`dia_vals` (D,n), static `offsets`) and its main diagonal `diag` (n,)
for the Jacobi preconditioner. Out-of-range diagonal entries are zero
(`core.solver.assemble_A_hat_dia` ensures it).

`cg_dia_solve` runs the whole solve through `csrc/cg_dia.cu` for CUDA
tensors (one C call, 1 + 3*n_iters launches, no host read-back) and
`cg_dia_solve_reference` for CPU tensors. It never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.solver import dia_apply, pcg_solve_fixed
from . import _build

MAX_DIAGONALS = 48  # the kernel's offset table (csrc/cg_dia.cu)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def cg_dia_solve_reference(b, x0, diag, dia_vals, offsets, n_iters):
    """Plain PyTorch version: pcg_solve_fixed around dia_apply."""
    x, _ = pcg_solve_fixed(
        lambda y: dia_apply(y, offsets, dia_vals), b, x0, diag, n_iters
    )
    return x


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


def cg_dia_solve(b, x0, diag, dia_vals, offsets, n_iters):
    """Solve A x = b with n_iters Jacobi-PCG iterations. b, x0: (n,3);
    diag: (n,); dia_vals: (D,n); offsets: tuple of D ints."""
    offsets = tuple(int(o) for o in offsets)
    n = _check(b, x0, diag, dia_vals, offsets)
    if b.device.type == "cpu":
        return cg_dia_solve_reference(b, x0, diag, dia_vals, offsets,
                                      int(n_iters))
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    lib = _build.load_library()
    fn = getattr(lib, "cg_dia_solve_" + _SUFFIX[b.dtype])
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    p = torch.empty_like(b)
    Ap = torch.empty_like(b)
    partials = torch.empty(lib.cg_dia_partials(n), dtype=b.dtype,
                           device=b.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    err = fn(b.data_ptr(), x0.data_ptr(), diag.data_ptr(), dia_vals.data_ptr(),
             ctypes.addressof(offs), len(offsets), n, int(n_iters),
             x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
             partials.data_ptr(), _build.stream_ptr(b))
    _build.check(err, "cg_dia_solve")
    cg_dia_solve.launches += 1
    return x


cg_dia_solve.launches = 0
