"""A chunk of Chebyshev iterations with a sparse-DIAgonal matvec in one
launch: hand-written CUDA kernel + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/cheb_dia.py`
(`cheb_dia_chunk`), with the JAX signature on the port's layout: vectors
b, x, z, d of shape (n,3), invd (n,), dia (n_dia, n) at vertex `offsets`
(reads past either end are 0), c1, c2 (n_it,) on the device. It runs

    x_out = x
    first: z = D^{-1}(b - A x); d = inv_theta z     (z, d inputs unused)
    n_it times: x += d; z -= D^{-1} A d; d = c1[i] d + c2[i] z
    last:  x += d

and returns (x, z, d): the dot-free solve of `parallel/cheb.py`, whose
coefficients carry the spectral bounds. At one device a whole solve of k
Chebyshev iterations is one call with n_it = k - 1 and first = last =
True; a chunked solve threads (x, z, d) through calls.

`cheb_dia_chunk` launches `csrc/cheb_dia.cu` (one persistent cooperative
launch per call) for CUDA tensors and runs `cheb_dia_chunk_reference` for
CPU tensors. It never falls back from one to the other.
`cheb_recurrence` is the same recurrence over any matvec; the sharded
stepper's plain path runs it over the dia or the ELL matvec.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.solver import dia_apply
from . import _build
from .cg_dia import MAX_DIAGONALS


def cheb_recurrence(A, b, x, z, d, invd, c1, c2, *, n_it, first, last,
                    inv_theta):
    """The chunk's arithmetic over the matvec A, (n,3) -> (n,3), in the
    kernel's order. Returns (x, z, d); the inputs are left untouched."""
    invd = invd[:, None]
    if first:
        z = invd * (b - A(x))
        d = inv_theta * z
    for i in range(n_it):
        x = x + d
        z = z - invd * A(d)
        d = c1[i] * d + c2[i] * z
    if last:
        x = x + d
    return x, z, d


def cheb_dia_chunk_reference(b, x, z, d, invd, dia, c1, c2, *, offsets,
                             n_it, first, last, inv_theta):
    """Plain PyTorch version: `cheb_recurrence` around `dia_apply`."""
    return cheb_recurrence(lambda y: dia_apply(y, offsets, dia), b, x, z, d,
                           invd, c1, c2, n_it=n_it, first=first, last=last,
                           inv_theta=inv_theta)


def _check(b, x, z, d, invd, dia, c1, c2, offsets, n_it):
    n = b.shape[0] if b.dim() == 2 else -1
    shapes = {"b": (b, (n, 3)), "x": (x, (n, 3)), "z": (z, (n, 3)),
              "d": (d, (n, 3)), "invd": (invd, (n,)),
              "dia": (dia, (len(offsets), n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("c1", c1), ("c2", c2)):
        if t.dim() != 1 or t.shape[0] < n_it:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected at "
                             f"least ({n_it},)")
    for name, t in (*((k, v[0]) for k, v in shapes.items()), ("c1", c1),
                    ("c2", c2)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != b.device or t.dtype != b.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{b.dtype} on {b.device}")
    if b.dtype not in _build.SUFFIX:
        raise TypeError(f"unsupported dtype {b.dtype}")
    if not 1 <= len(offsets) <= MAX_DIAGONALS:
        raise ValueError(f"{len(offsets)} diagonals; the kernel takes "
                         f"1..{MAX_DIAGONALS}")
    if n_it < 0:
        raise ValueError("n_it must be >= 0")
    return n


def cheb_dia_chunk(b, x, z, d, invd, dia, c1, c2, *, offsets, n_it, first,
                   last, inv_theta):
    """Run n_it Chebyshev iterations in one launch; returns new (x, z, d).
    c1 and c2 hold at least n_it coefficients (an init-only call, n_it = 0,
    reads none)."""
    offsets = tuple(int(o) for o in offsets)
    n_it, first, last = int(n_it), bool(first), bool(last)
    n = _check(b, x, z, d, invd, dia, c1, c2, offsets, n_it)
    if b.device.type == "cpu":
        return cheb_dia_chunk_reference(
            b, x, z, d, invd, dia, c1, c2, offsets=offsets, n_it=n_it,
            first=first, last=last, inv_theta=inv_theta)
    if b.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {b.device}")
    # d is double-buffered in the kernel; the final d lands in d_out
    x_out, z_out, d_out, d_tmp = (torch.empty_like(b) for _ in range(4))
    offs = (ctypes.c_int * len(offsets))(*offsets)
    fn = getattr(_build.load_library(),
                 "cheb_dia_chunk_" + _build.SUFFIX[b.dtype])
    with torch.cuda.device(b.device):
        err = fn(*(t.data_ptr() for t in (b, x, z, d, invd, dia, c1, c2,
                                          x_out, z_out, d_out, d_tmp)),
                 ctypes.addressof(offs), n, len(offsets), n_it, int(first),
                 int(last), float(inv_theta), _build.stream_ptr(b))
    _build.check(err, "cheb_dia_chunk")
    cheb_dia_chunk.launches += 1
    return x_out, z_out, d_out


cheb_dia_chunk.launches = 0
