"""One ADMM iteration's local phase without the global solve: hand-written
CUDA kernels + plain twin.

Counterpart of `admm_elastic_tpu/ops/pallas/banded_local.py`
(`banded_local_rhs`; `banded_local_rhs_xla` is its XLA twin), the
per-device kernel of the sharded banded stepper (`parallel/banded_spmd.py`).
On a tet mesh with StaticAnchors and optional analytic collision shapes it
computes

    element phase  F = u + sum_k cp x[idx_k] -> SVD -> Newton prox (nh,
                   stvk; warm start) or the ARAP projection -> u' = F - z,
                   rows = w2 D^T (F - 2u')
    vertex phase   b = the incidence sum of the rows (slot order); the
                   anchor dual au' (0 where the anchor weight is 0), b +=
                   aw2 (ancz - au'); the collision shapes in declaration
                   order, cu', b += cw2 (z - cu')

and returns (b, au', cu', u', warm'). These are the phases of the banded
whole-timestep kernel (`banded_step.py`, shared in
`csrc/banded_phases.cuh` and in the twin's `_element_phase` and
`_vertex_rhs`), so b sums in the same order: the anchor term before the
collision term, where the JAX body adds the two first and then to b.
Arrays are the `BandedStepper`'s: x, au, cu (n,3); u (9,E); warm (3,E);
`planes` its planes dict (idx, cp, w2, mu, lam, k, aw2, ancz, inc); `cfg`
its `BandedConfig` (model, newton_iters, coll_shapes, coll_w2). No
padding: the JAX kernel's chunk planes, windows and lane permutations are
TPU layout.

`banded_local_rhs` launches `csrc/banded_local.cu` (two launches: element
kernel, then vertex kernel) for CUDA tensors and runs
`banded_local_rhs_reference` for CPU tensors. It never falls back from one
to the other. Neither changes its inputs. The JAX kernel's primal
residual (`collect=True`) is not ported: it raises (ROADMAP 2d).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .banded_step import (_MODELS, BandedConfig, _element_phase,
                          _vertex_rhs)

#: the planes of a BandedStepper that the local phase reads
PLANES = ("idx", "cp", "w2", "mu", "lam", "k", "aw2", "ancz", "inc")


def banded_local_rhs_reference(x, au, cu, u, warm, planes,
                               cfg: BandedConfig):
    """Plain PyTorch version: the banded twin's element phase and vertex
    RHS."""
    u, warm, rows = _element_phase(x, u, warm, planes, cfg,
                                   torch.finfo(x.dtype).eps)
    b, au, cu = _vertex_rhs(x, au, cu, rows, planes, cfg)
    return b, au, cu, u, warm


def _check(x, au, cu, u, warm, planes):
    n = x.shape[0] if x.dim() == 2 else -1
    E = u.shape[-1]
    S = planes["inc"].shape[-1]
    want = {"x": (x, (n, 3)), "au": (au, (n, 3)), "cu": (cu, (n, 3)),
            "u": (u, (9, E)), "warm": (warm, (3, E))}
    want.update({k: (planes[k], shape) for k, shape in (
        ("idx", (4, E)), ("cp", (12, E)), ("w2", (E,)), ("mu", (E,)),
        ("lam", (E,)), ("k", (E,)), ("aw2", (n,)), ("ancz", (n, 3)),
        ("inc", (n, S)))})
    if x.dtype not in _build.SUFFIX:
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        dtype = torch.int32 if name in ("idx", "inc") else x.dtype
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {x.device}")
    return n, E, S


def banded_local_rhs(x, au, cu, u, warm, planes, cfg: BandedConfig,
                     collect=False):
    """One ADMM iteration's local phase; returns new (b, au', cu', u',
    warm')."""
    if collect:
        raise NotImplementedError(
            "banded_local_rhs(collect=True): the primal residual output is "
            "not ported (ROADMAP 2d)")
    n, E, S = _check(x, au, cu, u, warm, planes)
    if x.device.type == "cpu":
        return banded_local_rhs_reference(x, au, cu, u, warm, planes, cfg)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    b, au_out, cu_out = (torch.empty_like(x) for _ in range(3))
    u_out, warm_out = torch.empty_like(u), torch.empty_like(warm)
    rows = x.new_empty((12, E))
    kinds, table = cfg.shape_table()
    ns = len(kinds)
    c_kinds = (ctypes.c_int * max(ns, 1))(*kinds)
    c_table = (ctypes.c_double * (5 * max(ns, 1)))(
        *[q for row in table for q in row])
    c_scal = (ctypes.c_double * 7)(*cfg.scalars())
    fn = getattr(_build.load_library(),
                 "banded_local_rhs_" + _build.SUFFIX[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in (x, au, cu, u, warm)),
                 *(planes[k].data_ptr() for k in PLANES),
                 *(t.data_ptr() for t in (b, au_out, cu_out, u_out, warm_out,
                                          rows)),
                 *(ctypes.addressof(a) for a in (c_kinds, c_table, c_scal)),
                 n, E, S, ns, _MODELS[cfg.model], cfg.newton_iters,
                 _build.stream_ptr(x))
    _build.check(err, "banded_local_rhs")
    banded_local_rhs.launches += 1
    return b, au_out, cu_out, u_out, warm_out


banded_local_rhs.launches = 0
