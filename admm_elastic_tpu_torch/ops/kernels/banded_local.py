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

and returns (b, au', cu', u', warm'), with `collect` also r2, the squared
primal residual ||W (D x - z)||^2 of the iteration (0-dim; the sharded
stepper's "primal" residual is its square root). These are the phases of the banded
whole-timestep kernel (`banded_step.py`, shared in
`csrc/banded_phases.cuh` and in the twin's `_element_phase` and
`_vertex_rhs`), so b sums in the same order: the anchor term before the
collision term, where the JAX body adds the two first and then to b.
Arrays are the `BandedStepper`'s: x, au, cu (n,3); u (9,E); warm (3,E);
`planes` its planes dict (idx, cp, w2, mu, lam, k, aw2, ancz; inc for
the twin, its slot planes pos and off for the kernels); `cfg`
its `BandedConfig` (model, newton_iters, coll_shapes, coll_w2). No
padding: the JAX kernel's chunk planes, windows and lane permutations are
TPU layout.

`banded_local_rhs` launches `csrc/banded_local.cu` (two launches: element
kernel, which writes each element's rows into its vertices' slots, then
vertex kernel, which adds its slots in order; with collect a third, one
block that sums the residual's block partials, `residuals.py`) for CUDA
tensors and runs `banded_local_rhs_reference` for CPU tensors. It never
falls back from one to the other. Neither changes its inputs. On a card
the planes dict and the config are checked and made into the C call's
arguments once (`_Phase`, kept for each planes dict, config, dtype and
device); each call then checks only the state, and writes into `out`
when the caller gives its buffers.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, residuals
from .banded_step import (_MODELS, BandedConfig, _element_phase,
                          _vertex_rhs)

#: the planes of a BandedStepper that the kernels read, in their C entry's
#: order (the twin reads the incidence "inc" in place of the slot planes
#: "pos" and "off")
PLANES = ("idx", "cp", "w2", "mu", "lam", "k", "aw2", "ancz", "pos", "off")
_INT = ("idx", "inc", "pos", "off")


def banded_local_rhs_reference(x, au, cu, u, warm, planes,
                               cfg: BandedConfig, collect=False):
    """Plain PyTorch version: the banded twin's element phase and vertex
    RHS (and with collect their primal residual pieces, summed in the
    kernels' order)."""
    eps = torch.finfo(x.dtype).eps
    if not collect:
        u, warm, rows = _element_phase(x, u, warm, planes, cfg, eps)
        b, au, cu = _vertex_rhs(x, au, cu, rows, planes, cfg)
        return b, au, cu, u, warm
    u, warm, rows, ep, _ = _element_phase(x, u, warm, planes, cfg, eps,
                                          "primal")
    b, au, cu, vp, _, _ = _vertex_rhs(x, au, cu, rows, planes, cfg, "primal")
    r2 = residuals.sum_partials(torch.cat(
        [residuals.block_partials(ep), residuals.block_partials(vp)]))
    return b, au, cu, u, warm, r2


def _check_all(want, dtype, device):
    """Raise on the first of want {name: (tensor, shape)} that is not of
    its shape, contiguous, on `device` and of `dtype` (int32 for the index
    planes)."""
    if dtype not in _build.SUFFIX:
        raise TypeError(f"unsupported dtype {dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        tdtype = torch.int32 if name in _INT else dtype
        if t.device != device or t.dtype != tdtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{tdtype} on {device}")


def _state_shapes(x, au, cu, u, warm):
    n = x.shape[0] if x.dim() == 2 else -1
    E = u.shape[-1]
    return n, E, {"x": (x, (n, 3)), "au": (au, (n, 3)), "cu": (cu, (n, 3)),
                  "u": (u, (9, E)), "warm": (warm, (3, E))}


def _plane_shapes(planes, n, E):
    S = planes["inc"].shape[-1]
    return {k: (planes[k], shape) for k, shape in (
        ("idx", (4, E)), ("cp", (12, E)), ("w2", (E,)), ("mu", (E,)),
        ("lam", (E,)), ("k", (E,)), ("aw2", (n,)), ("ancz", (n, 3)),
        ("inc", (n, S)), ("pos", (4, E)), ("off", (n + 1,)))}


def _check(x, au, cu, u, warm, planes):
    n, E, want = _state_shapes(x, au, cu, u, warm)
    _check_all({**want, **_plane_shapes(planes, n, E)}, x.dtype, x.device)


class _Phase(_build.Plan):
    """The C call of banded_local_rhs on one planes dict and config: its
    planes checked, their pointers, the shape table and scalars as C
    arrays, and the entry point, made once."""

    def __init__(self, planes, cfg, x):
        n, E = planes["aw2"].shape[0], planes["idx"].shape[-1]
        want = _plane_shapes(planes, n, E)
        _check_all(want, x.dtype, x.device)
        self.n, self.E = n, E
        self.hold({k: planes[k] for k in want}, x.dtype, x.device)
        self.ptrs = tuple(planes[k].data_ptr() for k in PLANES)
        kinds, table = cfg.shape_table()
        ns = len(kinds)
        self.n_shapes = ns
        self._host = ((ctypes.c_int * max(ns, 1))(*kinds),
                      (ctypes.c_double * (5 * max(ns, 1)))(
                          *[q for row in table for q in row]),
                      (ctypes.c_double * 7)(*cfg.scalars()))
        self.host = tuple(ctypes.addressof(a) for a in self._host)
        self.ints = (_MODELS[cfg.model], cfg.newton_iters)
        self.nparts = (-(-E // residuals.THREADS)
                       - (-n // residuals.THREADS))
        self.fn = getattr(_build.load_library(),
                          "banded_local_rhs_" + _build.SUFFIX[x.dtype])

    def check(self, x, au, cu, u, warm):
        """The state's shapes, devices, dtypes and layout: the common case
        in one expression, the detail only where it fails."""
        n, E = self.n, self.E
        if (x.shape == au.shape == cu.shape == (n, 3)
                and u.shape == (9, E) and warm.shape == (3, E)
                and x.dtype == au.dtype == cu.dtype == u.dtype == warm.dtype
                and x.device == au.device == cu.device == u.device
                == warm.device
                and x.is_contiguous() and au.is_contiguous()
                and cu.is_contiguous() and u.is_contiguous()
                and warm.is_contiguous()):
            return
        _, _, want = _state_shapes(x, au, cu, u, warm)
        want.update(x=(x, (n, 3)), u=(u, (9, E)))
        _check_all(want, x.dtype, x.device)


def _phase(planes, cfg, x):
    """The phase of this planes dict, config, dtype and device
    (`_build.plan`)."""
    return _build.plan(("banded_local_rhs", id(planes), cfg, x.dtype,
                        x.device), planes, lambda: _Phase(planes, cfg, x))


def banded_local_rhs(x, au, cu, u, warm, planes, cfg: BandedConfig,
                     collect=False, out=None):
    """One ADMM iteration's local phase; returns new (b, au', cu', u',
    warm'), and with collect r2 after them. `out`: optional (b, au', cu',
    u', warm') buffers to write instead of new ones (CUDA; none of them an
    input)."""
    if x.device.type != "cuda":
        _check(x, au, cu, u, warm, planes)
        if x.device.type != "cpu":
            raise RuntimeError(f"no kernel for device {x.device}")
        return banded_local_rhs_reference(x, au, cu, u, warm, planes, cfg,
                                          collect)
    ph = _phase(planes, cfg, x)
    ph.check(x, au, cu, u, warm)
    out = ph.outputs(out, (x.shape, x.shape, x.shape, u.shape, warm.shape),
                     (x, au, cu, u, warm))
    slots = x.new_empty((4 * ph.E, 4))
    part = x.new_empty((ph.nparts,)) if collect else None
    r2 = x.new_empty(()) if collect else None
    with torch.cuda.device(x.device):
        err = ph.fn(x.data_ptr(), au.data_ptr(), cu.data_ptr(),
                    u.data_ptr(), warm.data_ptr(), *ph.ptrs,
                    *(t.data_ptr() for t in out), slots.data_ptr(),
                    None if part is None else part.data_ptr(),
                    None if r2 is None else r2.data_ptr(), *ph.host,
                    ph.n, ph.E, ph.n_shapes, *ph.ints,
                    int(bool(collect)),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        _build.check(err, "banded_local_rhs")
    banded_local_rhs.launches += 1
    banded_local_rhs.residual_launches += bool(collect)
    return out + (r2,) if collect else out


banded_local_rhs.launches = 0
#: the calls in its collect mode (a count within `launches`)
banded_local_rhs.residual_launches = 0
