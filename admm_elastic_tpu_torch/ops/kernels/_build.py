"""Builds and loads the hand-written CUDA kernels.

Each `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with `ctypes`. The library goes to `build/torch_kernels/`
beside the package, under a hash of the sources and flags, so an unchanged
tree builds once. Nothing here runs at import: the CPU tests never need
`nvcc`. On a machine where `nvcc` or the build fails, `load_library`
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import weakref
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

# No --use_fast_math: approximate log/division and flushed denormals would
# change which Newton candidate wins. --fmad=false keeps each product
# rounded on its own, as in the plain PyTorch versions the kernels are
# held against, so nh_local equals its twin bitwise; contracting into FMAs
# would make it ~5% faster on an H100 and lose that equality.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, seconds spent compiling; 0 when cached)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libadmm_kernels.so"
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = sorted(CSRC.glob("*.cu"))
    # objects and the library are made under a private name first, so a
    # concurrent build of the same tree never reads a half-written file
    work = Path(tempfile.mkdtemp(dir=out_dir))
    objs = [work / (p.stem + ".o") for p in cu]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                               "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p, o in zip(cu, objs)]
    log = "".join(f"== {c.name}\n{''.join(p.communicate())}"
                  for c, p in zip(cu, procs))
    failed = [c.name for c, p in zip(cu, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(work / lib.name), *map(str, objs)],
            capture_output=True, text=True)
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(log)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(work / lib.name, lib)  # atomic: all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return lib, seconds


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points (restype, argtypes): pointers and the stream as void*
_SIGNATURES = {
    # x, tets, u, warm, cp, mu, lam, k, w2, then z, u', warm', rows, then
    # E, iters, model, emit_z and the stream
    **{f"nh_local_step_fused_{t}": (_I, [_P] * 13 + [_I] * 4 + [_P])
       for t in ("f32", "f64")},
    # b, x0, diag, the matrix (2), then D or K, H, n, n_iters, diag_inv,
    # then x, scratch and the stream
    **{f"cg_{m}_solve_{t}": (_I, [_P] * 5 + [_I] * 5 + [_P] * 3)
       for m in ("dia", "ell") for t in ("f32", "f64")},
    # D, H, n; H, n
    **{f"cg_dia_prepare_{t}": (_I, [_I] * 3) for t in ("f32", "f64")},
    **{f"cg_dia_clusters_{t}": (_I, [_I] * 3 + [_P]) for t in ("f32", "f64")},
    **{f"cg_ell_clusters_{t}": (_I, [_I] * 2 + [_P]) for t in ("f32", "f64")},
    **{f"cg_ell_prepare_{t}": (_I, [_I] * 2) for t in ("f32", "f64")},
    "cg_cluster_plan": (_I, [_I] * 4 + [_P]),
    # b, x0, dia, offsets, then D, n, n_iters, then the multigrid (a
    # UAMGHost), x, scratch and the stream
    **{f"mg_dia_solve_{t}": (_I, [_P] * 4 + [_I] * 3 + [_P] * 4)
       for t in ("f32", "f64")},
    # D, n, the multigrid
    **{f"mg_dia_prepare_{t}": (_I, [_I] * 2 + [_P]) for t in ("f32", "f64")},
    # n, D, the multigrid, elem_bytes, out
    "mg_solve_plan": (_I, [_I] * 2 + [_P, _I, _P]),
    # b, x0, the ELL rows (2), then K, n, n_iters, then the multigrid (a
    # UAMGHost), x, scratch and the stream
    **{f"uamg_ell_solve_{t}": (_I, [_P] * 4 + [_I] * 3 + [_P] * 4)
       for t in ("f32", "f64")},
    # n, the multigrid
    **{f"uamg_ell_prepare_{t}": (_I, [_I, _P]) for t in ("f32", "f64")},
    # x, r, p, rz, Ap, invd, then n, then x', r', p', rz' and the stream
    **{f"cg_update_{t}": (_I, [_P] * 6 + [_I] + [_P] * 5)
       for t in ("f32", "f64")},
    **{f"nh_local_step_{t}": (_I, [_P] * 9 + [_I] * 3 + [_P])
       for t in ("f32", "f64")},
    # the triangle step's last output pointer is the emit_z block, null
    # when it is not asked for
    **{f"tri_local_step_fused_{t}": (_I, [_P] * 11 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    **{f"tri_local_step_{t}": (_I, [_P] * 8 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    # x, tets, u, cp, w2, k, then z, u', rows, then E, emit_z and the
    # stream
    **{f"arap_local_step_fused_{t}": (_I, [_P] * 9 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    **{f"arap_local_step_{t}": (_I, [_P] * 6 + [_I] + [_P])
       for t in ("f32", "f64")},
    # state 6, element planes 6, vertex planes 4 and the slot planes 2,
    # matrix 3 (dia, ell_idx_t, ell_vals_t), scratch 5, residual scratch 4
    # (zrows, tz, part, dpart) and results 2, host arrays 4, the multigrid
    # (or null), then n, E, D, K, H, n_shapes, model, newton_iters,
    # cg_iters, admm_iters, n_steps, collect, and the stream
    **{f"banded_rollout_{t}": (_I, [_P] * 37 + [_I] * 13 + [_P])
       for t in ("f32", "f64")},
    # state 5, element planes 7, vertex planes 7, scratch 6 (xpre, mxbar,
    # rows, wf, rhs, the solve's), residual scratch 4 and results 2, host
    # arrays 2, the multigrid (or null), then n, Et, Eh, Ew, D, H, S, Sw,
    # limiting, cg_iters, admm_iters, n_steps, collect, and the stream
    **{f"cloth_rollout_{t}": (_I, [_P] * 34 + [_I] * 13 + [_P])
       for t in ("f32", "f64")},
    # state 6, vertex planes 5, scratch 5, host arrays 5, then nx, ny, nz,
    # D, H, model, floor, newton_iters, cg_iters, admm_iters, n_steps, and
    # the stream
    **{f"lattice_rollout_{t}": (_I, [_P] * 21 + [_I] * 11 + [_P])
       for t in ("f32", "f64")},
    # state in 5, element planes 6, vertex planes 2, the slot planes 2,
    # outputs 6 (b, au, cu, u, warm, the slot buffer), the residual's
    # partials and r2 (or null), host arrays 3, then n, E, n_shapes,
    # model, newton_iters, collect, and the stream
    **{f"banded_local_rhs_{t}": (_I, [_P] * 26 + [_I] * 6 + [_P])
       for t in ("f32", "f64")},
    # b, x, z, d, invd, dia, c1, c2, x/z/d out, d scratch, offsets, then n,
    # D, n_it, first, last, inv_theta, and the stream
    **{f"cheb_dia_chunk_{t}": (_I, [_P] * 13 + [_I] * 5
                                + [ctypes.c_double, _P])
       for t in ("f32", "f64")},
    # n, H, D, elem_bytes, out
    "cheb_dia_plan": (_I, [_I] * 4 + [_P]),
    "admm_cuda_error_string": (ctypes.c_char_p, [_I]),
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process,
    with the C signatures of its entry points set."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the current
    sources, or '' before the first build."""
    p = BUILD_ROOT / _digest() / "build.log"
    return p.read_text() if p.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = load_library().admm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device as a C entry takes it (the
    raw handle: ~0.3 us a call on an H100's host, where building the
    torch.cuda.Stream object took ~6 us)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _span(t):
    """The bytes a contiguous tensor occupies: (first, past the last)."""
    p = t.data_ptr()
    return p, p + t.numel() * t.element_size()


class Plan:
    """The work of a wrapper that its constant inputs fix (checks, pointers,
    the C entry), done once. A subclass checks those tensors and calls
    `hold`; `plan` keeps the plans made so far. A plan holds the tensors by
    weak reference only and serves while each is still the very tensor it
    was made on: a replaced tensor gets a new plan."""

    def hold(self, tensors, dtype, device, read=None):
        """Keep weak references to `tensors` {name: tensor}, the dtype and
        device the plan's calls take, and the spans of the tensors the
        kernel reads (`read`, by default `tensors`) for `outputs`."""
        self.dtype, self.device = dtype, device
        self._refs = {k: weakref.ref(t) for k, t in tensors.items()}
        self._spans = [_span(t) for t in (tensors.values() if read is None
                                          else read) if t.numel()]

    def serves(self, tensors):
        """Whether each held tensor is still the one of its name in
        `tensors`."""
        return all(tensors.get(k) is r() for k, r in self._refs.items())

    def outputs(self, out, shapes, ins):
        """A call's output buffers: new ones of `shapes`, or `out` checked
        to hold one contiguous tensor of each shape, of the plan's dtype
        and device, none of them overlapping another, an input (`ins`) or
        the plan's constants."""
        if out is None:
            return tuple(torch.empty(s, dtype=self.dtype, device=self.device)
                         for s in shapes)
        out = tuple(out)
        if len(out) != len(shapes) or not all(
                isinstance(o, torch.Tensor) and o.shape == s
                and o.dtype == self.dtype and o.device == self.device
                and o.is_contiguous() for o, s in zip(out, shapes)):
            raise ValueError(f"out: {len(shapes)} contiguous buffers of "
                             f"shapes {tuple(shapes)}, {self.dtype} on "
                             f"{self.device}, expected")
        # by first byte: a span that starts before the end of an earlier one
        # overlaps it, which is an error where either is an output
        spans = sorted([(*_span(o), True) for o in out if o.numel()]
                       + [(*_span(t), False) for t in ins if t.numel()]
                       + [(*sp, False) for sp in self._spans])
        end = out_end = 0
        for lo, hi, is_out in spans:
            if lo < (end if is_out else out_end):
                raise ValueError("out: a buffer overlaps an input or "
                                 "another output")
            end = max(end, hi)
            if is_out:
                out_end = max(out_end, hi)
        return out


class ElementPlan(Plan):
    """An element step's constant inputs for one force (the selector planes
    cp12 (12,E) and per-element vectors (E,), in the C entry's order):
    checked once (shape, layout, one dtype and device), the tets of a
    fused entry in int32 with their largest index, the pointers and, on a
    card, the C entry resolved once. Used by the hyperelastic and the
    ARAP element steps (`nh_local.py`, `tet_local.py`)."""

    def __init__(self, entry, consts, tets):
        first = next(iter(consts.values()))
        dtype, device = first.dtype, first.device
        self.E = E = first.shape[-1]
        if dtype not in SUFFIX:
            raise TypeError(f"unsupported dtype {dtype}")
        for name, t in consts.items():
            shape = (12, E) if name == "cp12" else (E,)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: not contiguous")
            if t.dtype != dtype or t.device != device:
                raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                                 f"{dtype} on {device}")
        # the device index as Tensor.get_device() gives it (-1 off CUDA):
        # the per-call check compares ints, not torch.device objects
        self.index = device.index if device.type == "cuda" else -1
        held = dict(consts)
        self.vmax = -1
        if tets is not None:
            if (tuple(tets.shape) != (E, 4) or tets.is_floating_point()
                    or tets.is_complex() or tets.device != device):
                raise ValueError(f"tets: {tets.dtype} {tuple(tets.shape)} on "
                                 f"{tets.device}, expected integers (E, 4) "
                                 f"= ({E}, 4) on {device}")
            held["tets"] = tets
        self.fn = None
        if device.type not in ("cuda", "cpu"):
            self.hold(held, dtype, device)
            return  # no kernel and no twin: the wrapper raises
        read = list(consts.values())
        if tets is not None:
            t32 = tets.to(torch.int32).contiguous()
            if t32.data_ptr() % 16:  # the kernel reads a tet as one int4
                t32 = t32.clone()
            if E and int(t32.min()) < 0:
                raise ValueError("tets: negative vertex index")
            self.vmax = int(t32.max()) if E else -1
            self.tets32, self.tets_ptr = t32, t32.data_ptr()
            read.append(t32)
        self.hold(held, dtype, device, read)
        self.ptrs = tuple(t.data_ptr() for t in consts.values())
        if device.type == "cuda":
            self.fn = getattr(load_library(), f"{entry}_{SUFFIX[dtype]}")

    def check_state(self, state):
        """Raise unless each of state {name: (tensor, shape)} has its shape
        and the plan's dtype and device and is contiguous (the caller's
        one-expression test failed)."""
        for name, (t, shape) in state.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: not contiguous")
            if t.dtype != self.dtype or t.device != self.device:
                raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                                 f"{self.dtype} on {self.device}")

    def twin(self, out, shapes, ins, run):
        """A call where the plan has no kernel: on CPU tensors the plain
        twin's outputs (`run()`), copied into `out` where it is given
        (checked as `outputs` checks it); on any other device an error."""
        if ins[0].device.type != "cpu":
            raise RuntimeError(f"no kernel for device {ins[0].device}")
        got = run()
        if out is None:
            return got
        out = self.outputs(out, shapes, ins)
        for o, g in zip(out, got):
            o.copy_(g)
        return out


#: the plans made so far, by their wrapper's key; a few are kept (a
#: System's forces and a stepper's calls find theirs at once)
_PLANS: dict = {}
KEEP_PLANS = 16


def plan(key, tensors, make):
    """The plan made under `key` while it serves `tensors`, else `make()`
    in its place (the oldest plan dropped beyond KEEP_PLANS)."""
    made = _PLANS.get(key)
    if made is None or not made.serves(tensors):
        made = make()
        _PLANS.pop(key, None)
        while len(_PLANS) >= KEEP_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = made
    return made


def element_plan(entry, consts, tets=None):
    """The element step `entry`'s plan for these constants (`plan`, by
    their identities)."""
    held = consts if tets is None else {**consts, "tets": tets}
    return plan((entry, *map(id, held.values())), held,
                lambda: ElementPlan(entry, consts, tets))


def check_inputs(planes, vectors):
    """Check a kernel wrapper's inputs: planes {name: (tensor, rows)} of
    shape (rows, E) and vectors {name: tensor} of shape (E,), contiguous,
    all of one device and one dtype (f32 or f64). Returns E."""
    first = next(iter(planes.values()))[0]
    E = first.shape[1] if first.dim() == 2 else -1
    shapes = {**{n: (t, (rows, E)) for n, (t, rows) in planes.items()},
              **{n: (t, (E,)) for n, t in vectors.items()}}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(
                f"{name}: {t.dtype} on {t.device}, expected {first.dtype} on "
                f"{first.device}"
            )
    if first.dtype not in SUFFIX:
        raise TypeError(f"unsupported dtype {first.dtype}")
    return E


def launch(name, ins, outs, *ints):
    """Launch the C entry `name`_f32/_f64 on CUDA tensors: the pointers of
    ins and outs (None passes a null pointer), then ints and the current
    stream. Raises on any CUDA error of the launch."""
    t0 = ins[0]
    if t0.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t0.device}")
    fn = getattr(load_library(), f"{name}_{SUFFIX[t0.dtype]}")
    err = fn(*(None if t is None else t.data_ptr() for t in (*ins, *outs)),
             *ints, stream_ptr(t0))
    check(err, name)
