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
    # the fused element steps' last output pointer is the emit_z block,
    # null when it is not asked for
    **{f"nh_local_step_fused_{t}": (_I, [_P] * 13 + [_I] * 3 + [_P])
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
    **{f"tri_local_step_fused_{t}": (_I, [_P] * 11 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    **{f"tri_local_step_{t}": (_I, [_P] * 8 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    **{f"arap_local_step_fused_{t}": (_I, [_P] * 9 + [_I] + [_P])
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
    return torch.cuda.current_stream(t.device).cuda_stream


SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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
