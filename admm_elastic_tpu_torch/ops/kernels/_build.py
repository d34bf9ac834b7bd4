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
    **{f"nh_local_step_fused_{t}": (_I, [_P] * 12 + [_I] * 3 + [_P])
       for t in ("f32", "f64")},
    **{f"cg_dia_solve_{t}": (_I, [_P] * 5 + [_I] * 3 + [_P] * 6)
       for t in ("f32", "f64")},
    "cg_dia_partials": (_I, [_I]),
    **{f"tri_local_step_fused_{t}": (_I, [_P] * 10 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    # state 6, element planes 6, vertex planes 6, scratch 7, host arrays 4,
    # then n, E, D, S, n_shapes, model, newton_iters, cg_iters, admm_iters,
    # n_steps, part_len, and the stream
    **{f"banded_rollout_{t}": (_I, [_P] * 29 + [_I] * 11 + [_P])
       for t in ("f32", "f64")},
    **{f"banded_rollout_grid_{t}": (_I, [_I]) for t in ("f32", "f64")},
    # state 5, element planes 7, vertex planes 7, scratch 8, host arrays 2,
    # then n, Et, Eh, Ew, D, S, Sw, limiting, cg_iters, admm_iters,
    # n_steps, part_len, and the stream
    **{f"cloth_rollout_{t}": (_I, [_P] * 29 + [_I] * 12 + [_P])
       for t in ("f32", "f64")},
    **{f"cloth_rollout_grid_{t}": (_I, []) for t in ("f32", "f64")},
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
