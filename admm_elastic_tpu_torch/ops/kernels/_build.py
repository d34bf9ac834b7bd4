"""Builds and loads the hand-written CUDA kernels.

`csrc/*.cu` are compiled by `nvcc` into one shared library with a plain C
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points (restype, argtypes): pointers and the stream as void*
_SIGNATURES = {
    **{f"nh_local_step_fused_{t}": (_I, [_P] * 12 + [_I] * 3 + [_P])
       for t in ("f32", "f64")},
    **{f"cg_dia_solve_{t}": (_I, [_P] * 5 + [_I] * 3 + [_P] * 6)
       for t in ("f32", "f64")},
    "cg_dia_partials": (_I, [_I]),
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
