"""Device-side operations: plain PyTorch pieces and hand-written kernels
(`ops/kernels`, CUDA sources in `csrc/`)."""

from .segment import coeff_apply

__all__ = ["coeff_apply"]
