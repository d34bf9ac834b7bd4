"""Hand-written Hopper kernels (CUDA C++ in `csrc/`) with their plain
PyTorch twins. Importing this package builds nothing; the kernels are
compiled at their first launch on a CUDA tensor (`_build.py`)."""

from .nh_local import nh_local_step_fused, nh_local_step_fused_reference
from .cg_dia import cg_dia_solve, cg_dia_solve_reference
from .banded_step import banded_rollout, banded_rollout_reference
from .tri_local import tri_local_step_fused, tri_local_step_fused_reference
from .cloth_step import cloth_rollout, cloth_rollout_reference

__all__ = [
    "nh_local_step_fused", "nh_local_step_fused_reference",
    "cg_dia_solve", "cg_dia_solve_reference",
    "banded_rollout", "banded_rollout_reference",
    "tri_local_step_fused", "tri_local_step_fused_reference",
    "cloth_rollout", "cloth_rollout_reference",
]
