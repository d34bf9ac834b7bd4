"""Hand-written Hopper kernels (CUDA C++ in `csrc/`) with their plain
PyTorch twins. Importing this package builds nothing; the kernels are
compiled at their first launch on a CUDA tensor (`_build.py`)."""

from .nh_local import (nh_local_step, nh_local_step_fused,
                       nh_local_step_fused_reference, nh_local_step_reference)
from .cg_dia import cg_dia_solve, cg_dia_solve_reference
from .cg_ell import cg_ell_solve, cg_ell_solve_reference
from .cg_step import cg_update, cg_update_reference, pcg_solve_fixed_fused
from .banded_step import banded_rollout, banded_rollout_reference
from .tri_local import (tri_local_step, tri_local_step_fused,
                        tri_local_step_fused_reference,
                        tri_local_step_reference)
from .tet_local import (arap_local_step, arap_local_step_fused,
                        arap_local_step_fused_reference,
                        arap_local_step_reference)
from .cloth_step import cloth_rollout, cloth_rollout_reference
from .banded_local import banded_local_rhs, banded_local_rhs_reference
from .cheb_dia import cheb_dia_chunk, cheb_dia_chunk_reference

__all__ = [
    "nh_local_step_fused", "nh_local_step_fused_reference",
    "nh_local_step", "nh_local_step_reference",
    "cg_dia_solve", "cg_dia_solve_reference",
    "cg_ell_solve", "cg_ell_solve_reference",
    "cg_update", "cg_update_reference", "pcg_solve_fixed_fused",
    "banded_rollout", "banded_rollout_reference",
    "tri_local_step_fused", "tri_local_step_fused_reference",
    "tri_local_step", "tri_local_step_reference",
    "arap_local_step_fused", "arap_local_step_fused_reference",
    "arap_local_step", "arap_local_step_reference",
    "cloth_rollout", "cloth_rollout_reference",
    "banded_local_rhs", "banded_local_rhs_reference",
    "cheb_dia_chunk", "cheb_dia_chunk_reference",
]
