"""admm_elastic_tpu_torch — the ADMM elastodynamics solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of `admm_elastic_tpu` (JAX/Pallas), which stays the reference. This
package imports torch and never jax.

Layout (mirrors the JAX package):
  core/      System (builder + timestep), global-solver assembly and solves
  models/    constraint batches (tets, triangles, springs, bend hinges,
             anchors, collisions) and explicit forces (gravity, wind)
  ops/       gather primitives; the default element backend's batched
             SVD (svd.py) and Newton (newton.py); kernels/ holds the
             hand-written kernels' wrappers and their plain PyTorch twins
  csrc/      CUDA C++ sources of the kernels (built at first use)
  geometry/  procedural meshes (numpy)
  parallel/  the sharded banded stepper (one device so far)
  utils/     carrying a JAX System's params and state across
"""

from .core.system import System, Settings
from . import models, geometry, ops

__version__ = "0.1.0"

__all__ = ["System", "Settings", "models", "geometry", "ops"]
