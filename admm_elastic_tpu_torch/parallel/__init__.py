"""Sharded steppers (counterpart of `admm_elastic_tpu/parallel/`): so far
the sharded banded stepper at one device, with its Chebyshev solve's
host-side bounds and schedule (`cheb.py`), and a scenario sweep's
per-scenario global matrices (`scenarios.py`)."""

from .banded_spmd import ShardedBandedStepper, sharded_banded_from_system

__all__ = ["ShardedBandedStepper", "sharded_banded_from_system"]
