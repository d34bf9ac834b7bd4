"""Constraint ("force") batches and explicit forces."""

from .base import ForceBatch
from .anchor import StaticAnchor
from .tet import HyperElasticTet
from .explicit import ExplicitForce

__all__ = ["ForceBatch", "StaticAnchor", "HyperElasticTet", "ExplicitForce"]
