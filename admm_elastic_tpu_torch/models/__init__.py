"""Constraint ("force") batches and explicit forces."""

from .base import ForceBatch
from .anchor import StaticAnchor
from .collision import Collision, Cylinder, Floor, Sphere
from .tet import HyperElasticTet
from .explicit import ExplicitForce

__all__ = ["ForceBatch", "StaticAnchor", "Collision", "Floor", "Sphere",
           "Cylinder", "HyperElasticTet", "ExplicitForce"]
