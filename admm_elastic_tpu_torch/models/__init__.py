"""Constraint ("force") batches and explicit forces."""

from .base import ForceBatch
from .anchor import StaticAnchor
from .bend import Bend
from .collision import Collision, Cylinder, Floor, Sphere
from .tet import HyperElasticTet, LinearTetStrain
from .triangle import LimitedTriangleStrain
from .explicit import ExplicitForce, WindForce

__all__ = ["ForceBatch", "StaticAnchor", "Bend", "Collision", "Floor",
           "Sphere", "Cylinder", "HyperElasticTet", "LinearTetStrain",
           "LimitedTriangleStrain", "ExplicitForce", "WindForce"]
