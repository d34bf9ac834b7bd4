"""Constraint ("force") batches and explicit forces."""

from .base import ForceBatch
from .spring import Spring
from .anchor import MovingAnchor, StaticAnchor, linear_move, smooth_move
from .tet import HyperElasticTet, LinearTetStrain, TetVolume
from .triangle import FungTriangle, LimitedTriangleStrain, TriArea
from .bend import Bend
from .collision import Collision, Cylinder, Floor, Sphere
from .explicit import ExplicitForce, WindForce

__all__ = ["ForceBatch", "Spring", "StaticAnchor", "MovingAnchor",
           "smooth_move", "linear_move",
           "LinearTetStrain", "TetVolume", "HyperElasticTet",
           "LimitedTriangleStrain", "FungTriangle", "TriArea", "Bend",
           "Collision", "Floor", "Sphere", "Cylinder",
           "ExplicitForce", "WindForce"]
