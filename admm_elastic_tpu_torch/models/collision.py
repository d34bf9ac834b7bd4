"""Hard collision constraints as an ADMM force (reference CollisionForce.cpp).

The selector is the identity over every node with weight 32
(CollisionForce.cpp:27-34): the constraint space is the node positions
themselves. The local step projects any penetrating node out of each
analytic shape (floor plane, sphere, z-axis cylinder; collision/*.hpp),
applying the shapes in declaration order, as the reference does per node
(CollisionForce.cpp:56-67): order matters where shapes overlap. Shape
parameters live in `params`, per kind.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base import ForceBatch


@dataclasses.dataclass
class Floor:
    """y <= center_y is inside; projection snaps y to the plane
    (CollisionFloor.hpp:47-55)."""

    center: tuple  # (3,), only y used


@dataclasses.dataclass
class Sphere:
    center: tuple
    radius: float


@dataclasses.dataclass
class Cylinder:
    """Axis parallel to z through (center_x, center_y)
    (CollisionCylinder.hpp:46-65)."""

    center: tuple
    radius: float


class Collision(ForceBatch):
    R, K = 1, 1

    def __init__(self, shapes, n_nodes: int, weight=32.0):
        self.shapes = list(shapes)
        self.n_nodes = int(n_nodes)
        self.weight_value = float(weight)

    @property
    def n_elements(self) -> int:
        return self.n_nodes

    def build(self, x, masses, dt):
        n = self.n_nodes
        floors = [s for s in self.shapes if isinstance(s, Floor)]
        spheres = [s for s in self.shapes if isinstance(s, Sphere)]
        cyls = [s for s in self.shapes if isinstance(s, Cylinder)]
        params = {
            "indices": np.arange(n, dtype=np.int32)[:, None],
            "coeff": np.ones((n, 1, 1)),
            "weight": np.full(n, self.weight_value),
            "floor_y": np.array([s.center[1] for s in floors], dtype=np.float64),
            "sphere_c": np.array(
                [s.center for s in spheres], dtype=np.float64
            ).reshape(-1, 3),
            "sphere_r": np.array([s.radius for s in spheres], dtype=np.float64),
            "cyl_c": np.array(
                [[s.center[0], s.center[1]] for s in cyls], dtype=np.float64
            ).reshape(-1, 2),
            "cyl_r": np.array([s.radius for s in cyls], dtype=np.float64),
        }
        return params, {}

    def project(self, Dx, u, params, state):
        p = (Dx + u)[:, 0, :]  # (n,3) candidate positions
        counters = {Floor: 0, Sphere: 0, Cylinder: 0}
        for shape in self.shapes:
            j = counters[type(shape)]
            counters[type(shape)] += 1
            if isinstance(shape, Floor):
                target = params["floor_y"][j]
                y = p[:, 1]
                p = torch.stack([p[:, 0], torch.where(y < target, target, y),
                                 p[:, 2]], dim=1)
            elif isinstance(shape, Sphere):
                c, r = params["sphere_c"][j], params["sphere_r"][j]
                d = p - c
                dist = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
                inside = dist[:, 0] < r
                dir_ = d / torch.where(dist > 0, dist, 1.0)
                p = torch.where(inside[:, None], c + r * dir_, p)
            else:
                c, r = params["cyl_c"][j], params["cyl_r"][j]
                d = p[:, :2] - c
                dist = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
                inside = dist[:, 0] < r
                dir_ = d / torch.where(dist > 0, dist, 1.0)
                proj = torch.cat([c + r * dir_, p[:, 2:3]], dim=1)
                p = torch.where(inside[:, None], proj, p)
        return p[:, None, :], state
