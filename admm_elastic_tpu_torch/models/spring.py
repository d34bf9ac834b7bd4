"""Edge springs (reference Force.hpp:63-72, Force.cpp:29-71)."""

from __future__ import annotations

import numpy as np
import torch

from .base import ForceBatch


class Spring(ForceBatch):
    """Batch of edge springs.

    Selector: one row-group per spring, Dx = x[i0] - x[i1]. Analytic prox:
    rescale Dx+u to rest length, then mix z = (k p + w^2 (Dx+u)) / (w^2 + k)
    with w = sqrt(k) (Force.cpp:37,52-71).
    """

    R, K = 1, 2

    def __init__(self, edges: np.ndarray, stiffness):
        self.edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (len(self.edges),)
        ).copy()

    @property
    def n_elements(self) -> int:
        return len(self.edges)

    def build(self, x, masses, dt):
        E = self.n_elements
        rest = np.linalg.norm(x[self.edges[:, 0]] - x[self.edges[:, 1]], axis=1)
        coeff = np.broadcast_to(
            np.array([[1.0, -1.0]]), (E, self.R, self.K)
        ).copy()
        params = {
            "indices": self.edges,
            "coeff": coeff,
            "weight": np.sqrt(self.stiffness),
            "stiffness": self.stiffness,
            "rest_length": rest,
        }
        return params, {}

    def project(self, Dx, u, params, state):
        dxu = (Dx + u)[:, 0, :]  # (E,3)
        norm = torch.sqrt(torch.sum(dxu * dxu, dim=1, keepdim=True))
        pos = norm > 0.0
        direction = torch.where(pos, dxu / torch.where(pos, norm, 1.0), 0.0)
        p = params["rest_length"][:, None] * direction
        k = params["stiffness"][:, None]
        w = params["weight"]
        w2 = (w * w)[:, None]
        z = (k * p + w2 * dxu) / (w2 + k)
        return z[:, None, :], state
