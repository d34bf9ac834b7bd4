"""Pin constraints: StaticAnchor pins nodes to their initial positions with
a large weight (default 1000)."""

from __future__ import annotations

import numpy as np

from .base import ForceBatch


class StaticAnchor(ForceBatch):
    R, K = 1, 1

    def __init__(self, indices: np.ndarray, weight=1000.0):
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        self.weight = np.broadcast_to(
            np.asarray(weight, dtype=np.float64), (len(self.indices),)
        ).copy()

    @property
    def n_elements(self) -> int:
        return len(self.indices)

    def build(self, x, masses, dt):
        E = self.n_elements
        params = {
            "indices": self.indices[:, None],
            "coeff": np.ones((E, 1, 1)),
            "weight": self.weight,
            "pos": np.asarray(x)[self.indices].copy(),
        }
        return params, {}

    def project(self, Dx, u, params, state):
        return params["pos"][:, None, :], state
