"""Explicit (pre-ADMM) velocity forces, applied to velocities before the
optimization predicts x_bar. ExplicitForce is a constant acceleration
(gravity). `WindForce` is not ported yet."""

from __future__ import annotations

import numpy as np


class ExplicitForce:
    """v += dt * direction on all nodes or an index subset. `direction`
    lives in params."""

    def __init__(self, direction=(0.0, 0.0, 0.0), indices=None):
        self.direction = np.asarray(direction, dtype=np.float64)
        self.indices = (
            None if indices is None else np.asarray(indices, dtype=np.int32)
        )
        self.name = ""

    def build(self):
        params = {"direction": self.direction}
        if self.indices is not None:
            params["indices"] = self.indices
        return params

    def apply(self, dt, x, v, masses, params):
        dv = dt * params["direction"]
        if self.indices is None:
            return v + dv
        idx = params["indices"]
        # a repeated index adds dv once per occurrence; every addend is the
        # same dv, so the result does not depend on the order of the adds
        return v.index_add(0, idx, dv.expand(idx.shape[0], 3))
