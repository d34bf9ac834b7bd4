"""Explicit (pre-ADMM) velocity forces, applied to velocities before the
optimization predicts x_bar (reference ExplicitForce.cpp). ExplicitForce is
a constant acceleration (gravity); WindForce is the Wejchert-Haumann (1991)
aerodynamic normal drag over triangles."""

from __future__ import annotations

import numpy as np
import torch

from ..core.solver import assemble_transpose_incidence, transpose_gather_apply


class ExplicitForce:
    """v += dt * direction on all nodes or an index subset. `direction`
    lives in params."""

    def __init__(self, direction=(0.0, 0.0, 0.0), indices=None):
        self.direction = np.asarray(direction, dtype=np.float64)
        self.indices = (
            None if indices is None else np.asarray(indices, dtype=np.int32)
        )
        self.name = ""

    def build(self, n_nodes=None):
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


class WindForce(ExplicitForce):
    """Per-triangle aerodynamic drag (ExplicitForce.cpp:42-98):
    force = -alpha * area * v_n * |v_n| * n_hat, scaled by 0.33*dt and added
    to each of the triangle's 3 vertex velocities.

    The reference scatters under `omp critical`, the JAX package with a
    segment_sum. Here each vertex sums its incident triangles' forces in
    ascending (triangle, corner) order through an incidence table
    (`core.solver.assemble_transpose_incidence`): no atomics, so repeats
    are bitwise equal."""

    ALPHA_N = 1000.0  # coupling strength (ExplicitForce.cpp:72)

    def __init__(self, tris, direction=(0.0, 0.0, 0.0)):
        super().__init__(direction)
        self.tris = np.asarray(tris, dtype=np.int32).reshape(-1, 3)

    def build(self, n_nodes=None):
        if n_nodes is None:
            raise ValueError("WindForce.build needs the node count")
        inc, _ = assemble_transpose_incidence(
            int(n_nodes), {"wind": {"indices": self.tris}}, ["wind"])
        return {"direction": self.direction, "tris": self.tris, "inc": inc}

    def apply(self, dt, x, v, masses, params):
        tris = params["tris"]
        p = x[tris]  # (F,3,3)
        curr_v = torch.mean(v[tris], dim=1)  # (F,3)
        v_r = curr_v - params["direction"]
        n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=1)
        n_len = torch.linalg.norm(n, dim=1, keepdim=True)
        normal = n / torch.where(n_len > 0, n_len, 1.0)
        area = 0.5 * n_len[:, 0]
        v_n = torch.einsum("fj,fj->f", normal, v_r)
        force = (
            -self.ALPHA_N * (area * v_n * torch.abs(v_n))[:, None] * normal
        ) * (0.33 * dt)
        # row 3f+k of the incidence's slots is corner k of triangle f; the
        # zero row last is the padding slots' sentinel
        rows = torch.cat([force.repeat_interleave(3, dim=0),
                          force.new_zeros((1, 3))])
        return v + transpose_gather_apply(rows, params["inc"])
