"""Discrete hinge bending (reference BendForce.cpp).

Hinge = 4 vertices in Volino ordering (wing0, wing1, shared_a, shared_b).
Selector rows: (x0 - x2, x3 - x2, x1 - x2) (BendForce.cpp:75-131). The local
step projects onto the flat state via the alpha-weighted analytic projection
(computeUsingProjection, BendForce.cpp:134-144); w = sqrt(k). Plain PyTorch
through the generic `ForceBatch` hooks: the JAX package has no kernel for
Bend on the general route either.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ForceBatch

# row-group coefficients for (v0,v1,v2,v3): rows = x0-x2, x3-x2, x1-x2
_BEND_COEFF = np.array(
    [
        [1.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0, 1.0],
        [0.0, 1.0, -1.0, 0.0],
    ]
)


class Bend(ForceBatch):
    R, K = 3, 4

    def __init__(self, hinges, stiffness):
        self.hinges = np.asarray(hinges, dtype=np.int32).reshape(-1, 4)
        E = len(self.hinges)
        self.stiffness = np.broadcast_to(np.asarray(stiffness, np.float64),
                                         (E,)).copy()

    @property
    def n_elements(self) -> int:
        return len(self.hinges)

    def build(self, x, masses, dt):
        h = self.hinges.astype(np.int64)
        v = np.asarray(x, dtype=np.float64)
        x0, x1, x2, x3 = (v[h[:, i]] for i in range(4))
        # rest-state geometry relative to shared vertex x2
        # (BendForce.cpp:35-55)
        xA = x0 - x2
        xB = x1 - x2
        xD = x3 - x2
        lenD = np.linalg.norm(xD, axis=1)
        area1 = 0.5 * np.linalg.norm(np.cross(xA, xD), axis=1)
        area2 = 0.5 * np.linalg.norm(np.cross(xD, xB), axis=1)
        safe = np.maximum(lenD, 1e-12)
        hA = 2.0 * area1 / safe
        hB = 2.0 * area2 / safe
        # (the reference also forms the normals at x0 and x1; alpha does
        # not use them)
        nC_ = np.cross(-xB, -xA)
        nD_ = np.cross(xD - xA, xD - xB)
        sum_h = np.maximum(hA + hB, 1e-12)
        nC = np.linalg.norm(nC_, axis=1)
        nD = np.linalg.norm(nD_, axis=1)
        sum_n = np.maximum(nC + nD, 1e-12)
        alpha = np.stack(
            [hB / sum_h, hA / sum_h, -nD / sum_n, -nC / sum_n], axis=1
        )  # (E,4); alpha[2] is never used by the projection

        E = self.n_elements
        params = {
            "indices": self.hinges,
            "coeff": np.broadcast_to(_BEND_COEFF, (E, 3, 4)).copy(),
            "weight": np.sqrt(self.stiffness),
            "stiffness": self.stiffness,
            "alpha": alpha,
        }
        return params, {}

    def project(self, Dx, u, params, state):
        dxu = Dx + u  # (E,3,3): rows c1,c2,c3
        a = params["alpha"]
        # weights in row order: (alpha0, alpha3, alpha1)
        # (BendForce.cpp:139-142)
        arow = torch.stack([a[:, 0], a[:, 3], a[:, 1]], dim=1)  # (E,3)
        denom = torch.sum(arow * arow, dim=1)
        lam = (
            2.0
            * torch.einsum("er,erj->ej", arow, dxu)
            / torch.where(denom > 0, denom, 1.0)[:, None]
        )  # (E,3)
        p = dxu - 0.5 * arow[:, :, None] * lam[:, None, :]
        k = params["stiffness"][:, None, None]
        w2 = (params["weight"] ** 2)[:, None, None]
        z = (k * p + w2 * dxu) / (w2 + k)
        return z, state
