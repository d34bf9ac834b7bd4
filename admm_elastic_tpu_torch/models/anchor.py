"""Pin constraints: StaticAnchor pins nodes to their initial positions with
a large weight (default 1000); MovingAnchor binds nodes to control points
that user code moves or deactivates between steps (an inactive anchor is a
no-op whose control point follows its node: interactive grabbing, as the
poordillo sample's). `smooth_move` and `linear_move` are the control-point
trajectories of the reference's helpers.

A release (poordillo) is `System.set_force_param(anchor, "weight", 0)`,
`set_force_state(anchor, "active", False)`, then `recompute_weights()`."""

from __future__ import annotations

import numpy as np
import torch

from .base import ForceBatch


def smooth_move(elapsed, start_t, end_t, start, end):
    """Smoothstep control-point trajectory (helper::smooth_move,
    AnchorForce.hpp:33-41). Host-side numpy."""
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    if elapsed < start_t:
        return start
    ratio = (elapsed - start_t) / (end_t - start_t)
    if ratio > 1.0:
        return end
    return start + (3.0 * ratio**2 - 2.0 * ratio**3) * (end - start)


def linear_move(elapsed, start_t, end_t, start, end):
    """helper::linear_move (AnchorForce.hpp:43-47): jumps to `end` once the
    window starts (the reference applies the full displacement at once)."""
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    if elapsed < start_t:
        return start
    return end


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


class MovingAnchor(ForceBatch):
    """Anchors bound to movable control points.

    state['pos'] (E,3): control point positions, which user code may
    overwrite between steps (a drag). state['active'] (E,) bool: when False
    the anchor is inert (z = Dx + u) and pos follows its node. Not a
    StaticAnchor: a scene that holds one steps the general route, as in
    the JAX package (the whole-timestep kernels pin fixed points only)."""

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
        }
        state = {
            "pos": np.asarray(x)[self.indices].copy(),
            "active": np.ones(E, dtype=bool),
        }
        return params, state

    def project(self, Dx, u, params, state):
        active = state["active"][:, None, None]
        z = torch.where(active, state["pos"][:, None, :], Dx + u)
        new_pos = torch.where(active[:, 0], state["pos"], Dx[:, 0, :])
        return z, {**state, "pos": new_pos}
