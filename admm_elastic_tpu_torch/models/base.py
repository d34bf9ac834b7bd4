"""ForceBatch: one batch of constraints of a single type.

Each constraint type is a struct-of-arrays batch with

  * ``params``: per-element arrays — selector data (`indices` (E,K),
    `coeff` (E,R,K)), per-element `weight` (E,), material constants;
  * ``state``: per-element values carried across steps (e.g. the
    hyperelastic warm-start sigma);
  * ``project``: the batched local step z-update.

`build` returns numpy arrays; the System moves them to its device and dtype.
Selector rows act component-wise, so Dx has shape (E, R, 3).
"""

from __future__ import annotations

import abc

import numpy as np
import torch


def flat_rows(blocks):
    """A fused kernel's row planes -> flat rows: plane 3k+j of element e ->
    row K e + k, column j; a second (emit_z) block fills columns 3:6."""
    flat = [c.T.reshape(-1, 3) for c in blocks]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)


class ForceBatch(abc.ABC):
    """Abstract constraint batch. Subclasses define R (row-groups per element)
    and K (stencil vertices per element)."""

    R: int = 1
    K: int = 1
    #: set by System.initialize(); key into the params/state/u dicts
    name: str = ""

    @property
    @abc.abstractmethod
    def n_elements(self) -> int:
        ...

    @abc.abstractmethod
    def build(self, x: np.ndarray, masses: np.ndarray, dt: float):
        """Host-side init. x: (n,3) rest positions. Returns (params, state)
        dicts of numpy arrays; params hold 'indices' (E,K), 'coeff' (E,R,K)
        and 'weight' (E,)."""

    @abc.abstractmethod
    def project(self, Dx, u, params, state):
        """Batched local step: returns (z, new_state)."""

    def project_with_dual(self, Dx, u, params, state):
        """Local step + dual update: returns (z, u_new, new_state)."""
        z, st = self.project(Dx, u, params, state)
        return z, u + Dx - z, st

    # ---- layout-owning hooks: the System treats Dx/u/z as opaque per-force
    # arrays produced and consumed only through these methods

    def dual_init(self):
        """Initial dual variable u (zeros) in this force's native layout."""
        return np.zeros((self.n_elements, self.R, 3))

    def compute_Dx(self, params, x):
        """D x in the native layout."""
        from ..ops.segment import coeff_apply

        return coeff_apply(params["coeff"], params["indices"], x)

    def rhs_contribution(self, params, z, u):
        """Per-(element, vertex-slot) rows of D^T W^2 (z-u): (E*K, 3), in the
        flattened order assemble_transpose_incidence expects."""
        w = params["weight"]
        c = torch.einsum("erk,e,erj->ekj", params["coeff"], w * w, z - u)
        return c.reshape(-1, 3)

    def rhs_contribution6(self, params, z, u):
        """(E*K, 6): columns 0:3 the rows of D^T W^2 (z - u) (as
        rhs_contribution), columns 3:6 the rows of D^T W^2 z, whose
        incidence sum T z gives the dual residual dt^2 ||T z_i - T
        z_{i-1}|| from the same gather as the RHS."""
        return torch.cat([self.rhs_contribution(params, z, u),
                          self.rhs_contribution(params, z,
                                                torch.zeros_like(z))], dim=1)

    def scatter_rhs(self, params, z, u, n_vertices):
        """D^T W^2 (z - u) summed per vertex, (n_vertices, 3): the rows of
        rhs_contribution added to their vertices one force at a time (the
        JAX package's segment-sum form; the System sums every force's rows
        at once through its incidence gather)."""
        rows = self.rhs_contribution(params, z, u)
        out = rows.new_zeros((n_vertices, 3))
        return out.index_add_(0, params["indices"].reshape(-1).long(), rows)

    def primal_piece(self, params, u_new, u_old):
        """||W (Dx - z)||^2 for this batch via the dual-update identity
        Dx - z = u_new - u_old."""
        w = params["weight"][:, None, None]
        return torch.sum((w * (u_new - u_old)) ** 2)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(E={self.n_elements})"
