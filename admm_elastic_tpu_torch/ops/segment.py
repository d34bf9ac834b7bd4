"""Gather primitives implementing the sparse selector D.

Every selector row-group acts component-wise, so a constraint batch is
(indices (E,K), coeff (E,R,K), weight (E,)) and

  D apply:  Dx[e,r,:] = sum_k coeff[e,r,k] * x[idx[e,k],:]      (gather)
"""

from __future__ import annotations

import torch


def coeff_apply(coeff: torch.Tensor, indices: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """D apply: (E,R,K), (E,K), (n,3) -> (E,R,3)."""
    verts = x[indices]  # (E,K,3)
    return torch.einsum("erk,ekj->erj", coeff, verts)


def flat_rows(blocks):
    """A fused kernel's row planes (3K, E) -> flat rows (E*K, 3): plane
    3k+j of element e -> row K e + k, column j; a second (emit_z) block
    fills columns 3:6."""
    flat = [c.T.reshape(-1, 3) for c in blocks]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
