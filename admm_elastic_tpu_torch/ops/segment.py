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
