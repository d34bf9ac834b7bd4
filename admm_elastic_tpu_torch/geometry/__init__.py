"""Host-side mesh geometry (pure numpy).

Device code lives in :mod:`admm_elastic_tpu_torch.ops` /
:mod:`admm_elastic_tpu_torch.models`.
"""

from .tetmesh import TetMesh
from .primitives import make_beam_tets

__all__ = ["TetMesh", "make_beam_tets"]
