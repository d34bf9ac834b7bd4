"""Host-side mesh geometry (pure numpy).

Device code lives in :mod:`admm_elastic_tpu_torch.ops` /
:mod:`admm_elastic_tpu_torch.models`.
"""

from .tetmesh import TetMesh
from .trimesh import TriMesh
from .primitives import make_beam_tets, make_plane_grid, make_sym_plane
from .connectivity import across_edge, extract_hinges, unique_edges

__all__ = ["TetMesh", "TriMesh", "make_beam_tets", "make_plane_grid",
           "make_sym_plane",
           "across_edge", "extract_hinges", "unique_edges"]
