"""The beam workload through the port's public API, for `chip_smoke.py`
and `profile_step`: a `make_beam_tets` beam with a StaticAnchor on the
x=0 face, gravity, and a kernel-backed HyperElasticTet (mu = lam = 1e5,
5 Newton iterations) on the dia solver, dt 0.04, 10 ADMM iterations."""

from __future__ import annotations

import numpy as np
import torch

from ..core.system import Settings, System
from ..geometry import make_beam_tets
from ..models import ExplicitForce, HyperElasticTet, StaticAnchor


def beam_system(dims, size, total_mass, cg, dtype=torch.float32,
                device="cuda") -> System:
    beam = make_beam_tets(*dims, size=size)
    n = beam.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                        dtype=dtype, device=device, cg_fixed_iters=cg))
    s.add_nodes(beam.vertices, np.full(n, total_mass / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh", backend="pallas"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def tet100k(cg, dtype=torch.float32) -> System:
    """The repo's headline workload (bench.py build_tet100k): 40 x 25 x 20
    cells x 5 = 100,000 tets, 22,386 nodes, 50 kg, cell size 0.05 m."""
    return beam_system((40, 25, 20), 0.05, 50.0, cg, dtype)
