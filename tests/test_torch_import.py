"""The port imports torch and never jax: it imports and steps a beam and a
cloth (general and cloth routes) with jax made unimportable, and no source
file of the package imports jax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "admm_elastic_tpu_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None            # any 'import jax' now raises
sys.modules["admm_elastic_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.models import ExplicitForce, HyperElasticTet, StaticAnchor
beam = pt.geometry.make_beam_tets(1, 1, 1)
s = pt.System(pt.Settings(admm_iters=3, verbose=0, dtype=torch.float64,
                          device="cpu", cg_fixed_iters=5))
s.add_nodes(beam.vertices, np.full(beam.n_vertices, 0.1))
s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
s.add_force(HyperElasticTet(beam.tets, 1e3, 1e3, max_iters=3, backend="pallas"))
s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
assert s.initialize()
s.step()
s.run(2)
assert np.isfinite(s.x).all() and s.x[:, 1].min() < 0
from admm_elastic_tpu_torch.models import (Bend, LimitedTriangleStrain,
                                           WindForce)
grid = pt.geometry.make_plane_grid(4, 3)
for fast in (False, True):
    c = pt.System(pt.Settings(admm_iters=3, verbose=0, dtype=torch.float64,
                              device="cpu", cg_fixed_iters=5,
                              lattice_fast_path=fast))
    c.add_nodes(grid.vertices, np.full(grid.n_vertices, 0.01))
    c.add_force(LimitedTriangleStrain(grid.faces, 100.0, 0.95, 1.05,
                                      backend="pallas"))
    c.add_force(Bend(pt.geometry.extract_hinges(grid.faces), 20.0))
    c.add_force(StaticAnchor([0, 4]))
    c.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    c.add_explicit_force(WindForce(grid.faces, direction=(1.5, 0, 0.4)))
    assert c.initialize()
    assert (c._stepper is not None) == fast
    c.run(2)
    assert np.isfinite(c.x).all() and c.x[:, 1].min() < 0
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


def test_imports_and_steps_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "admm_elastic_tpu")]
    assert not bad, f"{path.name} imports {bad}"
