"""The JAX package's golden trajectories (tests/golden/*.npz, written by
tests/test_golden.py) reproduced by the port: the same two scenes
(`utils/scenes.golden_cloth`, `golden_tetdrop`), built with the port's
default constructors (`backend="xla"`, default Settings,
so the dense global mode), f64 on the CPU, against the stored positions.
Only the port runs here; the JAX package is not imported.

cloth (a make_sym_plane(6, 4) sheet with strain limiting, bend, anchors,
gravity and wind; 12 steps) is held at tests/test_golden.py's own
tolerance, rtol 1e-10 and atol 1e-12.

tetdrop (a NeoHookean beam, 5 Newton iterations, falling onto a floor; 20
steps) is held at rtol 1e-10 and atol 1e-9. The stored positions are
those of the JAX step as XLA compiles it (fusing multiply-adds), and they
are reproducible only to a few 1e-10 m by any other evaluation of the
same algorithm:
  * the first 10 steps (free fall) agree to 2e-13 m; from step 11 the
    elements deform, and the safeguarded Newton of `ops/newton.py`
    stalls where its candidates' objective values tie within rounding
    (`improved = vals[best] < value_fn(x)`), so a 1-ulp change in the
    singular values moves an element's sigma* by up to 1e-8;
  * the JAX package's own step, run op by op (`jax.disable_jit()`),
    misses this file by 2.4e-10 m, and the port by 1.9e-10 m; the port
    started 1e-15 m away lands 2.5e-10 to 3.9e-10 m from it.
The cloth has no such tie (no Newton), and matches to 3e-14 m.
"""

import os

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.utils.scenes import (GOLDEN_STEPS, golden_cloth,
                                                 golden_tetdrop)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

#: name: (scene, atol)
SCENES = {"cloth": (golden_cloth, 1e-12), "tetdrop": (golden_tetdrop, 1e-9)}


@pytest.mark.parametrize("name", list(SCENES))
def test_golden_trajectory(name):
    build, atol = SCENES[name]
    want = np.load(os.path.join(GOLDEN, f"{name}.npz"))["x"]
    s = build("cpu")
    assert s._solver_mode == "dense"
    assert all(getattr(f, "backend", "xla") == "xla" for f in s.forces)
    for _ in range(GOLDEN_STEPS[name]):
        s.step()
    np.testing.assert_allclose(s.x, want, rtol=1e-10, atol=atol,
                               err_msg=f"golden drift in scene {name!r}")
