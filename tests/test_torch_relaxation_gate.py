"""The functions that call `banded_from_system` directly take its gate with
it: the banded kernel runs the plain alpha = 1 ADMM iteration only, so
under over-relaxation the port's `sweep_from_system` and
`sharded_banded_from_system` return None, as the JAX package's do
(admm_elastic_tpu/core/banded.py:590-591), and at relaxation 1 both
packages build a stepper. The jittered 4 x 3 x 3 beam, dia, cg20, f64,
built once per package and relaxation; nothing is stepped."""

import jax
import pytest

from admm_elastic_tpu.core.sweep import sweep_from_system as jax_sweep
from admm_elastic_tpu.parallel.banded_spmd import (
    sharded_banded_from_system as jax_sharded)
from admm_elastic_tpu_torch.core.sweep import SweepStepper, sweep_from_system
from admm_elastic_tpu_torch.parallel.banded_spmd import (
    ShardedBandedStepper, sharded_banded_from_system)
from torch_banded_scenes import aet, build, jittered_beam, pt

RELAXATIONS = [1.0, 1.6]

# maker: (JAX's call, the port's call, the port's stepper type)
MAKERS = {
    "sweep": (lambda s: jax_sweep(s, {}, 2),
              lambda s: sweep_from_system(s, {}, 2), SweepStepper),
    "sharded": (lambda s: jax_sharded(s, jax.make_mesh((1,), ("elem",))),
                lambda s: sharded_banded_from_system(s),
                ShardedBandedStepper),
}


@pytest.fixture(scope="module")
def systems():
    return {(pkg, a): build(pkg, jittered_beam(), fast=False, cg=20,
                            relaxation=a)
            for pkg in (aet, pt) for a in RELAXATIONS}


@pytest.mark.parametrize("relaxation", RELAXATIONS)
@pytest.mark.parametrize("maker", list(MAKERS))
def test_makers_follow_jax_under_relaxation(systems, maker, relaxation):
    jax_call, port_call, kind = MAKERS[maker]
    want = jax_call(systems[aet, relaxation])
    got = port_call(systems[pt, relaxation])
    assert (got is None) == (want is None)
    assert (got is None) == (relaxation != 1.0)
    if got is not None:
        assert isinstance(got[0], kind)
