"""The port's plain hyperelastic tet local steps against the JAX package's
Pallas kernels in f64: the fused one (`nh_local_step_fused`, from gathered
positions) and the unfused one (`nh_local_step`, from Dx), on the same
inputs (Dx formed from them).

Tolerance: 1e-9 absolute on elements whose singular-value gaps exceed 1e-2
(the SVD basis is ill-conditioned at near-degenerate sigma, so both answers
are valid there; test_pallas.py uses the same rule).

Two comparisons:

- The transcription itself: the Pallas kernel body, evaluated by JAX one
  operation at a time (`jax.disable_jit()`, array-backed refs), against the
  plain version with the same two elementary functions (sqrt correctly
  rounded, log as XLA computes it). They are bitwise equal on every element.
- The interpret-mode kernel (`interpret=True`), against the plain version
  as it is. Here 1e-9 holds on all but a few percent of the separated
  elements, for three reasons the first comparison isolates: the jitted
  interpreter fuses a*b+c into FMAs (jit differs from eager on ~23% of
  random f64 multiply-adds), XLA's log is not correctly rounded on ~0.1% of
  inputs, and PyTorch's vectorized CPU sqrt (AVX-512 kernels) is not
  correctly rounded on ~0.9%. The Newton ladder keeps a candidate only if
  its objective is strictly lower, and near the minimum candidates within
  ~sqrt(eps) of each other tie to round-off, so a last-bit difference can
  settle on another member of such a tie. For those elements the test
  asserts the tie: both objectives agree to 1e-14 relative, sigma* to 1e-7
  relative, and they are at most 5% of the elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops.pallas import nh_local as jnh
from admm_elastic_tpu.ops.pallas.nh_local import (
    nh_local_step_fused as jax_fused,
)
from admm_elastic_tpu.ops.pallas.tet_local import BLOCK
from admm_elastic_tpu_torch.ops.kernels import nh_local as pnh

torch.set_num_threads(1)

E = 1024


def _inputs(seed):
    """Random selector planes and gathered positions whose F covers
    inverted elements (a quarter), collapsed ones, random duals and warm
    starts (negative third component, collapsed), and mu != lam."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(12, E))
    cp = rng.normal(size=(12, E))
    # F = sum_k cp[4b+k] xg[3k+a]; flip the sign of the F columns' third
    # slot in a quarter of the elements by negating cp[8:12]
    cp[8:12, : E // 4] *= -1.0
    xg[:, E // 4: E // 4 + 16] *= 1e-4  # collapsed
    u = 0.1 * rng.normal(size=(9, E))
    warm = rng.uniform(0.5, 1.5, size=(3, E))
    warm[2, : E // 8] *= -1.0  # negative third component
    warm[:, E // 8: E // 8 + 16] = 1e-4  # collapsed warm start
    mu = rng.uniform(1e4, 1e5, E)
    lam = 4.0 * mu
    k = np.minimum(mu, lam)
    w2 = rng.uniform(0.5, 2.0, E)
    return xg, u, warm, cp, mu, lam, k, w2


def _planes_F(xg, cp, u):
    dx = np.einsum("bke,kae->abe", cp.reshape(3, 4, E), xg.reshape(4, 3, E))
    return dx.reshape(9, E) + u


def _separated(xg, cp, u):
    F = _planes_F(xg, cp, u).T.reshape(E, 3, 3)
    svs = np.linalg.svd(F, compute_uv=False)
    gaps = np.minimum(svs[:, 0] - svs[:, 1], svs[:, 1] - svs[:, 2])
    return gaps > 1e-2


def _objective_tie(model, ins, sig_a, sig_b):
    """Per element: do the two sigma* tie on the prox objective?"""
    xg, u, _, cp, mu, lam, k, _ = ins
    eps = jnp.asarray(np.finfo(np.float64).eps)
    _, _, s = jnh._svd_columns([jnp.asarray(p) for p in _planes_F(xg, cp, u)],
                               eps)
    value = jnh._nh_value if model == "nh" else jnh._stvk_value

    def f(sig):
        return np.asarray(value(*sig, mu, lam, k, *s))

    fa, fb = f(sig_a), f(sig_b)
    close_f = np.abs(fa - fb) <= 1e-14 * np.abs(fa)
    close_s = (np.abs(sig_a - sig_b) <= 1e-7 * np.maximum(np.abs(sig_a), 1.0)
               ).all(axis=0)
    return close_f & close_s


def _unfused(ins):
    """The unfused kernel's inputs (dx9, u9, warm, mu, lam, k)."""
    xg, u, warm, cp, mu, lam, k, _ = ins
    return _planes_F(xg, cp, 0.0), u, warm, mu, lam, k


def _assert_interpret_agreement(model, ins, ref, out):
    """1e-9 on separated elements but for asserted objective ties (at most
    5%, within 1e-6); ref and out put the warm start third."""
    sep = _separated(ins[0], ins[3], ins[1])
    assert sep.sum() > 0.8 * E
    ref = [np.asarray(r)[:, :E] for r in ref]
    out = [o.numpy() for o in out]
    err = np.zeros(E)
    for r, o in zip(ref, out):
        assert o.shape == r.shape and np.isfinite(o).all()
        err = np.maximum(err, np.abs(o - r).max(axis=0))
    tie = _objective_tie(model, ins, ref[2], out[2])
    off = sep & (err >= 1e-9)
    msg = (f"{model}: max err separated {err[sep].max():.3g}, all "
           f"{err.max():.3g}; {off.sum()} separated elements above 1e-9, "
           f"{(off & tie).sum()} of them objective ties")
    assert (tie | ~off).all(), msg
    assert off.sum() <= 0.05 * E, msg
    assert err[sep & ~off].max() < 1e-9 and err[off].max(initial=0) < 1e-6, msg


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_plain_matches_pallas_interpret(model):
    assert E % BLOCK == 0
    ins = _inputs(3 if model == "nh" else 4)
    ref = jax_fused(*(jnp.asarray(a) for a in ins), iters=5,
                    interpret=True, model=model)
    out = pnh.nh_local_step_fused(*(torch.as_tensor(a) for a in ins),
                                  iters=5, model=model)
    _assert_interpret_agreement(model, ins, ref, out)


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_unfused_plain_matches_pallas_interpret(model):
    ins = _inputs(3 if model == "nh" else 4)
    args = _unfused(ins)
    # 3 Newton iterations: the interpreter's compile time grows with them
    ref = jnh.nh_local_step(*(jnp.asarray(a) for a in args), iters=3,
                            interpret=True, model=model)
    out = pnh.nh_local_step(*(torch.as_tensor(a) for a in args), iters=3,
                            model=model)
    _assert_interpret_agreement(model, ins, ref, out)


class _Ref:
    """An array standing in for a Pallas ref: reads give jnp arrays,
    writes land in numpy."""

    def __init__(self, a):
        self.a = np.array(a, dtype=np.float64)

    def __getitem__(self, i):
        return jnp.asarray(self.a[i])

    def __setitem__(self, i, v):
        self.a[i] = np.asarray(v)


class _TorchWithXlaElementary:
    """torch, but sqrt correctly rounded (as XLA's is) and log as XLA
    computes it; everything else is torch's own."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sqrt(x):
        return torch.from_numpy(np.sqrt(x.numpy()))

    @staticmethod
    def log(x):
        return torch.from_numpy(np.array(jnp.log(x.numpy())))


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_plain_is_the_kernel_body_bitwise(model, monkeypatch):
    ins = _inputs(3 if model == "nh" else 4)
    refs = [_Ref(a) for a in ins[:4]] + [_Ref(a[None]) for a in ins[4:]]
    want = [_Ref(np.zeros_like(ins[i])) for i in (1, 1, 2, 0)]
    with jax.disable_jit():
        jnh._make_hyper_fused_kernel(5, model)(*refs, *want)
    monkeypatch.setattr(pnh, "torch", _TorchWithXlaElementary())
    got = pnh.nh_local_step_fused_reference(
        *(torch.as_tensor(a) for a in ins), iters=5, model=model)
    for name, w, g in zip(("z9", "u9'", "warm'", "contrib12"), want, got):
        d = np.abs(g.numpy() - w.a)
        assert np.array_equal(g.numpy(), w.a), (
            f"{model} {name}: {int((d > 0).sum())} values differ, max {d.max():.3g}")


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_unfused_plain_is_the_kernel_body_bitwise(model, monkeypatch):
    args = _unfused(_inputs(3 if model == "nh" else 4))
    refs = [_Ref(a) for a in args[:3]] + [_Ref(a[None]) for a in args[3:]]
    want = [_Ref(np.zeros_like(args[i])) for i in (1, 1, 2)]
    with jax.disable_jit():
        jnh._make_hyper_kernel(5, model)(*refs, *want)
    monkeypatch.setattr(pnh, "torch", _TorchWithXlaElementary())
    got = pnh.nh_local_step_reference(
        *(torch.as_tensor(a) for a in args), iters=5, model=model)
    for name, w, g in zip(("z9", "u9'", "warm'"), want, got):
        d = np.abs(g.numpy() - w.a)
        assert np.array_equal(g.numpy(), w.a), (
            f"{model} {name}: {int((d > 0).sum())} values differ, max {d.max():.3g}")


def test_wrapper_checks_and_cpu_route():
    ins = [torch.as_tensor(a) for a in _inputs(5)]
    pnh.nh_local_step_fused.launches = 0
    a = pnh.nh_local_step_fused(*ins, iters=2)
    b = pnh.nh_local_step_fused_reference(*ins, iters=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the CPU route is the plain version and counts no kernel launch
    assert pnh.nh_local_step_fused.launches == 0
    bad = list(ins)
    bad[1] = ins[1][:, :-1]
    with pytest.raises(ValueError, match="u9"):
        pnh.nh_local_step_fused(*bad)
    bad = list(ins)
    bad[4] = ins[4].float()
    with pytest.raises(ValueError, match="mu"):
        pnh.nh_local_step_fused(*bad)
    bad = list(ins)
    bad[0] = ins[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        pnh.nh_local_step_fused(*bad)
    # emit_z: the same outputs, then the rows of w2 D^T z
    *same, cz = pnh.nh_local_step_fused(*ins, iters=2, emit_z=True)
    assert all(torch.equal(x, y) for x, y in zip(same, a))
    E = ins[0].shape[1]
    want = ins[7] * torch.einsum("rke,jre->kje", ins[3].reshape(3, 4, E),
                                 a[0].reshape(3, 3, E)).reshape(12, E)
    torch.testing.assert_close(cz, want, rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="model"):
        pnh.nh_local_step_fused(*ins, model="arap")


def test_unfused_wrapper_checks_and_cpu_route():
    args = [torch.as_tensor(a) for a in _unfused(_inputs(5))]
    pnh.nh_local_step.launches = 0
    for x, y in zip(pnh.nh_local_step(*args, iters=2),
                    pnh.nh_local_step_reference(*args, iters=2)):
        assert torch.equal(x, y)
    assert pnh.nh_local_step.launches == 0
    bad = list(args)
    bad[2] = args[2][:2]
    with pytest.raises(ValueError, match="warm"):
        pnh.nh_local_step(*bad)
    bad = list(args)
    bad[5] = args[5].float()
    with pytest.raises(ValueError, match="k"):
        pnh.nh_local_step(*bad)
    with pytest.raises(ValueError, match="model"):
        pnh.nh_local_step(*args, model="arap")
    with pytest.raises(RuntimeError, match="no kernel"):
        pnh.nh_local_step(*(t.to("meta") for t in args))
