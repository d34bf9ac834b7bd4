#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
`admm_elastic_tpu_torch/csrc/`, checks each against its plain PyTorch
version on the card, checks the general route against the CPU run, then
drives the port's main paths (System -> initialize -> step/run, dia
global solver, f32) and times them in this one process: on the
100,000-tet NeoHookean beam the general route (nh_local + cg_dia kernels)
and the banded whole-timestep route (`lattice_fast_path=True`, one
banded_rollout launch per 10-step window); on the cloth100k sheet (101,250
triangles, bend hinges, anchors, gravity, wind) the general route
(tri_local + cg_dia kernels) and the cloth whole-timestep route (one
cloth_rollout launch per 10-step window). Every phase prints one line of
numbers. Any failure raises: the script then exits non-zero and prints no
result line. It needs CUDA (it never falls back to the CPU) and imports
nothing of JAX.

The last two lines are a JSON object with each kernel's launch count in
its main path's run, error against its plain version, times and roofline
bound, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import dataclasses

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from admm_elastic_tpu_torch.models import StaticAnchor  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import _build  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import banded_step as pbs  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cg_dia as pcg  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cloth_step as pcs  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import nh_local as pnh  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import tri_local as ptri  # noqa: E402
from admm_elastic_tpu_torch.utils import profile_step, scenes  # noqa: E402
from admm_elastic_tpu_torch.utils.opcount import (  # noqa: E402
    count_ops, nbytes, rollout_counts, roofline_ms, tri_local_counts)
from admm_elastic_tpu_torch.utils.scenes import (  # noqa: E402
    cloth100k, small_cloth, tet100k)
DT = 0.04  # the workload's timestep and ADMM iterations
ADMM_ITERS = 10  # (admm_elastic_tpu_torch/utils/scenes.py)
WARMUP_STEPS = 2
WINDOWS, WINDOW_STEPS = 3, 10
CLOTH_BUDGETS = (300, 25)  # cg300: the Jacobi budget matched at 225x225
KERNELS = (pnh.nh_local_step_fused, pcg.cg_dia_solve, pbs.banded_rollout,
           ptri.tri_local_step_fused, pcs.cloth_rollout)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def say(phase, **numbers):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def cuda_ms(torch, fn, reps, warmup=1, batch=1):
    """Median device time of fn() in ms, by CUDA events: reps samples, each
    over `batch` back-to-back calls (for kernels of tens of microseconds,
    where one pair of events around one launch is too coarse)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def drive(torch, s):
    """The main-path protocol: WARMUP_STEPS single steps, then WINDOWS
    run(WINDOW_STEPS) windows, each timed on the host clock around work
    that ends in torch.cuda.synchronize(). Returns (median ms/step,
    per-window ms/step)."""
    for _ in range(WARMUP_STEPS):
        s.step()
    torch.cuda.synchronize()
    windows = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        s.run(WINDOW_STEPS)
        torch.cuda.synchronize()
        windows.append(1e3 * (time.perf_counter() - t0) / WINDOW_STEPS)
    return statistics.median(windows), windows


def nh_inputs(torch, s, rng):
    """The tet100k beam's first ADMM iteration (x_bar after the gravity
    kick, zero dual, unit warm start). The rest state has F = I, where the
    SVD is degenerate; so half of the elements are randomly deformed, and
    half of those inverted (row z of F negated)."""
    p = s.params["c1_HyperElasticTet"]
    E = p["indices"].shape[0]
    x0 = s.state["x"]
    v = torch.zeros_like(x0)
    v[:, 1] = -9.8 * DT
    xbar = x0 + DT * v
    xg = xbar[p["indices"]].reshape(E, 12).T.contiguous()
    perm = torch.as_tensor(rng.permutation(E), device=xg.device)
    inv, noisy = perm[: E // 4], perm[: E // 2]
    for a in (2, 5, 8, 11):
        xg[a, inv] = -xg[a, inv]
    xg[:, noisy] += torch.as_tensor(
        0.02 * rng.standard_normal((12, len(noisy))), dtype=xg.dtype,
        device=xg.device)
    u = torch.zeros((9, E), dtype=xg.dtype, device=xg.device)
    warm = torch.ones((3, E), dtype=xg.dtype, device=xg.device)
    return [xg, u, warm, p["coeff_p"], p["mu"], p["lam"], p["k"], p["w2"]]


def separated(ins):
    """Elements whose singular-value gaps exceed 1e-2 (computed in f64 on
    the host): elsewhere the SVD basis is ill-conditioned."""
    xg, u, _, cp = (t.double().cpu().numpy() for t in ins[:4])
    E = xg.shape[1]
    dx = np.einsum("bke,kae->abe", cp.reshape(3, 4, E), xg.reshape(4, 3, E))
    F = (dx.reshape(9, E) + u).T.reshape(E, 3, 3)
    svs = np.linalg.svd(F, compute_uv=False)
    gaps = np.minimum(svs[:, 0] - svs[:, 1], svs[:, 1] - svs[:, 2])
    return gaps > 1e-2


def check_nh(torch, pnh, ins, dtype):
    ins = [t.to(dtype) for t in ins]
    got = pnh.nh_local_step_fused(*ins, iters=5)
    want = pnh.nh_local_step_fused_reference(*ins, iters=5)
    torch.cuda.synchronize()
    sep = separated(ins)
    E = ins[0].shape[1]
    err = np.zeros(E)
    rel = 0.0
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("nh_local_step_fused: non-finite output")
        d = (g - w).abs().amax(dim=0).double().cpu().numpy()
        err = np.maximum(err, d)
        scale = float(w.abs().amax(dim=0).double().cpu().numpy()[sep].max())
        rel = max(rel, float(d[sep].max()) / scale)
    if dtype == torch.float64:
        ok = float(err[sep].max()) <= 1e-9
        verdict = dict(max_abs_err_sep=float(err[sep].max()), tol_abs=1e-9)
    else:
        ok = rel <= 1e-3
        verdict = dict(max_abs_err_sep=float(err[sep].max()), max_rel_err_sep=rel,
                       tol_rel=1e-3)
    ms = cuda_ms(torch, lambda: pnh.nh_local_step_fused(*ins, iters=5), 10,
                 batch=20)
    plain_ms = cuda_ms(torch, lambda: pnh.nh_local_step_fused_reference(
        *ins, iters=5), 5)
    n_ops, _ = count_ops(pnh.nh_local_step_fused_reference, *ins, iters=5)
    bound_ms, bound_by = roofline_ms(nbytes(ins, got), n_ops)
    say(f"kernel nh_local {str(dtype)[6:]}", E=E, separated=int(sep.sum()),
        **verdict, ms=ms, plain_ms=plain_ms, operations=n_ops,
        bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"nh_local_step_fused disagrees in {dtype}")
    return float(err[sep].max()), ms, plain_ms, bound_ms, bound_by


def check_cg(torch, pcg, s, dtype, n_iters):
    sv = s.params["_solver"]
    x0 = s.state["x"].to(dtype)
    b = (s._masses_dev[:, None] * x0).to(dtype)
    b[:, 1] -= (s._masses_dev * 9.8 * DT * DT).to(dtype)
    args = (b, x0, sv["diag"].to(dtype), sv["dia_vals"].to(dtype),
            s._dia_offsets, n_iters)
    got = pcg.cg_dia_solve(*args)
    want = pcg.cg_dia_solve_reference(*args)
    again = pcg.cg_dia_solve(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    ok = (rel <= tol and bool(torch.isfinite(got).all())
          and bool(torch.equal(got, again)))
    ms = cuda_ms(torch, lambda: pcg.cg_dia_solve(*args), 20)
    plain_ms = cuda_ms(torch, lambda: pcg.cg_dia_solve_reference(*args), 5)
    n_ops, _ = count_ops(pcg.cg_dia_solve_reference, *args)
    bound_ms, bound_by = roofline_ms(nbytes(args, got), n_ops)
    say(f"kernel cg_dia {str(dtype)[6:]}", n=b.shape[0],
        diagonals=len(s._dia_offsets), n_iters=n_iters, max_abs_err=err,
        rel_err=rel, tol=tol, bitwise_repeat=bool(torch.equal(got, again)),
        ms=ms, plain_ms=plain_ms, operations=n_ops, bound_ms=bound_ms,
        bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"cg_dia_solve disagrees in {dtype} at {n_iters}")
    return err, ms, plain_ms, bound_ms, bound_by


# the whole-timestep kernels: wrapper, plain twin, state keys
ROLLOUTS = {
    "banded": (pbs.banded_rollout, pbs.banded_rollout_reference, pbs.STATE),
    "cloth": (pcs.cloth_rollout, pcs.cloth_rollout_reference, pcs.STATE),
}


def rollout_errors(torch, kind, st, cfg, steps):
    """Kernel and twin from the same state; (x abs err, x rel err, v abs
    err, bitwise repeat, finite)."""
    run, reference, keys = ROLLOUTS[kind]
    got = run(st.state, st.planes, cfg, steps)
    again = run(st.state, st.planes, cfg, steps)
    want = reference(st.state, st.planes, cfg, steps)
    torch.cuda.synchronize()
    ex = float((got["x"] - want["x"]).abs().max())
    ev = float((got["v"] - want["v"]).abs().max())
    rel = ex / float(want["x"].abs().max())
    bit = all(torch.equal(got[k], again[k]) for k in keys)
    fin = all(bool(torch.isfinite(got[k]).all()) for k in keys)
    return ex, rel, ev, bit, fin


def check_rollout_small(torch, kind, st, dtype, tol_1it):
    """1 step of 1 ADMM iteration, then a 10-step window: x within tol_1it
    and 1e-8 (f64) or 1e-4 relative (f32)."""
    f64 = dtype == torch.float64
    ok = True
    for tag, cfg, steps, tol in (
            ("1 iteration", dataclasses.replace(st.cfg, admm_iters=1), 1,
             tol_1it if f64 else 1e-4),
            ("10-step window", st.cfg, 10, 1e-8 if f64 else 1e-4)):
        ex, rel, ev, bit, fin = rollout_errors(torch, kind, st, cfg, steps)
        err = ex if f64 else rel
        good = err <= tol and bit and fin
        say(f"kernel {kind} {str(dtype)[6:]} small {tag}", n=st.n_nodes,
            elements=st.n_elements, max_abs_err_x=ex, rel_err_x=rel,
            max_abs_err_v=ev, tol=tol, tol_on="abs x" if f64 else "rel x",
            bitwise_repeat=bit, finite=fin, ok=good)
        ok = ok and good
    if not ok:
        raise AssertionError(f"{kind} rollout disagrees in {dtype} (small)")


def check_rollout_full(torch, kind, st, label, dtype, tol):
    """One full-width step, kernel vs twin (x within tol: abs in f64,
    relative in f32); the kernel's time per 1-step and per 10-step
    launch, the twin's per step, and the bound of one step."""
    run, reference, keys = ROLLOUTS[kind]
    ex, rel, ev, bit, fin = rollout_errors(torch, kind, st, st.cfg, 1)
    err = ex if dtype == torch.float64 else rel
    ok = err <= tol and bit and fin
    ms = cuda_ms(torch, lambda: run(st.state, st.planes, st.cfg, 1), 5)
    window_ms = cuda_ms(torch, lambda: run(st.state, st.planes, st.cfg, 10),
                        3)
    plain_ms = cuda_ms(torch, lambda: reference(st.state, st.planes, st.cfg,
                                                1), 1, warmup=0)
    n_ops, n_bytes = rollout_counts(reference, keys, st.state, st.planes,
                                    st.cfg, 1)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    say(f"kernel {kind} {str(dtype)[6:]} {label}", n=st.n_nodes,
        elements=st.n_elements, diagonals=len(st.cfg.dia_offs),
        max_abs_err_x=ex, rel_err_x=rel, max_abs_err_v=ev, tol=tol,
        bitwise_repeat=bit, finite=fin, ms_per_1step_launch=ms,
        ms_per_10step_launch=window_ms, ms_per_step_in_window=window_ms / 10,
        plain_ms_per_step=plain_ms, operations=n_ops, bytes=n_bytes,
        bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"{kind} rollout disagrees at {label}, {dtype}")
    return ex, ms, plain_ms, bound_ms, bound_by


def tri_inputs(torch, s, rng):
    """The cloth100k sheet's triangle-step inputs with every vertex moved
    by 0.2 grid spacings N(0,1) per axis (at rest F^T F is isotropic, a
    single branch of the SVD) and a random dual 0.05 N(0,1)."""
    p = s.params["c0_LimitedTriangleStrain"]
    E = p["indices"].shape[0]
    x = s.state["x"]
    x = x + torch.as_tensor(0.2 * (2.0 / 225) * rng.standard_normal(x.shape),
                            dtype=x.dtype, device=x.device)
    xg = x[p["indices"]].reshape(E, 9).T.contiguous()
    u = torch.as_tensor(0.05 * rng.standard_normal((6, E)), dtype=x.dtype,
                        device=x.device)
    return [xg, u, p["coeff_p"], p["w2"], p["k"], p["limit_min"],
            p["limit_max"]]


def check_tri(torch, ptri, ins, dtype):
    ins = [t.to(dtype) for t in ins]
    got = ptri.tri_local_step_fused(*ins)
    want = ptri.tri_local_step_fused_reference(*ins)
    again = ptri.tri_local_step_fused(*ins)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = err / max(float(w.abs().max()) for w in want)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    fin = all(bool(torch.isfinite(g).all()) for g in got)
    f64 = dtype == torch.float64
    tol = 1e-12 if f64 else 1e-5
    ok = fin and repeat and (err if f64 else rel) <= tol
    ms = cuda_ms(torch, lambda: ptri.tri_local_step_fused(*ins), 10,
                 batch=20)
    plain_ms = cuda_ms(torch, lambda: ptri.tri_local_step_fused_reference(
        *ins), 5)
    n_ops, n_bytes = tri_local_counts(*ins)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    say(f"kernel tri_local {str(dtype)[6:]}", E=ins[0].shape[1],
        max_abs_err=err, rel_err=rel, tol=tol,
        tol_on="abs" if f64 else "rel", bitwise_vs_twin=bitwise,
        bitwise_repeat=repeat, ms=ms, plain_ms=plain_ms, operations=n_ops,
        bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"tri_local_step_fused disagrees in {dtype}")
    return err, ms, plain_ms, bound_ms, bound_by


def cloth_trajectory(s):
    """(finite, anchor drift m, lowest dy m) of a cloth System."""
    x = s.x
    anchored = np.concatenate([f.indices for f in s.forces
                               if isinstance(f, StaticAnchor)])
    drift = float(np.abs(x[anchored] - s._x[anchored]).max())
    sag = float((x[:, 1] - s._x[:, 1]).min())
    return bool(np.isfinite(x).all()), drift, sag


def off_path(*kernels):
    """Raise if any of these kernels launched since the last reset."""
    bad = [k.__name__ for k in kernels if k.launches]
    if bad:
        raise AssertionError(f"a route launched kernels of another: {bad}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")

    # phase 1: the device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # phase 2: build the kernels from the checkout's sources
    lib_path, build_s = _build.build()
    _build.load_library()
    say("build", seconds=round(build_s, 3), library=os.path.relpath(lib_path, HERE))
    entry, spills = "?", ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            print(f"  ptxas {entry}: {used}; {spills}")

    # phase 3: each kernel against its plain version at the slice's shapes
    rng = np.random.default_rng(0)
    ref64 = tet100k(25, torch.float64)
    ins = nh_inputs(torch, ref64, rng)
    check_nh(torch, pnh, ins, torch.float64)
    nh32 = check_nh(torch, pnh, ins, torch.float32)
    cg_ms = {}
    for dtype in (torch.float64, torch.float32):
        for k in (25, 75):
            cg_ms[(dtype, k)] = check_cg(torch, pcg, ref64, dtype, k)
    del ref64, ins

    # phase 3b: the banded whole-timestep kernel against its plain version
    for dtype in (torch.float64, torch.float32):
        check_rollout_small(torch, "banded",
                            scenes.jittered_system(dtype=dtype)._stepper,
                            dtype, 1e-11)
    check_rollout_full(torch, "banded",
                       tet100k(75, torch.float64, fast=True)._stepper,
                       "tet100k cg75", torch.float64, 1e-8)
    banded32 = check_rollout_full(
        torch, "banded", tet100k(75, torch.float32, fast=True)._stepper,
        "tet100k cg75", torch.float32, 1e-4)

    # phase 3c: the triangle-strain kernel at the cloth100k sheet's shapes
    cloth64 = cloth100k(25, torch.float64, fast=False)
    ins = tri_inputs(torch, cloth64, rng)
    check_tri(torch, ptri, ins, torch.float64)
    tri32 = check_tri(torch, ptri, ins, torch.float32)
    del cloth64, ins

    # phase 3d: the cloth whole-timestep kernel against its plain version
    for dtype in (torch.float64, torch.float32):
        check_rollout_small(torch, "cloth", small_cloth(dtype)._stepper,
                            dtype, 1e-12)
    cloth32 = check_rollout_full(torch, "cloth",
                                 cloth100k(25, torch.float32)._stepper,
                                 "cloth100k cg25", torch.float32, 1e-4)

    # phase 4: slice parity, card vs CPU, and determinism on the card
    def small(device):
        s = scenes.beam_system((6, 4, 4), 0.05, 1.0, 25, torch.float64,
                               device)
        s.run(5)
        return s.x, s.v

    xc, _ = small("cpu")
    xg1, vg1 = small("cuda")
    xg2, vg2 = small("cuda")
    diff = float(np.abs(xg1 - xc).max())
    bitwise = bool(np.array_equal(xg1, xg2) and np.array_equal(vg1, vg2))
    say("slice parity 6x4x4 f64", max_abs_dx_cuda_vs_cpu=diff, tol=1e-8,
        bitwise_repeat=bitwise)
    if not (diff < 1e-8 and bitwise):
        raise AssertionError("slice parity or determinism failed on the card")

    # phase 5: the general route at full width, f32
    steps = WARMUP_STEPS + WINDOWS * WINDOW_STEPS
    systems = {cg: tet100k(cg, torch.float32) for cg in (75, 25)}
    reset_launches()
    per_budget = {}
    for cg, s in systems.items():
        n0 = (pnh.nh_local_step_fused.launches, pcg.cg_dia_solve.launches)
        per_budget[cg] = (*drive(torch, s),
                          (pnh.nh_local_step_fused.launches - n0[0],
                           pcg.cg_dia_solve.launches - n0[1]), s)
    launches = {"nh_local": pnh.nh_local_step_fused.launches,
                "cg_dia": pcg.cg_dia_solve.launches}
    off_path(pbs.banded_rollout, ptri.tri_local_step_fused,
             pcs.cloth_rollout)

    for cg, (med, windows, counts, s) in per_budget.items():
        x = s.x
        anchored = np.flatnonzero(s._x[:, 0] < 1e-9)
        drift = float(np.abs(x[anchored] - s._x[anchored]).max())
        sag = float((x[:, 1] - s._x[:, 1]).min())
        nh_step = ADMM_ITERS * nh32[1]
        cg_step = ADMM_ITERS * cg_ms[(torch.float32, cg)][1]
        say(f"tet100k cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            nh_launches=counts[0], cg_launches=counts[1],
            anchor_drift_m=drift, min_dy_m=sag,
            finite=bool(np.isfinite(x).all()))
        say(f"attribution cg{cg}", local_nh_ms=nh_step, cg_ms=cg_step,
            rest_ms=med - nh_step - cg_step)
        if counts != (steps * ADMM_ITERS, steps * ADMM_ITERS):
            raise AssertionError(f"cg{cg}: kernel launches {counts}, expected "
                                 f"{steps * ADMM_ITERS} each")
        if not (np.isfinite(x).all() and drift < 1e-4 and sag < 0):
            raise AssertionError(f"cg{cg}: bad trajectory (drift {drift}, "
                                 f"min dy {sag})")

    # phase 5b: the banded whole-timestep route at full width, f32
    fast = {cg: tet100k(cg, torch.float32, fast=True) for cg in (75, 25)}
    reset_launches()
    fast_budget = {}
    for cg, s in fast.items():
        n0 = pbs.banded_rollout.launches
        fast_budget[cg] = (*drive(torch, s), pbs.banded_rollout.launches - n0)
    launches["banded"] = pbs.banded_rollout.launches
    off_path(pnh.nh_local_step_fused, pcg.cg_dia_solve,
             ptri.tri_local_step_fused, pcs.cloth_rollout)
    for cg, (med, windows, n_launch) in fast_budget.items():
        s, gen = fast[cg], per_budget[cg][3]
        x = s.x
        anchored = np.flatnonzero(s._x[:, 0] < 1e-9)
        drift = float(np.abs(x[anchored] - s._x[anchored]).max())
        sag = float((x[:, 1] - s._x[:, 1]).min())
        vs_general = float(np.abs(x - gen.x).max())
        want = WARMUP_STEPS + WINDOWS  # single warm-up steps, one per window
        say(f"tet100k fast cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            banded_launches=n_launch, expected_launches=want,
            anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_general_m=vs_general,
            finite=bool(np.isfinite(x).all()))
        say(f"routes cg{cg} f32 (this call)",
            general_ms_per_step=per_budget[cg][0], fast_ms_per_step=med)
        if n_launch != want:
            raise AssertionError(f"fast cg{cg}: {n_launch} banded launches, "
                                 f"expected {want}")
        if not (np.isfinite(x).all() and drift < 1e-4 and sag < 0):
            raise AssertionError(f"fast cg{cg}: bad trajectory (drift "
                                 f"{drift}, min dy {sag})")
    for cg, s in fast.items():
        profile_step.profile(cg, WINDOW_STEPS, "fast", s=s)
    del systems, fast, per_budget, fast_budget

    # phase 5c: cloth100k on the general and the cloth route, f32
    gen = {cg: cloth100k(cg, torch.float32, fast=False)
           for cg in CLOTH_BUDGETS}
    reset_launches()
    gen_runs = {}
    for cg, s in gen.items():
        n0 = (ptri.tri_local_step_fused.launches, pcg.cg_dia_solve.launches)
        gen_runs[cg] = (*drive(torch, s),
                        (ptri.tri_local_step_fused.launches - n0[0],
                         pcg.cg_dia_solve.launches - n0[1]))
    launches["tri_local"] = ptri.tri_local_step_fused.launches
    off_path(pnh.nh_local_step_fused, pbs.banded_rollout, pcs.cloth_rollout)

    cloth = {cg: cloth100k(cg, torch.float32, fast=True)
             for cg in CLOTH_BUDGETS}
    reset_launches()
    cloth_runs = {}
    for cg, s in cloth.items():
        n0 = pcs.cloth_rollout.launches
        cloth_runs[cg] = (*drive(torch, s), pcs.cloth_rollout.launches - n0)
    launches["cloth"] = pcs.cloth_rollout.launches
    off_path(pnh.nh_local_step_fused, pcg.cg_dia_solve, pbs.banded_rollout,
             ptri.tri_local_step_fused)

    # the general route once more from rest positions moved by 1e-6 m
    # (N(0,1) per axis, about f32 round-off): how far the same 32 steps
    # carry such a perturbation bounds how closely the routes can agree
    sens = {}
    for cg in CLOTH_BUDGETS:
        p = cloth100k(cg, torch.float32, fast=False)
        p.x = p._x + 1e-6 * np.random.default_rng(1).standard_normal(
            p._x.shape)
        p.run(steps)
        sens[cg] = float(np.abs(p.x - gen[cg].x).max())
        del p

    for cg in CLOTH_BUDGETS:
        g, c = gen[cg], cloth[cg]
        gmed, gwin, gcounts = gen_runs[cg]
        cmed, cwin, n_launch = cloth_runs[cg]
        gfin, gdrift, gsag = cloth_trajectory(g)
        cfin, cdrift, csag = cloth_trajectory(c)
        vs_general = float(np.abs(c.x - g.x).max())
        want = WARMUP_STEPS + WINDOWS
        say(f"cloth100k general cg{cg} f32", ms_per_step_median=gmed,
            windows_ms=[round(w, 4) for w in gwin],
            spread_ms=max(gwin) - min(gwin), steps=steps,
            tri_local_launches=gcounts[0], cg_launches=gcounts[1],
            anchor_drift_m=gdrift, min_dy_m=gsag, finite=gfin)
        say(f"cloth100k cloth cg{cg} f32", ms_per_step_median=cmed,
            windows_ms=[round(w, 4) for w in cwin],
            spread_ms=max(cwin) - min(cwin), steps=steps,
            cloth_launches=n_launch, expected_launches=want,
            anchor_drift_m=cdrift, min_dy_m=csag,
            max_abs_dx_vs_general_m=vs_general,
            general_vs_perturbed_general_m=sens[cg], finite=cfin)
        say(f"cloth routes cg{cg} f32 (this call)", general_ms_per_step=gmed,
            cloth_ms_per_step=cmed)
        if gcounts != (steps * ADMM_ITERS, steps * ADMM_ITERS):
            raise AssertionError(f"cloth cg{cg}: general-route launches "
                                 f"{gcounts}, expected {steps * ADMM_ITERS}")
        if n_launch != want:
            raise AssertionError(f"cloth cg{cg}: {n_launch} cloth launches, "
                                 f"expected {want}")
        if not (gfin and cfin and max(gdrift, cdrift) < 1e-4
                and max(gsag, csag) < 0
                and vs_general <= max(1e-3, 10.0 * sens[cg])):
            raise AssertionError(f"cloth cg{cg}: bad trajectory")
    # the one-launch route first: the general route's traces hold tens of
    # thousands of launches
    for route, runs in (("fast", cloth), ("general", gen)):
        for cg, s in runs.items():
            profile_step.profile(cg, WINDOW_STEPS, route, s=s,
                                 scene="cloth100k")

    def entry(name, source, replaces, n, err, ms, plain_ms, bound_ms,
              bound_by):
        return {"name": name, "route": "cuda",
                "source": f"admm_elastic_tpu_torch/csrc/{source}",
                "replaces": f"admm_elastic_tpu/ops/pallas/{replaces}",
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    print(json.dumps({"kernels": [
        entry("nh_local_step_fused", "nh_local.cu", "nh_local.py:442",
              launches["nh_local"], *nh32),
        entry("cg_dia_solve", "cg_dia.cu", "cg_dia.py:99", launches["cg_dia"],
              *cg_ms[(torch.float32, 75)]),
        entry("banded_rollout", "banded_step.cu", "banded_step.py:1090",
              launches["banded"], *banded32),
        entry("tri_local_step_fused", "tri_local.cu", "tri_local.py:245",
              launches["tri_local"], *tri32),
        entry("cloth_rollout", "cloth_step.cu", "cloth_step.py:746",
              launches["cloth"], *cloth32),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
