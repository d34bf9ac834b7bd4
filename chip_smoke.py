#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
`admm_elastic_tpu_torch/csrc/`, checks each against its plain PyTorch
version on the card, checks small scenes of every route against the CPU
run, then drives the port's main paths (System -> initialize -> step/run,
f32) and times them in this one process: on the 100,000-tet NeoHookean beam
(dia global solver) the general route (nh_local + cg_dia kernels) and the
banded whole-timestep route (`lattice_fast_path=True`, one banded_rollout
submission per 10-step window: a CUDA graph of its element, vertex and
cluster-solve launches); on the cloth100k sheet (101,250 triangles,
bend hinges, anchors, gravity, wind; dia) the general route (tri_local +
cg_dia kernels) and the cloth whole-timestep route (one cloth_rollout
submission per 10-step window: a CUDA graph of its wind, kick, element,
vertex and cluster-solve launches); on the delaunay100k mesh (100,852 tets of
arbitrary topology, ell global solver) the general route with each CG
backend (xla: plain PyTorch PCG; fused: cg_update kernel; kernel: cg_ell
kernel; all with nh_local) and the banded route with its ELL matvec; and
the unfused pipeline: the beam on the dense global mode (nh_local_step
kernel, A_inv @ b), the beam as LinearTetStrain (arap100k) on dia
(arap_local_step_fused + cg_dia) and with over-relaxation 1.6
(arap_local_step), and cloth100k on the matrix-free cg mode
(tri_local_step, plain PyTorch PCG); the beam on the lattice
whole-timestep route (the cg global mode with `lattice_fast_path=True`,
one lattice_rollout submission per 10-step window) against the banded
route;
and arap100k on the banded route's arap mode against its general route;
and the beam on the sharded banded stepper at one device (cg25, cg75
through one cg_dia_solve launch per solve, cheb180 through one
cheb_dia_chunk launch per solve, on one thread-block cluster; one
banded_local_rhs call per ADMM iteration) against the banded route;
and the in-kernel geometric multigrid (`preconditioner="amg"`): the
multigrid mode of the cluster solve (mg_dia_solve, `csrc/mg_vcycle.cuh`)
and of the banded and cloth windows against their twins (phase 3o), then
tet100k on the banded route at mg6 and mg8 and cloth100k on the cloth
route at mg8 against the matched Jacobi routes of the same call (phase
5i); and the algebraic multigrids (`preconditioner="amg"` under "ell"):
the algebraic mode of the cluster solve (uamg_ell_solve, the aggregation
V-cycle of `csrc/mg_vcycle.cuh`) and the banded window's ELL mode on it
against their twins (phase 3r), then delaunay100k on the banded-ELL route
at uamg6 (bench.py's matched row) and uamg8 against the banded-ELL
Jacobi route at cg1000 with their last ADMM iteration's primal residual
beside cg75's, and on the general ell route with the aggregation AMG
(plain PyTorch) at amg6 (phase 5k).
The two whole-solve kernels (cg_dia_solve, cg_ell_solve: one launch on a
16-CTA thread-block cluster each) are also held to their twins on
delaunay100k renumbered at random (phase 3f) and on banded systems of
1,003 and 11 rows, and timed at 4 and 16 times tet100k's rows, beside the
per-iteration floor and the cost of each synchronisation they are built
from (phase 3n, the latter by a microbenchmark built beside the kernels,
`csrc/probes/sync_probe.cu`, which also times the grid barrier that
cooperative kernels pay, on the grid of the rollout kernels the windows
replaced, and asks whether the card takes a launch both cooperative and
clustered).
The residual modes (`collect_residuals`): the three fused element
kernels' emit_z block against their twins and against the launch without
it (phase 3p), the banded and cloth windows' "primal" and "full" modes
and B11's collect against their twins, bitwise, with the state bitwise to
the same window without collection and graph replays equal to eager
launches (phase 3q), then every route that collects at full width timed
with collection off, "primal" and True beside the first and last ADMM
iteration's residuals, the general route's against the banded route's,
and iteration 0's dual residual by both forms of its seed (phase 5j).
The scenario sweep (`core/sweep.py`, the banded window's sweep mode: S
simulations of one mesh in the same launches, one cluster solve a
scenario): small sweeps of 4 jittered beams in both matrix forms and
three models, bitwise to the twin and each scenario bitwise to a
single-scenario window fed its planes, graph steps held to the twin and
the residual modes (phase 3s); then `bench.py --preset sweep64` at full
width (64 drops of a 2,800-tet beam, f32) on ELL and dia: ms/step and per
scenario-step beside the single-scenario route of scenario 0 (and that
times 64), device ops a step, the clusters the card holds at once and the
waves they make, scenarios 0, 31, 63 against their own single routes after
32 steps (bitwise), and the same sweep at 1,024 scenarios (phase 5l).
The hyperelastic element steps (phase 3): `nh_local_step_fused` (it
gathers each tet's vertices from x and writes the RHS rows in the
gather's layout) on tet100k's own mesh and on inverted, collapsed and
degenerate elements whose vertices it shares with no other, nh and stvk,
with and without emit_z, and `nh_local_step` on their Dx, bitwise to
their twins in f64 and f32; their registers, spills and SASS size, and
their times traced and by events beside the host's us a call (the
triangle and ARAP steps' times the same way, phases 3c and 3i); in phase
5 the general route's element pipeline is one device op an ADMM
iteration, and the route's device ops a step are counted.
Depth is cut where the plain twins and the tracer would take the time
(constants below): small windows of SMALL_STEPS steps of SMALL_ADMM ADMM
iterations, the f64 full-width windows at F64_FULL_ADMM iterations (f32 at
full depth), GRAPH_STEPS graph steps held to the twin, PROFILE_ATTEMPTS
traced windows a route; the SASS counts run in a process of their own.
The JAX package's default element backend (`backend="xla"`: the
SVD and Newton of `ops/svd.py` and `ops/newton.py` in plain PyTorch, no
kernel of its own): tet100k, arap100k and cloth100k default-constructed
on the general dia route (cg_dia_solve) with their ms/step, device ops a
step and idle share, against the pallas-constructed scenes; the same
three on their whole-timestep windows, bitwise the pallas-constructed
Systems'; the JAX package's two golden trajectories in f64 (phase 5m).
Runtime edits and checkpoints at tet100k (phase 5n): poordillo's grab,
drag and release on the general dia route (a MovingAnchor, through
nh_local_step_fused and cg_dia_solve), the banded window after a release
of half its anchors (its new planes' graph steps each bitwise the twin's)
and the sharded cheb180 stepper after refresh_params (bitwise one built
from the released System), and checkpoints resumed bitwise on the
general route and the banded window.
Every phase prints one line of numbers, its script time last (t=). Any
failure raises: the script
then exits non-zero and prints no result line. It needs CUDA (it never
falls back to the CPU) and imports nothing of JAX.

The last two lines are a JSON object with each kernel's launch count in
its main path's run, error against its plain version, times and roofline
bound, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
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

from admm_elastic_tpu_torch.core.banded import BandedStepper  # noqa: E402
from admm_elastic_tpu_torch.core.cloth import ClothStepper  # noqa: E402
from admm_elastic_tpu_torch.core.lattice import LatticeStepper  # noqa: E402
from admm_elastic_tpu_torch.models import StaticAnchor, smooth_move  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import _build  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import banded_step as pbs  # noqa: E402
from admm_elastic_tpu_torch.core.solver import (  # noqa: E402
    assemble_A_hat, dense_inverse, dia_apply, ell_apply)
from admm_elastic_tpu_torch.ops.kernels import cg_dia as pcg  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cg_ell as pell  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cg_step as pstep  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cloth_step as pcs  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import lattice_step as plat  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import nh_local as pnh  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import tet_local as ptet  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import tri_local as ptri  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import banded_local as pbl  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import cheb_dia as pchb  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import mg as pmg  # noqa: E402
from admm_elastic_tpu_torch.ops.kernels import uamg as puamg  # noqa: E402
from admm_elastic_tpu_torch.parallel import (  # noqa: E402
    ShardedBandedStepper, sharded_banded_from_system)
from admm_elastic_tpu_torch.parallel.cheb import (  # noqa: E402
    cheb_coefficients, dia_operator_bounds)
from admm_elastic_tpu_torch.utils import profile_step, scenes  # noqa: E402
from admm_elastic_tpu_torch.utils.time_solves import graph_ms  # noqa: E402
from admm_elastic_tpu_torch.utils.opcount import (  # noqa: E402
    banded_local_counts, cg_dia_counts, cg_ell_counts, cg_update_counts,
    cheb_dia_counts, mg_dia_counts, nbytes, rollout_counts, roofline_ms,
    sweep_counts, twin_counts, uamg_ell_counts)
from admm_elastic_tpu_torch.utils.scenes import (  # noqa: E402
    arap100k, banded_spd, beam_system, cloth100k, delaunay100k, small_cloth,
    small_delaunay, small_mg_beam, small_uamg, tet100k, tet100k_sharded)
DT = 0.04  # the workload's timestep and ADMM iterations
ADMM_ITERS = 10  # (admm_elastic_tpu_torch/utils/scenes.py)
WARMUP_STEPS = 2
WINDOWS, WINDOW_STEPS = 3, 10
CLOTH_BUDGETS = (300, 25)  # cg300: the Jacobi budget matched at 225x225
# delaunay100k: cg25 is bench.py's budget, not matched to an exact solve;
# cg75 a second budget, not claimed matched either
DELAUNAY_BUDGETS = (25, 75)
KERNELS = (pnh.nh_local_step_fused, pcg.cg_dia_solve, pbs.banded_rollout,
           ptri.tri_local_step_fused, pcs.cloth_rollout, pstep.cg_update,
           pell.cg_ell_solve, pnh.nh_local_step, ptri.tri_local_step,
           ptet.arap_local_step_fused, ptet.arap_local_step,
           plat.lattice_rollout, pbl.banded_local_rhs, pchb.cheb_dia_chunk,
           pmg.mg_dia_solve, puamg.uamg_ell_solve)
# the sharded banded stepper at tet100k (phase 5h): solver, budget; cheb180
# is the Chebyshev budget matched at 100k tets (f64 study, worst residual
# ratio 1.027 against an exact solve, as cg75's 1.022)
SHARDED = (("cg", 25), ("cg", 75), ("cheb", 180))
# the multigrid routes (phase 5i): scene, V-cycle PCG iterations a solve.
# tet100k at mg6 is bench.py --amg (its matched row); mg8 the JAX
# package's default budget there; cloth100k at mg8 is bench's matched
# cloth100k row (bench.py:229-232)
MG_ROUTES = (("tet100k", 6), ("tet100k", 8), ("cloth100k", 8))
# the most a multigrid route may lie from the 4 times deeper Jacobi route
# after 32 steps in f32 (m), set from this phase's readings on the H100:
# at tet100k mg6 / mg8 3.9e-5 / 2.8e-5 (banded cg75 itself 3.3e-5 from
# cg300), at cloth100k mg8 1.1e-3 from cg1200 (cloth cg300 1.3e-2); the
# scene's Jacobi route at cg8 is printed beside each as the control the
# limit must reject (0.22 m and 2.5 m there)
MG_DX_LIMIT_M = {"tet100k": 1e-4, "cloth100k": 3e-3}
MG_CONTROL_CG = 8
# the algebraic multigrid routes (phases 3r and 5k): delaunay100k's
# V-cycle PCG iterations a solve. uamg6 is bench.py --preset delaunay100k
# --amg (its matched row), uamg8 the JAX package's default budget; the
# banded-ELL Jacobi route at UAMG_DEEP_CG is the yardstick after 32 steps
# and cg75 the deepest Jacobi budget the earlier phases time
UAMG_BUDGETS = (6, 8)
UAMG_DEEP_CG = 1000
UAMG_JACOBI_CG = 75
# the most an algebraic multigrid route may lie from its yardstick after
# 32 steps in f32 (m), set from phase 5k's readings on the H100: banded
# uamg6 / uamg8 2.1e-4 / 1.3e-4 from cg1000, the general amg6 3.7e-5 from
# banded uamg6; the banded-ELL Jacobi route at UAMG_JACOBI_CG (8.4e-3 m
# from cg1000) is the control the limit must reject
UAMG_DX_LIMIT_M = 1e-3
# the small sweeps of phase 3s (scenes.jittered_sweep, 4 scenarios, 3 ADMM
# iterations of cg8: the twin's dots are host-bound, and bitwise needs no
# depth)
SMALL_SWEEPS = (
    ("dia nh", {"solver": "dia"}),
    ("ell nh", {"solver": "ell"}),
    ("dia arap anchors floor", {"solver": "dia", "model": "arap",
                                "anchor_sweep": True, "floor": True}),
    ("ell arap anchors floor", {"solver": "ell", "model": "arap",
                                "anchor_sweep": True, "floor": True}),
)
SMALL_DEPTH = {"admm": 3, "cg": 8}
# every other small window of phase 3 (banded, cloth, lattice, their
# multigrids, the residual modes): SMALL_STEPS steps of SMALL_ADMM ADMM
# iterations at the scene's CG budget (tests/test_torch_cuda.py holds
# 10-step windows at the scenes' own depth)
SMALL_STEPS, SMALL_ADMM = 2, 3
# the ADMM iterations of the f64 full-width window checks (banded and
# lattice at tet100k, cloth100k, the banded arap mode): the f64 twin takes
# seconds a step, and the kernels line reads the f32 checks, at full depth
F64_FULL_ADMM = 2
# the graph steps each held to the twin (check_steps: tet100k mg8,
# cloth100k mg8, delaunay100k uamg6, the small ELL sweep)
GRAPH_STEPS = 5
# profile_step's traces (phase 5): at most PROFILE_ATTEMPTS windows a
# route, of WINDOW_STEPS steps on a whole-timestep route (one submission)
# and of PROFILE_STEPS on a route that launches per ADMM iteration (a
# trace of thousands of records a step, which the tracer loses at times)
PROFILE_ATTEMPTS, PROFILE_STEPS = 2, 3
# phase 5l: bench.py --preset sweep64's scenarios, the scenarios held to
# their own single-scenario routes, and the scale README claims for the
# JAX package's sweep
SWEEP_SCENARIOS = 64
# the ADMM iterations of phase 5l's full-width check against the twin (the
# twin takes ~1 s a scenario-step at the preset's 10; the shapes are the
# preset's)
SWEEP_CHECK_ADMM = 2
SWEEP_WITNESSES = (0, 31, 63)
SWEEP_WIDE = 1024
# phase 5m: the default element backend ('xla', plain PyTorch) at full
# width on the general dia route: the steps of each trajectory (after one
# warm-up step), the budget, the steps of its profile, and the steps of the
# whole-timestep windows held bitwise to the pallas-constructed Systems'
XLA_STEPS, XLA_CG, XLA_PROFILE_STEPS, XLA_FAST_STEPS = 16, 25, 2, 10
# the most a golden scene may lie from its file on the card, f64 (relative
# to the trajectory's largest coordinate)
GOLDEN_REL_LIMIT = 1e-8
# phase 5n: runtime edits and checkpoints at tet100k, f32, cg25: the steps
# of poordillo's drag (the grab lifted by EDIT_DRAG_M along smooth_move) and
# after its release on the general route; the banded window's steps before
# its checkpoint and after it, then after a release of every other x = 0
# anchor (1 timed with its recapture, EDIT_TIMED_STEPS timed, GRAPH_STEPS
# held to the twin); the sharded cheb180 steps before and after
# refresh_params; the general route's steps after its checkpoint
EDIT_STEPS, EDIT_DRAG_M, EDIT_CG = 8, (0.0, 0.15, 0.0), 25
EDIT_WINDOW_STEPS, EDIT_TIMED_STEPS, EDIT_SHARDED_STEPS = 10, 3, 5
EDIT_CKPT_STEPS = 2
# the most the grab may lie from its control point at the end of the drag
# (m): a fifth of the drag; weight 1000 a node against the beam's pull
EDIT_HELD_LIMIT_M = 0.03


def reset_launches():
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "residual_launches"):
            k.residual_launches = 0


_T0 = time.perf_counter()


def say(phase, **numbers):
    """One line of a phase's numbers, the script's seconds so far last."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items())
          + f" t={time.perf_counter() - _T0:.1f}", flush=True)


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


def trace(cg, route, s, steps=None, **kw):
    """profile_step.profile of a route at this script's depth (PROFILE_*):
    its printed line, and the numbers."""
    if steps is None:
        steps = (WINDOW_STEPS if route in ("fast", "lattice")
                 else PROFILE_STEPS)
    return profile_step.profile(cg, steps, route, s=s,
                                attempts=PROFILE_ATTEMPTS, **kw)


def timed_ms(torch, fn):
    """fn() once, and the ms from a CUDA event before it to one after it,
    the stream drained first (a host-bound twin's time is its host's).
    Returns (fn(), ms)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tet_inputs(torch, s, name, rng):
    """A tet100k-sized beam's first ADMM iteration (x_bar after the gravity
    kick, zero dual): gathered positions xg (12,E) and the force's params.
    The rest state has F = I, where the SVD is degenerate; so half of the
    elements are randomly deformed, and half of those inverted (row z of F
    negated); 64 more collapse to a point (F = 0) and 64 to a line (rank
    1)."""
    p = s.params[name]
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
    point, line = perm[E // 2: E // 2 + 64], perm[E // 2 + 64: E // 2 + 128]
    xg[:, point] = xg[0:3, point].repeat(4, 1)
    d = torch.as_tensor(rng.standard_normal((3, 64)), dtype=xg.dtype,
                        device=xg.device)
    xg[:, line] = torch.cat([xg[0:3, line] + 0.01 * t * d
                             for t in (0.0, 1.0, 3.0, -2.0)])
    return xg, p


def tet_dx(xg, cp):
    """dx[3a+b] = F_{a,b} = sum_k cp[4b+k] xg[3k+a], (9,E)."""
    E = xg.shape[1]
    return torch.einsum("bke,kae->abe", cp.reshape(3, 4, E),
                        xg.reshape(4, 3, E)).reshape(9, E).contiguous()


def unshared(xg):
    """Positions and int32 tets whose gather is xg (12,E): vertex 4e+k of
    element e holds xg[3k:3k+3, e] (the gathered inputs of tet_inputs as a
    mesh whose elements share no vertex)."""
    E = xg.shape[1]
    x = xg.T.reshape(4 * E, 3).contiguous()
    return x, torch.arange(4 * E, dtype=torch.int32,
                           device=xg.device).reshape(E, 4)


def mesh_inputs(torch, s, name, xg, rng):
    """A tet force's element inputs at a scene's elements: (x_bar after the
    gravity kick moved by 2 mm N(0,1), the int32 tets, zero duals, the
    force's params, the unshared form of tet_inputs' gathered inputs xg
    (inverted, collapsed and degenerate elements), their Dx)."""
    p = s.params[name]
    E = p["indices"].shape[0]
    x0 = s.state["x"]
    xbar = x0.clone()
    xbar[:, 1] -= 9.8 * DT * DT
    xbar += torch.as_tensor(0.002 * rng.standard_normal(x0.shape),
                            dtype=x0.dtype, device=x0.device)
    u = torch.zeros((9, E), dtype=x0.dtype, device=x0.device)
    return (xbar, p["indices"].to(torch.int32), u, p, unshared(xg),
            tet_dx(xg, p["coeff_p"]))


def nh_inputs(torch, s, name, xg, rng):
    """Both hyperelastic entries' inputs at a scene's elements: "mesh", the
    fused entry on the scene's own mesh (mesh_inputs: the main path's
    gather from L2); "unshared", on tet_inputs' gathered inputs as a mesh
    of unshared vertices; "step", the unfused entry on their Dx. Zero
    duals, warm start 1."""
    xbar, tets, u, p, free, dx = mesh_inputs(torch, s, name, xg, rng)
    warm = torch.ones_like(u[:3])
    consts = [p["coeff_p"], p["mu"], p["lam"], p["k"], p["w2"]]
    return {"mesh": [xbar, tets, u, warm, *consts],
            "unshared": [*free, u, warm, *consts],
            "step": [dx, u, warm, *consts[1:4]]}


def arap_inputs(torch, s, name, xg, rng):
    """Both ARAP entries' inputs at a scene's elements, as nh_inputs':
    "mesh", "unshared" (the fused entry) and "step" (the unfused one).
    Zero duals."""
    xbar, tets, u, p, free, dx = mesh_inputs(torch, s, name, xg, rng)
    consts = [p["coeff_p"], p["w2"], p["k"]]
    return {"mesh": [xbar, tets, u, *consts],
            "unshared": [*free, u, *consts], "step": [dx, u, *consts[1:]]}


def check_element(torch, label, kernel, twin, ins, dtype, tol, tol_on,
                  counts=None, gates=None, info=None, reps=10, batch=20,
                  plain_reps=2, **kw):
    """A kernel against its plain twin on the same inputs (the floating
    ones cast to dtype): every value within tol ('abs' or 'rel' to the
    largest twin value); finite; repeated bitwise; and every extra predicate of `gates` (name ->
    fn(got, want)) true. 'bitwise_vs_twin' says whether kernel and twin
    agree to the last bit. Times the kernel (reps samples of `batch`
    launches) and the twin, and bounds it by `counts(*ins, **kw)`
    (operations, bytes), by default its twin's. Returns (error, ms,
    plain_ms, bound_ms, bound_by)."""
    ins = [t.to(dtype) if t.is_floating_point() else t for t in ins]
    got = kernel(*ins, **kw)
    again = kernel(*ins, **kw)
    want = twin(*ins, **kw)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for g, w in zip(got, want):
        d, scale = float((g - w).abs().max()), float(w.abs().max())
        err = max(err, d)
        rel = max(rel, d / max(scale, 1e-300))
    fin = all(bool(torch.isfinite(g).all()) for g in got)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    gated = {k: bool(fn(got, want)) for k, fn in (gates or {}).items()}
    ok = (fin and repeat and all(gated.values())
          and (err if tol_on == "abs" else rel) <= tol)
    ms = cuda_ms(torch, lambda: kernel(*ins, **kw), reps, batch=batch)
    plain_ms = cuda_ms(torch, lambda: twin(*ins, **kw), plain_reps)
    if counts is None:
        n_ops, n_bytes = twin_counts(twin, *ins, **kw)
    else:
        n_ops, n_bytes = counts(*ins, **kw)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    if info is None:
        info = dict(E=ins[0].shape[1])
    say(f"kernel {label} {str(dtype)[6:]}", **info, max_abs_err=err,
        max_rel_err=rel, tol=tol, tol_on=tol_on, bitwise_vs_twin=bitwise,
        bitwise_repeat=repeat, finite=fin, **gated, ms=ms,
        plain_ms=plain_ms, operations=n_ops, bytes=n_bytes,
        bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"{label} disagrees with its twin in {dtype}"
                             + (f" at {info['case']}" if "case" in info
                                else ""))
    return err, ms, plain_ms, bound_ms, bound_by


def check_nh(torch, nh, dtype):
    """Both hyperelastic entries bitwise to their twins (nh_inputs): the
    fused one on the scene's mesh and on the unshared inputs, nh and stvk,
    with and without emit_z; the unfused one on Dx, nh and stvk. The nh
    cases on the mesh and Dx are also timed traced (the kernels' records
    under torch.profiler) and by events with the host's us a call. Returns
    the nh numbers (error, ms, plain_ms, bound_ms, bound_by) of the fused
    entry on the mesh and of the unfused entry."""
    got = {}
    for model in ("nh", "stvk"):
        for case in ("mesh", "unshared"):
            for emit_z in (False, True):
                label = f"nh_local {model} {case}" + (" emit_z" * emit_z)
                E = nh[case][1].shape[0]
                got[label] = check_element(
                    torch, label, pnh.nh_local_step_fused,
                    pnh.nh_local_step_fused_reference, nh[case], dtype, 0.0,
                    "abs", info=dict(E=E, n=nh[case][0].shape[0]), iters=5,
                    model=model, emit_z=emit_z)
        got[f"step {model}"] = check_element(
            torch, f"nh_local_step {model}", pnh.nh_local_step,
            pnh.nh_local_step_reference, nh["step"], dtype, 0.0, "abs",
            iters=5, model=model)
    element_times(torch, "nh_local mesh", pnh.nh_local_step_fused,
                  nh["mesh"], dtype, iters=5)
    element_times(torch, "nh_local mesh emit_z", pnh.nh_local_step_fused,
                  nh["mesh"], dtype, iters=5, emit_z=True)
    element_times(torch, "nh_local_step", pnh.nh_local_step, nh["step"],
                  dtype, iters=5)
    return got["nh_local nh mesh"], got["step nh"]


def element_times(torch, label, kernel, ins, dtype, **kw):
    """An element step's time a call on its inputs: traced (the kernel's
    records under torch.profiler, over 20 calls) and by CUDA events around
    20 calls with the host's us a call before the closing synchronize
    (the median of 5 windows): the host's work against the device's."""
    from admm_elastic_tpu_torch.utils.time_elements import traced
    from admm_elastic_tpu_torch.utils.time_solves import events_ms

    ins = [t.to(dtype) if t.is_floating_point() else t for t in ins]
    call = lambda: kernel(*ins, **kw)  # noqa: E731
    dev_ms, per = traced(torch, call)
    ev_ms, host_us = events_ms(torch, call, 20, 5)
    say(f"element time {label} {str(dtype)[6:]}", events_ms=ev_ms,
        host_us_per_call=host_us, traced_ms=dev_ms, traced_kernels=len(per))


def start_element_sass():
    """Start `utils/sass_counts.py` on this checkout's built library, in a
    process of its own beside the checks (it disassembles the whole
    library). Returns a function that waits for it and prints the
    hyperelastic and ARAP element kernels' registers, spills and static
    SASS size, one line each."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "admm_elastic_tpu_torch", "utils",
                                      "sass_counts.py"),
         "--root", HERE, "--label", "this", "--match", "nh::fused_kernel",
         "nh::step_kernel", "arap::fused_kernel", "arap::step_kernel"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)

    def finish():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"sass_counts failed:\n{out}{err}")
        for raw in out.splitlines():
            line = json.loads(raw)
            say("sass " + line["kernel"].split("(")[0],
                instructions=line["instructions"],
                float_ops=line["by_class"].get("float", 0),
                ptxas=(line["ptxas"] or "").replace(" ", ""))
    return finish


def check_arap(torch, arap, dtype):
    """Both ARAP entries bitwise to their twins (arap_inputs): the fused
    one on the scene's mesh and on the unshared inputs, with and without
    emit_z; the unfused one on Dx. The cases on the mesh and Dx are also
    timed traced and by events with the host's us a call. Returns the
    numbers (error, ms, plain_ms, bound_ms, bound_by) of the fused entry
    on the mesh and of the unfused entry."""
    got = {}
    for case in ("mesh", "unshared"):
        for emit_z in (False, True):
            label = f"arap_local_step_fused {case}" + (" emit_z" * emit_z)
            got[label] = check_element(
                torch, label, ptet.arap_local_step_fused,
                ptet.arap_local_step_fused_reference, arap[case], dtype, 0.0,
                "abs", info=dict(E=arap[case][1].shape[0],
                                 n=arap[case][0].shape[0]), emit_z=emit_z)
    step = check_element(torch, "arap_local_step", ptet.arap_local_step,
                         ptet.arap_local_step_reference, arap["step"], dtype,
                         0.0, "abs")
    element_times(torch, "arap_local_step_fused mesh",
                  ptet.arap_local_step_fused, arap["mesh"], dtype)
    element_times(torch, "arap_local_step_fused mesh emit_z",
                  ptet.arap_local_step_fused, arap["mesh"], dtype,
                  emit_z=True)
    element_times(torch, "arap_local_step", ptet.arap_local_step,
                  arap["step"], dtype)
    return got["arap_local_step_fused mesh"], step


def check_solve(torch, label, mod, args, tol, reps=20, plain_reps=5):
    """A cluster solve (mod: cg_dia or cg_ell) against its plain twin on
    the same inputs (args: the solve's, n_iters last): relative error
    within tol, a bitwise repeat, and one device operation a solve in a
    CUDA graph that captures it (`profile_step.call_ops`; the chain it
    replaced made 1 + 3 n_iters).
    Prints the cluster's layout and whether the twin's bits came back.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    kind = mod.__name__.rsplit(".", 1)[1]
    solve, twin = getattr(mod, f"{kind}_solve"), getattr(mod,
                                                        f"{kind}_solve_"
                                                        "reference")
    b, n_iters = args[0], args[-1]
    width = len(args[4]) if kind == "cg_dia" else 0
    reach = (max(abs(o) for o in args[4]) if kind == "cg_dia"
             else pell.bandwidth(args[3]))
    plan = pstep.cluster_plan(b.shape[0], b.dtype, reach, width)
    got = solve(*args)
    again = solve(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-300)
    bit = bool(torch.equal(got, again))
    ok = rel <= tol and bit and bool(torch.isfinite(got).all())
    ms = cuda_ms(torch, lambda: solve(*args), reps)
    plain_ms = cuda_ms(torch, lambda: twin(*args), plain_reps)
    counts = cg_dia_counts if kind == "cg_dia" else cg_ell_counts
    n_ops, n_bytes = counts(*args)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    graph = profile_step.call_ops(lambda: solve(*args))
    ops = graph["device_ops_per_call"]
    say(f"kernel {kind} {label} {str(b.dtype)[6:]}", n=b.shape[0],
        width=width or args[3].shape[1], n_iters=n_iters,
        reach=reach, cluster=plan["cluster"], threads=plan["threads"],
        layout="window" if plan["vectors_in_smem"] else "shared",
        slab_rows=plan["slab_rows"], window_rows=plan["window_rows"],
        smem_bytes_per_cta=plan["smem_bytes"],
        vectors_in_smem=plan["vectors_in_smem"],
        matrix_in_smem=plan["matrix_in_smem"], max_abs_err=err, rel_err=rel,
        tol=tol, bitwise_vs_twin=bool(torch.equal(got, want)),
        bitwise_repeat=bit, ms=ms, plain_ms=plain_ms, operations=n_ops,
        bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
        device_ops_per_solve=ops, device_op_kinds=graph["kinds"], ok=ok)
    if not ok or ops != 1.0:
        raise AssertionError(f"{kind} {label} disagrees in {b.dtype} at "
                             f"{n_iters} (device ops a solve: {ops})")
    return err, ms, plain_ms, bound_ms, bound_by


def mg_solve_numbers(torch, solve, twin, counts, args):
    """A multigrid solve (mg_dia_solve or uamg_ell_solve; args its own,
    n_iters last) against its twin on the same inputs: (dict of the
    bitwise checks, max_abs_err, ms, plain_ms, operations, bytes, bound
    ms, bound by, device operations a solve)."""
    got = solve(*args)
    again = solve(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    checks = {"bitwise_vs_twin": bool(torch.equal(got, want)),
              "bitwise_repeat": bool(torch.equal(got, again)),
              "finite": bool(torch.isfinite(got).all())}
    ms = cuda_ms(torch, lambda: solve(*args), 10)
    plain_ms = cuda_ms(torch, lambda: twin(*args), 2)
    n_ops, n_bytes = counts(*args)
    ops = profile_step.call_ops(lambda: solve(*args))["device_ops_per_call"]
    return (checks, float((got - want).abs().max()), ms, plain_ms, n_ops,
            n_bytes, *roofline_ms(n_bytes, n_ops), ops)


def _rest_rhs(st):
    """b of a stepper's first solve from rest as ADMM poses it: M x + M
    dt^2 g, g = -9.8 in y."""
    x0, m = st.state["x"], st.planes["mass"]
    b = m[:, None] * x0
    b[:, 1] -= m * 9.8 * DT * DT
    return b


def plan_numbers(plan):
    """What a multigrid solve's plan (`uamg.solve_plan`) keeps where: the
    shared memory a CTA, the parts resident in it, and the stage ends an
    iteration."""
    return {"smem_bytes_per_cta": plan["smem_bytes"],
            "resident": [k for k in ("matrix", "a2inv")
                         if plan[f"{k}_in_smem"]],
            "cluster_barriers_per_iteration":
                plan["cluster_barriers_per_iteration"],
            "mbarrier_waits_per_iteration":
                plan["mbarrier_waits_per_iteration"]}


def check_mg_solve(torch, label, st):
    """The multigrid mode of the cluster solve (mg_dia_solve) on a
    multigrid stepper's own matrix and planes at its budget, from its
    first solve from rest (warm start x): bitwise against its twin, a
    bitwise repeat, one device operation a solve. Returns (max_abs_err,
    ms, plain_ms, bound_ms, bound_by)."""
    cfg = st.cfg
    b = _rest_rhs(st)
    args = (b, st.state["x"], st.planes["dia"], cfg.dia_offs, st.planes,
            cfg.mg, cfg.cg_iters)
    checks, err, ms, plain_ms, n_ops, n_bytes, bound_ms, bound_by, ops = \
        mg_solve_numbers(torch, pmg.mg_dia_solve, pmg.mg_dia_solve_reference,
                         mg_dia_counts, args)
    plan = puamg.solve_plan(b.shape[0], len(cfg.dia_offs),
                            puamg.host_struct(st.planes, cfg.mg), b.dtype)
    ok = all(checks.values()) and ops == 1.0
    say(f"kernel mg_dia_solve {label} {str(b.dtype)[6:]}", n=b.shape[0],
        levels=st.mg_levels, diagonals=len(cfg.dia_offs),
        level1_diagonals=len(st.hierarchy["l1_offs"]),
        level1_ell_width=st.planes["ua_l1_idx"].shape[0],
        corners=(len(st.hierarchy["t0_offs"]),
                 len(st.hierarchy["t1_offs"])),
        largest_aggregates=(st.planes["ua_m1"].shape[0],
                            st.planes["ua_m2"].shape[0]),
        n_iters=cfg.cg_iters, **plan_numbers(plan), max_abs_err=err,
        tol="bitwise", **checks, ms=ms, plain_ms=plain_ms, operations=n_ops,
        bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
        device_ops_per_solve=ops, ok=ok)
    if not ok:
        raise AssertionError(f"mg_dia_solve {label} disagrees in {b.dtype}")
    return err, ms, plain_ms, bound_ms, bound_by


def check_uamg_solve(torch, label, st, n_iters):
    """The algebraic multigrid mode of the cluster solve (uamg_ell_solve)
    on a uAMG stepper's own ELL matrix and planes at n_iters, from its
    first solve from rest: as `check_mg_solve`."""
    cfg = st.cfg
    b = _rest_rhs(st)
    args = (b, st.state["x"], st.planes["ell_idx"], st.planes["ell_vals"],
            st.planes, cfg.mg, n_iters)
    checks, err, ms, plain_ms, n_ops, n_bytes, bound_ms, bound_by, ops = \
        mg_solve_numbers(torch, puamg.uamg_ell_solve,
                         puamg.uamg_ell_solve_reference, uamg_ell_counts,
                         args)
    n = cfg.mg.levels[0]
    plan = puamg.solve_plan(n, 0, puamg.host_struct(st.planes, cfg.mg),
                            b.dtype)
    ok = all(checks.values()) and ops == 1.0
    say(f"kernel uamg_ell_solve {label} {str(b.dtype)[6:]}", n=n,
        levels=cfg.mg.levels, ell_width=cfg.ell_width,
        level1_ell_width=st.planes["ua_l1_idx"].shape[0],
        largest_aggregates=(st.planes["ua_m1"].shape[0],
                            st.planes["ua_m2"].shape[0]),
        n_iters=n_iters, **plan_numbers(plan), max_abs_err=err, tol="bitwise", **checks, ms=ms, plain_ms=plain_ms,
        operations=n_ops, bytes=n_bytes, bound_ms=bound_ms,
        bound_by=bound_by, device_ops_per_solve=ops, ok=ok)
    if not ok:
        raise AssertionError(f"uamg_ell_solve {label} disagrees in "
                             f"{b.dtype} at {n_iters}")
    return err, ms, plain_ms, bound_ms, bound_by


def uamg_kernel_checks(torch):
    """Phase 3r. The algebraic multigrid mode (preconditioner="amg" under
    "ell"): the cluster solve's (uamg_ell_solve, csrc/mg_vcycle.cuh
    AggLevels) and the banded window's ELL mode on it against their twins,
    bitwise: the 10 x 7 x 6 Delaunay scene in f64 and f32 (the solve; 1
    ADMM iteration and a small window; the graphs against eager launches
    and the setters after capture), then delaunay100k's own A and planes
    in f32 (the solve at uamg6 and uamg8, its time and bound; one step of
    the window at uamg6, its times and bound a step; GRAPH_STEPS steps of
    its graph, each held to the twin). Returns the window's numbers at uamg6
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    for dtype in (torch.float64, torch.float32):
        st = small_uamg(8, dtype)._stepper
        check_uamg_solve(torch, "delaunay 10x7x6", st, 8)
        check_rollout_small(torch, "banded", st, dtype, 0.0,
                            name=" uamg delaunay 10x7x6")
        check_graph(torch, "banded", st,
                    f"uamg delaunay 10x7x6 {str(dtype)[6:]}")
    st = delaunay100k(UAMG_BUDGETS[0], amg=True)._stepper
    for cg in UAMG_BUDGETS:
        check_uamg_solve(torch, "delaunay100k", st, cg)
    window = check_rollout_full(torch, "banded", st,
                                f"delaunay100k uamg{UAMG_BUDGETS[0]}",
                                torch.float32, 0.0)
    check_steps(torch, "banded", st, f"delaunay100k uamg{UAMG_BUDGETS[0]}")
    return window


def last_primal(torch, s, steps=WINDOW_STEPS):
    """The last ADMM iteration's primal residual, median over one window
    of a banded-route System's stepper switched to collect it (its graphs
    captured anew), then switched back."""
    st = s._stepper
    st.collect_residuals = "primal"
    st.run(steps)
    torch.cuda.synchronize()
    st.collect_residuals = False
    return float(np.median(st.last_primal[:, -1]))


def uamg_routes(torch, steps):
    """Phase 5k. delaunay100k on the banded-ELL route with the in-kernel
    algebraic multigrid at each UAMG_BUDGETS (uamgN), f32, and on the
    general ell + xla route with the aggregation AMG at the first (amgN):
    ms/step (median of 3 x 10), submissions and launches; after `steps`
    steps each banded route against the banded-ELL Jacobi route at
    UAMG_DEEP_CG, beside the uamg6 route's divergence from a start moved
    by 1e-6 m, and the general route against the banded uamg6 route, each
    within UAMG_DX_LIMIT_M, which the Jacobi control must exceed; then
    the last ADMM iteration's primal residual of each banded route and of
    banded-ELL cg75 and cg1000 over one more window. Returns the banded
    routes' submissions."""
    routes = {("banded", cg): delaunay100k(cg, amg=True)
              for cg in UAMG_BUDGETS}
    routes[("general", UAMG_BUDGETS[0])] = delaunay100k(
        UAMG_BUDGETS[0], fast=False, amg=True)
    runs = {}
    for key, s in routes.items():
        reset_launches()
        n0 = pbs.banded_rollout.ops
        med, windows = drive(torch, s)
        runs[key] = (med, windows, {k.__name__: k.launches for k in KERNELS},
                     pbs.banded_rollout.ops - n0)
    first = routes[("banded", UAMG_BUDGETS[0])]
    p = delaunay100k(UAMG_BUDGETS[0], amg=True)
    p.x = p._x + 1e-6 * np.random.default_rng(1).standard_normal(p._x.shape)
    p.run(steps)
    sens = float(np.abs(p.x - first.x).max())
    del p
    deep = delaunay100k(UAMG_DEEP_CG, fast=True)
    deep.run(steps)
    jacobi = delaunay100k(UAMG_JACOBI_CG, fast=True)
    jacobi.run(steps)
    jacobi_vs_deep = float(np.abs(jacobi.x - deep.x).max())
    limit = UAMG_DX_LIMIT_M
    bad = []
    if not jacobi_vs_deep > limit:
        bad.append(f"control banded-ELL cg{UAMG_JACOBI_CG}: {jacobi_vs_deep} "
                   f"m from cg{UAMG_DEEP_CG}, within the limit {limit} m "
                   "it must exceed")
    for (route, cg), (med, windows, counts, n_ops) in runs.items():
        s = routes[(route, cg)]
        x = s.x
        anchored = np.flatnonzero(s._x[:, 0] < s._x[:, 0].min() + 0.025)
        drift = float(np.abs(x[anchored] - s._x[anchored]).max())
        sag = float((x[:, 1] - s._x[:, 1]).min())
        fin = bool(np.isfinite(x).all())
        want = {k.__name__: 0 for k in KERNELS}
        if route == "banded":
            want["banded_rollout"] = WARMUP_STEPS + WINDOWS
            dx_name, dx = f"banded-ELL cg{UAMG_DEEP_CG}", float(
                np.abs(x - deep.x).max())
            extra = dict(levels=s._stepper.mg_levels,
                         device_ops_per_step=n_ops / steps)
        else:
            want["nh_local_step_fused"] = steps * ADMM_ITERS
            dx_name, dx = f"banded uamg{UAMG_BUDGETS[0]}", float(
                np.abs(x - first.x).max())
            extra = dict(levels=[lv["agg"].shape[0] for lv in
                                 s.params["_solver"]["amg"][:-1]])
        name = f"{route} {'ua' if route == 'banded' else 'a'}mg{cg}"
        say(f"delaunay100k {name} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            launches_per_step={k: v / steps for k, v in counts.items() if v},
            **extra, anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_m=dx, vs=dx_name,
            jacobi_cg75_vs_deep_m=jacobi_vs_deep,
            uamg_perturbed_start_divergence_m=sens, limit_m=limit,
            finite=fin)
        if counts != want or (route == "banded" and n_ops != steps * (
                2 + 3 * ADMM_ITERS)):
            bad.append(f"{name}: launches {counts} ({n_ops} window "
                       f"launches), expected {want}")
        if not (fin and drift < 1e-3 and sag < 0 and dx <= limit):
            bad.append(f"{name}: bad trajectory ({dx} m from {dx_name}, "
                       f"limit {limit} m)")
    if bad:
        raise AssertionError("delaunay100k uamg: " + "; ".join(bad))
    residual = {f"uamg{cg}": last_primal(torch, routes[("banded", cg)])
                for cg in UAMG_BUDGETS}
    residual[f"jacobi_cg{UAMG_JACOBI_CG}"] = last_primal(torch, jacobi)
    residual[f"jacobi_cg{UAMG_DEEP_CG}"] = last_primal(torch, deep)
    if not all(np.isfinite(v) for v in residual.values()):
        raise AssertionError(f"delaunay100k uamg: residuals {residual}")
    say("delaunay100k uamg routes f32 (this call)",
        **{f"{route}_{'ua' if route == 'banded' else 'a'}mg{cg}_ms_per_step":
           run[0] for (route, cg), run in runs.items()},
        **{f"last_primal_residual_{k}": v for k, v in residual.items()})
    out = trace(UAMG_BUDGETS[0], "fast", first, scene="delaunay100k")
    check_window_ops(out, f"delaunay100k banded-ELL uamg{UAMG_BUDGETS[0]}")
    trace(UAMG_BUDGETS[0], "general", routes[("general", UAMG_BUDGETS[0])],
          scene="delaunay100k")
    return sum(run[2]["banded_rollout"] for (route, _), run in runs.items()
               if route == "banded")


def sweep_scenarios_bitwise(torch, sw, steps):
    """A sweep window from its stepper's state against a single-scenario
    window of each scenario fed that scenario's planes and state: the
    scenarios that disagree (none: bitwise)."""
    got = pbs.banded_rollout(sw.state, sw.planes, sw.cfg, steps)
    bad = []
    for s in range(sw.n_scen):
        one = sw.scenario(s)
        single = pbs.banded_rollout(one.state, one.planes, one.cfg, steps)
        if not all(torch.equal(single[k], got[k][s]) for k in pbs.STATE):
            bad.append(s)
    return bad


def sweep_kernel_checks(torch):
    """Phase 3s. The banded window's sweep mode on small sweeps of 4
    jittered beams (SMALL_SWEEPS: dia and ELL, nh and arap, one sweeping
    the anchor weights over a floor), f64 and f32: a SMALL_STEPS-step
    window bitwise to its twin and repeated bitwise, each scenario bitwise
    to a single-scenario window fed its planes; then GRAPH_STEPS graph
    steps of the ELL sweep in f32 each held to the twin, and the residual
    modes of the sweep (dia f64, ELL f32) against the twin and as graph
    replays."""
    for dtype in (torch.float64, torch.float32):
        for label, kw in SMALL_SWEEPS:
            sw = scenes.jittered_sweep(4, dtype=dtype, **SMALL_DEPTH, **kw)
            ex, rel, ev, bit, fin, twin, _ = rollout_errors(
                torch, "banded", sw, sw.cfg, SMALL_STEPS)
            bad = sweep_scenarios_bitwise(torch, sw, SMALL_STEPS)
            ok = bit and fin and twin and not bad
            say(f"kernel sweep {label} {str(dtype)[6:]} small "
                f"{SMALL_STEPS}-step window",
                scenarios=sw.n_scen, n=sw.n_nodes, elements=sw.n_elements,
                max_abs_err_x=ex, max_abs_err_v=ev, tol="bitwise",
                bitwise_vs_twin=twin, bitwise_repeat=bit, finite=fin,
                scenarios_bitwise_vs_single_window=not bad,
                scenarios_that_disagree=bad, ok=ok)
            if not ok:
                raise AssertionError(f"sweep {label} disagrees in {dtype}")
    sw = scenes.jittered_sweep(4, solver="ell", dtype=torch.float32,
                               anchor_sweep=True, floor=True, **SMALL_DEPTH)
    check_steps(torch, "banded", sw, "sweep ell f32 4 scenarios")
    check_residual_window(torch, "banded", sw, "sweep ell 4 scenarios",
                          torch.float32)
    sw = scenes.jittered_sweep(4, solver="dia", anchor_sweep=True,
                               floor=True, **SMALL_DEPTH)
    check_residual_window(torch, "banded", sw, "sweep dia 4 scenarios",
                          torch.float64)


def check_sweep_full(torch, sw, label):
    """One full-width step of a sweep from its stepper's state at
    SWEEP_CHECK_ADMM ADMM iterations, kernel vs twin (bitwise; the twin,
    whose dots are host-bound, runs once and is timed there), the
    kernel's time per 1-step and per 10-step launch and the bound of that
    step (`sweep_counts`); then the kernel's times at the full depth."""
    cfg = dataclasses.replace(sw.cfg, admm_iters=SWEEP_CHECK_ADMM)
    got = pbs.banded_rollout(sw.state, sw.planes, cfg, 1)
    again = pbs.banded_rollout(sw.state, sw.planes, cfg, 1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = pbs.banded_rollout_reference(sw.state, sw.planes, cfg, 1)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    keys = pbs.STATE
    ex = float((got["x"] - want["x"]).abs().max())
    ev = float((got["v"] - want["v"]).abs().max())
    bit = all(torch.equal(got[k], again[k]) for k in keys)
    fin = all(bool(torch.isfinite(got[k]).all()) for k in keys)
    twin = all(torch.equal(got[k], want[k]) for k in keys)

    def launch_ms(c):
        return (cuda_ms(torch, lambda: pbs.banded_rollout(
                    sw.state, sw.planes, c, 1), 5),
                cuda_ms(torch, lambda: pbs.banded_rollout(
                    sw.state, sw.planes, c, 10), 3))

    ms, window_ms = launch_ms(cfg)
    full_ms, full_window_ms = launch_ms(sw.cfg)
    n_ops, n_bytes = sweep_counts(sw.state, sw.planes, cfg, 1)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    ok = bit and fin and twin
    say(f"kernel sweep f32 {label}", scenarios=sw.n_scen, n=sw.n_nodes,
        elements=sw.n_elements, matrix=sw.cfg.matrix,
        admm_iters=SWEEP_CHECK_ADMM, max_abs_err_x=ex, max_abs_err_v=ev,
        tol="bitwise", bitwise_vs_twin=twin, bitwise_repeat=bit,
        finite=fin, ms_per_1step_launch=ms, ms_per_10step_launch=window_ms,
        plain_ms_per_step=plain_ms, operations=n_ops, bytes=n_bytes,
        bound_ms=bound_ms, bound_by=bound_by,
        full_depth_ms_per_1step_launch=full_ms,
        full_depth_ms_per_10step_launch=full_window_ms, ok=ok)
    if not ok:
        raise AssertionError(f"sweep disagrees at {label}")
    return ex, ms, plain_ms, bound_ms, bound_by


def sweep_clusters(torch, sw):
    """The clusters of a sweep's solve the card holds at once."""
    if sw.cfg.matrix == "ell":
        return pstep.active_clusters(sw.n_nodes, sw.dtype,
                                     pell.bandwidth(sw.planes["ell_idx"]), 0,
                                     ell=True)
    offs = sw.cfg.dia_offs
    return pstep.active_clusters(sw.n_nodes, sw.dtype,
                                 max(abs(o) for o in offs), len(offs))


def sweep_routes(torch, steps):
    """Phase 5l. bench.py --preset sweep64 at full width, f32, on ELL (the
    preset's solver) and on dia: the sweep's ms/step (median of 3 x 10
    after 2 single steps) and per scenario-step, its submissions and
    window launches, beside the single-scenario route of scenario 0 (its
    own planes) and that times 64; the clusters of its solve the card
    holds at once and the waves S of them make; after `steps` steps
    scenarios 0, 31 and 63 against their own single-scenario routes
    (bitwise: |dx| 0); device ops a step and the idle share. ELL is first
    held to its twin at full width (one step of SWEEP_CHECK_ADMM ADMM
    iterations, `check_sweep_full`). Then
    the ELL sweep at SWEEP_WIDE scenarios, timed the same way. Returns
    (the sweep routes' submissions, the ELL check's numbers)."""
    bad, submissions, full = [], 0, None
    for solver in ("ell", "dia"):
        sw = scenes.sweep64(SWEEP_SCENARIOS, solver)
        singles = {s: sw.scenario(s) for s in SWEEP_WITNESSES}
        if solver == "ell":
            full = check_sweep_full(torch, sw, f"sweep64 {solver} cg12")
        clusters = sweep_clusters(torch, sw)
        reset_launches()
        n0 = pbs.banded_rollout.ops
        med, windows = drive(torch, sw)
        n_sub = pbs.banded_rollout.launches
        n_ops = pbs.banded_rollout.ops - n0
        submissions += n_sub
        med1, windows1 = drive(torch, singles[0])
        for s in SWEEP_WITNESSES[1:]:
            singles[s].run(steps)
        x = sw.x
        dx = {s: float(np.abs(x[s] - one.x).max())
              for s, one in singles.items()}
        fin = bool(np.isfinite(x).all())
        sag = float((x[:, :, 1] - sw.base.state["x"][:, 1].cpu().numpy()
                     ).min())
        say(f"sweep64 {solver} f32", scenarios=sw.n_scen, n=sw.n_nodes,
            elements=sw.n_elements, ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows),
            ms_per_scenario_step=med / sw.n_scen,
            single_route_ms_per_step=med1,
            single_windows_ms=[round(w, 4) for w in windows1],
            single_times_scenarios_ms=med1 * sw.n_scen,
            submissions=n_sub, expected_submissions=WARMUP_STEPS + WINDOWS,
            device_ops_per_step=n_ops / steps,
            clusters_resident=clusters,
            solve_waves=-(-sw.n_scen // clusters), steps=steps,
            **{f"max_abs_dx_scenario_{s}_vs_single_m": d
               for s, d in dx.items()}, min_dy_m=sag, finite=fin)
        if n_sub != WARMUP_STEPS + WINDOWS or n_ops != steps * (
                2 + 3 * ADMM_ITERS):
            bad.append(f"{solver}: {n_sub} submissions, {n_ops} launches")
        if not (fin and sag < 0 and not any(dx.values())):
            bad.append(f"{solver}: bad trajectory ({dx}, min dy {sag})")
        check_window_ops(trace(12, "fast", sw, scene="sweep64"),
                         f"sweep64 {solver}")
        del sw, singles
    sw = scenes.sweep64(SWEEP_WIDE, "ell")
    reset_launches()
    med, windows = drive(torch, sw)
    clusters = sweep_clusters(torch, sw)
    fin = bool(np.isfinite(sw.x).all())
    submissions += pbs.banded_rollout.launches
    say(f"sweep{SWEEP_WIDE} ell f32", scenarios=sw.n_scen,
        ms_per_step_median=med, windows_ms=[round(w, 4) for w in windows],
        spread_ms=max(windows) - min(windows),
        ms_per_scenario_step=med / sw.n_scen, clusters_resident=clusters,
        solve_waves=-(-sw.n_scen // clusters), finite=fin)
    if not fin:
        bad.append(f"sweep{SWEEP_WIDE}: not finite")
    if bad:
        raise AssertionError("sweep64: " + "; ".join(bad))
    return submissions, full


def default_backend_routes(torch):
    """Phase 5m. The JAX package's default element backend (backend='xla':
    `ops/svd.py`, `ops/newton.py` in plain PyTorch, no kernel of its own)
    at full width, f32: tet100k (HyperElasticTet, 5 Newton iterations),
    arap100k (LinearTetStrain) and cloth100k (LimitedTriangleStrain),
    default-constructed, on the general dia route at cg25 (its solve is
    cg_dia_solve): ms/step, and device ops a step and idle share by
    profile_step; |dx| after the steps against the same scene built with
    backend='pallas' (other SVD and Newton code, so printed, not bounded),
    beside the xla route's own |dx| from a start moved by 1e-6 m. The
    same three with lattice_fast_path=True take the banded, banded arap
    and cloth windows, x bitwise the pallas-constructed Systems'. Then the
    two golden scenes in f64 against tests/golden/*.npz. Returns the
    general routes' numbers by scene."""
    builds = {"tet100k": tet100k, "arap100k": arap100k,
              "cloth100k": cloth100k}
    tri = (ptri.tri_local_step_fused, ptri.tri_local_step)
    elements = (pnh.nh_local_step_fused, pnh.nh_local_step,
                ptet.arap_local_step_fused, ptet.arap_local_step, *tri)
    numbers = {}
    for name, build in builds.items():
        s = build(XLA_CG, torch.float32, fast=False, backend="xla")
        if s._stepper is not None or s._solver_mode != "dia" or any(
                getattr(f, "backend", "xla") != "xla" for f in s.forces):
            raise AssertionError(f"{name} xla: not the general dia route")
        s.step()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        s.run(XLA_STEPS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / XLA_STEPS
        n_cg = pcg.cg_dia_solve.launches
        off_path(*elements, pbs.banded_rollout, pcs.cloth_rollout,
                 plat.lattice_rollout)
        on_card = all(t.is_cuda for t in (s.state["x"], s.state["v"],
                                          *s.state["u"].values()))
        x = s.x
        prof = trace(XLA_CG, "general", s, steps=XLA_PROFILE_STEPS,
                     scene=name)
        del s
        p = build(XLA_CG, torch.float32, fast=False, backend="pallas")
        p.run(1 + XLA_STEPS)
        vs_pallas = float(np.abs(p.x - x).max())
        del p
        q = build(XLA_CG, torch.float32, fast=False, backend="xla")
        q.x = q._x + 1e-6 * np.random.default_rng(1).standard_normal(
            q._x.shape)
        q.run(1 + XLA_STEPS)
        own = float(np.abs(q.x - x).max())
        del q
        fin = bool(np.isfinite(x).all())
        numbers[name] = (ms, prof["device_ops_per_step"], prof["idle_share"])
        say(f"{name} xla general cg{XLA_CG} f32", ms_per_step=ms,
            steps=1 + XLA_STEPS, cg_dia_launches=n_cg,
            expected_cg_dia_launches=XLA_STEPS * ADMM_ITERS,
            device_ops_per_step=prof["device_ops_per_step"],
            idle_share=prof["idle_share"],
            max_abs_dx_vs_pallas_m=vs_pallas,
            perturbed_start_divergence_m=own, state_on_card=on_card,
            finite=fin)
        if not (fin and np.isfinite(vs_pallas) and np.isfinite(own)
                and on_card and n_cg == XLA_STEPS * ADMM_ITERS):
            raise AssertionError(f"{name} xla: non-finite values, a tensor "
                                 f"off the card or {n_cg} cg_dia launches")

    routes = {"tet100k": (BandedStepper, "nh", pbs.banded_rollout),
              "arap100k": (BandedStepper, "arap", pbs.banded_rollout),
              "cloth100k": (ClothStepper, "cloth", pcs.cloth_rollout)}
    for name, build in builds.items():
        kind, model, kernel = routes[name]
        runs = []
        for backend in ("xla", "pallas"):
            s = build(XLA_CG, torch.float32, fast=True, backend=backend)
            if not (isinstance(s._stepper, kind)
                    and s._stepper.model == model):
                raise AssertionError(f"{name} {backend} fast: route "
                                     f"{type(s._stepper).__name__}")
            reset_launches()
            s.run(XLA_FAST_STEPS)
            runs.append((s.x, kernel.launches))
            del s
        same = bool(np.array_equal(runs[0][0], runs[1][0]))
        say(f"{name} xla fast cg{XLA_CG} f32", route=kind.__name__,
            model=model, window_launches=runs[0][1],
            bitwise_vs_pallas=same, finite=bool(np.isfinite(runs[0][0]).all()))
        if not (same and runs[0][1] > 0):
            raise AssertionError(f"{name} xla fast: x differs from the "
                                 "pallas-constructed System's")

    for name in ("cloth", "tetdrop"):
        s = getattr(scenes, f"golden_{name}")("cuda")
        s.run(scenes.GOLDEN_STEPS[name])
        want = np.load(os.path.join(HERE, "tests", "golden",
                                    f"{name}.npz"))["x"]
        d = float(np.abs(s.x - want).max())
        rel = d / float(np.abs(want).max())
        say(f"golden {name} f64", mode=s._solver_mode, max_abs_diff_m=d,
            max_rel_diff=rel, limit=GOLDEN_REL_LIMIT)
        if not rel <= GOLDEN_REL_LIMIT:
            raise AssertionError(f"golden {name}: {rel} from the file")
    return numbers



def runtime_edits(torch):
    """Phase 5n. Runtime force edits and checkpoints at tet100k, f32, cg25,
    through the System's API as poordillo uses it.
    (a) The general dia route with a 'pallas' tet and a MovingAnchor on the
    7 nodes at the far top corner (`scenes.tet100k_grab`): EDIT_STEPS steps
    dragging it along smooth_move, the release (weight 0, active False,
    recompute_weights), EDIT_STEPS steps: ms/step before and after, the
    host ms of the release, the grab's distance from its control point and
    its travel after the release; nh_local_step_fused and cg_dia_solve
    launched every ADMM iteration. Its checkpoint: saved after the release,
    EDIT_CKPT_STEPS steps on, and a fresh System given the same edits and
    the file takes them bitwise.
    (b, c) The banded dia window: EDIT_WINDOW_STEPS steps, a checkpoint,
    as many again; a fresh System loads the file and its steps are
    bitwise. Then every other x = 0 anchor released on the first
    (set_force_param, recompute_weights: the host ms of the rebuild), one
    step timed with the windows' recapture, EDIT_TIMED_STEPS steps timed,
    GRAPH_STEPS graph steps each held bitwise to the twin on the new
    planes; the second, edited without recompute_weights, takes as many
    steps: x differs and the lowest y is higher.
    (d) The sharded stepper (cheb180) built on the first System before the
    release: refresh_params after it (the host ms, with its Lanczos
    bounds), EDIT_SHARDED_STEPS steps bitwise a sharded stepper built from
    the released System given the same state. Returns the phase's
    seconds."""
    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(HERE, "build", "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    # (a) poordillo on the general route
    s = scenes.tet100k_grab(EDIT_CG, torch.float32)
    grab = s.forces[2]
    if s._stepper is not None or s._solver_mode != "dia" or (
            type(grab).__name__ != "MovingAnchor"):
        raise AssertionError("tet100k grab: not the general dia route")
    start = s._x[grab.indices]
    end = start + np.asarray(EDIT_DRAG_M)
    n_grab = grab.n_elements
    reset_launches()
    drag_ms = []
    for k in range(EDIT_STEPS):
        target = smooth_move((k + 1) * DT, 0.0, EDIT_STEPS * DT, start, end)
        s.set_force_state(grab, "pos", target)
        drag_ms.append(timed_ms(torch, s.step)[1])
    held = float(np.linalg.norm(s.x[grab.indices] - target, axis=1).max())
    at_release = s.x[grab.indices]

    def release():
        s.set_force_param(grab, "weight", np.zeros(n_grab))
        s.set_force_state(grab, "active", np.zeros(n_grab, bool))
        s.recompute_weights()

    release_ms = timed_ms(torch, release)[1]
    after_ms = [timed_ms(torch, s.step)[1] for _ in range(EDIT_STEPS)]
    travel = float(np.linalg.norm(s.x[grab.indices] - at_release,
                                  axis=1).max())
    n_nh, n_cg = pnh.nh_local_step_fused.launches, pcg.cg_dia_solve.launches
    off_path(pbs.banded_rollout, pcs.cloth_rollout, plat.lattice_rollout)
    want = 2 * EDIT_STEPS * ADMM_ITERS
    fin = bool(np.isfinite(s.x).all())
    say("edits tet100k general dia cg25 grab f32", grabbed=n_grab,
        drag_m=list(EDIT_DRAG_M),
        ms_per_step_drag_median=statistics.median(drag_ms[1:]),
        ms_per_step_after_median=statistics.median(after_ms[1:]),
        first_step_ms=drag_ms[0], first_step_after_release_ms=after_ms[0],
        release_host_ms=release_ms, grab_from_target_m=held,
        limit_m=EDIT_HELD_LIMIT_M, tip_travel_after_release_m=travel,
        nh_local_step_fused_launches=n_nh, cg_dia_solve_launches=n_cg,
        expected_launches=want, finite=fin)
    if not (fin and held <= EDIT_HELD_LIMIT_M and travel > 1e-3
            and n_nh == n_cg == want):
        raise AssertionError("tet100k grab: the grab, its release or the "
                             "launches went wrong")
    path = os.path.join(ckpt_dir, "general.npz")
    s.save_checkpoint(path)
    for _ in range(EDIT_CKPT_STEPS):
        s.step()
    q = scenes.tet100k_grab(EDIT_CG, torch.float32)
    qgrab = q.forces[2]
    q.set_force_param(qgrab, "weight", np.zeros(n_grab))
    q.recompute_weights()
    q.load_checkpoint(path)
    for _ in range(EDIT_CKPT_STEPS):
        q.step()
    general_resume = bool(np.array_equal(s.x, q.x)) and all(
        torch.equal(s.state["u"][k], q.state["u"][k]) for k in s.state["u"])
    del s, q

    # (b, c) the banded window: a checkpoint, then a release
    b1 = tet100k(EDIT_CG, torch.float32, fast=True)
    b2 = tet100k(EDIT_CG, torch.float32, fast=True)
    if not all(isinstance(b._stepper, BandedStepper) for b in (b1, b2)):
        raise AssertionError("tet100k fast: not the banded window")
    path = os.path.join(ckpt_dir, "banded.npz")
    b1.run(EDIT_WINDOW_STEPS)
    b1.save_checkpoint(path)
    b1.run(EDIT_WINDOW_STEPS)
    buffers = dict(b2._stepper.state)
    b2.load_checkpoint(path)
    in_place = all(b2._stepper.state[k] is t for k, t in buffers.items())
    b2.run(EDIT_WINDOW_STEPS)
    banded_resume = in_place and all(
        torch.equal(t, b2._stepper.state[k])
        for k, t in b1._stepper.state.items())
    say("edits checkpoints f32", general_grab_steps=EDIT_CKPT_STEPS,
        general_resume_bitwise=general_resume,
        banded_steps=EDIT_WINDOW_STEPS, banded_resume_bitwise=banded_resume,
        banded_load_into_own_buffers=in_place)
    if not (general_resume and banded_resume):
        raise AssertionError("a checkpoint did not resume bitwise")

    # (d), built before the release
    sp, _ = sharded_banded_from_system(b1, solver="cheb", cheb_iters=180)
    sp.run(2)
    bounds = sp.cheb_bounds

    anchor = b1.forces[0]
    w = np.array(anchor.weight)
    w[::2] = 0.0
    old = b1._stepper

    def rebuild():
        b1.set_force_param(anchor, "weight", w)
        b1.recompute_weights()

    rebuild_ms = timed_ms(torch, rebuild)[1]
    b2.set_force_param(b2.forces[0], "weight", w)
    if b1._stepper is old or not all(
            b1._stepper.state[k] is t for k, t in old.state.items()):
        raise AssertionError("the release did not rebuild the stepper on "
                             "its state")
    del old
    reset_launches()
    first_ms = timed_ms(torch, b1.step)[1]
    timed = [timed_ms(torch, b1.step)[1] for _ in range(EDIT_TIMED_STEPS)]
    check_steps(torch, "banded", b1._stepper, "tet100k after a release")
    n_windows = pbs.banded_rollout.launches
    b2.run(1 + EDIT_TIMED_STEPS + GRAPH_STEPS)
    dx = float(np.abs(b1.x - b2.x).max())
    low = (float(b1.x[:, 1].min()), float(b2.x[:, 1].min()))
    say("edits tet100k banded release f32", released=int((w == 0).sum()),
        of=len(w), rebuild_host_ms=rebuild_ms,
        first_step_with_recapture_ms=first_ms,
        ms_per_step_median=statistics.median(timed),
        recapture_ms=first_ms - statistics.median(timed),
        graph_steps_checked=GRAPH_STEPS, banded_rollout_launches=n_windows,
        max_abs_dx_vs_not_recomputed_m=dx, min_y_m=low[0],
        min_y_not_recomputed_m=low[1])
    if not (n_windows == 1 + EDIT_TIMED_STEPS + GRAPH_STEPS and dx > 1e-5
            and low[0] < low[1]):
        raise AssertionError("the banded release did not take effect")
    del b2

    # (d) the sharded stepper after refresh_params
    refresh_ms = timed_ms(torch, sp.refresh_params)[1]
    state = {k: t.clone() for k, t in sp.state.items()}
    reset_launches()
    sp.run(EDIT_SHARDED_STEPS)
    n_local = pbl.banded_local_rhs.launches
    n_cheb = pchb.cheb_dia_chunk.launches
    ref, _ = sharded_banded_from_system(b1, solver="cheb", cheb_iters=180)
    ref.state = state
    ref.run(EDIT_SHARDED_STEPS)
    same = all(torch.equal(sp.state[k], ref.state[k]) for k in state)
    want = EDIT_SHARDED_STEPS * ADMM_ITERS
    say("edits tet100k sharded cheb180 refresh_params f32",
        refresh_host_ms=refresh_ms, bounds_before=list(bounds),
        bounds_after=list(sp.cheb_bounds), steps=EDIT_SHARDED_STEPS,
        bitwise_vs_built_from_released=same,
        banded_local_rhs_launches=n_local, cheb_dia_chunk_launches=n_cheb,
        expected_launches=want)
    if not (same and n_local == n_cheb == want
            and tuple(sp.cheb_bounds) != tuple(bounds)):
        raise AssertionError("sharded refresh_params: not the stepper built "
                             "from the released System")
    del sp, ref, b1
    seconds = time.perf_counter() - t_phase
    say("edits phase 5n", seconds=seconds)
    return seconds


def cluster_floor(torch):
    """The per-iteration floor of the cluster solve: a 16-row system (one
    row a CTA), 1,000 iterations less 0, in us, in the layout the solves
    run when their windows fit in shared memory (st.async pushes counted
    on mbarriers). An iteration is two stages; a stage holds, besides its
    end, one or two CTA barriers, a warp-tree sum and a few loads."""
    p = banded_spd(16, dtype=torch.float32, device="cuda")
    args = (p["b"], p["x0"], p["diag"], p["dia_vals"], p["offsets"])
    ms = [cuda_ms(torch, lambda: pcg.cg_dia_solve(*args, k), 10)
          for k in (1000, 0)]
    say("cluster floor n=16 f32", ms_1000_iterations=ms[0],
        ms_0_iterations=ms[1], us_per_iteration=ms[0] - ms[1],
        us_per_stage=(ms[0] - ms[1]) / 2)
    return ms[0] - ms[1]


# the rounds of the synchronisation microbenchmark
# (admm_elastic_tpu_torch/csrc/probes/sync_probe.cu)
SYNC_PROBES = ("cluster barrier", "CTA barrier", "st.async exchange",
               "stage end, mbarrier", "stage end, cluster barrier")


def start_probe_build():
    """Start nvcc on the synchronisation microbenchmark, a library of its
    own beside the kernels' (it is not part of the port). Returns a
    function that waits for it and loads it with ctypes."""
    import ctypes

    src = os.path.join(_build.CSRC, "probes", "sync_probe.cu")
    out_dir = _build.BUILD_ROOT.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libsync_probe.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), "-o", str(lib), src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}{err}")
        dll = ctypes.CDLL(str(lib))
        i, p = ctypes.c_int, ctypes.c_void_p
        for name, args in (("cluster_sync_probe", [i, i, p, p]),
                           ("grid_sync_probe", [i, i, i, p, p]),
                           ("grid_probe_occupancy", [i]),
                           ("coop_cluster_probe", [i, i, p, p])):
            getattr(dll, name).restype = i
            getattr(dll, name).argtypes = args
        return dll
    return finish


def sync_costs(torch, probe, rounds=10000):
    """The cluster solve's synchronisation alone (probe: the loaded
    microbenchmark): us a round of each mode on 16 CTAs, (N rounds - 0) /
    N by CUDA events. Returns {mode name: us}."""
    out = {}
    buf = torch.empty(16, dtype=torch.float32, device="cuda")

    def run(mode, k):
        _build.check(probe.cluster_sync_probe(
            mode, k, buf.data_ptr(), _build.stream_ptr(buf)),
            "cluster_sync_probe")
    for mode, name in enumerate(SYNC_PROBES):
        ms = [cuda_ms(torch, lambda: run(mode, k), 5) for k in (rounds, 0)]
        out[name] = 1e3 * (ms[0] - ms[1]) / rounds
        say(f"cluster sync, {name}", cluster=16, rounds=rounds,
            us_per_round=out[name])
    return out


# the grid of the cooperative rollout kernel that banded_step.cu and
# lattice_step.cu ran before their windows were split at the solve:
# rollout_kernel<float, 0, false> held this many 128-thread blocks an SM
# (660 on the H100's 132 SMs, by the parent's banded_rollout_grid_f32)
ROLLOUT_BLOCKS_PER_SM = 5
GRID_PROBES = ("grid barrier", "grid stage end")


def grid_costs(torch, probe, rounds=2000):
    """What a cooperative kernel's CG paid for a stage, alone (probe: the
    loaded microbenchmark): us a round of grid.sync() and of a whole stage
    end (block sums, partials, grid.sync(), every block re-reading them)
    on the grid of the rollout kernels the windows replaced, (N - 0
    rounds) / N by CUDA events. Then whether the card takes a launch that
    is both cooperative and clustered. Returns {(grid, mode): us}."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {"rollout": sms * ROLLOUT_BLOCKS_PER_SM}
    out = {}
    for grid, blocks in grids.items():
        part = torch.empty(2 * blocks, dtype=torch.float32, device="cuda")

        def run(mode, k):
            _build.check(probe.grid_sync_probe(
                mode, k, blocks, part.data_ptr(), _build.stream_ptr(part)),
                "grid_sync_probe")
        for mode, name in enumerate(GRID_PROBES):
            ms = [cuda_ms(torch, lambda: run(mode, k), 5)
                  for k in (rounds, 0)]
            out[(grid, name)] = 1e3 * (ms[0] - ms[1]) / rounds
            say(f"grid sync, {name}", grid=grid, blocks=blocks,
                blocks_per_sm=blocks / sms,
                probe_blocks_per_sm=probe.grid_probe_occupancy(mode),
                rounds=rounds, us_per_round=out[(grid, name)])
    buf = torch.empty(128, dtype=torch.float32, device="cuda")
    for cluster in (16, 8):
        err = probe.coop_cluster_probe(128, cluster, buf.data_ptr(),
                                       _build.stream_ptr(buf))
        msg = _build.load_library().admm_cuda_error_string(err).decode()
        say("cooperative launch with a cluster dimension", blocks=128,
            threads=128, cluster=cluster, cuda_error=err,
            accepted=err == 0, message=msg.replace(" ", "_"))
    return out


def check_cg_update(torch, prob, dtype, wide=100003):
    """One cg_update (the first iteration of the solve) and a 25-iteration
    pcg_solve_fixed_fused chain against their plain versions (the twin sums
    in the kernel's order, so they should agree bitwise): relative error
    within 1e-12 (f64) or 1e-4 (f32), bitwise repeat; bitwise also with
    each output written over its own input, and on random vectors of
    `wide` rows (a CTA's threads hold 6 or 7 rows, the first in
    registers); one device op a call (the nodes of a captured call). Times
    it by events (host work included, `cuda_ms`) and as 20 calls in one
    CUDA graph (the device's time)."""
    b, x0, diag, idx, vals = prob

    def A(y):
        return ell_apply(y, idx, vals)

    inv = 1.0 / diag
    r = b - A(x0)
    p = inv[:, None] * r
    ins = (x0, r, p, pstep.cluster_dot(r, p), A(p), inv)
    got = pstep.cg_update(*ins)
    again = pstep.cg_update(*ins)
    want = pstep.cg_update_reference(*ins)
    over = tuple(t.clone() for t in ins)
    pstep.cg_update(*over, out=(over[0], over[1], over[2], over[3]))
    in_place = all(torch.equal(g, w) for g, w in zip(over[:3], want[:3])) \
        and torch.equal(over[3].reshape(()), want[3])
    rng = np.random.default_rng(7)
    wins = [torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                            device=b.device)
            for shape in ((wide, 3),) * 3 + ((),) + ((wide, 3),)]
    wins[3] = wins[3].abs()
    wins.append(torch.as_tensor(rng.uniform(0.5, 2.0, wide), dtype=dtype,
                                device=b.device))
    wide_bit = all(torch.equal(g, w) for g, w in zip(
        pstep.cg_update(*wins), pstep.cg_update_reference(*wins)))
    ops = profile_step.call_ops(lambda: pstep.cg_update(*ins))
    chain = pstep.pcg_solve_fixed_fused(A, b, x0, diag, 25)
    chain_want, r, p, rz = x0, *ins[1:4]
    for _ in range(25):
        chain_want, r, p, rz = pstep.cg_update_reference(chain_want, r, p,
                                                         rz, A(p), inv)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    chain_rel = float((chain - chain_want).abs().max()
                      / chain_want.abs().max())
    twin_bit = (all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.equal(chain, chain_want))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    bit = all(torch.equal(g, a) for g, a in zip(got, again))
    fin = all(bool(torch.isfinite(g).all()) for g in (*got, chain))
    one_op = ops["device_ops_per_call"] == 1.0 and ops["kinds"] == ["kernel"]
    ok = (rel <= tol and chain_rel <= tol and bit and fin and in_place
          and wide_bit and one_op)
    ms = cuda_ms(torch, lambda: pstep.cg_update(*ins), 10, batch=20)
    device_ms = graph_ms(torch, lambda: pstep.cg_update(*ins), 20, 3)
    plain_ms = cuda_ms(torch, lambda: pstep.cg_update_reference(*ins), 10,
                       batch=20)
    n_ops, n_bytes = cg_update_counts(*ins)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    say(f"kernel cg_update {str(dtype)[6:]}", n=b.shape[0], max_abs_err=err,
        rel_err=rel, chain25_rel_err=chain_rel, tol=tol,
        bitwise_vs_twin=twin_bit, bitwise_repeat=bit,
        bitwise_over_its_inputs=in_place, wide_n=wide,
        wide_bitwise_vs_twin=wide_bit, finite=fin,
        device_ops_per_call=ops["device_ops_per_call"], op_kinds=ops["kinds"],
        ms=ms, device_ms_graph=device_ms, plain_ms=plain_ms,
        operations=n_ops, bytes=n_bytes, bound_ms=bound_ms,
        bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"cg_update disagrees in {dtype}")
    return err, ms, plain_ms, bound_ms, bound_by


# the whole-timestep kernels: wrapper, plain twin, state keys
ROLLOUTS = {
    "banded": (pbs.banded_rollout, pbs.banded_rollout_reference, pbs.STATE),
    "cloth": (pcs.cloth_rollout, pcs.cloth_rollout_reference, pcs.STATE),
    "lattice": (plat.lattice_rollout, plat.lattice_rollout_reference,
                plat.STATE),
}


# the windows whose twins sum in their kernels' order (the cluster solve's,
# cg_step.cluster_dot): held to them bitwise
BITWISE = ("banded", "lattice", "cloth")


def rollout_errors(torch, kind, st, cfg, steps, planes=None):
    """Kernel and twin from the same state; (x abs err, x rel err, v abs
    err, bitwise repeat, finite, bitwise against the twin, the twin's ms a
    step)."""
    run, reference, keys = ROLLOUTS[kind]
    planes = st.planes if planes is None else planes
    got = run(st.state, planes, cfg, steps)
    again = run(st.state, planes, cfg, steps)
    want, plain_ms = timed_ms(torch, lambda: reference(st.state, planes, cfg,
                                                       steps))
    ex = float((got["x"] - want["x"]).abs().max())
    ev = float((got["v"] - want["v"]).abs().max())
    rel = ex / float(want["x"].abs().max())
    bit = all(torch.equal(got[k], again[k]) for k in keys)
    fin = all(bool(torch.isfinite(got[k]).all()) for k in keys)
    twin = all(torch.equal(got[k], want[k]) for k in keys)
    return ex, rel, ev, bit, fin, twin, plain_ms / steps


def check_rollout_small(torch, kind, st, dtype, tol_1it, tol_f32=1e-4,
                        name="", planes=None):
    """1 step of 1 ADMM iteration, then a window of SMALL_STEPS steps of
    SMALL_ADMM ADMM iterations (the card tests, tests/test_torch_cuda.py,
    hold 10-step windows): x within tol_1it and 1e-8 (f64) or tol_f32
    relative (f32); the windows of BITWISE bitwise (the tolerance is then
    moot)."""
    f64 = dtype == torch.float64
    ok = True
    for tag, cfg, steps, tol in (
            ("1 iteration", dataclasses.replace(st.cfg, admm_iters=1), 1,
             tol_1it if f64 else 1e-4),
            (f"{SMALL_STEPS}-step window",
             dataclasses.replace(st.cfg, admm_iters=SMALL_ADMM), SMALL_STEPS,
             1e-8 if f64 else tol_f32)):
        ex, rel, ev, bit, fin, twin, _ = rollout_errors(torch, kind, st, cfg,
                                                        steps, planes)
        err = ex if f64 else rel
        exact = kind in BITWISE
        good = bit and fin and (twin if exact else err <= tol)
        say(f"kernel {kind}{name} {str(dtype)[6:]} small {tag}", n=st.n_nodes,
            elements=st.n_elements, max_abs_err_x=ex, rel_err_x=rel,
            max_abs_err_v=ev, tol="bitwise" if exact else tol,
            tol_on="abs x" if f64 else "rel x",
            bitwise_vs_twin=twin, bitwise_repeat=bit, finite=fin, ok=good)
        ok = ok and good
    if not ok:
        raise AssertionError(f"{kind}{name} rollout disagrees in {dtype} "
                             "(small)")


def check_graph(torch, kind, st, label):
    """A stepper's windows as CUDA graph replays (a step, then a 10-step
    run: one submission each) against the same windows launched eagerly
    from the same state, and again after positions and velocities are set
    once the graphs are captured: bitwise."""
    run, _, keys = ROLLOUTS[kind]
    start = {k: st.state[k].clone() for k in keys}
    n0 = run.launches
    st.step()
    st.run(10)
    submissions = run.launches - n0
    want = run(run(start, st.planes, st.cfg, 1), st.planes, st.cfg, 10)
    replay = all(torch.equal(st.state[k], want[k]) for k in keys)
    x = st.x + 1e-3 * np.random.default_rng(2).standard_normal(st.x.shape)
    st.set_positions(x)
    st.set_velocities(np.zeros_like(x))
    start = {k: st.state[k].clone() for k in keys}
    st.run(10)
    want = run(start, st.planes, st.cfg, 10)
    setters = (bool(np.array_equal(start["x"].cpu().numpy(),
                                   x.astype(start["x"].cpu().numpy().dtype)))
               and all(torch.equal(st.state[k], want[k]) for k in keys))
    ok = replay and setters and submissions == 2
    say(f"graph {kind} {label}", submissions_for_2_windows=submissions,
        replay_bitwise_vs_eager=replay, setters_after_capture=setters,
        ok=ok)
    if not ok:
        raise AssertionError(f"{kind} {label}: graph replay or setters")


def check_steps(torch, kind, st, label, steps=GRAPH_STEPS):
    """A stepper's windows as graph replays, one step at a time, each held
    bitwise to the twin run from the same state: a fault that shows only
    now and then (a race) shows here as a step that disagrees."""
    run, reference, keys = ROLLOUTS[kind]
    bad = []
    for step in range(1, steps + 1):
        start = {k: st.state[k].clone() for k in keys}
        st.step()
        want = reference(start, st.planes, st.cfg, 1)
        if not all(torch.equal(st.state[k], want[k]) for k in keys):
            bad.append(step)
            for k in keys:  # go on from the twin's state
                st.state[k].copy_(want[k])
    say(f"steps {kind} {label}", steps=steps, bitwise_vs_twin_each_step=not
        bad, steps_that_disagree=bad, ok=not bad)
    if bad:
        raise AssertionError(f"{kind} {label}: steps {bad} disagree with the "
                             "twin")


def rollout_times(torch, kind, st):
    """A whole-timestep kernel's time per 1-step and per 10-step launch
    from a stepper's state, and the bound of one step: (ms, window ms,
    operations, bytes, bound ms, bound by)."""
    run, reference, keys = ROLLOUTS[kind]
    ms = cuda_ms(torch, lambda: run(st.state, st.planes, st.cfg, 1), 5)
    window_ms = cuda_ms(torch, lambda: run(st.state, st.planes, st.cfg, 10),
                        3)
    n_ops, n_bytes = rollout_counts(reference, keys, st.state, st.planes,
                                    st.cfg, 1)
    return (ms, window_ms, n_ops, n_bytes, *roofline_ms(n_bytes, n_ops))


def f64_depth(st, label):
    """A stepper at F64_FULL_ADMM ADMM iterations for an f64 full-width
    check, and the check's label."""
    return (_with_cfg(st, admm_iters=F64_FULL_ADMM),
            f"{label} {F64_FULL_ADMM} ADMM iterations")


def check_rollout_full(torch, kind, st, label, dtype, tol):
    """One full-width step, kernel vs twin (x within tol: abs in f64,
    relative in f32); the kernel's time per 1-step and per 10-step
    launch, the twin's (that step's), and the bound of one step."""
    ex, rel, ev, bit, fin, twin, plain_ms = rollout_errors(torch, kind, st,
                                                           st.cfg, 1)
    err = ex if dtype == torch.float64 else rel
    exact = kind in BITWISE
    ok = bit and fin and (twin if exact else err <= tol)
    ms, window_ms, n_ops, n_bytes, bound_ms, bound_by = rollout_times(
        torch, kind, st)
    say(f"kernel {kind} {str(dtype)[6:]} {label}", n=st.n_nodes,
        elements=st.n_elements, matrix=getattr(st.cfg, "matrix", "dia"),
        diagonals=len(st.cfg.dia_offs),
        ell_width=getattr(st.cfg, "ell_width", 0),
        max_abs_err_x=ex, rel_err_x=rel, max_abs_err_v=ev,
        tol="bitwise" if exact else tol, bitwise_vs_twin=twin,
        bitwise_repeat=bit, finite=fin, ms_per_1step_launch=ms, ms_per_10step_launch=window_ms,
        ms_per_step_in_window=window_ms / 10,
        plain_ms_per_step=plain_ms, operations=n_ops, bytes=n_bytes,
        bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"{kind} rollout disagrees at {label}, {dtype}")
    return ex, ms, plain_ms, bound_ms, bound_by


def local_inputs(torch, st, rng, jitter):
    """Inputs of one banded_local_rhs call on a BandedStepper: x = the
    first ADMM iteration's x_bar (rest positions after the gravity kick)
    moved by jitter N(0,1) per axis, random duals (au 0.01 N(0,1) on every
    vertex, so a released anchor's must come back exactly 0; cu 0.01
    N(0,1); u 0.01 N(0,1)) and warm = 1."""
    x0 = st.state["x"]

    def noise(shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=x0.dtype, device=x0.device)

    x = x0 + noise(x0.shape, jitter)
    x[:, 1] -= 9.8 * DT * DT
    E = st.n_elements
    return [x, noise(x0.shape, 0.01), noise(x0.shape, 0.01),
            noise((9, E), 0.01), torch.ones((3, E), dtype=x0.dtype,
                                            device=x0.device)]


def check_local(torch, label, ins, planes, cfg, dtype, released=None):
    """banded_local_rhs against its plain twin (`check_element`): every
    output within 1e-12 (f64) or 1e-4 (f32) relative to its largest twin
    value (a last-bit difference may move a Newton tie in f32); a released
    anchor's dual exactly 0 in both."""
    gates = {} if released is None else {
        "released_anchor_dual_zero": lambda got, want: (
            float(got[1][released].abs().max()) == 0.0
            and float(want[1][released].abs().max()) == 0.0)}
    return check_element(
        torch, "banded_local_rhs", pbl.banded_local_rhs,
        pbl.banded_local_rhs_reference, ins, dtype,
        1e-12 if dtype == torch.float64 else 1e-4, "rel",
        counts=banded_local_counts, gates=gates,
        info=dict(case=label, n=ins[0].shape[0], E=ins[3].shape[1],
                  model=cfg.model, shapes=len(cfg.coll_shapes)),
        planes=planes, cfg=cfg)


def check_cheb(torch, label, args, kw, dtype):
    """cheb_dia_chunk against its plain twin (`check_element`): x, z, d
    bitwise (the kernel repeats the twin's arithmetic in its order, in
    either layout of its cluster); timed one launch per event pair."""
    plan = pchb.cheb_plan(args[0].shape[0], dtype, kw["offsets"])
    return check_element(
        torch, "cheb_dia_chunk", pchb.cheb_dia_chunk,
        pchb.cheb_dia_chunk_reference, args, dtype, 0.0, "abs",
        counts=cheb_dia_counts,
        info=dict(case=label, n=args[0].shape[0],
                  diagonals=len(kw["offsets"]), n_it=kw["n_it"],
                  first=kw["first"], last=kw["last"],
                  layout="window" if plan["vectors_in_smem"] else "shared",
                  slab_rows=plan["slab_rows"],
                  window_rows=plan["window_rows"],
                  matrix_in_smem=plan["matrix_in_smem"],
                  smem_bytes_per_cta=plan["smem_bytes"]),
        batch=1, plain_reps=3, **kw)


def cheb_problem(torch, st, rng, budget=180):
    """tet100k's A_hat (a BandedStepper's dia planes) and a global solve
    as the first ADMM iteration poses it from rest: b = A x_rest + M dt^2
    g, x = x_rest; z and d N(0,1) for chunks that are not the first; the
    Chebyshev schedule of `budget` iterations from the operator's bounds.
    Returns (args without c1/c2, (inv_theta, c1, c2), bounds)."""
    dia, offs = st.planes["dia"], st.cfg.dia_offs
    x = st.state["x"]
    b = dia_apply(x, offs, dia)
    b[:, 1] -= st.planes["mass"] * 9.8 * DT * DT
    z, d = (torch.as_tensor(rng.standard_normal(x.shape), dtype=x.dtype,
                            device=x.device) for _ in range(2))
    bounds = dia_operator_bounds(dia.double().cpu().numpy(), offs)
    inv_theta, c1, c2 = cheb_coefficients(budget, *bounds)
    c1, c2 = (torch.as_tensor(c, dtype=x.dtype, device=x.device)
              for c in (c1, c2))
    return (b, x, z, d, st.planes["invd"], dia), (inv_theta, c1, c2), bounds


def wide_cheb_problem(torch, dtype, n=20000, budget=40):
    """A chunk whose band reaches past its windows (the SHARED layout):
    `banded_spd` of n rows on offsets (1, 3, 7, 9000), its whole solve of
    `budget` iterations from the operator's bounds. Returns (args, kw)."""
    sp = banded_spd(n, offsets=(1, 3, 7, 9000), dtype=dtype, device="cuda")
    offs = sp["offsets"]
    inv_theta, c1, c2 = cheb_coefficients(budget, *dia_operator_bounds(
        sp["dia_vals"].double().cpu().numpy(), offs))
    c1, c2 = (torch.as_tensor(c, dtype=dtype, device="cuda")
              for c in (c1, c2))
    z, d = (torch.zeros_like(sp["b"]) for _ in range(2))
    args = (sp["b"], sp["x0"], z, d, 1.0 / sp["diag"], sp["dia_vals"], c1,
            c2)
    return args, dict(offsets=offs, n_it=budget - 1, first=True, last=True,
                      inv_theta=inv_theta)


def tri_inputs(torch, s, rng):
    """The cloth100k sheet's triangle-step inputs with every vertex moved
    by 0.2 grid spacings N(0,1) per axis (at rest F^T F is isotropic, a
    single branch of the SVD) and a random dual 0.05 N(0,1); 64 triangles
    collapse to a point and 64 to a line, with a zero dual (F = 0, rank
    1)."""
    p = s.params["c0_LimitedTriangleStrain"]
    E = p["indices"].shape[0]
    x = s.state["x"]
    x = x + torch.as_tensor(0.2 * (2.0 / 225) * rng.standard_normal(x.shape),
                            dtype=x.dtype, device=x.device)
    xg = x[p["indices"]].reshape(E, 9).T.contiguous()
    perm = torch.as_tensor(rng.permutation(E), device=xg.device)
    point, line = perm[:64], perm[64:128]
    xg[:, point] = xg[0:3, point].repeat(3, 1)
    xg[6:9, line] = 2.0 * xg[3:6, line] - xg[0:3, line]
    u = torch.as_tensor(0.05 * rng.standard_normal((6, E)), dtype=x.dtype,
                        device=x.device)
    u[:, perm[:128]] = 0.0
    return [xg, u, p["coeff_p"], p["w2"], p["k"], p["limit_min"],
            p["limit_max"]]


def check_tri(torch, ins, dtype):
    """Both triangle entries: 1e-12 absolute (f64) or 1e-5 relative
    (f32)."""
    xg, u, cp, w2, k, lmin, lmax = ins
    E = xg.shape[1]
    dx = torch.einsum("bke,kae->abe", cp.reshape(2, 3, E),
                      xg.reshape(3, 3, E)).reshape(6, E).contiguous()
    tol = (1e-12, "abs") if dtype == torch.float64 else (1e-5, "rel")
    fused = check_element(torch, "tri_local", ptri.tri_local_step_fused,
                          ptri.tri_local_step_fused_reference, ins, dtype,
                          *tol)
    step = check_element(torch, "tri_local_step", ptri.tri_local_step,
                         ptri.tri_local_step_reference,
                         [dx, u, w2, k, lmin, lmax], dtype, *tol)
    element_times(torch, "tri_local", ptri.tri_local_step_fused, ins, dtype)
    element_times(torch, "tri_local_step", ptri.tri_local_step,
                  [dx, u, w2, k, lmin, lmax], dtype)
    return fused, step


def cloth_trajectory(s):
    """(finite, anchor drift m, lowest dy m) of a cloth System."""
    x = s.x
    anchored = np.concatenate([f.indices for f in s.forces
                               if isinstance(f, StaticAnchor)])
    drift = float(np.abs(x[anchored] - s._x[anchored]).max())
    sag = float((x[:, 1] - s._x[:, 1]).min())
    return bool(np.isfinite(x).all()), drift, sag


def beam_trajectory(s):
    """(finite, anchor drift m, lowest dy m) of a beam System anchored at
    x = 0."""
    x = s.x
    anchored = np.flatnonzero(s._x[:, 0] < 1e-9)
    drift = float(np.abs(x[anchored] - s._x[anchored]).max())
    sag = float((x[:, 1] - s._x[:, 1]).min())
    return bool(np.isfinite(x).all()), drift, sag


def small_lattice(model, dtype, floor=False):
    """An 8 x 6 x 5 beam (cell 0.25 m, 2 kg) anchored at x = 0 on the
    lattice kernel: NeoHookean (mu 1e4, lam 2.5e4), StVK (mu 100, lam 400)
    or ARAP (stiffness 1e4), 4 Newton iterations, 10 ADMM iterations, cg25;
    with floor=True a Floor at y = 0.02 m, above its lowest layer."""
    n = 9 * 7 * 6
    mu, lam = {"nh": (1e4, 2.5e4), "stvk": (100.0, 400.0),
               "arap": (1e4, 1e4)}[model]
    return LatticeStepper(8, 6, 5, 0.25, np.full(n, 2.0 / n), mu, lam,
                          np.arange(7 * 6), admm_iters=ADMM_ITERS,
                          newton_iters=4, cg_iters=25, dtype=dtype,
                          model=model, floor_y=0.02 if floor else None,
                          device="cuda")


def window_layout(torch, st, label, window=True):
    """Raise unless a stepper's solve takes the cluster solve's WINDOW
    layout (its vectors in shared memory) on this card, or with
    window=False the SHARED one."""
    offs = st.cfg.dia_offs
    plan = pstep.cluster_plan(st.n_nodes, st.state["x"].dtype,
                              max(abs(o) for o in offs), len(offs))
    say(f"solve layout {label}", n=st.n_nodes, reach=max(abs(o) for o in offs),
        window=plan["vectors_in_smem"], matrix_in_smem=plan["matrix_in_smem"],
        smem_bytes=plan["smem_bytes"])
    if plan["vectors_in_smem"] != window:
        raise AssertionError(f"{label}: the solve takes the "
                             f"{'SHARED' if window else 'WINDOW'} layout")


def window_device_ops(torch, st, label, want):
    """The device operations of a 1-step cloth window on a copy of a
    stepper's state (the nodes of a CUDA graph that captures its launches,
    `profile_step.call_ops`): `want`, every one a kernel, none a grid
    barrier (no kernel of the window is cooperative)."""
    state = {k: st.state[k].clone() for k in pcs.STATE}
    window = pcs.ClothWindow(state, st.planes, st.cfg)
    graph = profile_step.call_ops(lambda: window.launch(1))
    got = graph["device_ops_per_call"]
    say(f"device ops cloth {label}", device_ops_per_step=got, expected=want,
        kinds=graph["kinds"], grid_stages_per_step=0)
    if got != want or graph["kinds"] != ["kernel"]:
        raise AssertionError(f"cloth {label}: {got} device ops a step "
                             f"({graph['kinds']}), expected {want}")


def check_window_ops(out, label, per_step=2 + 3 * ADMM_ITERS):
    """A whole-timestep window's trace (profile_step's dict): per_step
    kernels a step, none a grid barrier (by default 2 + 3 admm_iters: a
    kick, then per ADMM iteration an element kernel, a vertex kernel and
    one cluster solve, then the end; the cloth adds its wind kernel), and
    the clock's one add a window."""
    want = per_step + 1 / WINDOW_STEPS
    got = out["device_ops_per_step"]
    say(f"device ops {label}", device_ops_per_step=got, expected=want,
        lost_kernel_records=out["lost_kernel_records"])
    if got is not None and out["lost_kernel_records"] == 0 and abs(
            got - want) > 1e-9:
        raise AssertionError(f"{label}: {got} device ops a step, expected "
                             f"{want}")


class _with_cfg:
    """A stepper's state and planes under another config (a mode the
    stepper was not built with), for the window checks."""

    def __init__(self, st, **cfg):
        self.state, self.planes = st.state, st.planes
        self.cfg = dataclasses.replace(st.cfg, **cfg)
        self.n_nodes, self.n_elements = st.n_nodes, st.n_elements


def off_path(*kernels):
    """Raise if any of these kernels launched since the last reset."""
    bad = [k.__name__ for k in kernels if k.launches]
    if bad:
        raise AssertionError(f"a route launched kernels of another: {bad}")

RESIDUAL_MODES = ("primal", "full")


def check_emit_z(torch, label, kernel, twin, ins, dtype, **kw):
    """A fused element kernel's emit_z mode on the same inputs (cast to
    dtype): every output, the z block included, bitwise to the twin's;
    every other output bitwise to the launch without emit_z; finite. Times
    both launches and bounds the emit_z one by its twin's counts. Returns
    (error, ms, plain_ms, bound_ms, bound_by)."""
    ins = [t.to(dtype) if t.is_floating_point() else t for t in ins]
    got = kernel(*ins, emit_z=True, **kw)
    base = kernel(*ins, **kw)
    want = twin(*ins, emit_z=True, **kw)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    twin_ok = all(torch.equal(g, w) for g, w in zip(got, want))
    # (nh_local_step_fused's rows are 6 wide with emit_z, 3 without)
    same = all(torch.equal(g[..., :b.shape[-1]], b)
               for g, b in zip(got, base))
    fin = all(bool(torch.isfinite(g).all()) for g in got)
    ms = cuda_ms(torch, lambda: kernel(*ins, emit_z=True, **kw), 10,
                 batch=20)
    ms_off = cuda_ms(torch, lambda: kernel(*ins, **kw), 10, batch=20)
    plain_ms = cuda_ms(torch, lambda: twin(*ins, emit_z=True, **kw), 3)
    n_ops, n_bytes = twin_counts(twin, *ins, emit_z=True, **kw)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    ok = twin_ok and same and fin
    say(f"emit_z {label} {str(dtype)[6:]}", E=got[0].shape[-1],
        max_abs_err=err, bitwise_vs_twin=twin_ok,
        other_outputs_bitwise_vs_off=same, finite=fin, ms=ms,
        ms_without_emit_z=ms_off, plain_ms=plain_ms, operations=n_ops,
        bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"emit_z {label} disagrees in {dtype}")
    return err, ms, plain_ms, bound_ms, bound_by


def residual_errors(torch, kind, st, collect, steps):
    """A window in a residual mode from a stepper's state, kernel against
    twin: (residuals and state bitwise to the twin, the state bitwise to
    the same window with collection off, max |residual error|, finite,
    the kernel's result, the twin's ms a step)."""
    run, reference, keys = ROLLOUTS[kind]
    cfg = dataclasses.replace(st.cfg, collect=collect)
    got = run(st.state, st.planes, cfg, steps)
    off = run(st.state, st.planes, dataclasses.replace(st.cfg, collect=None),
              steps)
    want, plain_ms = timed_ms(torch, lambda: reference(st.state, st.planes,
                                                       cfg, steps))
    res = ["primal"] + (["dual"] if collect == "full" else [])
    twin = all(torch.equal(got[k], want[k]) for k in (*keys, *res))
    same = all(torch.equal(got[k], off[k]) for k in keys)
    err = max(float((got[k] - want[k]).abs().max()) for k in res)
    fin = all(bool(torch.isfinite(got[k]).all()) for k in res)
    return twin, same, err, fin, got, plain_ms / steps


def check_residual_window(torch, kind, st, label, dtype):
    """A window's residual modes on a small scene: 1 step of 1 ADMM
    iteration and a window of SMALL_STEPS steps of SMALL_ADMM iterations
    in "primal" and "full", residuals and state bitwise to the twin and
    the state bitwise to the window with collection off; then the
    stepper's graphs in each mode (a step and a 10-step run) against the
    eager windows from the same state, residuals included.
    (tests/test_torch_cuda.py holds 10-step windows.)"""
    for collect in RESIDUAL_MODES:
        for tag, sub, steps in (
                ("1 iteration", _with_cfg(st, admm_iters=1), 1),
                (f"{SMALL_STEPS}-step window",
                 _with_cfg(st, admm_iters=SMALL_ADMM), SMALL_STEPS)):
            twin, same, err, fin, _, _ = residual_errors(torch, kind, sub,
                                                         collect, steps)
            ok = twin and same and fin
            say(f"residuals {kind} {label} {str(dtype)[6:]} {collect} {tag}",
                n=st.n_nodes, bitwise_vs_twin=twin,
                state_bitwise_vs_off=same, max_abs_err=err, finite=fin,
                ok=ok)
            if not ok:
                raise AssertionError(f"{kind} {label} {collect} residuals "
                                     f"disagree ({tag}, {dtype})")
        run, _, keys = ROLLOUTS[kind]
        st.collect_residuals = True if collect == "full" else "primal"
        start = {k: st.state[k].clone() for k in keys}
        st.step()
        one = (st.last_primal, st.last_dual)
        st.run(10)
        ten = (st.last_primal, st.last_dual)
        cfg = st.cfg
        w1 = run(start, st.planes, cfg, 1)
        w10 = run({k: w1[k] for k in keys}, st.planes, cfg, 10)
        replay = (all(torch.equal(st.state[k], w10[k]) for k in keys)
                  and _same_residuals(one, w1) and _same_residuals(ten, w10))
        st.collect_residuals = False
        say(f"graph residuals {kind} {label} {str(dtype)[6:]} {collect}",
            replay_bitwise_vs_eager=replay, ok=replay)
        if not replay:
            raise AssertionError(f"{kind} {label} {collect}: graph replay")


def _same_residuals(host, out):
    """A stepper's host copies (last_primal, last_dual) against a window's
    result: bitwise."""
    p, d = host
    ok = np.array_equal(p, out["primal"].cpu().numpy())
    if "dual" in out:
        ok = ok and np.array_equal(d, out["dual"].cpu().numpy())
    return ok and (d is None) == ("dual" not in out)


def check_residual_full(torch, kind, st, label):
    """One full-width f32 step in each residual mode, kernel against twin:
    bitwise (residuals and state), the state bitwise to the step with
    collection off; the kernel's times a 1-step and a 10-step window, the
    twin's (that step's) and the bound of one step in the "full" mode.
    Returns the kernels-line numbers of the "full" mode (error, ms,
    plain_ms, bound_ms, bound_by)."""
    for collect in RESIDUAL_MODES:
        twin, same, err, fin, _, plain_ms = residual_errors(torch, kind, st,
                                                            collect, 1)
        ok = twin and same and fin
        sub = _with_cfg(st, collect=collect)
        ms, window_ms, n_ops, n_bytes, bound_ms, bound_by = rollout_times(
            torch, kind, sub)
        say(f"residuals {kind} f32 {label} {collect}", n=st.n_nodes,
            bitwise_vs_twin=twin, state_bitwise_vs_off=same,
            max_abs_err=err, finite=fin, ms_per_1step_launch=ms,
            ms_per_10step_launch=window_ms,
            ms_per_step_in_window=window_ms / 10,
            plain_ms_per_step=plain_ms, operations=n_ops, bytes=n_bytes,
            bound_ms=bound_ms, bound_by=bound_by, ok=ok)
        if not ok:
            raise AssertionError(f"{kind} {label} {collect} residuals "
                                 "disagree at full width")
    return err, ms, plain_ms, bound_ms, bound_by


def check_local_collect(torch, label, ins, planes, cfg, dtype):
    """banded_local_rhs with collect against its twin: every output and r2
    bitwise; the five outputs bitwise to the call without collect. Returns
    (error, ms, plain_ms, bound_ms, bound_by)."""
    x, au, cu, u, warm = (t.to(dtype) for t in ins)
    args = (x, au, cu, u, warm, planes, cfg)
    got = pbl.banded_local_rhs(*args, collect=True)
    off = pbl.banded_local_rhs(*args)
    want = pbl.banded_local_rhs_reference(*args, collect=True)
    torch.cuda.synchronize()
    twin = all(torch.equal(g, w) for g, w in zip(got, want))
    same = all(torch.equal(g, o) for g, o in zip(got, off))
    err = float((got[-1] - want[-1]).abs())
    ok = twin and same and bool(torch.isfinite(got[-1]))
    ms = cuda_ms(torch, lambda: pbl.banded_local_rhs(*args, collect=True),
                 10, batch=10)
    plain_ms = cuda_ms(torch, lambda: pbl.banded_local_rhs_reference(
        *args, collect=True), 3)
    n_ops, n_bytes = banded_local_counts(*args, collect=True)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    say(f"local collect {label} {str(dtype)[6:]}", r2=float(got[-1]),
        bitwise_vs_twin=twin, outputs_bitwise_vs_off=same, ms=ms,
        plain_ms=plain_ms, operations=n_ops, bytes=n_bytes,
        bound_ms=bound_ms, bound_by=bound_by, ok=ok)
    if not ok:
        raise AssertionError(f"banded_local_rhs collect disagrees at {label}")
    return err, ms, plain_ms, bound_ms, bound_by


# phase 5j: the routes collecting residuals at full width, f32: label,
# System maker, the residual-mode kernel the route launches and how often
# a step. Each runs with collection off, "primal" and True (the sharded
# stepper "primal" only, its limit)
RESIDUAL_ROUTES = (
    ("tet100k banded cg25", lambda: tet100k(25, torch.float32, fast=True),
     "banded", 1),
    ("tet100k banded cg75", lambda: tet100k(75, torch.float32, fast=True),
     "banded", 1),
    ("tet100k banded mg6", lambda: tet100k(6, torch.float32, amg=True),
     "banded", 1),
    ("tet100k banded mg8", lambda: tet100k(8, torch.float32, amg=True),
     "banded", 1),
    ("tet100k general dia cg25", lambda: tet100k(25, torch.float32), "nh",
     ADMM_ITERS),
    ("arap100k general dia cg25", lambda: arap100k(25, torch.float32),
     "arap", ADMM_ITERS),
    ("cloth100k general dia cg25",
     lambda: cloth100k(25, torch.float32, fast=False), "tri", ADMM_ITERS),
    ("cloth100k cloth cg25", lambda: cloth100k(25, torch.float32), "cloth",
     1),
    ("cloth100k cloth cg300", lambda: cloth100k(300, torch.float32),
     "cloth", 1),
    ("cloth100k cloth mg8", lambda: cloth100k(8, torch.float32, amg=True),
     "cloth", 1),
    ("delaunay100k banded-ELL cg25",
     lambda: delaunay100k(25, torch.float32), "banded", 1),
    ("delaunay100k banded-ELL cg75",
     lambda: delaunay100k(75, torch.float32), "banded", 1),
    ("tet100k sharded cg75", lambda: tet100k_sharded("cg", 75), "local",
     ADMM_ITERS),
)
RESIDUAL_STEPS = 32


def step_residuals(s):
    """One step of a route; (primal, dual or None) of its ADMM iterations,
    host arrays."""
    s.step()
    if isinstance(s, ShardedBandedStepper):
        return s.last_primal, None
    aux = {k: np.asarray(torch.as_tensor(v).cpu())
           for k, v in s.last_aux.items()}
    return aux["primal_residual"], aux.get("dual_residual")


def route_ops(s, mode, counters):
    """Device operations a step: a window's launches (its wrapper's .ops
    over the steps counted by `counters`), the general route's by the
    nodes of a CUDA graph capturing one step; None for the sharded
    stepper, whose collecting step reads its residuals back to the host."""
    if isinstance(s, ShardedBandedStepper):
        return None
    if s._stepper is not None:
        return counters
    state = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in s.state.items()}
    return profile_step.call_ops(
        lambda: s._step(state, s.params))["device_ops_per_call"]


def element_pipeline_ops(s):
    """The general route's element pipeline on tet100k: one device op an
    ADMM iteration, the kernel (it gathers x and writes the RHS rows in the
    gather's layout itself; before, a gather, its transposing copy and the
    rows' copy came with it), and the route's device ops a step (CUDA
    graphs: `profile_step.call_ops`)."""
    f = next(f for f in s.forces if type(f).__name__ == "HyperElasticTet")
    p, st = s.params[f.name], s.state
    ops = profile_step.call_ops(lambda: f.fused_local_rhs(
        p, st["x"], st["u"][f.name], st["forces"][f.name]))
    step_ops = route_ops(s, None, None)
    one = ops["device_ops_per_call"] == 1.0 and ops["kinds"] == ["kernel"]
    say("tet100k general element pipeline",
        device_ops_per_call=ops["device_ops_per_call"], kinds=ops["kinds"],
        device_ops_per_admm_iteration_expected=1,
        route_device_ops_per_step=step_ops, ok=one)
    if not one:
        raise AssertionError("the element pipeline is not one kernel a call")


def residual_readings(rp, rd):
    """Medians over the steps of the first and last ADMM iteration's
    residuals."""
    med = {"primal_first": float(np.median(rp[:, 0])),
           "primal_last": float(np.median(rp[:, -1]))}
    if rd is not None:
        med.update(dual_first=float(np.median(rd[:, 0])),
                   dual_last=float(np.median(rd[:, -1])))
    return med


def residual_routes(torch):
    """Phase 5j. For every route of RESIDUAL_ROUTES, from its start: 32
    single steps collecting both residuals (the sharded stepper the
    primal), the medians of the first and last ADMM iteration's; then
    ms/step (drive: median of 3 windows of 10) and device ops a step with
    collection off, "primal" and True. Also the general dia route's
    residuals at cg25 against the banded route's, beside the banded
    route's own spread from a start moved by 1e-6 m. Returns (the launches
    of each residual mode's kernels in the collecting runs, the readings)."""
    launches = dict.fromkeys(("banded", "cloth", "nh", "arap", "tri",
                              "local"), 0)
    readings = {}
    for label, make, kernel, per_step in RESIDUAL_ROUTES:
        s = make()
        sharded = isinstance(s, ShardedBandedStepper)
        modes = (False, "primal") if sharded else (False, "primal", True)
        profile_step.set_collect(s, "primal" if sharded else True)
        reset_launches()
        res = [step_residuals(s) for _ in range(RESIDUAL_STEPS)]
        rp = np.stack([r[0] for r in res])
        rd = None if sharded else np.stack([r[1] for r in res])
        counts = {"banded": pbs.banded_rollout.residual_launches,
                  "cloth": pcs.cloth_rollout.residual_launches,
                  "nh": pnh.nh_local_step_fused.residual_launches,
                  "arap": ptet.arap_local_step_fused.residual_launches,
                  "tri": ptri.tri_local_step_fused.residual_launches,
                  "local": pbl.banded_local_rhs.residual_launches}
        # the route ran its residual mode, once a step (a window) or an
        # ADMM iteration, and no other
        want = dict.fromkeys(counts, 0)
        want[kernel] = RESIDUAL_STEPS * per_step
        if counts != want:
            raise AssertionError(f"{label}: residual-mode launches {counts}, "
                                 f"expected {want}")
        for k, n in counts.items():
            launches[k] += n
        readings[label] = (rp, rd)
        times = {}
        for mode in modes:
            profile_step.set_collect(s, mode)
            ops0 = pbs.banded_rollout.ops + pcs.cloth_rollout.ops
            med, windows = drive(torch, s)
            steps = WARMUP_STEPS + WINDOWS * WINDOW_STEPS
            ops = route_ops(s, mode, (pbs.banded_rollout.ops
                                      + pcs.cloth_rollout.ops - ops0) / steps)
            times[mode] = (med, max(windows) - min(windows), ops)
        say(f"residuals {label} f32", steps=RESIDUAL_STEPS,
            residual_mode_launches=counts[kernel],
            **residual_readings(rp, rd),
            finite=bool(np.isfinite(rp).all() and (
                rd is None or np.isfinite(rd).all())),
            **{f"ms_per_step_{m}": t[0] for m, t in zip(
                ("off", "primal", "full"), times.values())},
            **{f"spread_ms_{m}": t[1] for m, t in zip(
                ("off", "primal", "full"), times.values())},
            **{f"device_ops_per_step_{m}": t[2] for m, t in zip(
                ("off", "primal", "full"), times.values())})
        if not (np.isfinite(rp).all() and (rp > 0).all()):
            raise AssertionError(f"{label}: bad primal residuals")
        del s
    # the general and the banded route at cg25 run the same math: their
    # residuals agree within the f32 trajectories' own spread
    s = tet100k(25, torch.float32, fast=True)
    s.x = s.x + 1e-6 * np.random.default_rng(4).standard_normal(s.x.shape)
    profile_step.set_collect(s, True)
    res = [step_residuals(s) for _ in range(RESIDUAL_STEPS)]
    moved = (np.stack([r[0] for r in res]), np.stack([r[1] for r in res]))
    gen, ban = (readings["tet100k general dia cg25"],
                readings["tet100k banded cg25"])

    def rel(a, b):
        """max |a - b| over the steps and iterations, over max |b|."""
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    say("residuals general vs banded cg25 f32",
        primal_rel_vs_banded=rel(gen[0], ban[0]),
        dual_rel_vs_banded=rel(gen[1], ban[1]),
        primal_rel_banded_moved_1um=rel(moved[0], ban[0]),
        dual_rel_banded_moved_1um=rel(moved[1], ban[1]),
        **{f"general_{k}": v for k, v in residual_readings(*gen).items()},
        **{f"moved_{k}": v for k, v in residual_readings(*moved).items()})
    return launches, readings


def seed_forms(torch, st, kind, label):
    """Iteration 0's dual residual in f32 on the card by the two forms of
    T z_prev: the kernels' (the incidence sum of w2 D^T D x_pre rows, +
    aw2 x_pre) and the Pallas kernel's identity (A_hat - M) x_pre / dt^2,
    each seed's relative error against the first form in f64 (the planes
    cast up). A 1-step window of one ADMM iteration in "full" leaves T z_0
    in the window's tz and x_pre in its xpre."""
    mod, Window = ((pbs, pbs.BandedWindow) if kind == "banded"
                   else (pcs, pcs.ClothWindow))
    cfg = dataclasses.replace(st.cfg, admm_iters=1, collect="full")
    state = {k: st.state[k].clone() for k in mod.STATE}
    w = Window(state, st.planes, cfg)
    w.launch(1)
    rd_kernel = float(w.residuals(1)[1, 0, 0])
    dt2 = cfg.dt ** 2
    xpre = w.xpre
    ident = (dia_apply(xpre, cfg.dia_offs, st.planes["dia"])
             - st.planes["mass"][:, None] * xpre) / dt2

    def seed(x, planes):
        return (mod.seed_tz(x, planes, cfg) if kind == "banded"
                else mod.seed_tz(x, planes))

    direct = seed(xpre, st.planes)
    planes64 = {k: (v.double() if v.is_floating_point() else v)
                for k, v in st.planes.items()}
    truth = seed(xpre.double(), planes64)

    def err(a):
        return float((a.double() - truth).norm() / truth.norm())

    say(f"dual seed {label} f32", rd0_kernel=rd_kernel,
        rd0_direct=dt2 * float((w.tz - direct).norm()),
        rd0_identity=dt2 * float((w.tz - ident).norm()),
        seed_rel_err_direct=err(direct), seed_rel_err_identity=err(ident))


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

    # phase 2: build the kernels from the checkout's sources, and the
    # synchronisation microbenchmark beside them
    probe_lib = start_probe_build()
    lib_path, build_s = _build.build()
    _build.load_library()
    probe_lib = probe_lib()
    say("build", seconds=round(build_s, 3), library=os.path.relpath(lib_path, HERE))
    element_sass = start_element_sass()
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
    xg, p = tet_inputs(torch, ref64, "c1_HyperElasticTet", rng)
    nh = nh_inputs(torch, ref64, "c1_HyperElasticTet", xg, rng)
    check_nh(torch, nh, torch.float64)
    nh32, nhstep32 = check_nh(torch, nh, torch.float32)
    # phase 3p (the emit_z modes) at tet100k's elements
    emitz = {"nh": check_emit_z(torch, "nh_local tet100k",
                                pnh.nh_local_step_fused,
                                pnh.nh_local_step_fused_reference,
                                nh["mesh"], torch.float32, iters=5)}
    cg_ms = {}
    for dtype in (torch.float64, torch.float32):
        for k in (25, 75):
            cg_ms[(dtype, k)] = check_solve(
                torch, "tet100k", pcg,
                (*scenes.dia_solve_inputs(ref64, dtype), k),
                1e-10 if dtype == torch.float64 else 1e-4)
    del ref64, nh, xg, p

    # phase 3i: the ARAP entries at arap100k's elements
    a64 = arap100k(25, torch.float64)
    xg, p = tet_inputs(torch, a64, "c1_LinearTetStrain", rng)
    arap = arap_inputs(torch, a64, "c1_LinearTetStrain", xg, rng)
    check_arap(torch, arap, torch.float64)
    arapf32, arap32 = check_arap(torch, arap, torch.float32)
    # phase 3p at arap100k's elements
    emitz["arap"] = check_emit_z(
        torch, "arap_local_step_fused arap100k", ptet.arap_local_step_fused,
        ptet.arap_local_step_fused_reference, arap["mesh"], torch.float32)
    del a64, xg, p, arap

    # phase 3b: the banded whole-timestep window against its plain version
    # (bitwise): the jittered beam (floor, sphere, cylinder) in every mode
    # with vertex 0's anchor released, and at tet100k; then its CUDA graph
    # against eager launches, and the setters after capture
    for dtype in (torch.float64, torch.float32):
        st = scenes.jittered_system(dtype=dtype)._stepper
        check_rollout_small(torch, "banded", st, dtype, 1e-11)
        released = dict(st.planes, aw2=st.planes["aw2"].clone())
        released["aw2"][0] = 0.0
        for model in ("nh", "stvk", "arap"):
            check_rollout_small(
                torch, "banded", _with_cfg(st, model=model), dtype, 1e-11,
                name=f" {model} anchor 0 released", planes=released)
        check_graph(torch, "banded", st, f"jittered 8x6x5 {str(dtype)[6:]}")
    st = tet100k(75, torch.float64, fast=True)._stepper
    window_layout(torch, st, "banded tet100k float64")
    check_rollout_full(torch, "banded", *f64_depth(st, "tet100k cg75"),
                       torch.float64, 1e-8)
    del st
    st = tet100k(75, torch.float32, fast=True)._stepper
    banded32 = check_rollout_full(torch, "banded", st, "tet100k cg75",
                                  torch.float32, 1e-4)
    residual_banded = check_residual_full(torch, "banded", st, "tet100k cg75")
    del st

    # phase 3c: the triangle-strain kernel at the cloth100k sheet's shapes
    cloth64 = cloth100k(25, torch.float64, fast=False)
    ins = tri_inputs(torch, cloth64, rng)
    check_tri(torch, ins, torch.float64)
    tri32, tristep32 = check_tri(torch, ins, torch.float32)
    # phase 3p at the cloth100k sheet's elements
    emitz["tri"] = check_emit_z(torch, "tri_local cloth100k",
                                ptri.tri_local_step_fused,
                                ptri.tri_local_step_fused_reference, ins,
                                torch.float32)
    del cloth64, ins
    # the hyperelastic and ARAP kernels' registers, spills and SASS size,
    # counted beside phases 3 to 3c
    element_sass()

    # phase 3p: the three fused element kernels' emit_z mode (the rows of
    # w2 D^T z beside the RHS rows) on a small mesh in f64: bitwise to the
    # twins, the other outputs bitwise to the launch without it (at full
    # width in f32 above)
    beam = beam_system((6, 5, 4), 0.05, 50.0, 25, torch.float64)
    xg, p = tet_inputs(torch, beam, "c1_HyperElasticTet", rng)
    u9 = torch.zeros_like(xg[:9])
    check_emit_z(torch, "nh_local beam 6x5x4", pnh.nh_local_step_fused,
                 pnh.nh_local_step_fused_reference,
                 [*unshared(xg), u9, torch.ones_like(xg[:3]), p["coeff_p"],
                  p["mu"], p["lam"], p["k"], p["w2"]], torch.float64,
                 iters=5)
    check_emit_z(torch, "arap_local_step_fused beam 6x5x4",
                 ptet.arap_local_step_fused,
                 ptet.arap_local_step_fused_reference,
                 [*unshared(xg), u9, p["coeff_p"], p["w2"], p["k"]],
                 torch.float64)
    check_emit_z(torch, "tri_local sheet 8x6", ptri.tri_local_step_fused,
                 ptri.tri_local_step_fused_reference,
                 tri_inputs(torch, small_cloth(torch.float64, fast=False),
                            rng), torch.float64)
    del beam, xg, p, u9

    # phase 3d: the cloth whole-timestep window against its plain version
    # (bitwise): the 8 x 6 sheet (wind, bend, anchors; strain limiting on
    # and off; vertex 0's anchor released), its CUDA graph against eager
    # launches and the setters after capture; cloth100k at cg25 in f32
    # (the solve's WINDOW layout) and for one step in f64 (SHARED); its
    # device ops a step (3 + 3 admm_iters: wind, kick, then per ADMM
    # iteration an element kernel, a vertex kernel and one cluster solve,
    # then the end)
    for dtype in (torch.float64, torch.float32):
        st = small_cloth(dtype)._stepper
        check_rollout_small(torch, "cloth", st, dtype, 1e-12)
        released = dict(st.planes, aw2=st.planes["aw2"].clone())
        anchored = int(torch.nonzero(released["aw2"])[0])
        released["aw2"][anchored] = 0.0
        check_rollout_small(torch, "cloth", _with_cfg(st, limiting=False),
                            dtype, 1e-12,
                            name=f" unlimited anchor {anchored} released",
                            planes=released)
        check_graph(torch, "cloth", st, f"8x6 sheet {str(dtype)[6:]}")
        window_device_ops(torch, st, f"8x6 {str(dtype)[6:]}",
                          3 + 3 * ADMM_ITERS)
    st = cloth100k(25, torch.float32)._stepper
    window_layout(torch, st, "cloth cloth100k float32")
    window_device_ops(torch, st, "cloth100k float32", 3 + 3 * ADMM_ITERS)
    cloth32 = check_rollout_full(torch, "cloth", st, "cloth100k cg25",
                                 torch.float32, 0.0)
    residual_full = {"cloth": check_residual_full(torch, "cloth", st,
                                                  "cloth100k cg25")}
    del st
    st = cloth100k(25, torch.float64)._stepper
    window_layout(torch, st, "cloth cloth100k float64", window=False)
    check_rollout_full(torch, "cloth", *f64_depth(st, "cloth100k cg25"),
                       torch.float64, 0.0)
    del st
    # its time and bound at cg300, the Jacobi budget matched at 225 x 225
    # (held to the twin at cg25 above)
    ms, window_ms, n_ops, n_bytes, bound_ms, bound_by = rollout_times(
        torch, "cloth", cloth100k(300, torch.float32)._stepper)
    say("kernel cloth float32 cloth100k cg300", ms_per_1step_launch=ms,
        ms_per_10step_launch=window_ms, ms_per_step_in_window=window_ms / 10,
        operations=n_ops, bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by)

    # phase 3o: the multigrid mode (preconditioner="amg"): the cluster
    # solve's (mg_dia_solve, csrc/mg_vcycle.cuh) and the banded and cloth
    # windows' against their twins, bitwise: the 6 x 5 x 4 beam and the
    # 8 x 6 sheet in f64 and f32 (the solve; 1 ADMM iteration and a small
    # window; the CUDA graphs against eager launches and the setters after
    # capture), then tet100k's and cloth100k's own A and rhs in f32 (the
    # solve at mg8, its time and bound; one step of each window, its times
    # and bound a step; GRAPH_STEPS steps of its graph, each held to the
    # twin)
    for dtype in (torch.float64, torch.float32):
        for label, kind, st in (
                ("beam 6x5x4", "banded", small_mg_beam(dtype)._stepper),
                ("sheet 8x6", "cloth",
                 small_cloth(dtype, preconditioner="amg")._stepper)):
            check_mg_solve(torch, label, st)
            check_rollout_small(torch, kind, st, dtype, 0.0,
                                name=f" mg {label}")
            check_graph(torch, kind, st, f"mg {label} {str(dtype)[6:]}")
    mg_full = {}
    for label, kind, make in (
            ("tet100k mg8", "banded",
             lambda: tet100k(8, torch.float32, amg=True)),
            ("cloth100k mg8", "cloth",
             lambda: cloth100k(8, torch.float32, amg=True))):
        st = make()._stepper
        check_mg_solve(torch, label, st)
        mg_full[label] = check_rollout_full(torch, kind, st, label,
                                            torch.float32, 0.0)
        check_steps(torch, kind, st, label)
        check_residual_full(torch, kind, st, label)
        del st

    # phase 3r: the algebraic multigrid mode, solve and window, bitwise
    uamg_window = uamg_kernel_checks(torch)

    # phase 3s: the banded window's sweep mode on small sweeps, bitwise
    sweep_kernel_checks(torch)

    # phase 3q: the windows' residual modes ("primal", "full") against
    # their twins on small scenes: residuals bitwise, the state bitwise to
    # the window without collection, graph replays equal to eager launches
    # (the banded window in dia and ELL rows, nh and arap, Jacobi and
    # multigrid on the 6 x 5 x 4 beam, the algebraic multigrid on the
    # 10 x 7 x 6 Delaunay mesh; the cloth window, Jacobi and
    # multigrid, on the 8 x 6 sheet); f64 and f32 on the beam's dia nh and
    # the sheet's Jacobi, f32 on the others. At full width in f32 (one step
    # each mode) beside each route's window check above and below
    for dtype in (torch.float64, torch.float32):
        small = [("beam 6x5x4", "banded",
                  beam_system((6, 5, 4), 0.05, 50.0, 25, dtype,
                              fast=True)),
                 ("sheet 8x6", "cloth", small_cloth(dtype))]
        if dtype == torch.float32:
            small += [
                ("beam 6x5x4 arap", "banded",
                 beam_system((6, 5, 4), 0.05, 50.0, 25, dtype, fast=True,
                             arap=True)),
                ("beam 6x5x4 ell", "banded",
                 beam_system((6, 5, 4), 0.05, 50.0, 25, dtype, fast=True,
                             global_solver="ell")),
                ("beam 6x5x4 mg", "banded", small_mg_beam(dtype)),
                ("delaunay 10x7x6 uamg", "banded", small_uamg(8, dtype)),
                ("sheet 8x6 mg", "cloth",
                 small_cloth(dtype, preconditioner="amg"))]
        for label, kind, system in small:
            check_residual_window(torch, kind, system._stepper, label, dtype)
    del small, system

    # phase 3e: the fused CG update at delaunay100k's shapes
    d64 = delaunay100k(25, torch.float64, fast=False)
    probs = {dt: scenes.ell_solve_inputs(d64, dt)
             for dt in (torch.float64, torch.float32)}
    check_cg_update(torch, probs[torch.float64], torch.float64)
    upd32 = check_cg_update(torch, probs[torch.float32], torch.float32)

    # phase 3f: the ELL CG kernel on delaunay100k's own A_hat, in its grid
    # numbering (a row reaches 920 rows: the windows fit in shared memory)
    # and renumbered at random, as a mesh numbered without regard to its
    # band is (a row reaches across all of n: the shared layout)
    ell_ms = {}
    for dtype in (torch.float64, torch.float32):
        renumbered = scenes.renumbered_ell(*probs[dtype], seed=0)[:5]
        for k in DELAUNAY_BUDGETS:
            tol = 1e-12 if dtype == torch.float64 else 1e-4
            ell_ms[(dtype, k)] = check_solve(
                torch, "delaunay100k", pell, (*probs[dtype], k), tol)
            check_solve(torch, "delaunay100k renumbered", pell,
                        (*renumbered, k), tol)
        del renumbered
    del d64, probs

    # phase 3n: both cluster solves on banded SPD systems of 1,003 rows (the
    # last slab cut short) and 11 (fewer rows than CTAs); the per-iteration
    # floor; the synchronisation alone; and tet100k's beam made 4 and 16
    # times longer (the shared layout), to see where one cluster stops
    # paying against the chain's ~5.5 us a launch, 3 an iteration
    for n in (1003, 11):
        for dtype in (torch.float64, torch.float32):
            sp = banded_spd(n, dtype=dtype, device="cuda", seed=n)
            for k in (25, 75):
                for mod, tol, mat in ((pcg, 1e-10, ("dia_vals", "offsets")),
                                      (pell, 1e-12, ("ell_idx", "ell_vals"))):
                    check_solve(torch, f"banded_spd n={n}", mod,
                                (sp["b"], sp["x0"], sp["diag"],
                                 *(sp[m] for m in mat), k),
                                tol if dtype == torch.float64 else 1e-4,
                                reps=5, plain_reps=2)
    cluster_floor(torch)
    sync_costs(torch, probe_lib)
    grid_costs(torch, probe_lib)
    for cells in (160, 640):
        args = (*scenes.long_beam_dia_inputs(cells), 25)
        if cells == 160:
            check_solve(torch, f"beam {cells}x25x20", pcg, args, 1e-4,
                        reps=10, plain_reps=2)
        ms = cuda_ms(torch, lambda: pcg.cg_dia_solve(*args), 10)
        say(f"cluster at scale, beam {cells}x25x20 f32 cg25",
            n=args[0].shape[0], ms=ms, us_per_iteration=1e3 * ms / 25,
            **pstep.cluster_plan(args[0].shape[0], torch.float32,
                                 max(abs(o) for o in args[4]),
                                 len(args[4])))
        del args

    # phase 3g: the banded window's ELL rows (bitwise; the small mesh's f32
    # window keeps its 1e-3 against the twin: its Newton ties move x by
    # ~3e-4 relative in 10 steps if a bit differs), and its graph
    for dtype in (torch.float64, torch.float32):
        st = small_delaunay(dtype=dtype)._stepper
        check_rollout_small(torch, "banded", st, dtype, 1e-11, tol_f32=1e-3)
        check_graph(torch, "banded", st, f"ell 140 nodes {str(dtype)[6:]}")
    st = delaunay100k(25, torch.float32)._stepper
    bandedell32 = check_rollout_full(torch, "banded", st,
                                     "delaunay100k cg25", torch.float32, 1e-4)
    check_residual_full(torch, "banded", st, "delaunay100k cg25")
    del st

    # phase 3j: the lattice whole-timestep kernel against its plain
    # version: nh, stvk, arap and nh over a floor on a small beam, then
    # tet100k's beam on the cg mode (its route, phase 5f) at cg75
    for dtype in (torch.float64, torch.float32):
        for model, floor in (("nh", False), ("stvk", False), ("arap", False),
                             ("nh", True)):
            tag = f" {model} floor" if floor else f" {model}"
            check_rollout_small(torch, "lattice",
                                small_lattice(model, dtype, floor), dtype,
                                1e-11, name=tag)
        check_graph(torch, "lattice", small_lattice("nh", dtype, True),
                    f"8x6x5 floor {str(dtype)[6:]}")
    lattice_full = {}
    for dtype in (torch.float64, torch.float32):
        st = tet100k(75, dtype, fast=True, global_solver="cg")._stepper
        window_layout(torch, st, f"lattice tet100k {str(dtype)[6:]}")
        lattice_full[dtype] = check_rollout_full(
            torch, "lattice", *(f64_depth(st, "tet100k cg75")
                                if dtype == torch.float64
                                else (st, "tet100k cg75")), dtype,
            1e-8 if dtype == torch.float64 else 1e-4)
    lattice32 = lattice_full[torch.float32]
    del st

    # phase 3k: the banded kernel's arap mode on a small beam and at
    # arap100k (cg75)
    for dtype in (torch.float64, torch.float32):
        check_rollout_small(torch, "banded",
                            beam_system((6, 4, 4), 0.05, 1.0, 25, dtype,
                                        fast=True, arap=True)._stepper,
                            dtype, 1e-11, name=" arap")
    check_rollout_full(torch, "banded",
                       *f64_depth(arap100k(75, torch.float64,
                                           fast=True)._stepper,
                                  "arap100k cg75"), torch.float64, 1e-8)
    st = arap100k(75, torch.float32, fast=True)._stepper
    bandedarap32 = check_rollout_full(torch, "banded", st, "arap100k cg75",
                                      torch.float32, 1e-4)
    check_residual_full(torch, "banded", st, "arap100k cg75")
    del st

    # phase 3l: the sharded stepper's local phase (banded_local_rhs)
    # against its plain version: on the jittered 8x6x5 beam (anchors, floor,
    # sphere, cylinder) in the nh, stvk and arap modes with vertex 0's
    # anchor released (weight 0), and at tet100k's first ADMM iteration
    for dtype in (torch.float64, torch.float32):
        st = scenes.jittered_system(dtype=dtype)._stepper
        planes = dict(st.planes, aw2=st.planes["aw2"].clone())
        planes["aw2"][0] = 0.0
        ins = local_inputs(torch, st, rng, 0.05)
        for model in ("nh", "stvk", "arap"):
            check_local(torch, f"jittered 8x6x5 {model}", ins, planes,
                        dataclasses.replace(st.cfg, model=model), dtype,
                        released=0)
        # B11's collect mode (phase 3q), bitwise
        for model in ("nh", "arap"):
            check_local_collect(torch, f"jittered 8x6x5 {model}", ins,
                                planes, dataclasses.replace(st.cfg,
                                                            model=model),
                                dtype)
    local32 = {}
    for dtype in (torch.float64, torch.float32):
        st = tet100k(25, dtype, fast=True)._stepper
        ins = local_inputs(torch, st, rng, 0.002)
        local32[dtype] = check_local(torch, "tet100k", ins, st.planes,
                                     st.cfg, dtype)
        if dtype == torch.float32:
            local_collect32 = check_local_collect(torch, "tet100k", ins,
                                                  st.planes, st.cfg, dtype)
            # the call as the sharded stepper makes it (its output buffers
            # given), by events, and as 20 calls in one CUDA graph (the
            # device's time)
            out = tuple(torch.empty_like(t) for t in ins)
            say("kernel banded_local_rhs tet100k float32 times",
                ms_out_given=cuda_ms(torch, lambda: pbl.banded_local_rhs(
                    *ins, st.planes, st.cfg, out=out), 10, batch=20),
                device_ms_graph=graph_ms(torch, lambda: pbl.banded_local_rhs(
                    *ins, st.planes, st.cfg), 20, 3))
        del st

    # phase 3m: the Chebyshev chunk (cheb_dia_chunk, one launch on a
    # 16-CTA cluster) against its plain version on tet100k's own A_hat,
    # bitwise: the init-only first chunk, a middle chunk of 20 iterations,
    # and the whole cheb180 solve of one launch (n_it = 179, first = last
    # = True); f32 in the WINDOW layout, f64 in the SHARED one. Then the
    # chunk on a band wider than its windows (the SHARED layout in f32)
    cheb32 = {}
    for dtype in (torch.float64, torch.float32):
        st = tet100k(25, dtype, fast=True)._stepper
        args, (inv_theta, c1, c2), bounds = cheb_problem(torch, st, rng)
        say(f"cheb bounds tet100k {str(dtype)[6:]}", lmin=bounds[0],
            lmax=bounds[1], inv_theta=inv_theta)
        for label, n_it, first, last, lo in (("first", 0, True, False, 0),
                                             ("middle", 20, False, False, 50),
                                             ("whole cheb180", 179, True,
                                              True, 0)):
            cheb32[(dtype, label)] = check_cheb(
                torch, label, (*args, c1[lo:lo + max(n_it, 1)],
                               c2[lo:lo + max(n_it, 1)]),
                dict(offsets=st.cfg.dia_offs, n_it=n_it, first=first,
                     last=last, inv_theta=inv_theta), dtype)
        del st, args
    for dtype in (torch.float32, torch.float64):
        args, kw = wide_cheb_problem(torch, dtype)
        check_cheb(torch, "banded_spd n=20000 reach 9000", args, kw, dtype)

    # phase 4: small scenes of every general route, card vs CPU, and
    # determinism on the card: the 6x4x4 slice on dia and with bare
    # Settings() ('auto': dense), a LinearTetStrain beam on dia, dense and
    # over-relaxation 1.6, the 8x6 cloth on the cg mode
    small_routes = {
        "slice 6x4x4 dia": lambda d: beam_system(
            (6, 4, 4), 0.05, 1.0, 25, torch.float64, d),
        "slice 6x4x4 Settings() (dense)": lambda d: beam_system(
            (6, 4, 4), 0.05, 1.0, None, torch.float64, d,
            global_solver="auto"),
        "arap 6x4x4 dia": lambda d: beam_system(
            (6, 4, 4), 0.05, 1.0, 25, torch.float64, d, arap=True),
        "arap 6x4x4 dense": lambda d: beam_system(
            (6, 4, 4), 0.05, 1.0, 25, torch.float64, d, arap=True,
            global_solver="dense"),
        "arap 6x4x4 relax1.6": lambda d: beam_system(
            (6, 4, 4), 0.05, 1.0, 25, torch.float64, d, arap=True,
            relaxation=1.6),
        "cloth 8x6 cg": lambda d: small_cloth(torch.float64, d, fast=False,
                                              global_solver="cg"),
        "delaunay 10x7x6 ell amg (general AMG)": lambda d: small_uamg(
            8, torch.float64, d, fast=False),
    }
    for label, build in small_routes.items():
        def small(device):
            s = build(device)
            s.run(5)
            return s.x, s.v, s._solver_mode

        xc, _, mode = small("cpu")
        xg1, vg1, _ = small("cuda")
        xg2, vg2, _ = small("cuda")
        diff = float(np.abs(xg1 - xc).max())
        bitwise = bool(np.array_equal(xg1, xg2) and np.array_equal(vg1, vg2))
        say(f"{label} f64", mode=mode, max_abs_dx_cuda_vs_cpu=diff, tol=1e-8,
            bitwise_repeat=bitwise)
        if not (diff < 1e-8 and bitwise and np.isfinite(xg1).all()):
            raise AssertionError(f"{label}: card vs CPU or determinism failed")

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
             pcs.cloth_rollout, plat.lattice_rollout)
    element_pipeline_ops(systems[25])

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
             ptri.tri_local_step_fused, pcs.cloth_rollout,
             plat.lattice_rollout)
    for cg, (med, windows, n_launch) in fast_budget.items():
        s, gen = fast[cg], per_budget[cg][3]
        x = s.x
        anchored = np.flatnonzero(s._x[:, 0] < 1e-9)
        drift = float(np.abs(x[anchored] - s._x[anchored]).max())
        sag = float((x[:, 1] - s._x[:, 1]).min())
        vs_general = float(np.abs(x - gen.x).max())
        # one submission (a graph replay) a single warm-up step and a window
        want = WARMUP_STEPS + WINDOWS
        say(f"tet100k fast cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            submissions=n_launch, expected_submissions=want,
            anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_general_m=vs_general,
            finite=bool(np.isfinite(x).all()))
        say(f"routes cg{cg} f32 (this call)",
            general_ms_per_step=per_budget[cg][0], fast_ms_per_step=med)
        if n_launch != want:
            raise AssertionError(f"fast cg{cg}: {n_launch} window submissions, "
                                 f"expected {want}")
        if not (np.isfinite(x).all() and drift < 1e-4 and sag < 0):
            raise AssertionError(f"fast cg{cg}: bad trajectory (drift "
                                 f"{drift}, min dy {sag})")
    # phase 5f's trusted route, at the same 32 steps (profiling steps on)
    banded_x = {cg: s.x for cg, s in fast.items()}
    tet75_x = per_budget[75][3].x  # phase 5e's trusted route
    for cg, s in fast.items():
        check_window_ops(trace(cg, "fast", s), f"tet100k banded cg{cg}")
    for cg, run in per_budget.items():
        trace(cg, "general", run[3])
    banded_ms = {cg: run[0] for cg, run in fast_budget.items()}
    del systems, fast, per_budget, fast_budget

    # phase 5f: tet100k on the lattice whole-timestep route: the cg global
    # mode with lattice_fast_path=True, where the JAX package's chain passes
    # the banded kernel (dia and ell only) and engages the lattice kernel;
    # f32, against the banded route's trajectory, beside the lattice
    # route's own divergence from a start moved by 1e-6 m
    lat = {cg: tet100k(cg, torch.float32, fast=True, global_solver="cg")
           for cg in (75, 25)}
    for cg, s in lat.items():
        if not isinstance(s._stepper, LatticeStepper):
            raise AssertionError(f"cg{cg}: the lattice route did not engage "
                                 f"({type(s._stepper).__name__})")
    reset_launches()
    lat_runs = {}
    for cg, s in lat.items():
        n0 = plat.lattice_rollout.launches
        lat_runs[cg] = (*drive(torch, s), plat.lattice_rollout.launches - n0)
    launches["lattice"] = plat.lattice_rollout.launches
    off_path(*(k for k in KERNELS if k is not plat.lattice_rollout))
    sens = {}
    for cg in lat:
        p = tet100k(cg, torch.float32, fast=True, global_solver="cg")
        p.x = p._x + 1e-6 * np.random.default_rng(1).standard_normal(
            p._x.shape)
        p.run(steps)
        sens[cg] = float(np.abs(p.x - lat[cg].x).max())
        del p
    for cg, (med, windows, n_launch) in lat_runs.items():
        s = lat[cg]
        fin, drift, sag = beam_trajectory(s)
        vs_same = float(np.abs(s.x - banded_x[cg]).max())
        want = WARMUP_STEPS + WINDOWS
        say(f"tet100k lattice cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            submissions=n_launch, expected_submissions=want,
            anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_banded_same_budget_m=vs_same,
            max_abs_dx_vs_banded_cg75_m=float(
                np.abs(s.x - banded_x[75]).max()),
            perturbed_start_divergence_m=sens[cg], finite=fin)
        say(f"lattice routes cg{cg} f32 (this call)",
            banded_ms_per_step=banded_ms[cg], lattice_ms_per_step=med)
        if n_launch != want:
            raise AssertionError(f"lattice cg{cg}: {n_launch} window submissions, "
                                 f"expected {want}")
        if not (fin and drift < 1e-4 and sag < 0
                and vs_same <= max(1e-3, 10.0 * sens[cg])):
            raise AssertionError(f"lattice cg{cg}: bad trajectory (drift "
                                 f"{drift}, min dy {sag}, {vs_same} m from "
                                 "the banded route)")
    for cg, s in lat.items():
        check_window_ops(trace(cg, "lattice", s), f"tet100k lattice cg{cg}")
    del lat

    # phase 5h: tet100k on the sharded banded stepper at one device, f32:
    # cg25, cg75 (one cg_dia_solve launch per solve, the banded route's
    # cluster solve) and cheb180 (one cheb_dia_chunk launch per solve);
    # banded_local_rhs once per ADMM
    # iteration throughout. Each run against the banded route of phase 5b
    # at the same budget (cheb180: at cg75, its matched counterpart) and
    # at cg75, beside its own divergence from a start moved by 1e-6 m
    sharded = {key: tet100k_sharded(*key) for key in SHARDED}
    for (solver, budget), sp in sharded.items():
        if not isinstance(sp, ShardedBandedStepper) or sp.backend != "pallas":
            raise AssertionError(f"{solver}{budget}: the sharded stepper did "
                                 "not engage its kernels")
        if solver == "cheb":
            say(f"cheb bounds sharded {solver}{budget}",
                lmin=sp.cheb_bounds[0], lmax=sp.cheb_bounds[1])
    sh_runs = {}
    launches["banded_local"] = launches["cheb"] = 0
    for (solver, budget), sp in sharded.items():
        reset_launches()
        med, windows = drive(torch, sp)
        counts = {k.__name__: k.launches for k in KERNELS}
        sh_runs[(solver, budget)] = (med, windows, counts)
        launches["banded_local"] += pbl.banded_local_rhs.launches
        launches["cheb"] += pchb.cheb_dia_chunk.launches
    sens = {}
    for key in SHARDED:
        p = tet100k_sharded(*key)
        x0 = p.state["x"]
        p.state["x"] = x0 + torch.as_tensor(
            1e-6 * np.random.default_rng(1).standard_normal(tuple(x0.shape)),
            dtype=x0.dtype, device=x0.device)
        p.run(steps)
        sens[key] = float(np.abs(p.x - sharded[key].x).max())
        del p
    bad = []
    for (solver, budget), (med, windows, counts) in sh_runs.items():
        sp = sharded[(solver, budget)]
        x, rest = sp.x, sp.base.x
        anchored = np.flatnonzero(rest[:, 0] < 1e-9)
        drift = float(np.abs(x[anchored] - rest[anchored]).max())
        sag = float((x[:, 1] - rest[:, 1]).min())
        fin = bool(np.isfinite(x).all())
        trusted = banded_x[budget if solver == "cg" else 75]
        vs_trusted = float(np.abs(x - trusted).max())
        per_step = {k: v / steps for k, v in counts.items() if v}
        say(f"tet100k sharded {solver}{budget} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            launches_per_step=per_step, anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_banded_trusted_m=vs_trusted,
            trusted=f"banded cg{budget if solver == 'cg' else 75}",
            max_abs_dx_vs_banded_cg75_m=float(
                np.abs(x - banded_x[75]).max()),
            perturbed_start_divergence_m=sens[(solver, budget)], finite=fin)
        say(f"sharded routes {solver}{budget} f32 (this call)",
            banded_ms_per_step=banded_ms[budget if solver == "cg" else 75],
            sharded_ms_per_step=med)
        if solver == "cheb":
            local_ms = ADMM_ITERS * local32[torch.float32][1]
            solve_ms = ADMM_ITERS * cheb32[(torch.float32,
                                             "whole cheb180")][1]
            say(f"attribution sharded {solver}{budget}",
                banded_local_ms=local_ms, cheb_dia_ms=solve_ms,
                rest_ms=med - local_ms - solve_ms)
        want = {k.__name__: 0 for k in KERNELS}
        want["banded_local_rhs"] = steps * ADMM_ITERS
        want["cheb_dia_chunk" if solver == "cheb"
             else "cg_dia_solve"] = steps * ADMM_ITERS
        if counts != want:
            bad.append(f"{solver}{budget}: launches {counts}, expected {want}")
        if not (fin and drift < 1e-4 and sag < 0
                and vs_trusted <= max(1e-3, 10.0 * sens[(solver, budget)])):
            bad.append(f"{solver}{budget}: bad trajectory ({vs_trusted} m "
                       "from the banded route)")
    if bad:
        raise AssertionError("sharded routes: " + "; ".join(bad))
    for (solver, budget), sp in sharded.items():
        trace(budget, "sharded", sp, solver=solver)
    tet75_ref = banded_x[75]  # phase 5i's trusted route
    del sharded, banded_x

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
    off_path(pnh.nh_local_step_fused, pbs.banded_rollout, pcs.cloth_rollout,
             plat.lattice_rollout)

    cloth = {cg: cloth100k(cg, torch.float32, fast=True)
             for cg in CLOTH_BUDGETS}
    reset_launches()
    cloth_runs = {}
    for cg, s in cloth.items():
        n0 = (pcs.cloth_rollout.launches, pcs.cloth_rollout.ops)
        cloth_runs[cg] = (*drive(torch, s), pcs.cloth_rollout.launches - n0[0],
                          pcs.cloth_rollout.ops - n0[1])
    launches["cloth"] = pcs.cloth_rollout.launches
    off_path(pnh.nh_local_step_fused, pcg.cg_dia_solve, pbs.banded_rollout,
             ptri.tri_local_step_fused, plat.lattice_rollout)

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
        cmed, cwin, n_launch, n_ops = cloth_runs[cg]
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
            device_ops_per_window=n_ops / n_launch,
            device_ops_per_step=n_ops / steps,
            anchor_drift_m=cdrift, min_dy_m=csag,
            max_abs_dx_vs_general_m=vs_general,
            general_vs_perturbed_general_m=sens[cg], finite=cfin)
        say(f"cloth routes cg{cg} f32 (this call)", general_ms_per_step=gmed,
            cloth_ms_per_step=cmed)
        if gcounts != (steps * ADMM_ITERS, steps * ADMM_ITERS):
            raise AssertionError(f"cloth cg{cg}: general-route launches "
                                 f"{gcounts}, expected {steps * ADMM_ITERS}")
        if n_launch != want or n_ops != steps * (3 + 3 * ADMM_ITERS):
            raise AssertionError(f"cloth cg{cg}: {n_launch} cloth "
                                 f"submissions of {n_ops} launches, "
                                 f"expected {want} of "
                                 f"{steps * (3 + 3 * ADMM_ITERS)}")
        if not (gfin and cfin and max(gdrift, cdrift) < 1e-4
                and max(gsag, csag) < 0
                and vs_general <= max(1e-3, 10.0 * sens[cg])):
            raise AssertionError(f"cloth cg{cg}: bad trajectory")
    cloth300_x = cloth[300].x  # phase 5i's trusted route
    # the cloth route first: the general route's traces hold tens of
    # thousands of launches
    for cg, s in cloth.items():
        check_window_ops(trace(cg, "fast", s, scene="cloth100k"),
                         f"cloth100k cloth cg{cg}", 3 + 3 * ADMM_ITERS)
    for cg, s in gen.items():
        trace(cg, "general", s, scene="cloth100k")

    del gen, cloth

    # phase 5i: the multigrid routes at full width, f32: tet100k on the
    # banded route at mg6 (bench.py --amg) and mg8, cloth100k on the cloth
    # route at mg8 (bench's matched cloth100k row), each after 32 steps
    # against the matched Jacobi route of this call (banded cg75, phase 5b;
    # cloth cg300, phase 5c) and against a Jacobi route 4 times deeper
    # (banded cg300, cloth cg1200), beside its own divergence from a start
    # moved by 1e-6 m and the Jacobi route at cg8 (the control); then device operations a step and the idle share. The
    # routes are different approximations of one exact solve: a multigrid
    # route must lie within its scene's MG_DX_LIMIT_M of the deep route.
    # In f32 cloth100k's cg300 lies ~1 cm from cg1200 after 32 steps, so
    # the deep route is the yardstick
    mg_routes = {(scene, cg): (tet100k if scene == "tet100k" else cloth100k)(
        cg, torch.float32, amg=True) for scene, cg in MG_ROUTES}
    reset_launches()
    mg_runs = {}
    for (scene, cg), s in mg_routes.items():
        if s._stepper is None or s._stepper.cfg.mg is None:
            raise AssertionError(f"{scene} mg{cg}: the multigrid route did "
                                 "not engage")
        run = pbs.banded_rollout if scene == "tet100k" else pcs.cloth_rollout
        n0 = (run.launches, run.ops)
        mg_runs[(scene, cg)] = (*drive(torch, s), run.launches - n0[0],
                                run.ops - n0[1])
    launches["banded_mg"] = pbs.banded_rollout.launches
    launches["cloth_mg"] = pcs.cloth_rollout.launches
    off_path(*(k for k in KERNELS
               if k not in (pbs.banded_rollout, pcs.cloth_rollout)))
    sens = {}
    for scene, cg in MG_ROUTES:
        p = (tet100k if scene == "tet100k" else cloth100k)(
            cg, torch.float32, amg=True)
        p.x = p._x + 1e-6 * np.random.default_rng(1).standard_normal(
            p._x.shape)
        p.run(steps)
        sens[(scene, cg)] = float(np.abs(p.x - mg_routes[(scene, cg)].x).max())
        del p
    trusted = {"tet100k": ("banded cg75", tet75_ref, banded_ms[75]),
               "cloth100k": ("cloth cg300", cloth300_x, cloth_runs[300][0])}
    deep = {}
    for scene, name, make in (
            ("tet100k", "banded cg300",
             lambda: tet100k(300, torch.float32, fast=True)),
            ("cloth100k", "cloth cg1200",
             lambda: cloth100k(1200, torch.float32))):
        p = make()
        p.run(steps)
        deep[scene] = (name, p.x)
        del p
    control = {}
    for scene in deep:
        p = (tet100k(MG_CONTROL_CG, torch.float32, fast=True)
             if scene == "tet100k" else cloth100k(MG_CONTROL_CG,
                                                  torch.float32))
        p.run(steps)
        control[scene] = float(np.abs(p.x - deep[scene][1]).max())
        del p
    bad = []
    for (scene, cg), (med, windows, n_launch, n_ops) in mg_runs.items():
        s = mg_routes[(scene, cg)]
        fin, drift, sag = (beam_trajectory if scene == "tet100k"
                           else cloth_trajectory)(s)
        name, ref_x, ref_ms = trusted[scene]
        dx = float(np.abs(s.x - ref_x).max())
        deep_name, deep_x = deep[scene]
        dx_deep = float(np.abs(s.x - deep_x).max())
        jacobi_deep = float(np.abs(ref_x - deep_x).max())
        per_step = (2 if scene == "tet100k" else 3) + 3 * ADMM_ITERS
        want = WARMUP_STEPS + WINDOWS
        say(f"{scene} mg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            levels=s._stepper.mg_levels, submissions=n_launch,
            expected_submissions=want, device_ops_per_step=n_ops / steps,
            anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_matched_jacobi_m=dx, trusted=name,
            max_abs_dx_vs_deep_jacobi_m=dx_deep, deep=deep_name,
            matched_jacobi_vs_deep_m=jacobi_deep,
            control=f"jacobi cg{MG_CONTROL_CG}",
            control_vs_deep_m=control[scene],
            limit_m=MG_DX_LIMIT_M[scene],
            perturbed_start_divergence_m=sens[(scene, cg)], finite=fin)
        say(f"mg routes {scene} mg{cg} f32 (this call)",
            jacobi_matched_ms_per_step=ref_ms, jacobi_matched=name,
            mg_ms_per_step=med)
        if n_launch != want or n_ops != steps * per_step:
            bad.append(f"{scene} mg{cg}: {n_launch} submissions of {n_ops} "
                       f"launches, expected {want} of {steps * per_step}")
        if not (fin and drift < 1e-4 and sag < 0
                and dx_deep <= MG_DX_LIMIT_M[scene]):
            bad.append(f"{scene} mg{cg}: bad trajectory ({dx_deep} m from "
                       f"{deep_name}, over {MG_DX_LIMIT_M[scene]} m)")
    if bad:
        raise AssertionError("multigrid routes: " + "; ".join(bad))
    for (scene, cg), s in mg_routes.items():
        check_window_ops(trace(cg, "fast", s, scene=scene),
                         f"{scene} mg{cg}",
                         (2 if scene == "tet100k" else 3) + 3 * ADMM_ITERS)
    del mg_routes, tet75_ref, cloth300_x, deep

    # phase 5d: delaunay100k on the banded route (ELL matvec) and on the
    # general ell route with each CG backend, f32
    d_routes = {}
    for cg in DELAUNAY_BUDGETS:
        d_routes[("banded", cg)] = delaunay100k(cg, fast=True)
        for backend in ("xla", "fused", "kernel"):
            d_routes[(backend, cg)] = delaunay100k(cg, fast=False,
                                                   cg_backend=backend)
    d_runs = {}
    for (route, cg), s in d_routes.items():
        reset_launches()
        med, windows = drive(torch, s)
        d_runs[(route, cg)] = (med, windows,
                               {k.__name__: k.launches for k in KERNELS})
    sens = {}
    for cg in DELAUNAY_BUDGETS:
        p = delaunay100k(cg, fast=False)
        p.x = p._x + 1e-6 * np.random.default_rng(1).standard_normal(
            p._x.shape)
        p.run(steps)
        sens[cg] = float(np.abs(p.x - d_routes[("xla", cg)].x).max())
        del p
    # the anchors are soft penalties on an irregular face and drift ~2e-4
    # m in 32 steps here, so the limit is 1e-3 m (1e-4 m on the beam)
    bad = []
    for (route, cg), (med, windows, counts) in d_runs.items():
        s = d_routes[(route, cg)]
        x = s.x
        anchored = np.flatnonzero(s._x[:, 0] < s._x[:, 0].min() + 0.025)
        drift = float(np.abs(x[anchored] - s._x[anchored]).max())
        sag = float((x[:, 1] - s._x[:, 1]).min())
        vs_xla = float(np.abs(x - d_routes[("xla", cg)].x).max())
        per_step = {k: v / steps for k, v in counts.items() if v}
        say(f"delaunay100k {route} cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            launches_per_step=per_step, anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_general_xla_m=vs_xla,
            general_xla_vs_perturbed_m=sens[cg],
            finite=bool(np.isfinite(x).all()))
        want = {k.__name__: 0 for k in KERNELS}
        if route == "banded":
            want["banded_rollout"] = WARMUP_STEPS + WINDOWS
        else:
            want["nh_local_step_fused"] = steps * ADMM_ITERS
            if route == "fused":
                want["cg_update"] = steps * ADMM_ITERS * cg
            elif route == "kernel":
                want["cg_ell_solve"] = steps * ADMM_ITERS
        if counts != want:
            bad.append(f"{route} cg{cg}: launches {counts}, expected {want}")
        if not (np.isfinite(x).all() and drift < 1e-3 and sag < 0
                and vs_xla <= max(1e-3, 10.0 * sens[cg])):
            bad.append(f"{route} cg{cg}: bad trajectory")
    if bad:
        raise AssertionError("delaunay100k: " + "; ".join(bad))
    say("delaunay100k routes f32 (this call, ms/step)",
        **{f"{route}_cg{cg}": run[0] for (route, cg), run in d_runs.items()})
    for route, cg in (("banded", 25), ("banded", 75), ("kernel", 25),
                      ("kernel", 75), ("fused", 25), ("xla", 25)):
        out = trace(cg, "fast" if route == "banded" else "general",
                    d_routes[(route, cg)], scene="delaunay100k")
        if route == "banded":
            check_window_ops(out, f"delaunay100k banded-ELL cg{cg}")

    def launches_of(route, name):
        return sum(run[2][name] for (r, _), run in d_runs.items()
                   if r == route)

    launches["cg_update"] = launches_of("fused", "cg_update")
    launches["cg_ell"] = launches_of("kernel", "cg_ell_solve")
    launches["banded_ell"] = launches_of("banded", "banded_rollout")
    del d_routes

    # phase 5k: delaunay100k on the banded-ELL route with the in-kernel
    # algebraic multigrid (uamg6, uamg8) and on the general route's AMG
    launches["banded_uamg"] = uamg_routes(torch, steps)

    # phase 5l: the scenario sweep at sweep64's full width, ELL and dia,
    # beside the single-scenario route, and at 1,024 scenarios
    launches["sweep"], sweep32 = sweep_routes(torch, steps)

    # phase 5e: the unfused pipeline at full width, f32: tet100k on the
    # dense mode, arap100k on dia (fused) at cg25/cg75 and with relaxation
    # 1.6 (unfused), cloth100k on the matrix-free cg mode at cg25
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = tet100k(25, torch.float32, global_solver="dense")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = assemble_A_hat(dense.n_nodes, dense.masses, DT,
                       dense._cparams(dense._params_host))
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A_inv = dense_inverse(A, torch.float32, "cuda")
    torch.cuda.synchronize()
    inverse_s = time.perf_counter() - t0
    b = dense._masses_dev[:, None] * dense.state["x"]
    matmul_ms = cuda_ms(torch, lambda: A_inv @ b, 10, batch=20)
    mm_bound, mm_by = roofline_ms(nbytes(A_inv, b, b),
                                  2 * dense.n_nodes ** 2 * 3)
    same = bool(torch.equal(A_inv, dense.params["_solver"]["A_inv"]))
    say("dense inverse tet100k f32", n=dense.n_nodes,
        inverse_gb=A_inv.numel() * 4 / 1e9, system_init_s=init_s,
        host_assembly_s=assemble_s, inverse_on_card_s=inverse_s,
        same_as_system=same, matmul_ms=matmul_ms, matmul_bound_ms=mm_bound,
        matmul_bound_by=mm_by,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del A, A_inv
    if not same:
        raise AssertionError("dense inverse: not repeatable on the card")

    routes = {
        "tet100k dense": (dense, {"nh_local_step": 1}),
        "arap100k cg25": (arap100k(25), {"arap_local_step_fused": 1,
                                         "cg_dia_solve": 1}),
        "arap100k cg75": (arap100k(75), {"arap_local_step_fused": 1,
                                         "cg_dia_solve": 1}),
        "arap100k relax1.6 cg25": (arap100k(25, relaxation=1.6),
                                   {"arap_local_step": 1, "cg_dia_solve": 1}),
        "cloth100k cg cg25": (cloth100k(25, fast=False, global_solver="cg"),
                              {"tri_local_step": 1}),
    }
    u_runs = {}
    for label, (s, per_iter) in routes.items():
        reset_launches()
        med, windows = drive(torch, s)
        counts = {k.__name__: k.launches for k in KERNELS}
        u_runs[label] = (med, windows, counts)
        want = {k.__name__: 0 for k in KERNELS}
        want.update({k: steps * ADMM_ITERS * n for k, n in per_iter.items()})
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want}")

    # the witnesses: each new route against a route the port trusts at
    # cg75, beside the new route's own divergence from a start moved by
    # 1e-6 m. The relaxed route runs cg25, and on this stiff beam the
    # budget alone moves a trajectory by centimetres; over-relaxation on so
    # truncated a solve overshoots further, so its bound is twice the plain
    # cg25 route's distance, and its soft anchors drift like delaunay100k's
    # (1e-3 m)
    def perturbed(s):
        s.x = s._x + 1e-6 * np.random.default_rng(1).standard_normal(
            s._x.shape)
        s.run(steps)
        return s.x

    arap75_x = routes["arap100k cg75"][0].x
    # phase 5g's trusted routes, at the same 32 steps (profiling steps on)
    general_arap_x = {cg: routes[f"arap100k cg{cg}"][0].x for cg in (25, 75)}
    witness = {
        "tet100k dense": (tet75_x, perturbed(tet100k(
            25, torch.float32, global_solver="dense")), None),
        "arap100k relax1.6 cg25": (arap75_x, perturbed(
            arap100k(25, relaxation=1.6)), float(np.abs(
                routes["arap100k cg25"][0].x - arap75_x).max())),
    }
    bad = []
    for label, (s, _) in routes.items():
        relaxed = "relax" in label
        med, windows, counts = u_runs[label]
        fin, drift, sag = (cloth_trajectory(s) if label.startswith("cloth")
                           else beam_trajectory(s))
        extra = {}
        if label in witness:
            trusted, pert, budget = witness[label]
            extra = dict(max_abs_dx_vs_trusted_m=float(
                np.abs(s.x - trusted).max()),
                perturbed_start_divergence_m=float(np.abs(s.x - pert).max()))
            if budget is not None:
                extra["plain_cg25_vs_trusted_m"] = budget
        say(f"{label} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            launches_per_step={k: v / steps for k, v in counts.items() if v},
            anchor_drift_m=drift, min_dy_m=sag, finite=fin, **extra)
        if not (fin and drift < (1e-3 if relaxed else 1e-4) and sag < 0):
            bad.append(f"{label}: bad trajectory")
        if extra and extra["max_abs_dx_vs_trusted_m"] > max(
                1e-3, 10.0 * extra["perturbed_start_divergence_m"],
                2.0 * extra.get("plain_cg25_vs_trusted_m", 0.0)):
            bad.append(f"{label}: {extra['max_abs_dx_vs_trusted_m']} m from "
                       "the trusted route")
    if bad:
        raise AssertionError("unfused routes: " + "; ".join(bad))
    say("unfused routes f32 (this call, ms/step)",
        **{k.replace(" ", "_"): v[0] for k, v in u_runs.items()})
    for label, (s, _) in routes.items():
        trace(25, "general", s, 2 if label.startswith("cloth") else None,
              scene=label)

    def launches_u(label, name):
        return u_runs[label][2][name]

    launches["nh_local_step"] = launches_u("tet100k dense", "nh_local_step")
    launches["arap_fused"] = (launches_u("arap100k cg25",
                                         "arap_local_step_fused")
                              + launches_u("arap100k cg75",
                                           "arap_local_step_fused"))
    launches["arap_step"] = launches_u("arap100k relax1.6 cg25",
                                       "arap_local_step")
    launches["tri_local_step"] = launches_u("cloth100k cg cg25",
                                            "tri_local_step")
    del routes, witness, dense

    # phase 5g: arap100k on the banded route (the kernel's arap mode), f32,
    # against the general arap route of phase 5e at the same budget and at
    # cg75
    afast = {cg: arap100k(cg, fast=True) for cg in (75, 25)}
    reset_launches()
    a_runs = {}
    for cg, s in afast.items():
        if not (isinstance(s._stepper, BandedStepper)
                and s._stepper.cfg.model == "arap"):
            raise AssertionError(f"arap100k cg{cg}: the banded arap mode did "
                                 "not engage")
        n0 = pbs.banded_rollout.launches
        a_runs[cg] = (*drive(torch, s), pbs.banded_rollout.launches - n0)
    launches["banded_arap"] = pbs.banded_rollout.launches
    off_path(*(k for k in KERNELS if k is not pbs.banded_rollout))
    sens = {cg: float(np.abs(perturbed(arap100k(cg, fast=True))
                             - afast[cg].x).max()) for cg in afast}
    for cg, (med, windows, n_launch) in a_runs.items():
        s = afast[cg]
        fin, drift, sag = beam_trajectory(s)
        vs_same = float(np.abs(s.x - general_arap_x[cg]).max())
        want = WARMUP_STEPS + WINDOWS
        say(f"arap100k banded cg{cg} f32", ms_per_step_median=med,
            windows_ms=[round(w, 4) for w in windows],
            spread_ms=max(windows) - min(windows), steps=steps,
            submissions=n_launch, expected_submissions=want,
            anchor_drift_m=drift, min_dy_m=sag,
            max_abs_dx_vs_general_same_budget_m=vs_same,
            max_abs_dx_vs_general_cg75_m=float(
                np.abs(s.x - general_arap_x[75]).max()),
            perturbed_start_divergence_m=sens[cg], finite=fin)
        say(f"arap100k routes cg{cg} f32 (this call)",
            general_ms_per_step=u_runs[f"arap100k cg{cg}"][0],
            banded_ms_per_step=med)
        if n_launch != want:
            raise AssertionError(f"arap100k banded cg{cg}: {n_launch} "
                                 f"window submissions, expected {want}")
        if not (fin and drift < 1e-4 and sag < 0
                and vs_same <= max(1e-3, 10.0 * sens[cg])):
            raise AssertionError(f"arap100k banded cg{cg}: bad trajectory "
                                 f"({vs_same} m from the general route)")
    for cg, s in afast.items():
        check_window_ops(trace(cg, "fast", s, scene="arap100k"),
                         f"arap100k banded cg{cg}")
    del afast, general_arap_x

    # phase 5j: residuals at full width on every collecting route, f32;
    # iteration 0's dual residual by both forms of its seed
    residual_launches, _ = residual_routes(torch)
    seed_forms(torch, tet100k(25, torch.float32, fast=True)._stepper,
               "banded", "tet100k")
    seed_forms(torch, cloth100k(25, torch.float32)._stepper, "cloth",
               "cloth100k")

    # phase 5m: the default element backend ('xla'), general and fast
    default_backend_routes(torch)

    # phase 5n: runtime edits (poordillo's grab, drag and release) and
    # checkpoints, general route, banded window, sharded stepper
    runtime_edits(torch)

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
        entry("cg_update", "cg_step.cu", "cg_step.py:51",
              launches["cg_update"], *upd32),
        entry("cg_ell_solve", "cg_ell.cu", "cg_ell.py:86", launches["cg_ell"],
              *ell_ms[(torch.float32, 25)]),
        entry("banded_rollout[ell]", "banded_step.cu", "banded_step.py:1090",
              launches["banded_ell"], *bandedell32),
        entry("nh_local_step", "nh_local.cu", "nh_local.py:466",
              launches["nh_local_step"], *nhstep32),
        entry("tri_local_step", "tri_local.cu", "tri_local.py:206",
              launches["tri_local_step"], *tristep32),
        entry("arap_local_step_fused", "tet_local.cu", "tet_local.py:265",
              launches["arap_fused"], *arapf32),
        entry("arap_local_step", "tet_local.cu", "tet_local.py:289",
              launches["arap_step"], *arap32),
        entry("lattice_rollout", "lattice_step.cu", "lattice_step.py:439",
              launches["lattice"], *lattice32),
        entry("banded_rollout[arap]", "banded_step.cu", "banded_step.py:1090",
              launches["banded_arap"], *bandedarap32),
        entry("banded_local_rhs", "banded_local.cu", "banded_local.py:335",
              launches["banded_local"], *local32[torch.float32]),
        entry("cheb_dia_chunk", "cheb_dia.cu", "cheb_dia.py:112",
              launches["cheb"], *cheb32[(torch.float32, "whole cheb180")]),
        entry("banded_rollout[mg]", "mg_vcycle.cuh", "banded_step.py:1090",
              launches["banded_mg"], *mg_full["tet100k mg8"]),
        entry("cloth_rollout[mg]", "mg_vcycle.cuh", "cloth_step.py:746",
              launches["cloth_mg"], *mg_full["cloth100k mg8"]),
        entry("banded_rollout[uamg]", "mg_vcycle.cuh", "banded_step.py:1090",
              launches["banded_uamg"], *uamg_window),
        entry("banded_rollout[sweep]", "banded_step.cu", "banded_step.py:1090",
              launches["sweep"], *sweep32),
        # the residual modes (phase 5j's launches; 3p and 3q's numbers)
        entry("nh_local_step_fused[emit_z]", "nh_local.cu",
              "nh_local.py:442", residual_launches["nh"], *emitz["nh"]),
        entry("arap_local_step_fused[emit_z]", "tet_local.cu",
              "tet_local.py:265", residual_launches["arap"], *emitz["arap"]),
        entry("tri_local_step_fused[emit_z]", "tri_local.cu",
              "tri_local.py:245", residual_launches["tri"], *emitz["tri"]),
        entry("banded_rollout[collect]", "banded_step.cu",
              "banded_step.py:1090", residual_launches["banded"],
              *residual_banded),
        entry("banded_local_rhs[collect]", "banded_local.cu",
              "banded_local.py:335", residual_launches["local"],
              *local_collect32),
        entry("cloth_rollout[collect]", "cloth_step.cu", "cloth_step.py:746",
              residual_launches["cloth"], *residual_full["cloth"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
