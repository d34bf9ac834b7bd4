"""Where a timestep's time goes on the card: torch.profiler over a few
steps of the 100k-tet beam, the cloth100k sheet or the delaunay100k mesh
(the `chip_smoke.py` main paths), or of any System given to `profile`.

    python -m admm_elastic_tpu_torch.utils.profile_step [--cg 25 75]
        [--steps 10] [--route general|fast|lattice|sharded]
        [--solver cg|cheb] [--scene tet100k|cloth100k|delaunay100k]
        [--cg-backend xla|fused|kernel] [--amg]
        [--collect none|primal|full]

`--route general` (the default) steps the general route; `--route fast`
steps the scene's whole-timestep route (`lattice_fast_path=True`: the
banded window for tet100k and delaunay100k, the cloth window for
cloth100k), where `steps` = 10 is one submission (one CUDA graph of 2 + 3
admm_iters launches a step, 3 + 3 admm_iters for the cloth with wind);
`--route lattice`
steps tet100k on the lattice kernel (the cg global mode with
`lattice_fast_path=True`); `--route sharded` steps tet100k on the sharded
banded stepper at one device (`scenes.tet100k_sharded`) with `--solver`
cg or cheb, whose budgets `--cg` then gives. `--cg-backend` picks
delaunay100k's ell CG on the general route (the other scenes run dia).
`--amg` steps the scene with `preconditioner="amg"`, `--cg` V-cycle PCG
iterations a solve: with `--route fast` tet100k or cloth100k on its
whole-timestep route with the in-kernel geometric multigrid, delaunay100k
on the banded-ELL route with the in-kernel algebraic one; with `--route
general` delaunay100k on the general ell route (xla) with the aggregation
AMG. `--collect` turns on residual collection
(`collect_residuals`: "primal", or both residuals with "full"; the
sharded stepper takes "primal" only).
For each CG budget it times `steps` steps twice in one process, each
window closed by `torch.cuda.synchronize()`: first without the profiler,
then under it, tracing the device only. It prints one line: both windows' wall ms/step,
the profiled window's device-busy ms/step (the union of its kernel and
memcpy intervals) and idle share (1 - busy/wall, both from that same
window), and device operations per step; then the kernels with the most
device time. A traced window that lost a record of one of the port's own
kernels is traced again (at most 5 times); the line says how often, and
how many records the last window still lost. The profiled wall carries
the tracer's own cost, so its idle share is an upper bound for the
unprofiled run. The tracer can also return a window with no device
record at all; if every attempt does, the device numbers are printed as
"not measured" (None in the returned dict) and the command exits 1.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from ..ops.kernels import (banded_local, banded_step, cg_dia, cg_ell,
                           cheb_dia, cloth_step, lattice_step, mg, nh_local,
                           tet_local, tri_local, uamg)
from . import scenes


def _union_us(intervals):
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _window_ms(s, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(steps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


SCENES = ("tet100k", "cloth100k", "delaunay100k")
ATTEMPTS = 5
# the entry kernels of the port's wrappers, one per call (banded_local_rhs
# launches an element kernel and then this vertex kernel), and every
# kernel of the banded, lattice and cloth windows
_OWN = tuple(f"void admm::{ns}::{k}_kernel"
             for ns in ("nh", "tri", "arap") for k in ("fused", "step")) + (
    "void admm::banded::", "void admm::cloth::",
    "void admm::lattice::", "void admm::window::",
    "void admm::banded_local::vertex_kernel",
    "void admm::cheb::chunk_kernel", "void admm::cluster_pcg::solve_kernel",
    "void admm::mg::solve_kernel")


def _own_launches():
    """Launches of the port's own kernels so far: one a call of each
    wrapper, and each launch a banded, lattice or cloth window holds."""
    return sum(k.launches for k in (
        nh_local.nh_local_step_fused, nh_local.nh_local_step,
        tri_local.tri_local_step_fused, tri_local.tri_local_step,
        tet_local.arap_local_step_fused, tet_local.arap_local_step,
        banded_local.banded_local_rhs, cheb_dia.cheb_dia_chunk,
        cg_dia.cg_dia_solve, cg_ell.cg_ell_solve, mg.mg_dia_solve,
        uamg.uamg_ell_solve)) + sum(
        k.ops for k in (banded_step.banded_rollout,
                        lattice_step.lattice_rollout,
                        cloth_step.cloth_rollout))


# CUgraphNodeType (cuda.h)
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "event wait", 7: "event record"}


def call_ops(fn) -> dict:
    """Device operations that one call of fn() (a kernel wrapper on its
    inputs) enqueues, and their kinds: the nodes of a CUDA graph that
    captures the call, after one call outside the capture. Unlike a trace,
    this cannot lose a record."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())

    def check(res, what):
        if res != 0:
            raise RuntimeError(f"{what}: CUresult {res}")

    count = ctypes.c_size_t(0)
    check(driver.cuGraphGetNodes(handle, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(driver.cuGraphNodeGetType(ctypes.c_void_p(node),
                                        ctypes.byref(kind)),
              "cuGraphNodeGetType")
        kinds.append(_NODE_KINDS.get(kind.value, str(kind.value)))
    return {"device_ops_per_call": float(count.value),
            "kinds": sorted(set(kinds))}


COLLECT = {"none": False, "primal": "primal", "full": True}


def set_collect(s, mode):
    """Turn a System's (or a sharded stepper's) residual collection to
    mode, a collect_residuals value (False, "primal" or True): its
    whole-timestep stepper's, else its Settings'."""
    from ..parallel import ShardedBandedStepper

    if isinstance(s, ShardedBandedStepper):
        s.collect_residuals = bool(mode)
    elif s._stepper is not None:
        s._stepper.collect_residuals = mode
    else:
        s.settings.collect_residuals = mode


def profile(cg, steps, route="general", s=None, scene="tet100k",
            cg_backend="xla", solver="cg", amg=False,
            collect="none") -> dict:
    """Profile `steps` steps of the scene (or of the given System or
    stepper `s`) and print and return the numbers. amg: the scene on its
    whole-timestep route with the in-kernel multigrid. collect: a key of
    COLLECT, the residuals the scene's own build collects."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if s is None and route == "sharded":
        if scene != "tet100k":
            raise ValueError("--route sharded steps tet100k")
        if collect == "full":
            raise ValueError("the sharded stepper collects 'primal' only")
        s = scenes.tet100k_sharded(solver, cg)
        set_collect(s, COLLECT[collect])
        s.run(2)
    elif s is None:
        kw = {"cg_backend": cg_backend} if scene == "delaunay100k" else {}
        if amg:
            if route not in ("fast", "general") or (
                    route == "general" and scene != "delaunay100k"):
                raise ValueError("--amg steps a scene on --route fast, or "
                                 "delaunay100k on --route general")
            kw["amg"] = True
        if route == "lattice":
            if scene != "tet100k":
                raise ValueError("--route lattice steps tet100k")
            kw["global_solver"] = "cg"
        s = getattr(scenes, scene)(cg, fast=route != "general", **kw)
        set_collect(s, COLLECT[collect])
        s.run(2)
    plain_ms = _window_ms(s, steps)
    # the tracer can drop kernel records (seen after traces of tens of
    # thousands of launches in one process), or every record of a window:
    # the window is traced again, up to ATTEMPTS times, until every launch
    # of the port's own kernels (their launch counters) has its record.
    # The last window with any device record is the one reported
    dev, wall_ms, lost = [], None, 0
    for attempt in range(1, ATTEMPTS + 1):
        n0 = _own_launches()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            window_ms = _window_ms(s, steps)
        got = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got or not dev:
            dev, wall_ms = got, window_ms
            lost = (_own_launches() - n0
                    - sum(e.name.startswith(_OWN) for e in dev))
        if dev and lost <= 0:
            break
    busy_ms = (_union_us([(e.time_range.start, e.time_range.end)
                          for e in dev]) / 1e3 / steps if dev else None)
    per_name = {}
    for e in dev:
        c, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (c + 1, t + (e.time_range.end - e.time_range.start))
    out = {"unprofiled_wall_ms_per_step": plain_ms,
           "profiled_wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "device_ops_per_step": len(dev) / steps if dev else None,
           "traced_windows": attempt, "lost_kernel_records": max(lost, 0)}
    label, budget = route, f"cg{cg}"
    if collect != "none":
        label = f"{label} collect={collect}"
    mg_cfg = getattr(getattr(getattr(s, "_stepper", None), "cfg", None),
                     "mg", None)
    if mg_cfg is not None:
        budget = f"{'ua' if isinstance(mg_cfg, uamg.UAMGConfig) else ''}mg{cg}"
    if route == "general" and s._solver_mode == "ell":
        label = f"general {s.settings.cg_backend}"
        if "amg" in s.params["_solver"]:
            budget = f"amg{cg}"
    elif route == "sharded":
        budget = f"{s.solver}{cg}"
    print(f"[profile {scene} {label} {budget}] "
          + " ".join(f"{k}={'not measured' if v is None else v}"
                     for k, v in out.items()), flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (count, us) in top:
        print(f"  {us / 1e3 / steps:9.4f} ms/step {count / steps:7.1f}/step "
              f"{name[:90]}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cg", type=int, nargs="+", default=[25, 75])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--route", choices=("general", "fast", "lattice",
                                        "sharded"), default="general")
    ap.add_argument("--solver", choices=("cg", "cheb"), default="cg")
    ap.add_argument("--scene", choices=SCENES, default="tet100k")
    ap.add_argument("--cg-backend", choices=("xla", "fused", "kernel"),
                    default="xla")
    ap.add_argument("--amg", action="store_true",
                    help="preconditioner='amg': the in-kernel multigrid "
                         "(--route fast), the general AMG (--route general)")
    ap.add_argument("--collect", choices=tuple(COLLECT), default="none",
                    help="collect the residuals of each ADMM iteration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    outs = [profile(cg, args.steps, args.route, scene=args.scene,
                    cg_backend=args.cg_backend, solver=args.solver,
                    amg=args.amg, collect=args.collect)
            for cg in args.cg]
    if any(o["device_busy_ms_per_step"] is None for o in outs):
        raise SystemExit("profile_step: the profiler recorded no device "
                         "activity")


if __name__ == "__main__":
    main()
