"""Where a timestep's time goes on the card: torch.profiler over a few
steps of the 100k-tet beam or the cloth100k sheet (the `chip_smoke.py`
main paths).

    python -m admm_elastic_tpu_torch.utils.profile_step [--cg 25 75]
        [--steps 10] [--route general|fast] [--scene tet100k|cloth100k]

`--route general` (the default) steps the general route; `--route fast`
steps the scene's whole-timestep route (`lattice_fast_path=True`: the
banded kernel for tet100k, the cloth kernel for cloth100k), where `steps`
= 10 is one kernel launch. For each CG budget it times `steps`
steps twice in one process, each window closed by
`torch.cuda.synchronize()`: first without the profiler, then under it,
tracing the device only. It prints one line: both windows' wall ms/step,
the profiled window's device-busy ms/step (the union of its kernel and
memcpy intervals) and idle share (1 - busy/wall, both from that same
window), and device operations per step; then the kernels with the most
device time. A traced window that lost a record of one of the port's own
kernels is traced again (at most 3 times); the line says how often, and
how many records the last window still lost. The profiled wall carries
the tracer's own cost, so its idle share is an upper bound for the
unprofiled run. Needs a CUDA device; fails if the profiler records no
device activity.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.kernels import banded_step, cloth_step, nh_local, tri_local
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


SCENES = ("tet100k", "cloth100k")
ATTEMPTS = 3
# the entry kernels of the port's one-launch-per-call wrappers
_OWN = ("void admm::nh::fused_kernel", "void admm::tri::fused_kernel",
        "void admm::banded::rollout_kernel", "void admm::cloth::rollout_kernel")


def _own_launches():
    return sum(k.launches for k in (
        nh_local.nh_local_step_fused, tri_local.tri_local_step_fused,
        banded_step.banded_rollout, cloth_step.cloth_rollout))


def profile(cg, steps, route="general", s=None, scene="tet100k") -> dict:
    """Profile `steps` steps of the scene (or of the given System `s`) and
    print and return the numbers."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if s is None:
        s = getattr(scenes, scene)(cg, fast=route == "fast")
        s.run(2)
    plain_ms = _window_ms(s, steps)
    # the tracer can drop kernel records (seen after traces of tens of
    # thousands of launches in one process): the window is traced again,
    # up to ATTEMPTS times, until every launch of the port's own kernels
    # (their launch counters) has its record
    for attempt in range(1, ATTEMPTS + 1):
        n0 = _own_launches()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_ms = _window_ms(s, steps)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        lost = (_own_launches() - n0
                - sum(e.name.startswith(_OWN) for e in dev))
        if lost <= 0:
            break
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev]) / 1e3 / steps
    per_name = {}
    for e in dev:
        c, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (c + 1, t + (e.time_range.end - e.time_range.start))
    out = {"unprofiled_wall_ms_per_step": plain_ms,
           "profiled_wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops_per_step": len(dev) / steps,
           "traced_windows": attempt, "lost_kernel_records": max(lost, 0)}
    print(f"[profile {scene} {route} cg{cg}] "
          + " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (count, us) in top:
        print(f"  {us / 1e3 / steps:9.4f} ms/step {count / steps:7.1f}/step "
              f"{name[:90]}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cg", type=int, nargs="+", default=[25, 75])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--route", choices=("general", "fast"), default="general")
    ap.add_argument("--scene", choices=SCENES, default="tet100k")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    for cg in args.cg:
        profile(cg, args.steps, args.route, scene=args.scene)


if __name__ == "__main__":
    main()
