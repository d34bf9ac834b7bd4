"""Times the whole-timestep routes of the port found under a given root, so
that two checkouts (a commit and its parent) are timed one after the other
on the same card, each in a process of its own.

    python admm_elastic_tpu_torch/utils/time_rollouts.py --root DIR \\
        --label NAME [--out JSONL] [--save DIR] [--cg 25 75]
        [--scenes NAME ...] [--collect none|primal|full]

For each scene and CG budget (f32) it builds the System with that
checkout's `utils/scenes.py` and steps it as `chip_smoke.py` drives a
route: 2 single steps, then 3 windows of 10 steps, each timed on the host
clock around work that ends in a synchronize. It prints one JSON line a
scene and budget: the median ms/step, the windows, the spread, and
whether the positions are finite. The scenes, at the `--cg` budgets:
tet100k on the banded route (`lattice_fast_path=True`, dia) and on the
lattice route (the cg global mode), arap100k on the banded route's arap
mode, delaunay100k on the banded route's ELL mode, and tet100k's beam
made 4 times longer (160 x 25 x 20 cells, 87,906 nodes, 200 kg) on the
banded route; tet100k on the sharded banded stepper at one device with
the cluster CG solve, and delaunay100k on the general ell route with the
fused CG update (`cg_backend="fused"`, one `cg_update` a CG iteration);
and at budgets of their own: cloth100k on the cloth route (cg25, and
cg300, its matched Jacobi budget), tet100k on the sharded banded stepper
with the Chebyshev solve (cheb180), and sweep64 (64 scenarios of one
beam on the banded window's sweep mode, ELL, its preset's cg12); with
the in-kernel multigrid (`preconditioner="amg"`), tet100k on the banded
route at mg6 and mg8 and cloth100k on the cloth route at mg8; with the
algebraic multigrids (`--scenes uamg`), delaunay100k on the banded-ELL
route at uamg6 and uamg8 and on the general ell route's aggregation AMG
at 6 (a checkout before them has neither: leave them out there); and
the general route (`--scenes general`: no whole-timestep stepper, the
element steps through `nh_local_step_fused` or `nh_local_step`, and
`arap_local_step_fused` or `arap_local_step`): tet100k on dia at the
`--cg` budgets, on the dense inverse and with `relaxation=1.6` (cg25),
delaunay100k on ell with the cg_ell kernel (cg25), and arap100k on dia
at the `--cg` budgets and with `relaxation=1.6` (cg25).
`--scenes` keeps the scenes whose names start with one of its words.
`--collect` turns on residual collection on every route ("primal", or
"full": both residuals; the sharded stepper collects "primal" only, and
its line says so); a checkout without it (before the residual modes)
raises there.
With `--save` the positions after the 32 steps go to
DIR/LABEL_SCENE_cgN.npy (a label holds no "_"), so that two checkouts'
trajectories can be held against each other:

    python admm_elastic_tpu_torch/utils/time_rollouts.py --compare DIR

prints, for each scene and budget saved in DIR, whether each label's
positions equal the first label's (in sorted order) bit for bit, then
ALL_BITWISE or NOT_BITWISE, and exits 1 unless all are. Timing needs a
CUDA device; the comparison does not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

WARMUP, WINDOWS, STEPS = 2, 3, 10


def _scenes(scenes, torch, budgets):
    """name: (build(cg), budgets)."""
    f32 = torch.float32
    return {
        "tet100k banded": (lambda cg: scenes.tet100k(cg, f32, fast=True),
                           budgets),
        "tet100k lattice": (lambda cg: scenes.tet100k(
            cg, f32, fast=True, global_solver="cg"), budgets),
        "arap100k banded": (lambda cg: scenes.arap100k(cg, f32, fast=True),
                            budgets),
        "delaunay100k banded-ELL": (lambda cg: scenes.delaunay100k(
            cg, f32, fast=True), budgets),
        "beam 160x25x20 banded": (lambda cg: scenes.beam_system(
            (160, 25, 20), 0.05, 200.0, cg, f32, fast=True), budgets),
        "cloth100k cloth": (lambda cg: scenes.cloth100k(cg, f32, fast=True),
                            (25, 300)),
        "tet100k sharded cheb": (lambda cg: scenes.tet100k_sharded(
            "cheb", cg, f32), (180,)),
        "tet100k sharded cg": (lambda cg: scenes.tet100k_sharded(
            "cg", cg, f32), budgets),
        "delaunay100k general fused": (lambda cg: scenes.delaunay100k(
            cg, f32, fast=False, cg_backend="fused"), budgets),
        "sweep64 ell": (lambda cg: scenes.sweep64(), (12,)),
        "mg tet100k banded": (lambda cg: scenes.tet100k(cg, f32, amg=True),
                              (6, 8)),
        "mg cloth100k cloth": (lambda cg: scenes.cloth100k(cg, f32,
                                                           amg=True), (8,)),
        "uamg delaunay100k banded-ELL": (lambda cg: scenes.delaunay100k(
            cg, f32, amg=True), (6, 8)),
        "uamg delaunay100k general": (lambda cg: scenes.delaunay100k(
            cg, f32, fast=False, amg=True), (6,)),
        "general tet100k dia": (lambda cg: scenes.tet100k(cg, f32),
                                budgets),
        "general tet100k dense": (lambda cg: scenes.tet100k(
            cg, f32, global_solver="dense"), (25,)),
        "general tet100k relaxation1.6": (lambda cg: scenes.beam_system(
            (40, 25, 20), 0.05, 50.0, cg, f32, relaxation=1.6), (25,)),
        "general delaunay100k ell": (lambda cg: scenes.delaunay100k(
            cg, f32, fast=False, cg_backend="kernel"), (25,)),
        "general arap100k dia": (lambda cg: scenes.arap100k(cg, f32),
                                 budgets),
        "general arap100k relaxation1.6": (lambda cg: scenes.arap100k(
            cg, f32, relaxation=1.6), (25,)),
    }


def time_root(root, label, out_path, save, budgets, only=None,
              collect="none"):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import admm_elastic_tpu_torch as pkg
    from admm_elastic_tpu_torch.utils import scenes

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    card = torch.cuda.get_device_name(0)
    lines = []
    for name, (build, cgs) in _scenes(scenes, torch, budgets).items():
        if only and not any(name.startswith(w) for w in only):
            continue
        for cg in cgs:
            s = build(cg)
            stepper = getattr(s, "_stepper", s)  # a System or a stepper
            route = type(stepper).__name__ if stepper else "general"
            mode = collect
            if collect != "none":
                from admm_elastic_tpu_torch.utils.profile_step import (
                    COLLECT, set_collect)

                if route == "ShardedBandedStepper":
                    mode = "primal"
                set_collect(s, COLLECT[mode])
            for _ in range(WARMUP):
                s.step()
            torch.cuda.synchronize()
            windows = []
            for _ in range(WINDOWS):
                t0 = time.perf_counter()
                s.run(STEPS)
                torch.cuda.synchronize()
                windows.append(1e3 * (time.perf_counter() - t0) / STEPS)
            x = s.x
            line = {"label": label, "scene": name, "cg": cg, "route": route,
                    "collect": mode, "device": card,
                    "ms_per_step": statistics.median(windows),
                    "windows_ms": windows,
                    "spread_ms": max(windows) - min(windows),
                    "steps": WARMUP + WINDOWS * STEPS,
                    "finite": bool(np.isfinite(x).all())}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if save:
                os.makedirs(save, exist_ok=True)
                tag = f"{label}_{name}_cg{cg}".replace(" ", "_")
                np.save(os.path.join(save, tag + ".npy"), x)
            del s
            if not line["finite"]:
                raise AssertionError(f"{label} {name} cg{cg}: not finite")
    if out_path:
        with open(out_path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


def compare(save) -> bool:
    """Whether every label's saved positions in `save` equal, scene by
    scene, the first label's bit for bit; prints a line a pair."""
    import numpy as np

    runs = {}
    for f in sorted(os.listdir(save)):
        if f.endswith(".npy"):
            label, tag = f[:-4].split("_", 1)
            runs.setdefault(tag, {})[label] = np.load(os.path.join(save, f))
    same = bool(runs)
    for tag, by_label in sorted(runs.items()):
        (first, x0), *rest = sorted(by_label.items())
        for label, x in rest:
            eq = x.shape == x0.shape and x.tobytes() == x0.tobytes()
            err = float(np.abs(x - x0).max()) if x.shape == x0.shape else None
            print(f"{tag} {label} vs {first}: bitwise={eq} max_abs={err}")
            same = same and eq
    print("ALL_BITWISE" if same else "NOT_BITWISE")
    return same


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose admm_elastic_tpu_torch to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="append the JSON lines to this file")
    ap.add_argument("--save", help="save each run's final positions here")
    ap.add_argument("--cg", type=int, nargs="+", default=[25, 75])
    ap.add_argument("--scenes", nargs="+",
                    help="time only the scenes whose names start with one "
                         "of these words")
    ap.add_argument("--collect", choices=("none", "primal", "full"),
                    default="none",
                    help="collect the residuals of each ADMM iteration")
    ap.add_argument("--compare", metavar="DIR",
                    help="hold the positions saved in DIR against each "
                         "other instead of timing")
    a = ap.parse_args()
    if a.compare:
        sys.exit(0 if compare(a.compare) else 1)
    time_root(a.root, a.label or a.root, a.out, a.save, a.cg, a.scenes,
              a.collect)


if __name__ == "__main__":
    main()
