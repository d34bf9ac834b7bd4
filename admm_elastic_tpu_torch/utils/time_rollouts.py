"""Times the whole-timestep routes of the port found under a given root, so
that two checkouts (a commit and its parent) are timed one after the other
on the same card, each in a process of its own.

    python admm_elastic_tpu_torch/utils/time_rollouts.py --root DIR \\
        --label NAME [--out JSONL] [--save DIR] [--cg 25 75]

For each scene and CG budget (f32) it builds the System with that
checkout's `utils/scenes.py` and steps it as `chip_smoke.py` drives a
route: 2 single steps, then 3 windows of 10 steps, each timed on the host
clock around work that ends in a synchronize. It prints one JSON line a
scene and budget: the median ms/step, the windows, the spread, and
whether the positions are finite. The scenes: tet100k on the banded route
(`lattice_fast_path=True`, dia) and on the lattice route (the cg global
mode), arap100k on the banded route's arap mode, delaunay100k on the
banded route's ELL mode, and tet100k's beam made 4 times longer (160 x 25
x 20 cells, 87,906 nodes, 200 kg) on the banded route. With `--save` the
positions after the 32 steps go to DIR/LABEL_SCENE_cgN.npy, so that two
checkouts' trajectories can be held against each other. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

WARMUP, WINDOWS, STEPS = 2, 3, 10


def _scenes(scenes, torch):
    f32 = torch.float32
    return {
        "tet100k banded": lambda cg: scenes.tet100k(cg, f32, fast=True),
        "tet100k lattice": lambda cg: scenes.tet100k(
            cg, f32, fast=True, global_solver="cg"),
        "arap100k banded": lambda cg: scenes.arap100k(cg, f32, fast=True),
        "delaunay100k banded-ELL": lambda cg: scenes.delaunay100k(
            cg, f32, fast=True),
        "beam 160x25x20 banded": lambda cg: scenes.beam_system(
            (160, 25, 20), 0.05, 200.0, cg, f32, fast=True),
    }


def time_root(root, label, out_path, save, budgets):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import admm_elastic_tpu_torch as pkg
    from admm_elastic_tpu_torch.utils import scenes

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    card = torch.cuda.get_device_name(0)
    lines = []
    for name, build in _scenes(scenes, torch).items():
        for cg in budgets:
            s = build(cg)
            route = type(s._stepper).__name__ if s._stepper else "general"
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
                    "device": card, "ms_per_step": statistics.median(windows),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose admm_elastic_tpu_torch to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="append the JSON lines to this file")
    ap.add_argument("--save", help="save each run's final positions here")
    ap.add_argument("--cg", type=int, nargs="+", default=[25, 75])
    a = ap.parse_args()
    time_root(a.root, a.label or a.root, a.out, a.save, a.cg)


if __name__ == "__main__":
    main()
