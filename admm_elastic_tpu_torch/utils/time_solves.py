"""Times the whole-solve kernels, cg_dia_solve and cg_ell_solve, and the
Chebyshev chunk cheb_dia_chunk, of the port found under a given root, on
inputs saved once, so that two checkouts (a commit and its parent) are
timed on the same bits, one after the other on the same card.

    python admm_elastic_tpu_torch/utils/time_solves.py --make FILE
    python admm_elastic_tpu_torch/utils/time_solves.py --inputs FILE \\
        --root DIR --label NAME [--out JSONL]

`--make` builds the inputs with this checkout's scenes (f32 unless said):
tet100k's first dia solve, delaunay100k's first ELL solve in its grid
numbering and renumbered at random (`scenes.renumbered_ell`, seed 0; also
f64), tet100k's beam made 4 times longer (160 x 25 x 20 cells, dia),
cloth100k's first dia solve (also at 300 iterations, its matched Jacobi
budget), and tet100k's whole cheb180 Chebyshev solve (one chunk of 179
iterations, first and last, from the operator's bounds), and saves them
to FILE. `--inputs` loads them and imports `admm_elastic_tpu_torch` from
DIR (any checkout whose kernels take these arguments), then for each
input and budget (the solves at 25 and 75 iterations) prints one JSON
line: the device ms a call (CUDA events around 20 back-to-back calls,
the median of 3 such windows), the host us a call (the same calls' wall
time before the closing synchronize, over 20; the host's work, as long
as it does not wait for the card), and the relative error against that
checkout's own plain version. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def make(path):
    import torch

    from admm_elastic_tpu_torch.parallel.cheb import (cheb_coefficients,
                                                      dia_operator_bounds)
    from admm_elastic_tpu_torch.utils import scenes

    out = {}
    s = scenes.tet100k(25, torch.float64)
    out["tet100k dia f32"] = ("dia", scenes.dia_solve_inputs(
        s, torch.float32))
    b, x0, diag, dia, offs = scenes.dia_solve_inputs(s, torch.float32)
    inv_theta, c1, c2 = cheb_coefficients(180, *dia_operator_bounds(
        dia.double().cpu().numpy(), offs))
    c1, c2 = (torch.as_tensor(c, dtype=torch.float32, device=b.device)
              for c in (c1, c2))
    out["tet100k cheb180 f32"] = ("cheb", (
        b, x0, b, b, 1.0 / diag, dia, c1, c2,
        {"offsets": tuple(int(o) for o in offs),
         "inv_theta": float(inv_theta)}))
    del s
    s = scenes.cloth100k(25, torch.float64, fast=False)
    out["cloth100k dia f32"] = ("dia", scenes.dia_solve_inputs(
        s, torch.float32))
    del s
    s = scenes.delaunay100k(25, torch.float64, fast=False)
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        prob = scenes.ell_solve_inputs(s, dtype)
        if dtype == torch.float32:
            out["delaunay100k ell f32"] = ("ell", prob)
        out[f"delaunay100k renumbered ell {tag}"] = (
            "ell", scenes.renumbered_ell(*prob, seed=0)[:5])
    del s
    out["beam 160x25x20 dia f32"] = ("dia",
                                     scenes.long_beam_dia_inputs(160))
    cpu = {k: (kind, tuple(a.cpu() if torch.is_tensor(a) else a
                           for a in args))
           for k, (kind, args) in out.items()}
    torch.save(cpu, path)
    print(json.dumps({k: list(v[1][0].shape) for k, v in cpu.items()}))


def time_root(inputs, root, label, out_path, reps=20, windows=3):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import admm_elastic_tpu_torch as pkg
    from admm_elastic_tpu_torch.ops.kernels import cg_dia, cg_ell, cheb_dia

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    data = torch.load(inputs)
    lines = []
    for name, (kind, args) in data.items():
        args = tuple(a.cuda() if torch.is_tensor(a) else a for a in args)
        if kind == "cheb":
            *args, kw = args
            budgets = (len(args[6]) + 1,)

            def solve(*a, k=None, _kw=kw):
                return cheb_dia.cheb_dia_chunk(
                    *a, n_it=k - 1, first=True, last=True, **_kw)[0]

            def twin(*a, k=None, _kw=kw):
                return cheb_dia.cheb_dia_chunk_reference(
                    *a, n_it=k - 1, first=True, last=True, **_kw)[0]
        else:
            mod = cg_dia if kind == "dia" else cg_ell
            budgets = (25, 75, 300) if name.startswith("cloth") else (25, 75)

            def solve(*a, k=None, _f=getattr(mod, f"cg_{kind}_solve")):
                return _f(*a, k)

            def twin(*a, k=None,
                     _f=getattr(mod, f"cg_{kind}_solve_reference")):
                return _f(*a, k)
        for k in budgets:
            got = solve(*args, k=k)
            want = twin(*args, k=k)
            rel = float((got - want).abs().max() / want.abs().max())
            dev_ms, host_us = [], []
            for _ in range(windows):
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                for _ in range(reps):
                    solve(*args, k=k)
                e1.record()
                host_us.append(1e6 * (time.perf_counter() - t0) / reps)
                torch.cuda.synchronize()
                dev_ms.append(e0.elapsed_time(e1) / reps)
            line = {"label": label, "input": name, "n": args[0].shape[0],
                    "n_iters": k, "device": torch.cuda.get_device_name(0),
                    "bitwise_vs_own_twin": bool(torch.equal(got, want)),
                    "ms": statistics.median(dev_ms),
                    "ms_windows": dev_ms,
                    "host_us_per_call": statistics.median(host_us),
                    "us_per_iteration": 1e3 * statistics.median(dev_ms) / k,
                    "rel_err_vs_own_twin": rel}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not rel <= 1e-4 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label} {name} cg{k}: {rel}")
    if out_path:
        with open(out_path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--make", help="build the inputs and save them here")
    ap.add_argument("--inputs", help="the saved inputs to time")
    ap.add_argument("--root", default=".",
                    help="checkout whose admm_elastic_tpu_torch to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="append the JSON lines to this file")
    a = ap.parse_args()
    if a.make:
        sys.path.insert(0, os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "..")))
        make(a.make)
    else:
        time_root(a.inputs, a.root, a.label or a.root, a.out)


if __name__ == "__main__":
    main()
