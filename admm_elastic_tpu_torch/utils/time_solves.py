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

The general ell route's fused CG (`cg_update`, one call a CG iteration
after the plain ELL matvec) is timed on its own input, `--make FILE
--fused`: delaunay100k's first ELL solve (f32). Its lines give, for one
`cg_update` call on the solve's first iteration's inputs, the device ms
(CUDA events around 20 back-to-back calls), the host us a call, and the
ms a call as 20 calls captured in one CUDA graph (the device's time,
launch gaps included); and for `pcg_solve_fixed_fused` at 25 and 75
iterations the ms a solve by events around 20 solves and the host us a
solve: the route's cost a CG iteration, host work and all, beside its
relative distance from that checkout's `cg_ell_solve` twin (another sum
order, so printed, not checked).

The multigrid solves (`mg_dia_solve`, `uamg_ell_solve`) are timed the same
way on their own inputs, `--make FILE --multigrid`: the first solve from
rest of tet100k and cloth100k under `preconditioner="amg"` (dia) and of
delaunay100k (ELL), f32, each saved with its hierarchy as `build_grid_mg`
or `build_uamg` returned it, so that each checkout's own `planes_from`
makes its planes. They run at 0, 1, 2, 6 and 8 iterations, timed also as
20 calls captured in one CUDA graph (`graph_ms`: the device's time, where
a short solve takes less than the wrapper's host work), and a line more
for each input gives the least-squares fit of graph_ms against the count:
the fixed part of a solve and the part each iteration adds. `--probe`
then builds `csrc/probes/mg_stage_probe.cu` of the checkout (the solve
kernel with its PROBE flag, which stamps %globaltimer at every stage end
of CTA 0) and prints, for each multigrid input at 8 iterations, the mean
us of each stage over the 8 iterations of 20 solves, with the fine stages
fused by recomputation and not (the kernel picks by the slab's size), and
the solve's bound at 6 and 8 iterations (`utils/opcount.py`). The
multigrid lines carry the plain version's ms too (one call, CUDA events).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

#: the multigrid solves' budgets: the split of fixed and per-iteration time
MG_BUDGETS = (0, 1, 2, 6, 8)
#: the iterations a stage probe runs, and its solves an input
PROBE_ITERS, PROBE_REPS = 8, 20
DT = 0.04  # the scenes' timestep (s)


def rest_rhs(st):
    """b of a stepper's first solve from rest as ADMM poses it: M x + M
    dt^2 g, g = -9.8 in y."""
    x0, m = st.state["x"], st.planes["mass"]
    b = m[:, None] * x0
    b[:, 1] -= m * 9.8 * DT * DT
    return b


def multigrid_inputs():
    """The multigrid solves' inputs: {name: (kind, (b, x0, matrix...,
    hierarchy))}, kind "mg" (dia: dia_vals, offsets) or "uamg" (ELL:
    ell_idx, ell_vals)."""
    import torch

    from admm_elastic_tpu_torch.utils import scenes

    out = {}
    for name, build in (
            ("tet100k mg f32", lambda: scenes.tet100k(8, torch.float32,
                                                      amg=True)),
            ("cloth100k mg f32", lambda: scenes.cloth100k(8, torch.float32,
                                                          amg=True)),
            ("delaunay100k uamg f32", lambda: scenes.delaunay100k(
                6, torch.float32, amg=True))):
        st = build()._stepper
        b, x0 = rest_rhs(st), st.state["x"]
        if getattr(st.cfg, "ell_width", 0):
            out[name] = ("uamg", (b, x0, st.planes["ell_idx"],
                                  st.planes["ell_vals"], st.hierarchy))
        else:
            out[name] = ("mg", (b, x0, st.planes["dia"], st.cfg.dia_offs,
                                st.hierarchy))
        del st
    return out


def make(path, multigrid=False, fused=False):
    import torch

    if multigrid:
        return save(path, multigrid_inputs())
    if fused:
        from admm_elastic_tpu_torch.utils import scenes

        s = scenes.delaunay100k(25, torch.float64, fast=False)
        return save(path, {"delaunay100k fused f32": (
            "fused", scenes.ell_solve_inputs(s, torch.float32))})

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
    save(path, out)


def save(path, out):
    import torch

    cpu = {k: (kind, tuple(a.cpu() if torch.is_tensor(a) else a
                           for a in args))
           for k, (kind, args) in out.items()}
    torch.save(cpu, path)
    print(json.dumps({k: list(v[1][0].shape) for k, v in cpu.items()}))


def graph_ms(torch, call, reps, windows):
    """Device ms a call of `call` (which launches one solve and allocates
    its output), its host work out of the way: `reps` calls captured in
    one CUDA graph, the median over `windows` replays by CUDA events."""
    call()  # the set-up a capture must find done
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    out = []
    for _ in range(windows):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return statistics.median(out)


def bound_line(kind, args, planes, cfg, k, label, name):
    """A multigrid solve's bound at k iterations (`utils.opcount`: the
    bytes its inputs and output take, the operations it needs)."""
    from admm_elastic_tpu_torch.utils.opcount import (mg_dia_counts,
                                                      roofline_ms,
                                                      uamg_ell_counts)

    counts = mg_dia_counts if kind == "mg" else uamg_ell_counts
    n_ops, n_bytes = counts(*args[:-1], planes, cfg, k)
    bound_ms, bound_by = roofline_ms(n_bytes, n_ops)
    line = {"label": label, "input": name, "n_iters": k,
            "operations": n_ops, "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": bound_by}
    print(json.dumps(line), flush=True)
    return line


def multigrid_solve(mod, kind, args):
    """(solve, twin) of a multigrid input in a checkout's modules (mod:
    its ops.kernels package), each f(k) at k iterations."""
    *args, hier = args
    b = args[0]
    if kind == "mg":
        m, f = mod.mg, "mg_dia_solve"
        planes, cfg = m.planes_from(hier, b.dtype, b.device), \
            m.MGConfig.of(hier)
    else:
        m, f = mod.uamg, "uamg_ell_solve"
        planes, cfg = m.planes_from(hier, b.dtype, b.device), \
            m.UAMGConfig.of(hier)
    solve, twin = getattr(m, f), getattr(m, f + "_reference")
    return (lambda k: solve(*args, planes, cfg, k),
            lambda k: twin(*args, planes, cfg, k), planes, cfg)


def load_probe(name, signatures):
    """Build the checkout's csrc/probes/NAME.cu into a library of its own
    and load it, with the C signatures {entry: (restype, argtypes)} set.
    Returns (the library, nvcc's output, the library's path)."""
    from admm_elastic_tpu_torch.ops.kernels import _build

    src = os.path.join(_build.CSRC, "probes", name + ".cu")
    out_dir = _build.BUILD_ROOT.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", str(_build.CSRC), "-o", str(lib), src],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}"
                           f"{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    for entry, (res, argt) in signatures.items():
        getattr(dll, entry).restype = res
        getattr(dll, entry).argtypes = argt
    return dll, done.stdout + done.stderr, lib


_I, _P = ctypes.c_int, ctypes.c_void_p
#: csrc/probes/mg_stage_probe.cu's entries
STAGE_PROBE = {
    "mg_probe_slots_per_pass": (_I, []), "mg_probe_slots": (_I, [_I]),
    "mg_probe_stage_names": (ctypes.c_char_p, [_I]),
    "mg_stage_probe_dia_f32": (_I, [_P] * 4 + [_I] * 3 + [_P] * 3
                               + [_I, _P, _P]),
    "mg_stage_probe_ell_f32": (_I, [_P] * 4 + [_I] * 3 + [_P] * 3
                               + [_I, _P, _P])}


def probe_stages(dll, mod, kind, args, planes, cfg, label, name, fuse):
    """The stage split of a multigrid input's solve at PROBE_ITERS
    iterations, its fine stages fused or not: the mean us from one stage
    end of CTA 0 to the next, over the iterations (not the start's
    V-cycle) of PROBE_REPS solves, and the bits of x against the
    product kernel's."""
    import torch

    from admm_elastic_tpu_torch.ops.kernels import _build

    b, x0, m1, m2, _ = args
    n, k = b.shape[0], PROBE_ITERS
    x = torch.empty_like(b)
    stamps = torch.zeros(dll.mg_probe_slots(k), dtype=torch.int64,
                         device=b.device)
    names = dll.mg_probe_stage_names(fuse).decode().split("|")
    S, W = len(names), dll.mg_probe_slots_per_pass()
    host = mod.uamg.host_struct(planes, cfg)
    scratch = mod.uamg.solve_prepare(b, n, len(m2) if kind == "mg" else 0,
                                     host)
    if kind == "mg":
        offs = (ctypes.c_int * len(m2))(*m2)
        run = lambda: dll.mg_stage_probe_dia_f32(  # noqa: E731
            b.data_ptr(), x0.data_ptr(), m1.data_ptr(),
            ctypes.addressof(offs), len(m2), n, k, ctypes.addressof(host),
            x.data_ptr(), scratch.data_ptr(), fuse, stamps.data_ptr(),
            _build.stream_ptr(b))
        want = mod.mg.mg_dia_solve(b, x0, m1, m2, planes, cfg, k)
    else:
        idx_t, vals_t = (mod.cg_ell.slot_major(a) for a in (m1, m2))
        run = lambda: dll.mg_stage_probe_ell_f32(  # noqa: E731
            b.data_ptr(), x0.data_ptr(), idx_t.data_ptr(), vals_t.data_ptr(),
            m1.shape[1], n, k, ctypes.addressof(host), x.data_ptr(),
            scratch.data_ptr(), fuse, stamps.data_ptr(),
            _build.stream_ptr(b))
        want = mod.uamg.uamg_ell_solve(b, x0, m1, m2, planes, cfg, k)
    sums = [0.0] * S
    start = whole = 0.0
    for _ in range(PROBE_REPS):
        _build.check(run(), "mg stage probe")
        torch.cuda.synchronize()
        t = stamps.cpu().tolist()
        start += (t[2 + S - 1] - t[0]) / 1e3
        whole += (t[2 + W * k + S - 1] - t[2 + S - 1]) / 1e3 / k
        for it in range(1, k + 1):
            base = 2 + W * it
            for q in range(S):
                prev = base + q - 1 if q else base - W + S - 1
                sums[q] += (t[base + q] - t[prev]) / 1e3
    line = {"label": label, "input": name, "probe": "stage split",
            "fused": bool(fuse), "n_iters": k,
            "device": torch.cuda.get_device_name(0),
            "bitwise_vs_kernel": bool(torch.equal(x, want)),
            "us_per_stage": {nm: v / (PROBE_REPS * k)
                             for nm, v in zip(names, sums)},
            "us_per_iteration": whole / PROBE_REPS,
            "us_start_to_first_iteration": start / PROBE_REPS,
            "stages_per_iteration": S}
    print(json.dumps(line), flush=True)
    return line


def events_ms(torch, call, reps, windows):
    """(device ms a call by CUDA events around `reps` back-to-back calls,
    host us a call before the closing synchronize), medians of
    `windows`."""
    dev_ms, host_us = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        host_us.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
        dev_ms.append(e0.elapsed_time(e1) / reps)
    return statistics.median(dev_ms), statistics.median(host_us)


def fused_lines(torch, mod, solver, args, label, name, reps, windows):
    """The lines of a fused input (see the module's docstring)."""
    b, x0, diag, idx, vals = args
    step = mod.cg_step

    def A(y):
        return solver.ell_apply(y, idx, vals)

    inv = 1.0 / diag
    r = b - A(x0)
    p = inv[:, None] * r
    ins = (x0, r, p, (r * p).sum(), A(p), inv)
    base = {"label": label, "input": name, "n": b.shape[0],
            "device": torch.cuda.get_device_name(0)}

    def update():
        return step.cg_update(*ins)

    ms, host = events_ms(torch, update, reps, windows)
    lines = [{**base, "call": "cg_update", "ms": ms,
              "host_us_per_call": host,
              "graph_ms": graph_ms(torch, update, reps, windows)}]
    for k in (25, 75):
        def solve(_k=k):
            return step.pcg_solve_fixed_fused(A, b, x0, diag, _k)

        got = solve()
        want = mod.cg_ell.cg_ell_solve_reference(b, x0, diag, idx, vals, k)
        ms, host = events_ms(torch, solve, 5, windows)
        lines.append({**base, "call": "pcg_solve_fixed_fused", "n_iters": k,
                      "ms": ms, "host_us_per_call": host,
                      "us_per_iteration": 1e3 * ms / k,
                      "rel_vs_cg_ell_twin": float(
                          (got - want).abs().max() / want.abs().max())})
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def time_root(inputs, root, label, out_path, reps=20, windows=3,
              probe=False):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import admm_elastic_tpu_torch as pkg
    from admm_elastic_tpu_torch.core import solver
    from admm_elastic_tpu_torch.ops import kernels
    from admm_elastic_tpu_torch.ops.kernels import cg_dia, cg_ell, cheb_dia

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    # the inputs hold the multigrids' numpy hierarchies besides tensors
    data = torch.load(inputs, weights_only=False)
    dll = load_probe("mg_stage_probe", STAGE_PROBE)[0] if probe else None
    lines = []
    for name, (kind, args) in data.items():
        args = tuple(a.cuda() if torch.is_tensor(a) else a for a in args)
        if kind == "fused":
            lines += fused_lines(torch, kernels, solver, args, label, name,
                                 reps, windows)
            continue
        if kind == "cheb":
            *args, kw = args
            budgets = (len(args[6]) + 1,)

            def solve(*a, k=None, _kw=kw):
                return cheb_dia.cheb_dia_chunk(
                    *a, n_it=k - 1, first=True, last=True, **_kw)[0]

            def twin(*a, k=None, _kw=kw):
                return cheb_dia.cheb_dia_chunk_reference(
                    *a, n_it=k - 1, first=True, last=True, **_kw)[0]
        elif kind in ("mg", "uamg"):
            budgets = MG_BUDGETS
            msolve, mtwin, planes, cfg = multigrid_solve(kernels, kind, args)

            def solve(*a, k=None, _f=msolve):
                return _f(k)

            def twin(*a, k=None, _f=mtwin):
                return _f(k)
        else:
            mod = cg_dia if kind == "dia" else cg_ell
            budgets = (25, 75, 300) if name.startswith("cloth") else (25, 75)

            def solve(*a, k=None, _f=getattr(mod, f"cg_{kind}_solve")):
                return _f(*a, k)

            def twin(*a, k=None,
                     _f=getattr(mod, f"cg_{kind}_solve_reference")):
                return _f(*a, k)
        mine = []
        for k in budgets:
            got = solve(*args, k=k)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            want = twin(*args, k=k)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
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
            ms = statistics.median(dev_ms)
            graph = (graph_ms(torch, lambda: solve(*args, k=k), reps,
                              windows) if kind in ("mg", "uamg") else None)
            line = {"label": label, "input": name, "n": args[0].shape[0],
                    "n_iters": k, "device": torch.cuda.get_device_name(0),
                    "bitwise_vs_own_twin": bool(torch.equal(got, want)),
                    "ms": ms, "ms_windows": dev_ms,
                    "host_us_per_call": statistics.median(host_us),
                    "graph_ms": graph, "plain_ms": plain_ms,
                    "us_per_iteration": 1e3 * ms / k if k else None,
                    "rel_err_vs_own_twin": rel}
            print(json.dumps(line), flush=True)
            mine.append(line)
            if not rel <= 1e-4 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label} {name} cg{k}: {rel}")
        if kind in ("mg", "uamg"):
            slope, fixed = np.polyfit([q["n_iters"] for q in mine],
                                      [q["graph_ms"] for q in mine], 1)
            mine.append({"label": label, "input": name,
                         "fit": "least squares of graph_ms on n_iters",
                         "n_iters": list(budgets), "fixed_ms": float(fixed),
                         "us_per_iteration": 1e3 * float(slope)})
            print(json.dumps(mine[-1]), flush=True)
            if dll is not None:
                mine += [probe_stages(dll, kernels, kind, args, planes, cfg,
                                      label, name, fuse) for fuse in (1, 0)]
                mine += [bound_line(kind, args, planes, cfg, k, label, name)
                         for k in (6, 8)]
        lines += mine
    if out_path:
        with open(out_path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--make", help="build the inputs and save them here")
    ap.add_argument("--multigrid", action="store_true",
                    help="with --make: the multigrid solves' inputs only")
    ap.add_argument("--fused", action="store_true",
                    help="with --make: the fused CG's input only")
    ap.add_argument("--inputs", help="the saved inputs to time")
    ap.add_argument("--root", default=".",
                    help="checkout whose admm_elastic_tpu_torch to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="append the JSON lines to this file")
    ap.add_argument("--probe", action="store_true",
                    help="the multigrid inputs' stage split as well")
    a = ap.parse_args()
    if a.make:
        sys.path.insert(0, os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "..")))
        make(a.make, a.multigrid, a.fused)
    else:
        time_root(a.inputs, a.root, a.label or a.root, a.out,
                  probe=a.probe)


if __name__ == "__main__":
    main()
