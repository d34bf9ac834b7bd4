"""Times the hyperelastic tet element steps of the port found under a given
root at tet100k's shapes, so that two checkouts (a commit and its parent)
are timed one after the other on the same card, each in a process of its
own; and, for this checkout, each device schedule of the same arithmetic.

    python admm_elastic_tpu_torch/utils/time_elements.py --root DIR \\
        --label NAME [--out JSONL] [--save DIR]
    python admm_elastic_tpu_torch/utils/time_elements.py --designs|--host \\
        [--out JSONL]
    python admm_elastic_tpu_torch/utils/time_elements.py --compare DIR

`--root` builds tet100k (dia, cg25) with that checkout's `utils/scenes.py`
in f32 and f64, moves x by 5 mm N(0,1) and the duals by 0.01 N(0,1) and
the warm start by U(0.5, 1.5) (seed 0), and times, through the force's
own methods (as the System calls them): `fused_local_rhs` without and
with the dual residual's rows (the general dia/ell route's whole element
pipeline: in a checkout before the element kernel gathered for itself,
the gather, its transposing copy, the kernel and the rows' copy), and
`project_with_dual` on Dx (the unfused pipeline's `nh_local_step`). For
each it prints one JSON line: the ms a call by CUDA events around 20
back-to-back calls and the host us a call before the closing synchronize
(`time_solves.events_ms`, the median of 5 such windows), the ms a call
as 20 calls captured in one CUDA graph (`time_solves.graph_ms`: the
device's time with the launch gaps), the traced device ms a call (the
sum of the kernels' records over 20 calls under `torch.profiler`, by
kernel name; traced again, up to 5 times, while a record is missing) and
the device operations a call (`profile_step.call_ops`). A last line gives
the device operations of one whole step of tet100k's general route in
f32 (a CUDA graph of `System._step`). With `--save` each call's outputs
go to DIR/LABEL_NAME.npy (a label holds no "_"), so that `--compare DIR`
can hold two checkouts' outputs against each other bit for bit (exit 1
unless all agree).

`--designs` builds `csrc/probes/nh_design_probe.cu` of this checkout (the
element kernels of `csrc/nh_local.cu` under each register cap tried:
design d is `__launch_bounds__(128, d + 1)`, d = 0 with no cap, d = 1
to 7 with a cap of 65,536 / 128 (d + 1) registers) and, on the same
tet100k inputs in f32 and f64, launches each
design's fused (nh, no emit_z) and unfused entry directly: bits against
design 0 and the twin, ms a call by CUDA events around 20 launches,
traced device ms a call, and ptxas's registers and spills with the
static SASS instruction count (`utils/sass_counts.py`). `--host` splits
this checkout's fused wrapper's host work a call into its parts (the
plan lookup, the output allocations, the stream lookup, the C entry).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
REPS, WINDOWS, ATTEMPTS = 20, 5, 5
#: csrc/probes/nh_design_probe.cu's designs: d is __launch_bounds__(128,
#: d + 1)
N_DESIGNS = 8
_I, _P = ctypes.c_int, ctypes.c_void_p
#: the probe's entries
DESIGN_PROBE = {
    **{f"nh_design_fused_{t}": (_I, [_I] + [_P] * 13 + [_I] * 2 + [_P])
       for t in ("f32", "f64")},
    **{f"nh_design_step_{t}": (_I, [_I] + [_P] * 9 + [_I] * 2 + [_P])
       for t in ("f32", "f64")}}


def traced(torch, call, reps=REPS):
    """(device ms a call, {kernel name: ms a call}) of `call` from the
    kernels' records under torch.profiler over `reps` calls; the window
    is traced again, up to ATTEMPTS times, while it has fewer records than
    launches of the calls' first window."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    best = []
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        got = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(got) > len(best):
            best = got
        if got and len(got) % reps == 0:
            break
    per = {}
    for e in best:
        per[e.name] = per.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / reps
    return (sum(per.values()) if best else None), per


def tet100k_inputs(torch, scenes, dtype):
    """tet100k's System (dia, cg25), its HyperElasticTet and params, and
    seeded x, u and force state at tet100k's shapes."""
    import numpy as np

    s = scenes.tet100k(25, dtype)
    f = next(f for f in s.forces if type(f).__name__ == "HyperElasticTet")
    p = s.params[f.name]
    rng = np.random.default_rng(0)
    x0 = s.state["x"]
    x = x0 + torch.as_tensor(0.005 * rng.standard_normal(x0.shape),
                             dtype=dtype, device=x0.device)
    E = f.n_elements
    u = torch.as_tensor(0.01 * rng.standard_normal((9, E)), dtype=dtype,
                        device=x0.device)
    st = dict(s.state["forces"][f.name])
    st["sigma"] = torch.as_tensor(rng.uniform(0.5, 1.5, (3, E)), dtype=dtype,
                                  device=x0.device)
    return s, f, p, x, u, st


def time_root(root, label, out_path, save):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import admm_elastic_tpu_torch as pkg
    from admm_elastic_tpu_torch.utils import profile_step, scenes
    from admm_elastic_tpu_torch.utils.time_solves import events_ms, graph_ms

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    card = torch.cuda.get_device_name(0)
    lines = []
    for dtype in (torch.float32, torch.float64):
        s, f, p, x, u, st = tet100k_inputs(torch, scenes, dtype)
        dx = f.compute_Dx(p, x)
        calls = {
            "fused": lambda: f.fused_local_rhs(p, x, u, st),
            "fused emit_z": lambda: f.fused_local_rhs(p, x, u, st,
                                                      with_z=True),
            "step": lambda: f.project_with_dual(dx, u, p, st),
        }
        for name, call in calls.items():
            ev_ms, host_us = events_ms(torch, call, REPS, WINDOWS)
            dev_ms, per = traced(torch, call)
            line = {"label": label, "call": name, "dtype": str(dtype)[6:],
                    "E": f.n_elements, "device": card, "events_ms": ev_ms,
                    "host_us": host_us,
                    "graph_ms": graph_ms(torch, call, REPS, WINDOWS),
                    "traced_ms": dev_ms, "traced_by_kernel": per,
                    "device_ops_per_call": profile_step.call_ops(call)[
                        "device_ops_per_call"]}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if save:
                os.makedirs(save, exist_ok=True)
                out = call()
                flat = [out[0], out[1], out[2]["sigma"],
                        *(out[3:] if name != "step" else ())]
                tag = f"{label}_{name}_{str(dtype)[6:]}".replace(" ", "-")
                np.save(os.path.join(save, tag + ".npy"), np.concatenate(
                    [t.double().cpu().numpy().ravel() for t in flat]))
        del s, f, p, x, u, st, dx, calls
    s = scenes.tet100k(25, torch.float32)
    state = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in s.state.items()}
    line = {"label": label, "call": "tet100k general step", "dtype":
            "float32", "device": card, "device_ops_per_step":
            profile_step.call_ops(lambda: s._step(state, s.params))[
                "device_ops_per_call"]}
    print(json.dumps(line), flush=True)
    lines.append(line)
    if out_path:
        with open(out_path, "a") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")


def designs(out_path):
    import torch

    sys.path.insert(0, ROOT)
    from admm_elastic_tpu_torch.ops.kernels import _build, nh_local
    from admm_elastic_tpu_torch.utils import sass_counts, scenes
    from admm_elastic_tpu_torch.utils.time_solves import load_probe

    dll, log, lib = load_probe("nh_design_probe", DESIGN_PROBE)
    card = torch.cuda.get_device_name(0)
    sass = sass_counts.counts(ROOT, "probe", ("nh::",), lib=lib, log=log)
    lines = []
    for dtype in (torch.float32, torch.float64):
        t = _build.SUFFIX[dtype]
        s, f, p, x, u, st = tet100k_inputs(torch, scenes, dtype)
        E, warm = f.n_elements, st["sigma"]
        tets = p["indices"].to(torch.int32).contiguous()
        consts = (p["coeff_p"], p["mu"], p["lam"], p["k"], p["w2"])
        dx = f.compute_Dx(p, x)
        twins = {"fused": nh_local.nh_local_step_fused_reference(
                     x, tets, u, warm, *consts, iters=f.max_iters),
                 "step": nh_local.nh_local_step_reference(
                     dx, u, warm, *consts[1:4], iters=f.max_iters)}
        for entry, twin in twins.items():
            outs = [torch.empty_like(w) for w in twin]
            if entry == "fused":
                fn = getattr(dll, f"nh_design_fused_{t}")
                args = (x, tets, u, warm, *consts)
            else:
                fn = getattr(dll, f"nh_design_step_{t}")
                args = (dx, u, warm, *consts[1:4])
            ptrs = [a.data_ptr() for a in (*args, *outs)]
            first = None
            for d in range(N_DESIGNS):
                def call():
                    err = fn(d, *ptrs, E, f.max_iters,
                             torch.cuda.current_stream().cuda_stream)
                    _build.check(err, f"design {d}")

                call()
                torch.cuda.synchronize()
                got = [o.clone() for o in outs]
                first = first or got
                ev = []
                for _ in range(WINDOWS):
                    e0, e1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    e0.record()
                    for _ in range(REPS):
                        call()
                    e1.record()
                    torch.cuda.synchronize()
                    ev.append(e0.elapsed_time(e1) / REPS)
                kernel = [ln for ln in sass
                          if _instance(entry, dtype, d) in ln["kernel"]]
                line = {"design": d, "min_blocks": d + 1, "entry": entry,
                        "dtype": str(dtype)[6:], "E": E, "device": card,
                        "events_ms": sorted(ev)[len(ev) // 2],
                        "traced_ms": traced(torch, call)[0],
                        "bitwise_vs_design_0": all(
                            torch.equal(a, b) for a, b in zip(got, first)),
                        "bitwise_vs_twin": all(
                            torch.equal(a, b) for a, b in zip(got, twin)),
                        "ptxas": kernel[0]["ptxas"] if kernel else None,
                        "sass_instructions": kernel[0]["instructions"]
                        if kernel else None}
                print(json.dumps(line), flush=True)
                lines.append(line)
        del s, f, p, x, u, st, dx, twins
    if out_path:
        with open(out_path, "a") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    bad = [ln for ln in lines if not (ln["bitwise_vs_design_0"]
                                      and ln["bitwise_vs_twin"])]
    if bad:
        raise SystemExit(f"time_elements: {len(bad)} designs disagree")


def host_split(out_path):
    """The host's us a call of `nh_local_step_fused` at tet100k's shapes
    (f32), whole and by part: the force's method, the wrapper with and
    without `out=` buffers, its plan lookup, its four output allocations,
    one allocation split into four views in their place, the stream
    lookup and the C entry alone (a launch). Each part over 200
    calls on the host clock, before the closing synchronize (the card
    runs behind: the host's work is what is timed)."""
    import time

    import torch

    sys.path.insert(0, ROOT)
    from admm_elastic_tpu_torch.ops.kernels import _build, nh_local
    from admm_elastic_tpu_torch.utils import scenes

    s, f, p, x, u, st = tet100k_inputs(torch, scenes, torch.float32)
    names = ("cp12", "mu", "lam", "k", "w2")
    consts = tuple(p[k] for k in ("coeff_p", "mu", "lam", "k", "w2"))
    tets, warm = p["indices"], st["sigma"]
    args = (x, tets, u, warm, *consts)
    want = nh_local.nh_local_step_fused(*args)
    out = tuple(torch.empty_like(w) for w in want)
    plan = nh_local._plan("nh_local_step_fused", dict(zip(names, consts)),
                          tets)
    ptrs = (x.data_ptr(), plan.tets_ptr, u.data_ptr(), warm.data_ptr(),
            *plan.ptrs, *(o.data_ptr() for o in out))
    stream = _build.stream_ptr(x)
    sizes = [w.numel() for w in want]

    def one_allocation():
        buf = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
        return [b.view(w.shape) for b, w in zip(torch.split(buf, sizes),
                                                want)]

    parts = {
        "force method": lambda: f.fused_local_rhs(p, x, u, st),
        "wrapper": lambda: nh_local.nh_local_step_fused(*args),
        "wrapper, out= given": lambda: nh_local.nh_local_step_fused(
            *args, out=out),
        "plan lookup": lambda: nh_local._plan(
            "nh_local_step_fused", dict(zip(names, consts)), tets),
        "4 output allocations": lambda: [
            torch.empty(w.shape, dtype=w.dtype, device=w.device)
            for w in want],
        "1 allocation, 4 views": one_allocation,
        "stream lookup": lambda: _build.stream_ptr(x),
        "C entry alone": lambda: plan.fn(*ptrs, plan.E, f.max_iters, 0, 0,
                                         stream),
    }
    line = {"call": "host split nh_local_step_fused", "dtype": "float32",
            "E": plan.E, "device": torch.cuda.get_device_name(0)}
    for name, call in parts.items():
        best = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            best.append(1e6 * (time.perf_counter() - t0) / 200)
        torch.cuda.synchronize()
        line[f"{name} us"] = sorted(best)[len(best) // 2]
    print(json.dumps(line), flush=True)
    if out_path:
        with open(out_path, "a") as fh:
            fh.write(json.dumps(line) + "\n")


def _instance(entry, dtype, d):
    """The demangled name (as cuobjdump gives it) of design d's kernel of
    an entry (NeoHookean, no emit_z), up to its arguments."""
    import torch

    ctype = "float" if dtype == torch.float32 else "double"
    mode = "(bool)0, " if entry == "fused" else ""
    return f"nh::{entry}_kernel<{ctype}, (int)0, {mode}(int){d + 1}>"


def compare(save) -> bool:
    """Whether every label's saved outputs in `save` equal the first
    label's (sorted), call by call, bit for bit; prints a line a pair."""
    import numpy as np

    runs = {}
    for fn in sorted(os.listdir(save)):
        if fn.endswith(".npy"):
            label, tag = fn[:-4].split("_", 1)
            runs.setdefault(tag, {})[label] = np.load(os.path.join(save, fn))
    same = bool(runs)
    for tag, by_label in sorted(runs.items()):
        (first, a), *rest = sorted(by_label.items())
        for label, b in rest:
            eq = a.shape == b.shape and a.tobytes() == b.tobytes()
            print(f"{tag} {label} vs {first}: bitwise={eq}")
            same = same and eq
    print("ALL_BITWISE" if same else "NOT_BITWISE")
    return same


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose element steps to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="append the JSON lines to this file")
    ap.add_argument("--save", help="save each call's outputs here")
    ap.add_argument("--designs", action="store_true",
                    help="time this checkout's device schedules instead")
    ap.add_argument("--host", action="store_true",
                    help="split this checkout's fused wrapper's host work")
    ap.add_argument("--compare", metavar="DIR",
                    help="hold the outputs saved in DIR against each other")
    a = ap.parse_args()
    if a.compare:
        sys.exit(0 if compare(a.compare) else 1)
    if a.host:
        host_split(a.out)
    elif a.designs:
        designs(a.out)
    else:
        time_root(a.root, a.label or a.root, a.out, a.save)


if __name__ == "__main__":
    main()
