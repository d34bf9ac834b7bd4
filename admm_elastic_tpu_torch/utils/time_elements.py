"""Times the tet element steps of the port found under a given root at
their workload's shapes, so that two checkouts (a commit and its parent)
are timed one after the other on the same card, each in a process of its
own; and, for this checkout, each device schedule of the same arithmetic.

    python admm_elastic_tpu_torch/utils/time_elements.py [--force arap] \\
        --root DIR --label NAME [--out JSONL] [--save DIR]
    python admm_elastic_tpu_torch/utils/time_elements.py [--force arap] \\
        --designs|--host [--out JSONL]
    python admm_elastic_tpu_torch/utils/time_elements.py --compare DIR

`--force nh` (the default) times the hyperelastic pair
(`nh_local_step_fused`, `nh_local_step`) at tet100k's shapes, `--force
arap` the ARAP pair (`arap_local_step_fused`, `arap_local_step`) at
arap100k's (the same beam with LinearTetStrain). `--root` builds the
scene (dia, cg25) with that checkout's `utils/scenes.py` in f32 and f64,
moves x by 5 mm N(0,1) and the duals by 0.01 N(0,1) and the warm start
(nh) by U(0.5, 1.5) (seed 0), and times, through the force's own methods
(as the System calls them): `fused_local_rhs` without and with the dual
residual's rows (the general dia/ell route's whole element pipeline: in
a checkout before the element kernel gathered for itself, the gather,
its transposing copy, the kernel and the rows' copy), and
`project_with_dual` on Dx (the unfused pipeline's step). For
each it prints one JSON line: the ms a call by CUDA events around 20
back-to-back calls and the host us a call before the closing synchronize
(`time_solves.events_ms`, the median of 5 such windows), the ms a call
as 20 calls captured in one CUDA graph (`time_solves.graph_ms`: the
device's time with the launch gaps), the traced device ms a call (the
sum of the kernels' records over 20 calls under `torch.profiler`, by
kernel name; traced again, up to 5 times, while a record is missing) and
the device operations a call (`profile_step.call_ops`). A last line gives
the device operations of one whole step of the scene's general route in
f32 (a CUDA graph of `System._step`). With `--save` each call's outputs
go to DIR/LABEL_NAME.npy (a label holds no "_"), so that `--compare DIR`
can hold two checkouts' outputs against each other bit for bit (exit 1
unless all agree).

`--designs` builds the force's schedule probe of this checkout,
`csrc/probes/nh_design_probe.cu` or `arap_design_probe.cu` (the element
kernels of `csrc/nh_local.cu` or `tet_local.cu` under each register cap
tried: design d is `__launch_bounds__(128, d + 1)`, d = 0 with no cap,
d = 1 to 7 with a cap of 65,536 / 128 (d + 1) registers) and, on the
same inputs in f32 and f64, launches each design's fused (nh: the
NeoHookean model; no emit_z) and unfused entry directly: bits against
design 0 and the twin, ms a call by CUDA events around 20 launches,
traced device ms a call, and ptxas's registers and spills with the
static SASS instruction count (`utils/sass_counts.py`). `--host` splits
this checkout's wrappers' host work a call into its parts (the plan
lookup, the output allocations, the stream lookup, the C entry; the
fused and the unfused wrapper with and without `out=` buffers).
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
_I, _P = ctypes.c_int, ctypes.c_void_p
#: each force's schedule probe: its source under csrc/probes/ and its
#: entries' C signatures; design d is __launch_bounds__(128, d + 1)
N_DESIGNS = 8
PROBES = {
    "nh": ("nh_design_probe", {
        **{f"nh_design_fused_{t}": (_I, [_I] + [_P] * 13 + [_I] * 2 + [_P])
           for t in ("f32", "f64")},
        **{f"nh_design_step_{t}": (_I, [_I] + [_P] * 9 + [_I] * 2 + [_P])
           for t in ("f32", "f64")}}),
    "arap": ("arap_design_probe", {
        **{f"arap_design_fused_{t}": (_I, [_I] + [_P] * 9 + [_I, _P])
           for t in ("f32", "f64")},
        **{f"arap_design_step_{t}": (_I, [_I] + [_P] * 6 + [_I, _P])
           for t in ("f32", "f64")}}),
}
#: the force class and the scene of each --force
FORCES = {"nh": ("HyperElasticTet", "tet100k"),
          "arap": ("LinearTetStrain", "arap100k")}


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


def force_inputs(torch, scenes, dtype, force):
    """The force's scene (tet100k or arap100k; dia, cg25), its tet force
    and params, and seeded x, u and force state at the scene's shapes."""
    import numpy as np

    cls, scene = FORCES[force]
    s = getattr(scenes, scene)(25, dtype)
    f = next(f for f in s.forces if type(f).__name__ == cls)
    p = s.params[f.name]
    rng = np.random.default_rng(0)
    x0 = s.state["x"]
    x = x0 + torch.as_tensor(0.005 * rng.standard_normal(x0.shape),
                             dtype=dtype, device=x0.device)
    E = f.n_elements
    u = torch.as_tensor(0.01 * rng.standard_normal((9, E)), dtype=dtype,
                        device=x0.device)
    st = dict(s.state["forces"][f.name])
    if force == "nh":
        st["sigma"] = torch.as_tensor(rng.uniform(0.5, 1.5, (3, E)),
                                      dtype=dtype, device=x0.device)
    return s, f, p, x, u, st


def time_root(root, label, out_path, save, force):
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
        s, f, p, x, u, st = force_inputs(torch, scenes, dtype, force)
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
            line = {"label": label, "force": force, "call": name,
                    "dtype": str(dtype)[6:],
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
                flat = [out[0], out[1], *out[2].values(),
                        *(out[3:] if name != "step" else ())]
                tag = f"{label}_{force}-{name}-{str(dtype)[6:]}".replace(
                    " ", "-")
                np.save(os.path.join(save, tag + ".npy"), np.concatenate(
                    [t.double().cpu().numpy().ravel() for t in flat]))
        del s, f, p, x, u, st, dx, calls
    scene = FORCES[force][1]
    s = getattr(scenes, scene)(25, torch.float32)
    state = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in s.state.items()}
    line = {"label": label, "force": force,
            "call": f"{scene} general step", "dtype": "float32",
            "device": card, "device_ops_per_step":
            profile_step.call_ops(lambda: s._step(state, s.params))[
                "device_ops_per_call"]}
    print(json.dumps(line), flush=True)
    lines.append(line)
    if out_path:
        with open(out_path, "a") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")


def entry_args(force, f, p, x, u, st):
    """The force's two wrappers on these inputs as the C entries take them:
    {"fused"|"step": (module, wrapper name, its tensor arguments, its
    keyword arguments, the ints its C entry takes after E)}."""
    from admm_elastic_tpu_torch.ops.kernels import nh_local, tet_local

    tets = p["indices"]
    dx = f.compute_Dx(p, x)
    if force == "arap":
        consts = (p["coeff_p"], p["w2"], p["k"])
        return {"fused": (tet_local, "arap_local_step_fused",
                          (x, tets, u, *consts), {}, ()),
                "step": (tet_local, "arap_local_step", (dx, u, *consts[1:]),
                         {}, ())}
    consts = (p["coeff_p"], p["mu"], p["lam"], p["k"], p["w2"])
    iters = {"iters": f.max_iters}
    return {"fused": (nh_local, "nh_local_step_fused",
                      (x, tets, u, st["sigma"], *consts), iters,
                      (f.max_iters,)),
            "step": (nh_local, "nh_local_step",
                     (dx, u, st["sigma"], *consts[1:4]), iters,
                     (f.max_iters,))}


def designs(out_path, force):
    import torch

    sys.path.insert(0, ROOT)
    from admm_elastic_tpu_torch.ops.kernels import _build
    from admm_elastic_tpu_torch.utils import sass_counts, scenes
    from admm_elastic_tpu_torch.utils.time_solves import load_probe

    probe, signatures = PROBES[force]
    dll, log, lib = load_probe(probe, signatures)
    card = torch.cuda.get_device_name(0)
    sass = sass_counts.counts(ROOT, "probe", (f"{force}::",), lib=lib,
                              log=log)
    lines = []
    for dtype in (torch.float32, torch.float64):
        t = _build.SUFFIX[dtype]
        s, f, p, x, u, st = force_inputs(torch, scenes, dtype, force)
        E = f.n_elements
        for entry, (mod, name, args, kw, ints) in entry_args(
                force, f, p, x, u, st).items():
            args = [a.to(torch.int32).contiguous()
                    if not a.is_floating_point() else a for a in args]
            twin = getattr(mod, name + "_reference")(*args, **kw)
            outs = [torch.empty_like(w) for w in twin]
            fn = getattr(dll, f"{force}_design_{entry}_{t}")
            ptrs = [a.data_ptr() for a in (*args, *outs)]
            first = None
            for d in range(N_DESIGNS):
                def call():
                    err = fn(d, *ptrs, E, *ints,
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
                kernel = [ln for ln in sass if _instance(
                    force, entry, dtype, d) in ln["kernel"]]
                line = {"force": force, "design": d,
                        "min_blocks": d + 1, "entry": entry,
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
        del s, f, p, x, u, st
    if out_path:
        with open(out_path, "a") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    bad = [ln for ln in lines if not (ln["bitwise_vs_design_0"]
                                      and ln["bitwise_vs_twin"])]
    if bad:
        raise SystemExit(f"time_elements: {len(bad)} designs disagree")


def host_split(out_path, force):
    """The host's us a call of the force's element wrappers at its scene's
    shapes (f32), whole and by part: the force's fused method, the fused
    wrapper with and without `out=` buffers, its plan lookup, its output
    allocations, one allocation split into as many views in their place,
    the stream lookup and the C entry alone (a launch); and the unfused
    wrapper with and without `out=` buffers. Each part over 200 calls on
    the host clock, before the closing synchronize (the card runs behind:
    the host's work is what is timed)."""
    import time

    import torch

    sys.path.insert(0, ROOT)
    from admm_elastic_tpu_torch.ops.kernels import _build
    from admm_elastic_tpu_torch.utils import scenes

    s, f, p, x, u, st = force_inputs(torch, scenes, torch.float32, force)
    calls = entry_args(force, f, p, x, u, st)
    mod, name, args, kw, ints = calls["fused"]
    wrapper = getattr(mod, name)
    want = wrapper(*args, **kw)
    out = tuple(torch.empty_like(w) for w in want)
    names = (("cp12", "w2", "k") if force == "arap"
             else ("cp12", "mu", "lam", "k", "w2"))
    consts = dict(zip(names, args[-len(names):]))
    tets = args[1]
    plan = _build.element_plan(name, consts, tets)
    state = args[2:-len(names)]  # u9 (and the warm start)
    ptrs = (x.data_ptr(), plan.tets_ptr, *(a.data_ptr() for a in state),
            *plan.ptrs, *(o.data_ptr() for o in out))
    stream = _build.stream_ptr(x)
    sizes = [w.numel() for w in want]
    smod, sname, sargs, skw, _ = calls["step"]
    step = getattr(smod, sname)
    sout = tuple(torch.empty_like(w) for w in step(*sargs, **skw))

    def one_allocation():
        buf = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
        return [b.view(w.shape) for b, w in zip(torch.split(buf, sizes),
                                                want)]

    n = len(want)
    parts = {
        "force method": lambda: f.fused_local_rhs(p, x, u, st),
        "wrapper": lambda: wrapper(*args, **kw),
        "wrapper, out= given": lambda: wrapper(*args, **kw, out=out),
        "plan lookup": lambda: _build.element_plan(name, consts, tets),
        f"{n} output allocations": lambda: [
            torch.empty(w.shape, dtype=w.dtype, device=w.device)
            for w in want],
        f"1 allocation, {n} views": one_allocation,
        "stream lookup": lambda: _build.stream_ptr(x),
        # E, the ints, then emit_z (nh: model 0 first) and the stream
        "C entry alone": lambda: plan.fn(*ptrs, plan.E, *ints,
                                         *((0,) if force == "nh" else ()),
                                         0, stream),
        "unfused wrapper": lambda: step(*sargs, **skw),
        "unfused wrapper, out= given": lambda: step(*sargs, **skw,
                                                    out=sout),
    }
    line = {"call": f"host split {name}", "force": force,
            "dtype": "float32", "E": plan.E,
            "device": torch.cuda.get_device_name(0)}
    for part, call in parts.items():
        best = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            best.append(1e6 * (time.perf_counter() - t0) / 200)
        torch.cuda.synchronize()
        line[f"{part} us"] = sorted(best)[len(best) // 2]
    print(json.dumps(line), flush=True)
    if out_path:
        with open(out_path, "a") as fh:
            fh.write(json.dumps(line) + "\n")


def _instance(force, entry, dtype, d):
    """The demangled name (as cuobjdump gives it) of design d's kernel of
    a force's entry (nh: NeoHookean; no emit_z), up to its arguments."""
    import torch

    ctype = "float" if dtype == torch.float32 else "double"
    mode = "(bool)0, " if entry == "fused" else ""
    if force == "arap":
        return f"arap::{entry}_kernel<{ctype}, {mode}(int){d + 1}>"
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
    ap.add_argument("--force", choices=tuple(FORCES), default="nh",
                    help="the element pair: nh (tet100k) or arap "
                         "(arap100k)")
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
        host_split(a.out, a.force)
    elif a.designs:
        designs(a.out, a.force)
    else:
        time_root(a.root, a.label or a.root, a.out, a.save, a.force)


if __name__ == "__main__":
    main()
