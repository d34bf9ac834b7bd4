"""What the compiler made of the port's kernels: static SASS instruction
counts (`cuobjdump -sass` of the kernel library) and ptxas's register and
spill report, for the kernels of a given checkout, so that two checkouts
(a commit and its parent) can be held against each other.

    python admm_elastic_tpu_torch/utils/sass_counts.py --root DIR \\
        --label NAME [--match SUBSTRING ...] [--out JSONL]

It builds the kernel library of the checkout under DIR with that
checkout's `ops/kernels/_build.py` (or finds it built), disassembles it,
and prints one JSON line for each kernel whose demangled name holds one of
the `--match` words (by default the banded phases' and the CG update's
kernels): its instructions in all, by class (float: F*, D*, H* and MUFU;
memory: loads, stores, atomics and reductions; wide: the 64-bit address
steps IMAD.WIDE, IADD3.X, LEA.HI.X; barrier: BAR, WARPSYNC and cluster
syncs; other), its twelve most frequent opcodes, and ptxas's line for it.
The counts are static: a loop's body counts once. Needs the CUDA toolkit
(nvcc, cuobjdump); no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

MATCH = ("element_kernel", "vertex_kernel", "seed_", "update_kernel")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_WIDE = ("IMAD.WIDE", "IADD3.X", "LEA.HI.X")


def _tool(nvcc, name):
    path = os.path.join(os.path.dirname(nvcc), name)
    return path if os.path.exists(path) else shutil.which(name)


def _classify(op):
    base = op.split(".")[0]
    if op.startswith(_WIDE):
        return "wide"
    if base[0] in "FDH" or base == "MUFU":
        return "float"
    if base.startswith(("LD", "ST", "ATOM", "RED", "UBLKCP", "UTMA")):
        return "memory"
    if base in ("BAR", "WARPSYNC", "UCGABAR_ARV", "UCGABAR_WAIT", "CCTL",
                "MEMBAR", "SYNCS"):
        return "barrier"
    return "other"


def functions(sass):
    """{mangled name: [opcode, ...]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            out[name].append(m.group(2))
    return out


def ptxas_lines(log):
    """{mangled name: ptxas's stack, spill and register lines for it,
    joined by ' | '} of a build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and ("spill" in line
                       or ("Used" in line and "registers" in line)):
            out[name].append(line.split(":", 1)[-1].strip()
                             if "ptxas" in line else line.strip())
    return {k: " | ".join(v) for k, v in out.items()}


def counts(root, label, match=MATCH, lib=None, log=""):
    """The lines of the kernels of the checkout under `root` whose names
    hold a `match` word; with `lib`, of that built library in its place,
    ptxas's lines from its build output `log`."""
    sys.path.insert(0, os.path.abspath(root))
    from admm_elastic_tpu_torch.ops.kernels import _build

    assert os.path.abspath(_build.__file__).startswith(os.path.abspath(root))
    if lib is None:
        lib, _ = _build.build()
        log = _build.build_log()
    nvcc = _build._nvcc()
    sass = subprocess.run([_tool(nvcc, "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fns = functions(sass)
    names = list(fns)
    filt = _tool(nvcc, "cu++filt") or shutil.which("c++filt")
    if filt and names:
        names = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    report = ptxas_lines(log)
    lines = []
    for (mangled, ops), name in zip(fns.items(), names):
        if not any(w in name for w in match):
            continue
        by_class = collections.Counter(_classify(op) for op in ops)
        top = collections.Counter(op for op in ops).most_common(12)
        lines.append({"label": label, "kernel": name,
                      "instructions": len(ops), "by_class": dict(by_class),
                      "top": top, "ptxas": report.get(mangled)})
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose kernels to disassemble")
    ap.add_argument("--label", default="")
    ap.add_argument("--match", nargs="+", default=list(MATCH))
    ap.add_argument("--out", help="append the JSON lines to this file")
    a = ap.parse_args()
    lines = counts(a.root, a.label or a.root, a.match)
    for line in lines:
        print(json.dumps(line), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
