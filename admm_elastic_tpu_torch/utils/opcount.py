"""Operation and byte counts of a function, for a kernel's roofline bound.

`count_ops(fn)` runs `fn` (a kernel's plain PyTorch twin, on the kernel's
inputs) under a dispatch mode and counts its arithmetic: one operation per
output element of every elementwise arithmetic, comparison or select op,
and one per input element of every sum. Data movement (indexing, copies,
stacking, padding, reshapes) counts nothing. The twins evaluate every
branch the kernels evaluate (both sides of each select, every Newton
candidate), so the count is the work the kernel does on those inputs.

`nbytes(*trees)` sums the sizes of the tensors in dicts, lists or tuples:
each input read once and each output written once.

bound_ms = max(bytes / memory rate, operations / peak rate) is the least
time the card could take for the same work (`roofline_ms`).
`tri_local_counts` and `rollout_counts` give (operations, bytes) of the
triangle kernel and of the whole-timestep kernels on their inputs, from
their twins.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.kernels import tri_local

_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "log",
    "reciprocal", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "where", "sign", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
))
_REDUCTIONS = frozenset(("sum",))

#: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity): HBM3
#: bytes/s and float32 operations/s outside the tensor cores, at 700 W
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name == "mul" and any(a is not None and not isinstance(a, torch.Tensor)
                                 and a == 1 for a in args):
            return out  # the scale of 1 / t = reciprocal(t) * 1
        if name in _ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        elif name in _REDUCTIONS:
            self.ops += args[0].numel()
        return out


def count_ops(fn, *args, **kwargs) -> tuple[int, object]:
    """(operations, fn's result) of fn(*args, **kwargs)."""
    with _Counter() as c:
        out = fn(*args, **kwargs)
    return c.ops, out


def nbytes(*trees) -> int:
    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
    return total


def roofline_ms(n_bytes, n_ops, bytes_per_s=H100_BYTES_PER_S,
                ops_per_s=H100_F32_OPS_PER_S) -> tuple[float, str]:
    """(bound in ms, 'bytes' or 'operations', whichever binds)."""
    t_bytes, t_ops = n_bytes / bytes_per_s, n_ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tri_local_counts(xg9, u6, cp6, w2, k, lmin, lmax, limiting=True):
    """(operations, bytes) of `tri_local_step_fused` on these inputs."""
    ins = (xg9, u6, cp6, w2, k, lmin, lmax)
    ops, out = count_ops(tri_local.tri_local_step_fused_reference, *ins,
                         limiting=limiting)
    return ops, nbytes(ins, out)


def rollout_counts(reference, keys, state, planes, cfg, n_steps):
    """(operations, bytes) of a whole-timestep kernel (banded_rollout or
    cloth_rollout, given its twin and state keys) for n_steps: the state
    and planes read once, the new state written once."""
    ops, out = count_ops(reference, state, planes, cfg, n_steps)
    return ops, nbytes(({k: state[k] for k in keys}, planes), out)
