"""Operation and byte counts of a function, for a kernel's roofline bound.

`count_ops(fn)` runs `fn` (a kernel's plain PyTorch twin, on the kernel's
inputs) under a dispatch mode and counts its arithmetic: one operation per
output element of every elementwise arithmetic, comparison or select op,
and one per input element of every sum. Data movement (indexing, copies,
stacking, padding, reshapes) counts nothing. The twins evaluate every
branch the kernels evaluate (both sides of each select, every Newton
candidate), so the count is the work the kernel does on those inputs.
A multigrid V-cycle is the exception: its twin (`uamg.vcycle`, the
geometric multigrid's too, in its compact level form) adds the zeros of
its padded member lists and ELL slots, so `count_ops` counts each V-cycle
by the work the function needs (`uamg_vcycle_ops`) instead.

`nbytes(*trees)` sums the sizes of the tensors in dicts, lists or tuples:
each input read once and each output written once.

bound_ms = max(bytes / memory rate, operations / peak rate) is the least
time the card could take for the same work (`roofline_ms`).
`twin_counts` gives (operations, bytes) of a kernel on its inputs from its
twin (the element steps', by their `_reference` twins; `cg_update_counts`,
`cg_dia_counts`, `cg_ell_counts` and `mg_dia_counts` name the CG kernels,
the solves' with one plain sum a dot (the multigrid modes' V-cycles
included, `uamg_ell_counts` the algebraic one's); `banded_local_counts` and
`cheb_dia_counts` the sharded stepper's), and `rollout_counts` those of the
whole-timestep kernels (banded in dia or ELL mode, cloth, lattice; the
banded and cloth ones in their multigrid mode too; `sweep_counts` the
banded window's sweep mode). The
lattice kernel's twin skips a group's zero selector coefficients as the
kernel does, so its count is the arithmetic of the nonzero ones.
The residual modes (the element steps' `emit_z`, the windows'
`cfg.collect`, B11's `collect`) are counted the same way, from twins that
compute them: each element's and vertex's piece and the partial sums,
with the partials' zero padding to whole blocks counted as sums too (at
most THREADS - 1 additions a block row).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.solver import dia_apply, pcg_solve_fixed
from ..ops.kernels import (banded_local, banded_step, cg_ell, cg_step,
                           cheb_dia, uamg)

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
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
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
    """(operations, fn's result) of fn(*args, **kwargs); each V-cycle that
    fn reaches through `uamg.vcycle` counts as `uamg_vcycle_ops` says."""
    with _Counter() as c, _needed_vcycles(c):
        out = fn(*args, **kwargs)
    return c.ops, out


@contextlib.contextmanager
def _paused(counter):
    counter.paused = True
    try:
        yield
    finally:
        counter.paused = False


def uamg_level_ops(planes, n) -> int:
    """Operations one algebraic V-cycle (`uamg.vcycle`) needs on one
    column of n fine rows, besides its two fine matvecs. With nc1, nc2 the
    level sizes and L the nonzero entries of A1: on the fine rows z = om0
    r, r - A z, r - A z, om0 times it, z plus it and z + P0 z1 (6n) and
    R0 (n - nc1 sums); on level 1 om1 r1, two A1 products (2 L - nc1
    each), r1 - A1 z1 twice, z1 + P1 z2, om1 times it and z1 plus it
    (6 nc1) and R1 (nc1 - nc2 sums); A2^-1 r2 nc2 (2 nc2 - 1):
        7 n + 4 L + 4 nc1 + 2 nc2^2 - 2 nc2."""
    nc1 = planes["ua_om1"].numel()
    nc2 = planes["ua_a2inv"].shape[0]
    L = int(torch.count_nonzero(planes["ua_l1_vals"]))
    return 7 * n + 4 * L + 4 * nc1 + 2 * nc2 * nc2 - 2 * nc2


def uamg_vcycle_ops(r, A, planes) -> int:
    """Operations one algebraic V-cycle on r (n,k) needs: its two fine
    matvecs as A counts them, and k columns of `uamg_level_ops`."""
    matvec, _ = count_ops(A, r)
    return 2 * matvec + r.shape[1] * uamg_level_ops(planes, r.shape[0])


@contextlib.contextmanager
def _needed_vcycles(counter):
    """While counting, `uamg.vcycle` computes as before, uncounted, and
    adds its two fine matvecs (run once more to be counted as A counts
    them) and `uamg_level_ops` for each column."""
    twin = uamg.vcycle

    def vcycle(r, A, planes):
        with _paused(counter):
            z = twin(r, A, planes)
            level = r.shape[1] * uamg_level_ops(planes, r.shape[0])
        A(r), A(r)
        counter.ops += level
        return z

    uamg.vcycle = vcycle
    try:
        yield
    finally:
        uamg.vcycle = twin


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


def twin_counts(reference, *args, **kwargs) -> tuple[int, int]:
    """(operations, bytes) of a kernel whose twin is `reference`, on these
    inputs: the twin's arithmetic, each tensor input read once and each
    output written once."""
    ops, out = count_ops(reference, *args, **kwargs)
    return ops, nbytes(args, out)


def cg_update_counts(x, r, p, rz, Ap, inv_diag):
    """(operations, bytes) of one `cg_update`."""
    return twin_counts(cg_step.cg_update_reference, x, r, p, rz, Ap,
                       inv_diag)


def _solve_counts(A_apply, b, x0, diag, n_iters, matrix):
    """(operations, bytes) of a fixed-iteration Jacobi-PCG solve: its
    arithmetic with each dot one product and one sum of 3n values (the
    order a kernel adds them in is not work), b, x0, diag and the matrix
    read once, x written once."""
    ops, x = count_ops(lambda: pcg_solve_fixed(A_apply, b, x0, diag,
                                               n_iters)[0])
    return ops, nbytes(b, x0, diag, matrix, x)


def cg_dia_counts(b, x0, diag, dia_vals, offsets, n_iters):
    """(operations, bytes) of a `cg_dia_solve` of n_iters iterations: the
    diagonals count once however often the iterations read them, and the
    matvec only its terms inside the matrix (`dia_apply`)."""
    return _solve_counts(lambda y: dia_apply(y, offsets, dia_vals), b, x0,
                         diag, n_iters, dia_vals)


def cg_ell_counts(b, x0, diag, ell_idx, ell_vals, n_iters):
    """(operations, bytes) of a `cg_ell_solve` of n_iters iterations: the
    ELL arrays count once however often the iterations read them."""
    return _solve_counts(
        lambda y: cg_ell.ell_apply_by_slot(y, ell_idx, ell_vals), b, x0,
        diag, n_iters, (ell_idx, ell_vals))


def mg_dia_counts(b, x0, dia_vals, offsets, planes, cfg, n_iters):
    """(operations, bytes) of an `mg_dia_solve` of n_iters iterations: the
    V-cycle PCG's arithmetic with each dot one product and one sum of 3n
    values and each V-cycle what it needs (`uamg_vcycle_ops`); b, x0, the
    diagonals and the multigrid's planes (its compact level form) read
    once however often the iterations read them, x written once."""
    ops, x = count_ops(uamg.pcg_fixed_uamg,
                       lambda y: dia_apply(y, offsets, dia_vals), b, x0,
                       planes, n_iters)
    return ops, nbytes(b, x0, dia_vals, [planes[k] for k in uamg.PLANES],
                       x)


def uamg_ell_counts(b, x0, ell_idx, ell_vals, planes, cfg, n_iters):
    """(operations, bytes) of a `uamg_ell_solve` of n_iters iterations:
    the V-cycle PCG's arithmetic with each dot one product and one sum of
    3n values and each V-cycle what it needs (`uamg_vcycle_ops`); b, x0,
    the ELL arrays and the multigrid's planes read once however often the
    iterations read them, x written once."""
    ops, x = count_ops(uamg.pcg_fixed_uamg,
                       lambda y: cg_ell.ell_apply_by_slot(y, ell_idx,
                                                          ell_vals),
                       b, x0, planes, n_iters)
    return ops, nbytes(b, x0, ell_idx, ell_vals,
                       [planes[k] for k in uamg.PLANES], x)


def rollout_counts(reference, keys, state, planes, cfg, n_steps):
    """(operations, bytes) of a whole-timestep kernel (banded_rollout,
    cloth_rollout or lattice_rollout, given its twin and state keys) for
    n_steps: the state and planes read once, the new state written once.
    A twin that sums its solve's dots in a kernel's order (a `dot`
    argument) is counted with plain sums: a dot is one product and one sum
    of 3n values, as in the solves' counts."""
    kw = ({"dot": None} if "dot" in inspect.signature(reference).parameters
          else {})
    ops, out = count_ops(reference, state, planes, cfg, n_steps, **kw)
    return ops, nbytes(({k: state[k] for k in keys}, planes), out)


def sweep_counts(state, planes, cfg, n_steps):
    """(operations, bytes) of a sweep window (`banded_rollout` with
    cfg.n_scen = S scenarios) for n_steps: S times one scenario's
    operations (the twin evaluates every branch, so each scenario does the
    same work; counted on scenario 0 with plain sums, as
    `rollout_counts`), the state and every plane read once (a swept plane
    for each scenario, a shared one once) and the new state written
    once."""
    S = cfg.n_scen
    ops, out = count_ops(banded_step.banded_rollout_reference,
                         {k: state[k][0] for k in banded_step.STATE},
                         banded_step.scenario_planes(planes, 0),
                         dataclasses.replace(cfg, n_scen=None), n_steps,
                         dot=None)
    read = nbytes({k: state[k] for k in banded_step.STATE}, planes)
    return S * ops, read + S * nbytes(out)


def banded_local_counts(x, au, cu, u, warm, planes, cfg, collect=False):
    """(operations, bytes) of one `banded_local_rhs`: the twin's
    arithmetic; the state and the planes the kernels read (the slot planes,
    not the twin's incidence) once, its five outputs (six with collect)
    written once (the slot buffer passed between its two kernels, and the
    residual's partials, are not counted)."""
    ops, out = count_ops(banded_local.banded_local_rhs_reference, x, au, cu,
                         u, warm, planes, cfg, collect)
    return ops, nbytes(x, au, cu, u, warm,
                       [planes[k] for k in banded_local.PLANES], out)


def cheb_dia_counts(b, x, z, d, invd, dia, c1, c2, *, offsets, n_it, first,
                    last, inv_theta):
    """(operations, bytes) of one `cheb_dia_chunk`: what it reads (b with
    `first`, else z and d; n_it coefficients each) once, x, z, d written
    once; the matrix counts once however often the iterations read it.
    The matvec counts only the terms inside the matrix, as the kernel
    computes only those (`dia_apply`)."""
    ops, out = count_ops(cheb_dia.cheb_dia_chunk_reference, b, x, z, d, invd,
                         dia, c1, c2, offsets=offsets, n_it=n_it, first=first,
                         last=last, inv_theta=inv_theta)
    read = [x, invd, dia, c1[:n_it], c2[:n_it], *([b] if first else [z, d])]
    return ops, nbytes(read, out)
