"""One fused Jacobi-PCG vector update: hand-written CUDA kernel + plain
twin, and the fixed-iteration solve built on it.

Counterpart of `admm_elastic_tpu/ops/pallas/cg_step.py` (`cg_update`,
`pcg_solve_fixed_fused`). `cg_update(x, r, p, rz, Ap, inv_diag)` does every
vector op of one CG iteration after the matvec: pAp, alpha (pAp > 0
guard), x', r', z = D^-1 r', rz' = r'.z, beta (rz > 0 guard), p' = z +
beta p. Vectors are (n,3) (the JAX kernel's (3, n+pad) lane layout is not
carried over), inv_diag is (n,), rz a one-element tensor; rz' comes back
as a 0-dim tensor on the same device, never read by the host.

`cg_update` runs `csrc/cg_step.cu` for CUDA tensors (one C call, one
launch on one 16-CTA thread-block cluster, both dots summed in
`cluster_dot`'s order) and `cg_update_reference` for CPU tensors. It
never falls back from one to the other.

The whole solves (`cg_dia_solve`, `cg_ell_solve`) run on one thread-block
cluster too (`csrc/cluster_pcg.cuh`); `cluster_dot` is their order of
sums, `cluster_plan` their layout and `cluster_solve` their launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the cluster kernels (csrc/cluster_pcg.cuh, csrc/cg_step.cu): CTAs of the
# cluster (fixed at compile time) and threads of each
CLUSTER = 16
CLUSTER_THREADS = 1024


def _halving_tree(v):
    """Sum each row of (m, w), w a power of two, as the kernels' trees do
    (`block_sum` in csrc/common.cuh, the warp trees of
    csrc/cluster_pcg.cuh): lane t adds lane t + s for s = w/2, ..., 1."""
    w = v.shape[1]
    while w > 1:
        w //= 2
        lo, hi = v.split(w, dim=1)
        v = lo + hi
    return v[:, 0]


def cluster_dot(a, b):
    """sum(a * b) over (n,3) in the order of the cluster kernels' sums
    (csrc/cluster_pcg.cuh, csrc/cg_step.cu), so a twin that uses it
    repeats them bitwise: per row the three products in order; the rows
    cut into CLUSTER slabs of ceil(n / CLUSTER); in a slab, thread t adds
    rows t, t + CLUSTER_THREADS, ... in turn; the threads' sums by the
    halving tree within each warp of 32, then over the 32 warps; the
    slabs' sums in rank order."""
    p0, p1, p2 = (a * b).unbind(1)
    rows = (p0 + p1) + p2
    n = rows.shape[0]
    S = -(-n // CLUSTER)
    m = -(-S // CLUSTER_THREADS)
    slabs = F.pad(rows, (0, CLUSTER * S - n)).view(CLUSTER, S)
    turns = F.pad(slabs, (0, m * CLUSTER_THREADS - S)).view(
        CLUSTER, m, CLUSTER_THREADS)
    acc = turns.new_zeros(())
    for turn in turns.unbind(1):
        acc = acc + turn
    warps = _halving_tree(acc.view(-1, 32)).view(CLUSTER, -1)
    # the ranks in order, one scalar add at a time in the working
    # precision (a Python float is a double)
    scalar = np.float32 if rows.dtype == torch.float32 else float
    total = scalar(0)
    for cta in _halving_tree(warps).tolist():
        total = total + scalar(cta)
    return torch.tensor(total, dtype=rows.dtype, device=rows.device)


@functools.lru_cache(maxsize=None)
def _plan(device, n, reach, mat_per_row, elem):
    lib = _build.load_library()
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device):
        _build.check(lib.cg_cluster_plan(n, reach, mat_per_row, elem,
                                         ctypes.addressof(out)),
                     "cg_cluster_plan")
    return {"cluster": CLUSTER, "threads": CLUSTER_THREADS,
            "slab_rows": out[0], "window_rows": out[1],
            "vectors_in_smem": bool(out[2]), "matrix_in_smem": bool(out[3]),
            "smem_bytes": out[4], "scratch": out[5]}


def cluster_plan(n, dtype, reach, mat_per_row, device=None) -> dict:
    """The layout of a cluster solve of n rows, each reaching `reach` rows
    away, on a CUDA device (the current one by default): rows a CTA owns,
    rows of its window of the vectors, whether those (and its matrix
    rows: `mat_per_row` values each, the dia solve's D; 0 for ELL) are in
    shared memory, the dynamic shared memory a CTA, and the elements of
    global scratch the solve needs (0 when the vectors are in shared
    memory). Asked of the library once for each device, size and dtype."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    elem = torch.empty((), dtype=dtype).element_size()
    return dict(_plan(device.index, int(n), int(reach), int(mat_per_row),
                      elem))


def cluster_solve(name, b, ptrs, width, reach, mat_per_row, n_iters,
                  inverse=False):
    """Launch the cluster solve `name` (cg_dia_solve, cg_ell_solve) for
    b (n,3) on a CUDA device: `ptrs` are the C entry's five leading
    pointers (the third A's diagonal, or with inverse=True D^-1), `width`
    its D or K, `reach` how far a row reaches. Returns x; raises on any
    CUDA error, among them a cluster the card cannot place."""
    n = b.shape[0]
    plan = cluster_plan(n, b.dtype, reach, mat_per_row, b.device)
    x = torch.empty_like(b)
    scratch = b.new_empty(plan["scratch"]) if plan["scratch"] else None
    fn = getattr(_build.load_library(), f"{name}_{_SUFFIX[b.dtype]}")
    err = fn(*ptrs, width, reach, n, int(n_iters), int(inverse),
             x.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             _build.stream_ptr(b))
    _build.check(err, name)
    return x


def cluster_prepare(like, n, reach, width, ell=False, n_scen=1):
    """The set-up of the cluster solves of n rows reaching `reach`, dtype
    and device of `like`, D = `width` diagonals (or ELL rows, ell=True):
    the kernel's attributes and the check that the card can place the
    cluster, which a CUDA graph capture must find done. Returns the
    solve's global scratch, n_scen times over for a sweep's solves (None
    when its plan keeps the vectors in shared memory)."""
    plan = cluster_plan(n, like.dtype, reach, 0 if ell else width,
                        like.device)
    lib, suffix = _build.load_library(), _SUFFIX[like.dtype]
    with torch.cuda.device(like.device):
        err = (getattr(lib, f"cg_ell_prepare_{suffix}")(reach, n) if ell
               else getattr(lib, f"cg_dia_prepare_{suffix}")(width, reach,
                                                             n))
    _build.check(err, "cluster solve set-up")
    return (like.new_empty(plan["scratch"] * n_scen) if plan["scratch"]
            else None)


def active_clusters(n, dtype, reach, width, ell=False, device=None) -> int:
    """How many clusters of the cluster solve of n rows reaching `reach`
    (D = `width` diagonals, or ELL rows with ell=True) the card holds at
    once (cudaOccupancyMaxActiveClusters for its plan's kernel and shared
    memory): a sweep's solve of S scenarios, one cluster each, runs in
    ceil(S / this) waves."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    lib, suffix = _build.load_library(), _SUFFIX[dtype]
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = (getattr(lib, f"cg_ell_clusters_{suffix}")(
            int(reach), int(n), ctypes.byref(out)) if ell
               else getattr(lib, f"cg_dia_clusters_{suffix}")(
            int(width), int(reach), int(n), ctypes.byref(out)))
    _build.check(err, "cluster occupancy")
    return out.value


def cg_update_reference(x, r, p, rz, Ap, inv_diag):
    """Plain PyTorch version: the Pallas kernel's steps, with both dots
    summed in the CUDA kernel's order (`cluster_dot`)."""
    pAp = cluster_dot(p, Ap)
    rz = rz.reshape(())
    alpha = rz / torch.where(pAp > 0, pAp, 1.0)
    x = x + alpha * p
    r = r - alpha * Ap
    z = inv_diag[:, None] * r
    rz_new = cluster_dot(r, z)
    beta = rz_new / torch.where(rz > 0, rz, 1.0)
    return x, r, z + beta * p, rz_new


def _check(x, r, p, rz, Ap, inv_diag):
    """n, after checking the six inputs: the common case in one
    expression, the detail only where it fails."""
    n = x.shape[0] if x.dim() == 2 else -1
    if (x.shape == r.shape == p.shape == Ap.shape == (n, 3)
            and inv_diag.shape == (n,) and rz.numel() == 1
            and x.dtype in _SUFFIX
            and x.dtype == r.dtype == p.dtype == Ap.dtype == inv_diag.dtype
            == rz.dtype
            and x.device == r.device == p.device == Ap.device
            == inv_diag.device == rz.device
            and x.is_contiguous() and r.is_contiguous()
            and p.is_contiguous() and Ap.is_contiguous()
            and inv_diag.is_contiguous()):
        return n
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {x.dtype}")
    for name, t, shape in (("x", x, (n, 3)), ("r", r, (n, 3)),
                           ("p", p, (n, 3)), ("Ap", Ap, (n, 3)),
                           ("inv_diag", inv_diag, (n,)),
                           ("rz", rz, tuple(rz.shape))):
        if tuple(t.shape) != shape or (name == "rz" and t.numel() != 1):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape if name != 'rz' else 'one element'}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{x.dtype} on {x.device}")
    raise ValueError("cg_update: inconsistent inputs")


@functools.cache
def _update_fn(dtype):
    return getattr(_build.load_library(), "cg_update_" + _SUFFIX[dtype])


def cg_update(x, r, p, rz, Ap, inv_diag, out=None):
    """One fused CG update; returns (x', r', p', rz'). `out`: optional
    (x', r', p', rz') buffers the kernel writes instead of new ones (each
    may be its own input's buffer; the CPU twin returns new tensors)."""
    n = _check(x, r, p, rz, Ap, inv_diag)
    if x.device.type == "cpu":
        return cg_update_reference(x, r, p, rz, Ap, inv_diag)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if out is None:
        out = (torch.empty_like(x), torch.empty_like(x),
               torch.empty_like(x), x.new_empty(()))
    elif not (len(out) == 4 and all(
            o.shape == x.shape and o.dtype == x.dtype and o.device == x.device
            and o.is_contiguous() for o in out[:3])
              and out[3].numel() == 1 and out[3].dtype == x.dtype
              and out[3].device == x.device):
        raise ValueError("out: (x', r', p') of x's shape, dtype and device "
                         "and a one-element rz' expected")
    x_out, r_out, p_out, rz_out = out
    err = _update_fn(x.dtype)(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
        Ap.data_ptr(), inv_diag.data_ptr(), n, x_out.data_ptr(),
        r_out.data_ptr(), p_out.data_ptr(), rz_out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        _build.check(err, "cg_update")
    cg_update.launches += 1
    return out


cg_update.launches = 0


def pcg_solve_fixed_fused(A_apply, b, x0, diag, n_iters: int):
    """Fixed-iteration Jacobi-PCG: A_apply (plain PyTorch, e.g. the ELL
    gather) then one `cg_update` per iteration. Returns x. On a card the
    iterations ping-pong between two sets of (x, r, p, rz) buffers."""
    inv_diag = 1.0 / diag
    r = b - A_apply(x0)
    p = inv_diag[:, None] * r
    rz = cluster_dot(r, p)
    x = x0
    sets = ([tuple(torch.empty_like(b) for _ in range(3)) + (b.new_empty(()),)
             for _ in range(2)] if b.device.type == "cuda" else [None, None])
    for k in range(int(n_iters)):
        x, r, p, rz = cg_update(x, r, p, rz, A_apply(p), inv_diag,
                                out=sets[k % 2])
    return x
