"""One fused Jacobi-PCG vector update: hand-written CUDA kernels + plain
twin, and the fixed-iteration solve built on it.

Counterpart of `admm_elastic_tpu/ops/pallas/cg_step.py` (`cg_update`,
`pcg_solve_fixed_fused`). `cg_update(x, r, p, rz, Ap, inv_diag)` does every
vector op of one CG iteration after the matvec: pAp, alpha (pAp > 0
guard), x', r', z = D^-1 r', rz' = r'.z, beta (rz > 0 guard), p' = z +
beta p. Vectors are (n,3) (the JAX kernel's (3, n+pad) lane layout is not
carried over), inv_diag is (n,), rz a one-element tensor; rz' comes back
as a 0-dim tensor on the same device, never read by the host.

`cg_update` runs `csrc/cg_step.cu` for CUDA tensors (one C call, three
launches) and `cg_update_reference` for CPU tensors. It never falls back
from one to the other.

The whole solves (`cg_dia_solve`, `cg_ell_solve`) run on one thread-block
cluster (`csrc/cluster_pcg.cuh`); `cluster_dot` is their order of sums,
`cluster_plan` their layout and `cluster_solve` their launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
THREADS = 256  # the block of the chain kernels (csrc/pcg_chain.cuh)
# the cluster solves (csrc/cluster_pcg.cuh): CTAs of the cluster (fixed at
# compile time) and threads of each
CLUSTER = 16
CLUSTER_THREADS = 1024


def _halving_tree(v):
    """Sum each row of (m, THREADS) as block_sum does (csrc/common.cuh):
    lane t adds lane t + s for s = THREADS/2, ..., 1."""
    w = v.shape[1]
    while w > 1:
        w //= 2
        v = v[:, :w] + v[:, w:2 * w]
    return v[:, 0]


def chain_dot(a, b):
    """sum(a * b) over (n,3) in the order of the chain kernels' partial
    sums (csrc/pcg_chain.cuh), so a twin that uses it repeats the kernels
    bitwise: per row the three products in order; per block of THREADS
    rows the halving tree; the block partials strided over THREADS lanes,
    then the same tree."""
    prod = a * b
    rows = (prod[:, 0] + prod[:, 1]) + prod[:, 2]
    nb = -(-rows.shape[0] // THREADS)
    part = _halving_tree(F.pad(rows, (0, nb * THREADS - rows.shape[0]))
                         .reshape(nb, THREADS))
    m = -(-nb // THREADS)
    lanes = F.pad(part, (0, m * THREADS - nb)).reshape(m, THREADS)
    acc = lanes[0]
    for j in range(1, m):
        acc = acc + lanes[j]
    return _halving_tree(acc[None, :])[0]


def cluster_dot(a, b):
    """sum(a * b) over (n,3) in the order of the cluster solves' sums
    (csrc/cluster_pcg.cuh), so a twin that uses it repeats them bitwise:
    per row the three products in order; the rows cut into CLUSTER slabs
    of ceil(n / CLUSTER); in a slab, thread t adds rows t, t +
    CLUSTER_THREADS, ... in turn; the threads' sums by the halving tree
    within each warp of 32, then over the 32 warps; the slabs' sums in
    rank order."""
    prod = a * b
    rows = (prod[:, 0] + prod[:, 1]) + prod[:, 2]
    n = rows.shape[0]
    S = -(-n // CLUSTER)
    m = -(-S // CLUSTER_THREADS)
    slabs = F.pad(rows, (0, CLUSTER * S - n)).reshape(CLUSTER, S)
    turns = F.pad(slabs, (0, m * CLUSTER_THREADS - S)).reshape(
        CLUSTER, m, CLUSTER_THREADS)
    acc = torch.zeros_like(turns[:, 0])
    for k in range(m):
        acc = acc + turns[:, k]
    warps = _halving_tree(acc.reshape(-1, 32)).reshape(CLUSTER, -1)
    ctas = _halving_tree(warps)
    total = torch.zeros_like(ctas[0])
    for r in range(CLUSTER):
        total = total + ctas[r]
    return total


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


def cluster_solve(name, b, ptrs, width, reach, mat_per_row, n_iters):
    """Launch the cluster solve `name` (cg_dia_solve, cg_ell_solve) for
    b (n,3) on a CUDA device: `ptrs` are the C entry's five leading
    pointers, `width` its D or K, `reach` how far a row reaches. Returns
    x; raises on any CUDA error, among them a cluster the card cannot
    place."""
    n = b.shape[0]
    plan = cluster_plan(n, b.dtype, reach, mat_per_row, b.device)
    x = torch.empty_like(b)
    scratch = b.new_empty(plan["scratch"]) if plan["scratch"] else None
    fn = getattr(_build.load_library(), f"{name}_{_SUFFIX[b.dtype]}")
    err = fn(*ptrs, width, reach, n, int(n_iters), x.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             _build.stream_ptr(b))
    _build.check(err, name)
    return x


def cg_update_reference(x, r, p, rz, Ap, inv_diag):
    """Plain PyTorch version: the Pallas kernel's steps, with its sums in
    the CUDA kernel's order (`chain_dot`)."""
    pAp = chain_dot(p, Ap)
    rz = rz.reshape(())
    alpha = rz / torch.where(pAp > 0, pAp, 1.0)
    x = x + alpha * p
    r = r - alpha * Ap
    z = inv_diag[:, None] * r
    rz_new = chain_dot(r, z)
    beta = rz_new / torch.where(rz > 0, rz, 1.0)
    return x, r, z + beta * p, rz_new


def _check(x, r, p, rz, Ap, inv_diag):
    n = x.shape[0] if x.dim() == 2 else -1
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
    return n


def cg_update(x, r, p, rz, Ap, inv_diag):
    """One fused CG update; returns (x', r', p', rz')."""
    n = _check(x, r, p, rz, Ap, inv_diag)
    if x.device.type == "cpu":
        return cg_update_reference(x, r, p, rz, Ap, inv_diag)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    lib = _build.load_library()
    fn = getattr(lib, "cg_update_" + _SUFFIX[x.dtype])
    x_out, r_out, p_out = (torch.empty_like(x) for _ in range(3))
    rz_out = x.new_empty(())
    partials = x.new_empty(lib.cg_partials(n))
    err = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
             Ap.data_ptr(), inv_diag.data_ptr(), n, x_out.data_ptr(),
             r_out.data_ptr(), p_out.data_ptr(), rz_out.data_ptr(),
             partials.data_ptr(), _build.stream_ptr(x))
    _build.check(err, "cg_update")
    cg_update.launches += 1
    return x_out, r_out, p_out, rz_out


cg_update.launches = 0


def pcg_solve_fixed_fused(A_apply, b, x0, diag, n_iters: int):
    """Fixed-iteration Jacobi-PCG: A_apply (plain PyTorch, e.g. the ELL
    gather) then one `cg_update` per iteration. Returns x."""
    inv_diag = 1.0 / diag
    r = b - A_apply(x0)
    p = inv_diag[:, None] * r
    rz = chain_dot(r, p)
    x = x0
    for _ in range(int(n_iters)):
        x, r, p, rz = cg_update(x, r, p, rz, A_apply(p), inv_diag)
    return x
