"""The orders of sums of the redesigned kernels, on the CPU, f64 and f32.

The banded element phase writes each element's rows into its vertices'
slots of a slot-major buffer and the vertex phase adds a vertex's slots in
order (csrc/banded_phases.cuh): the plain version of that scatter and sum
(`banded_step.slot_planes`, `scatter_slots`, `sum_slots`) is held bitwise
to the twins' incidence walk (`_gather_rows`) on a small banded beam and
on a small Delaunay mesh (an ELL window's incidence). `cg_update`'s kernel
sums both of its dots on one thread-block cluster in `cluster_dot`'s
order: its twin is held bitwise to that order written out in numpy, one
scalar at a time, at an n that is no multiple of 16 x 1,024 and at one
where a CTA's threads hold two rows. The kernels are held to these twins
on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.ops.kernels import banded_step
from admm_elastic_tpu_torch.ops.kernels.cg_step import (CLUSTER,
                                                        CLUSTER_THREADS,
                                                        cg_update_reference)
from admm_elastic_tpu_torch.utils.scenes import jittered_system, small_delaunay

torch.set_num_threads(1)

DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(scope="module", params=["banded beam", "delaunay"])
def stepper(request):
    if request.param == "banded beam":
        s = jittered_system((4, 3, 3), device="cpu")
    else:
        s = small_delaunay(device="cpu")
    assert s._stepper is not None
    return s._stepper


def test_slot_planes_place_every_corner(stepper):
    """The slot buffer holds each vertex's slots in its incidence's order,
    vertex after vertex: vertex i's rows run from off[i] to off[i+1] - 1,
    and corner k of element e, of vertex i = idx[k,e], sits at pos[k,e] =
    off[i] + j where inc[i, j] = 4e + k; every row holds one corner."""
    p = stepper.planes
    E, n = stepper.n_elements, stepper.n_nodes
    pos, off = banded_step.slot_planes(p["inc"], E)
    assert torch.equal(pos, p["pos"]) and torch.equal(off, p["off"])
    assert pos.dtype == off.dtype == torch.int32 and off.shape == (n + 1,)
    idx, pos, off = p["idx"].long(), pos.long(), off.long()
    place = pos - off[idx]
    assert bool((place >= 0).all()) and bool((pos < off[idx + 1]).all())
    flat = 4 * torch.arange(E)[None, :] + torch.arange(4)[:, None]
    assert torch.equal(p["inc"].long()[idx, place], flat)
    assert torch.equal(torch.sort(pos.flatten()).values, torch.arange(4 * E))
    assert int(off[0]) == 0 and int(off[-1]) == 4 * E


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slot_sum_is_the_incidence_walk(stepper, dtype):
    """Random element rows (12,E) scattered into the slot buffer and each
    vertex's run of slots summed in order: bitwise the twins' walk of the
    incidence."""
    p = stepper.planes
    E = stepper.n_elements
    rng = np.random.default_rng(3)
    rows = torch.as_tensor(rng.standard_normal((12, E)), dtype=DTYPES[dtype])
    buf = banded_step.scatter_slots(rows, p["pos"])
    assert buf.shape == (4 * E, 4)
    got = banded_step.sum_slots(buf, p["off"])
    want = banded_step._gather_rows(rows, p["inc"].long())
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.0


def _tree(v):
    while len(v) > 1:
        h = len(v) // 2
        v = [v[t] + v[t + h] for t in range(h)]
    return v[0]


def _numpy_cluster_dot(a, b):
    """cg_update's order, one scalar at a time: per row the three products
    in order; CLUSTER slabs of ceil(n / CLUSTER) rows, thread t of a slab
    adding rows t, t + CLUSTER_THREADS, ...; a halving tree in each warp,
    then over the warps; the slabs in rank order."""
    zero = a.dtype.type(0)
    rows = [(p[0] + p[1]) + p[2] for p in a * b]
    n = len(rows)
    S = -(-n // CLUSTER)
    total = zero
    for rank in range(CLUSTER):
        lo, hi = min(rank * S, n), min(rank * S + S, n)
        acc = [zero] * CLUSTER_THREADS
        for li in range(hi - lo):
            t = li % CLUSTER_THREADS
            acc[t] = acc[t] + rows[lo + li]
        total = total + _tree([_tree(acc[w:w + 32])
                               for w in range(0, CLUSTER_THREADS, 32)])
    return total


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1000, 20011])
def test_cg_update_twin_sums_in_the_cluster_order(n, dtype):
    """Every output of cg_update_reference bitwise to the update written out
    in numpy with both dots in the cluster order (n = 20,011: slabs of
    1,251 rows, two a thread)."""
    npt = np.float64 if dtype == "f64" else np.float32
    rng = np.random.default_rng(n)
    x, r, p, Ap = (rng.standard_normal((n, 3)).astype(npt) for _ in range(4))
    invd = rng.uniform(0.5, 2.0, n).astype(npt)
    rz = npt(0.7)
    got = cg_update_reference(*(torch.as_tensor(a) for a in (
        x, r, p, np.array(rz), Ap, invd)))
    pAp = _numpy_cluster_dot(p, Ap)
    alpha = rz / (pAp if pAp > 0 else npt(1))
    x1 = x + alpha * p
    r1 = r - alpha * Ap
    z = invd[:, None] * r1
    rz1 = _numpy_cluster_dot(r1, z)
    beta = rz1 / (rz if rz > 0 else npt(1))
    want = (x1, r1, z + beta * p, np.array(rz1))
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dtype]
        assert np.array_equal(g.numpy(), w)
