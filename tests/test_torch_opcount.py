"""The operation and byte counts behind chip_smoke.py's roofline bounds."""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.utils.opcount import count_ops, nbytes, roofline_ms

A = torch.ones(10, 3, dtype=torch.float64)
B = torch.full((10, 3), 2.0, dtype=torch.float64)


@pytest.mark.parametrize("fn,ops", [
    (lambda: torch.sum(A * B + 1.0), 90),          # mul, add, sum over 30
    (lambda: torch.where(A > 0, A, B) / 2.0, 90),  # gt, where, div
    (lambda: 1.0 / A, 30),                         # one division each
    (lambda: torch.sqrt(torch.clamp_min(A, 0.5)), 60),
    (lambda: A[torch.tensor([0, 1])].reshape(-1).clone(), 0),  # movement
    (lambda: torch.stack([A, B]).permute(2, 0, 1).contiguous(), 0),
], ids=["mul-add-sum", "select-div", "reciprocal", "clamp-sqrt", "gather",
        "stack"])
def test_count_ops(fn, ops):
    got, out = count_ops(fn)
    assert got == ops
    assert torch.equal(out, fn())


def test_nbytes_and_roofline():
    tree = {"x": A, "y": [B, torch.zeros(4, dtype=torch.int32)]}
    assert nbytes(tree) == 2 * 30 * 8 + 4 * 4
    assert roofline_ms(3.35e9, 1e9) == (pytest.approx(1.0), "bytes")
    assert roofline_ms(1.0, 67e9) == (pytest.approx(1.0), "operations")


def test_tri_local_counts_are_per_element():
    """The triangle step's work does not depend on the data: the count
    doubles with E, and the bytes are 25 inputs and 21 outputs per
    element."""
    from admm_elastic_tpu_torch.ops.kernels import tri_local
    from admm_elastic_tpu_torch.utils.opcount import twin_counts

    def counts(E, seed):
        g = torch.Generator().manual_seed(seed)
        ins = [torch.randn(r, E, generator=g, dtype=torch.float64)
               for r in (9, 6, 6)]
        ins += [torch.rand(E, generator=g, dtype=torch.float64) + 0.5
                for _ in range(4)]
        return twin_counts(tri_local.tri_local_step_fused_reference, *ins)

    (o1, b1), (o2, b2) = counts(40, 0), counts(80, 1)
    assert o2 == 2 * o1 and o1 > 100 * 40
    assert b1 == 40 * (25 + 21) * 8 and b2 == 2 * b1


def test_cloth_rollout_counts_one_cg_iteration():
    """One more CG iteration per ADMM iteration adds exactly the work of
    one Jacobi-PCG iteration (`pcg_fixed_inv`) with the dia matvec, per
    ADMM iteration: the matvec (a product and a sum, 6(n - |off|), for
    each diagonal), 33n vector ops and 6 scalar ones."""
    import dataclasses

    from admm_elastic_tpu_torch.ops.kernels import cloth_step
    from admm_elastic_tpu_torch.utils.opcount import rollout_counts
    from admm_elastic_tpu_torch.utils.scenes import small_cloth

    st = small_cloth(device="cpu")._stepper
    cfg = dataclasses.replace(st.cfg, cg_iters=3, admm_iters=2)

    def counts(cfg):
        return rollout_counts(cloth_step.cloth_rollout_reference,
                              cloth_step.STATE, st.state, st.planes, cfg, 1)

    o3, b3 = counts(cfg)
    o4, b4 = counts(dataclasses.replace(cfg, cg_iters=4))
    n = st.n_nodes
    matvec = sum(6 * (n - abs(off)) for off in cfg.dia_offs)
    assert o4 - o3 == cfg.admm_iters * (matvec + 33 * n + 6)
    assert b3 == b4 > 0


def test_cg_update_counts_bytes():
    """cg_update reads x, r, p, Ap (n,3), inv_diag (n,) and rz, and writes
    x', r', p' and rz': 22 n-values and 2 scalars."""
    from admm_elastic_tpu_torch.utils.opcount import cg_update_counts

    n = 300
    g = torch.Generator().manual_seed(0)
    x, r, p, Ap = (torch.randn(n, 3, generator=g, dtype=torch.float64)
                   for _ in range(4))
    inv = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    ops, n_bytes = cg_update_counts(x, r, p, torch.tensor(0.3, dtype=x.dtype),
                                    Ap, inv)
    assert n_bytes == 8 * (22 * n + 2)
    assert ops > 30 * n


def test_banded_ell_rollout_counts_one_cg_iteration():
    """In ELL mode one more CG iteration per ADMM iteration adds the ELL
    matvec (a product and a sum per slot: 6nK) and the 33n + 6 vector and
    scalar operations of a Jacobi-PCG iteration (`pcg_fixed_inv`, which
    forms D^-1 r once), per ADMM iteration."""
    import dataclasses

    from admm_elastic_tpu_torch.ops.kernels import banded_step
    from admm_elastic_tpu_torch.utils.opcount import rollout_counts
    from admm_elastic_tpu_torch.utils.scenes import small_delaunay

    st = small_delaunay(device="cpu")._stepper
    cfg = dataclasses.replace(st.cfg, cg_iters=3, admm_iters=2)
    assert cfg.matrix == "ell"

    def counts(cfg):
        return rollout_counts(banded_step.banded_rollout_reference,
                              banded_step.STATE, st.state, st.planes, cfg, 1)

    o3, b3 = counts(cfg)
    o4, b4 = counts(dataclasses.replace(cfg, cg_iters=4))
    n, K = st.n_nodes, cfg.ell_width
    assert o4 - o3 == cfg.admm_iters * (6 * n * K + 33 * n + 6)
    assert b3 == b4 > 0


def test_lattice_rollout_counts():
    """One more CG iteration per ADMM iteration adds the dia matvec (a
    product and a sum per term inside the matrix: 6(n - |off|) per
    diagonal) and the 33n + 6 vector and scalar operations of a Jacobi-PCG
    iteration (`pcg_fixed_inv`, which forms D^-1 r once), per ADMM
    iteration; and the
    element phase does no work on a group's zero selector coefficients."""
    import dataclasses

    import numpy as np

    from admm_elastic_tpu_torch.core.lattice import LatticeStepper
    from admm_elastic_tpu_torch.ops.kernels import lattice_step
    from admm_elastic_tpu_torch.utils.opcount import count_ops, rollout_counts

    st = LatticeStepper(3, 2, 2, 0.25, np.full(36, 1 / 36), 1e4, 1e4,
                        np.arange(9), dtype=torch.float64, device="cpu",
                        model="arap")
    cfg = dataclasses.replace(st.cfg, cg_iters=3, admm_iters=2)

    def counts(cfg):
        return rollout_counts(lattice_step.lattice_rollout_reference,
                              lattice_step.STATE, st.state, st.planes, cfg, 1)

    o3, b3 = counts(cfg)
    o4, b4 = counts(dataclasses.replace(cfg, cg_iters=4))
    n = st.n_nodes
    matvec = sum(6 * (n - abs(off)) for off in cfg.dia_offs)
    assert o4 - o3 == cfg.admm_iters * (matvec + 33 * n + 6)
    assert b3 == b4 > 0
    idx, grp, _ = lattice_step.lattice_tables(cfg.dims)
    members = [torch.as_tensor(np.flatnonzero(grp == g)) for g in range(10)]

    def element_ops(cfg):
        return count_ops(lattice_step._element_phase, st.state["x"],
                         st.state["u"], st.state["warm"], cfg,
                         torch.as_tensor(idx), members)[0]

    # every zero coefficient made 1: 6 more operations in F (a product and
    # a sum in each of 3 rows) and 6 in the RHS rows, per tet
    zeros = sum((12 - np.count_nonzero(cfg.cp[g])) * len(m)
                for g, m in enumerate(members))
    assert zeros > 0
    dense = dataclasses.replace(cfg, cp=tuple(
        tuple(q if q != 0 else 1.0 for q in g) for g in cfg.cp))
    assert element_ops(dense) - element_ops(cfg) == 12 * zeros


@pytest.mark.parametrize("kernel,planes,vectors,floats", [
    ("nh_local_step", (9, 9, 3), 3, 45),
    ("arap_local_step_fused", (12, 9, 12), 2, 65),
    ("arap_local_step", (9, 9), 2, 38),
    ("tri_local_step", (6, 6), 4, 28),
], ids=["nh_local_step", "arap_local_step_fused", "arap_local_step",
        "tri_local_step"])
def test_local_step_counts_are_per_element(kernel, planes, vectors, floats):
    """The element steps' work does not depend on the data: the count
    doubles with E, and each element reads and writes `floats` values
    (inputs once, outputs once)."""
    from admm_elastic_tpu_torch.ops import kernels
    from admm_elastic_tpu_torch.utils.opcount import twin_counts

    reference = getattr(kernels, kernel + "_reference")

    def counts(E, seed):
        g = torch.Generator().manual_seed(seed)
        ins = [torch.randn(r, E, generator=g, dtype=torch.float64)
               for r in planes]
        ins += [torch.rand(E, generator=g, dtype=torch.float64) + 0.5
                for _ in range(vectors)]
        return twin_counts(reference, *ins)

    (o1, b1), (o2, b2) = counts(40, 0), counts(80, 1)
    assert o2 == 2 * o1 and o1 > 100 * 40
    assert b1 == 40 * floats * 8 and b2 == 2 * b1


def test_cheb_dia_counts_one_iteration():
    """One more Chebyshev iteration adds the dia matvec (a product and a
    sum per term inside the matrix: 6(n - |off|) per diagonal, as the
    kernel skips the terms past either end), 3n for x += d, 6n for
    z -= D^-1 A d and 9n for d = c1 d + c2 z; a first chunk reads b but
    not z and d."""
    from admm_elastic_tpu_torch.utils.opcount import cheb_dia_counts
    from admm_elastic_tpu_torch.utils.scenes import jittered_system

    st = jittered_system((4, 3, 3), device="cpu")._stepper
    x, dia, offs = st.state["x"], st.planes["dia"], st.cfg.dia_offs
    c = torch.full((4,), 0.5, dtype=x.dtype)
    n, D = x.shape[0], len(offs)

    def counts(n_it, first):
        return cheb_dia_counts(x, x, x, x, st.planes["invd"], dia, c, c,
                               offsets=offs, n_it=n_it, first=first,
                               last=True, inv_theta=0.7)

    (o2, b2), (o3, b3) = counts(2, True), counts(3, True)
    matvec = sum(6 * (n - abs(off)) for off in offs)
    assert matvec < 6 * n * D  # the beam's offsets reach past both ends
    assert o3 - o2 == matvec + 18 * n
    assert b3 - b2 == 2 * 8  # one more c1 and c2
    # b, x, invd, dia, c1, c2 read; x, z, d written
    assert b2 == 8 * (3 * n + 3 * n + n + D * n + 2 * 2 + 9 * n)
    _, b_mid = counts(2, False)  # z and d in place of b
    assert b_mid == b2 + 8 * 3 * n


def test_banded_local_counts_bytes():
    """banded_local_rhs reads x, au, cu (n,3), u (9,E), warm (3,E) and the
    ten planes its kernels use (the slot planes pos and off, not the
    twin's incidence), and writes b, au', cu', u', warm'."""
    from admm_elastic_tpu_torch.ops.kernels import banded_local
    from admm_elastic_tpu_torch.utils.opcount import (banded_local_counts,
                                                      nbytes)
    from admm_elastic_tpu_torch.utils.scenes import jittered_system

    st = jittered_system((4, 3, 3), device="cpu")._stepper
    s = st.state
    ins = (s["x"], s["au"], s["cu"], s["u"], s["warm"])
    ops, n_bytes = banded_local_counts(*ins, st.planes, st.cfg)
    n, E = st.n_nodes, st.n_elements
    planes = nbytes([st.planes[k] for k in banded_local.PLANES])
    assert planes == 8 * (12 * E + 4 * E + 4 * n) + 4 * (8 * E + n + 1)
    assert n_bytes == 2 * 8 * (9 * n + 12 * E) + planes
    assert ops > 1000 * E  # the SVD and the Newton prox per element


def test_mg_dia_counts_one_iteration():
    """One more V-cycle PCG iteration adds the fine matvec (a product and a
    sum per term inside the matrix), 30n + 6 vector and scalar operations
    (Jacobi's 33n + 6 less z = D^-1 r) and one V-cycle as the function
    needs it (`uamg_vcycle_ops` on the compact levels: fewer operations
    than the twin, which adds its padding's zeros), in the solve and once
    per ADMM iteration in the banded window's multigrid mode; the solve
    reads b, x0, the diagonals and the multigrid's planes once and writes
    x."""
    import dataclasses

    from admm_elastic_tpu_torch.core.solver import dia_apply
    from admm_elastic_tpu_torch.ops.kernels import banded_step, uamg
    from admm_elastic_tpu_torch.utils.opcount import (mg_dia_counts, nbytes,
                                                      rollout_counts,
                                                      uamg_vcycle_ops)
    from admm_elastic_tpu_torch.utils.scenes import small_mg_beam

    st = small_mg_beam(device="cpu")._stepper
    x, dia, offs, cfg = (st.state["x"], st.planes["dia"], st.cfg.dia_offs,
                         st.cfg)
    n = x.shape[0]
    (o3, b3), (o4, b4) = (mg_dia_counts(x, x, dia, offs, st.planes, cfg.mg,
                                        k) for k in (3, 4))
    def A(y):
        return dia_apply(y, offs, dia)

    vcycle = uamg_vcycle_ops(x, A, st.planes)
    twin, _ = count_ops(uamg.vcycle, x, A, st.planes)
    matvec = sum(6 * (n - abs(off)) for off in offs)
    assert 2 * matvec < vcycle < twin
    assert o4 - o3 == matvec + 30 * n + 6 + vcycle
    planes = nbytes([st.planes[k] for k in uamg.PLANES])
    assert b3 == b4 == 8 * (9 * n + dia.numel()) + planes

    def counts(k):
        c = dataclasses.replace(cfg, cg_iters=k, admm_iters=2)
        return rollout_counts(banded_step.banded_rollout_reference,
                              banded_step.STATE, st.state, st.planes, c, 1)

    (r3, _), (r4, _) = counts(3), counts(4)
    assert r4 - r3 == 2 * (o4 - o3)


def test_vcycle_counts_the_representatives():
    """A V-cycle's coarse work is counted at each level's representatives
    (the builder's level sizes) and at the nonzero coefficients there: the
    6x5x4 beam's hierarchy in its compact form keeps the levels'
    representatives and A1's nonzero entries at them, and
    `uamg_level_ops` counts 7 n + 4 L + 4 n1 + 2 nc2^2 - 2 nc2 a column
    from them, the coarsest product nc2 (2 nc2 - 1)."""
    from admm_elastic_tpu_torch.utils.opcount import uamg_level_ops
    from admm_elastic_tpu_torch.utils.scenes import small_mg_beam

    st = small_mg_beam(device="cpu")._stepper
    planes, (n, n1, nc2), h = st.planes, st.mg_levels, st.hierarchy
    reps1 = np.flatnonzero(np.asarray(h["om_invd1"]) != 0)
    assert len(reps1) == n1 == planes["ua_om1"].numel()
    assert nc2 == len(h["rp2"]) == planes["ua_a2inv"].shape[0]
    L = int(np.count_nonzero(np.asarray(h["l1_vals"])[:, reps1]))
    assert int(torch.count_nonzero(planes["ua_l1_vals"])) == L
    want = 7 * n + 4 * L + 4 * n1 + 2 * nc2 * nc2 - 2 * nc2
    assert uamg_level_ops(planes, n) == want
    assert planes["ua_l1_vals"].numel() < np.asarray(h["l1_vals"]).size


def test_uamg_ell_counts_one_iteration():
    """The algebraic multigrid mode as the geometric one: one more
    iteration adds the fine ELL matvec, 30n + 6 vector and scalar
    operations and one V-cycle as the function needs it
    (`uamg_vcycle_ops`: 7n + 4 L + 4 nc1 + 2 nc2^2 - 2 nc2 a column beside
    its two matvecs, fewer than the twin, which adds its padding's zeros),
    in the solve and once per ADMM iteration in the banded window's ELL
    mode; the solve reads b, x0, the ELL arrays and the planes once and
    writes x."""
    import dataclasses

    from admm_elastic_tpu_torch.ops.kernels import banded_step, uamg
    from admm_elastic_tpu_torch.ops.kernels.cg_ell import ell_apply_by_slot
    from admm_elastic_tpu_torch.utils.opcount import (nbytes, rollout_counts,
                                                      uamg_ell_counts,
                                                      uamg_vcycle_ops)
    from admm_elastic_tpu_torch.utils.scenes import small_uamg

    st = small_uamg(device="cpu")._stepper
    x, cfg, planes = st.state["x"], st.cfg, st.planes
    idx, vals = planes["ell_idx"], planes["ell_vals"]
    n, nc1, nc2 = st.mg_levels
    (o3, b3), (o4, b4) = (uamg_ell_counts(x, x, idx, vals, planes, cfg.mg, k)
                          for k in (3, 4))

    def A(y):
        return ell_apply_by_slot(y, idx, vals)

    matvec, _ = count_ops(A, x)
    L = int((planes["ua_l1_vals"] != 0).sum())
    vcycle = uamg_vcycle_ops(x, A, planes)
    assert vcycle == 2 * matvec + 3 * (7 * n + 4 * L + 4 * nc1
                                       + 2 * nc2 * nc2 - 2 * nc2)
    twin, _ = count_ops(uamg.vcycle, x, A, planes)
    assert 2 * matvec < vcycle < twin
    assert o4 - o3 == matvec + 30 * n + 6 + vcycle
    assert b3 == b4 == nbytes(x, x, idx, vals, x,
                              [planes[k] for k in uamg.PLANES])

    def counts(k):
        c = dataclasses.replace(cfg, cg_iters=k, admm_iters=2)
        return rollout_counts(banded_step.banded_rollout_reference,
                              banded_step.STATE, st.state, planes, c, 1)

    (r3, _), (r4, _) = counts(3), counts(4)
    assert r4 - r3 == 2 * (o4 - o3)
