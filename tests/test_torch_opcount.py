"""The operation and byte counts behind chip_smoke.py's roofline bounds."""

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
    from admm_elastic_tpu_torch.utils.opcount import tri_local_counts

    def counts(E, seed):
        g = torch.Generator().manual_seed(seed)
        ins = [torch.randn(r, E, generator=g, dtype=torch.float64)
               for r in (9, 6, 6)]
        ins += [torch.rand(E, generator=g, dtype=torch.float64) + 0.5
                for _ in range(4)]
        return tri_local_counts(*ins)

    (o1, b1), (o2, b2) = counts(40, 0), counts(80, 1)
    assert o2 == 2 * o1 and o1 > 100 * 40
    assert b1 == 40 * (25 + 21) * 8 and b2 == 2 * b1


def test_cloth_rollout_counts_one_cg_iteration():
    """One more CG iteration per ADMM iteration adds exactly the work of
    one Jacobi-PCG iteration with the symmetric-dia matvec, per ADMM
    iteration: the matvec (6n for the main diagonal, 12(n - off) for each
    other stored one), 36n vector ops and 6 scalar ones."""
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
    matvec = sum(6 * n if off == 0 else 12 * (n - off)
                 for off in cfg.dia_offs)
    assert o4 - o3 == cfg.admm_iters * (matvec + 36 * n + 6)
    assert b3 == b4 > 0
