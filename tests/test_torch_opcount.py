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
