"""The order in which the kernels sum the per-ADMM-iteration residuals
(`csrc/residuals.cuh`), for their plain twins.

A kernel that collects residuals gives each element (vertex) a piece of
the squared residual; each block of THREADS elements (vertices) sums its
pieces by the halving tree of `block_sum` (`csrc/common.cuh`) into one
partial; one block then sums an ADMM iteration's partials, thread t adding
partials t, t + THREADS, ... in turn, by the same tree. The functions here
repeat that order with torch ops, so a twin's residuals equal the
kernel's bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cg_step import _halving_tree

THREADS = 128  # csrc/residuals.cuh, the windows' block (csrc/window.cuh)
#: the modes of BandedConfig / ClothConfig.collect and their kernels' ids
MODES = {None: 0, "primal": 1, "full": 2}


def block_partials(pieces):
    """(N,) pieces -> one partial for each block of THREADS, (ceil(N /
    THREADS),): the pieces past N count as 0."""
    nb = -(-pieces.shape[0] // THREADS)
    return _halving_tree(F.pad(pieces, (0, nb * THREADS - pieces.shape[0]))
                         .reshape(nb, THREADS))


def sum_partials(partials):
    """(P,) partials -> their sum, 0-dim, in finalize_kernel's order."""
    m = max(-(-partials.shape[0] // THREADS), 1)
    lanes = F.pad(partials, (0, m * THREADS - partials.shape[0])).reshape(
        m, THREADS)
    acc = torch.zeros_like(lanes[0])
    for row in lanes:
        acc = acc + row
    return _halving_tree(acc[None, :])[0]


def primal(element_pieces, vertex_pieces):
    """The primal residual of one ADMM iteration: sqrt of the sum of the
    element blocks' partials, then the vertex blocks'."""
    return torch.sqrt(sum_partials(torch.cat(
        [block_partials(element_pieces), block_partials(vertex_pieces)])))


def dual(dt2, vertex_pieces):
    """The dual residual of one ADMM iteration: dt2 sqrt(the sum of the
    vertex blocks' partials)."""
    return dt2 * torch.sqrt(sum_partials(block_partials(vertex_pieces)))


def squares(d):
    """Per row of d (N, C): d_0^2 + d_1^2 + ..., added in column order from
    0, as the kernels add a vertex's or an element's components."""
    acc = torch.zeros_like(d[:, 0])
    for c in range(d.shape[1]):
        acc = acc + d[:, c] * d[:, c]
    return acc


def extra_ops(collect):
    """Launches a collecting window adds to a timestep: the finalize
    kernel, and under "full" the two seed kernels."""
    return {None: 0, "primal": 1, "full": 3}[collect]


def attach(out, collect, res):
    """A window's state dict with its residual buffer (2, n_steps,
    admm_iters) as "primal" (and "dual"), as the twins return them."""
    if collect is not None:
        out["primal"] = res[0]
        if collect == "full":
            out["dual"] = res[1]
    return out
