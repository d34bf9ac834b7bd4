"""Simulation-state checkpoints: the JAX package's format.

The full step state (positions, velocities, elapsed time, the warm-started
duals u, which the reference keeps across steps (System.cpp:42), and the
per-force state: hyperelastic warm starts, control points) goes into one
flat `.npz` whose keys join the tree's path with '/', as
`admm_elastic_tpu/utils/checkpoint.py` writes it, so that a general-route
checkpoint of either package loads in the other. The flatten and unflatten
are a copy of that module's (it imports jax; this package does not).
"""

from __future__ import annotations

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_state(path: str, state) -> None:
    """Write a tree of dicts whose leaves are tensors, arrays or scalars."""
    np.savez_compressed(path, **_flatten(state))


def load_state(path: str, dtype=None, like=None, device="cpu"):
    """Load a checkpoint as a tree of tensors on `device`, floats cast to
    `dtype` if given. Empty sub-dicts (constraint types with no state) are
    not representable in an npz: `like=` (an existing state tree, e.g.
    System.state) restores the full structure, a leaf of the template
    standing where the file has none."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = _unflatten(flat)

    if like is not None:
        def merge(template, loaded):
            if isinstance(template, dict):
                return {
                    k: merge(template[k], loaded.get(k, {})
                             if isinstance(loaded, dict) else {})
                    for k in template
                }
            return loaded if not isinstance(loaded, dict) else template

        tree = merge(like, tree)

    def to_dev(a):
        if isinstance(a, dict):
            return {k: to_dev(v) for k, v in a.items()}
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        if dtype is not None and np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=dtype, device=device)
        return torch.as_tensor(a, device=device)

    return to_dev(tree)
