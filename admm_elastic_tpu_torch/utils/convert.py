"""Carry a JAX `System`'s params and state into a port `System`.

`from_reference(system, params_np, state_np)` takes the JAX System's
`params` and `state` trees as numpy (e.g. `jax.device_get(sys.params)`)
and loads them into a port System that was built and initialized from the
same scene. Forces match by their `c{i}_{Type}` names. The JAX Pallas
layout pads per-element planes ((9, E_pad), (3, E_pad), (12, E_pad)) to
the kernel block; the port's planes are unpadded, so the padding is cut
off. A port param that the reference derives on the fly (`w2`, the
squared weight) is derived here from the reference's `weight`. Takes numpy
only: this module never imports jax.

`banded_from_reference(stepper, state_np, subs, positions)` does the same
for the banded route: it loads a JAX `BandedStepper`'s state into the
port's `BandedStepper` built from the same scene, and
`cloth_from_reference(stepper, state_np)` a JAX `ClothStepper`'s state into
the port's `ClothStepper`.
"""

from __future__ import annotations

import numpy as np
import torch


def _load(port, ref, where):
    if isinstance(port, dict):
        if not isinstance(ref, dict):
            raise ValueError(f"{where}: expected a dict in the reference tree")
        if "w2" in port and "w2" not in ref and "weight" in ref:
            ref = {**ref, "w2": np.asarray(ref["weight"]) ** 2}
        if "inc" in port and "inc" not in ref:
            # WindForce's vertex incidence exists only in the port
            ref = {**ref, "inc": port["inc"]}
        missing = set(port) - set(ref)
        if missing:
            raise KeyError(f"{where}: reference lacks {sorted(missing)}")
        return {k: _load(port[k], ref[k], f"{where}/{k}") for k in port}
    if ref is port:
        return port
    a = np.asarray(ref)
    shape = tuple(port.shape)
    if a.shape != shape:
        # strip the block padding of the last (element) axis
        if (a.ndim == len(shape) and a.ndim >= 1
                and a.shape[:-1] == shape[:-1] and a.shape[-1] > shape[-1]):
            a = a[..., : shape[-1]]
        else:
            raise ValueError(f"{where}: reference shape {a.shape}, port {shape}")
    # a fresh writable, contiguous copy (device_get may return read-only
    # views)
    return torch.as_tensor(np.array(a), dtype=port.dtype, device=port.device)


def from_reference(system, params_np, state_np) -> None:
    """Overwrite `system.params` and `system.state` with the reference's
    values (converted to the port's dtype, device and layout), and set
    `elapsed_s` from the reference's time."""
    if not system.initialized:
        raise RuntimeError("initialize() the port System first")
    system.params = _load(system.params, params_np, "params")
    system.state = _load(system.state, state_np, "state")
    system.elapsed_s = float(np.asarray(state_np["t"]))


def banded_from_reference(stepper, state_np, subs, positions) -> None:
    """Overwrite a port `BandedStepper`'s state with a JAX `BandedStepper`'s.

    state_np: the JAX stepper's `state` as numpy (x, v, ancu, colu as
    (3*Nr, 128) planes; d as (n_chunks, 12*SUB, 128) chunk planes; t).
    subs: its `_subs`, the (n_chunks, SUB, 128) chunk -> element map (-1
    pads). positions: its `_positions`, vertex -> slot of the flattened
    planes. The JAX stepper relabels tet corners (`perm`) to pack its
    scatter lanes; the dual u and the warm start live in F-space, which
    that relabeling leaves alone, so they carry across by element id."""
    positions = np.asarray(positions, np.int64)
    subs = np.asarray(subs, np.int64)
    n_chunks = subs.shape[0]

    def xyz(planes):
        return np.asarray(planes).reshape(3, -1)[:, positions].T

    d = np.asarray(state_np["d"])
    d = d.reshape(n_chunks, 12, -1, d.shape[-1]).transpose(1, 0, 2, 3)
    real = subs >= 0
    ue = np.zeros((12, stepper.n_elements))
    ue[:, subs[real]] = d[:, real]
    new = {"x": xyz(state_np["x"]), "v": xyz(state_np["v"]), "u": ue[:9],
           "warm": ue[9:], "au": xyz(state_np["ancu"]),
           "cu": xyz(state_np["colu"]), "t": np.asarray(state_np["t"])}
    ref = stepper.state
    stepper.state = {k: torch.as_tensor(np.array(a), dtype=ref[k].dtype,
                                        device=ref[k].device)
                     for k, a in new.items()}


def cloth_from_reference(stepper, state_np) -> None:
    """Overwrite a port `ClothStepper`'s state with a JAX `ClothStepper`'s.

    state_np: the JAX stepper's `state` as numpy: x, v, ancu as (3, N)
    lane-padded planes; u as (n_groups, 16, N) group planes, indexed by
    each element's base (minimum) vertex, triangle groups first (planes
    0-5), then bend groups (planes 0-8); t. The port's stepper groups its
    elements the same way, so each element's dual is read at (its group,
    its base)."""
    n = stepper.n_nodes
    u = np.asarray(state_np["u"])
    Gt = stepper.planes["ttab"].shape[0]

    def duals(planes, grp, base):
        return u[grp[None, :], np.arange(planes)[:, None], base[None, :]]

    new = {"x": np.asarray(state_np["x"])[:, :n].T,
           "v": np.asarray(state_np["v"])[:, :n].T,
           "tu": duals(6, stepper._tgrp, stepper._tbase),
           "hu": duals(9, Gt + stepper._hgrp, stepper._hbase),
           "au": np.asarray(state_np["ancu"])[:, :n].T,
           "t": np.asarray(state_np["t"])}
    ref = stepper.state
    stepper.state = {k: torch.as_tensor(np.array(a, order="C"),
                                        dtype=ref[k].dtype,
                                        device=ref[k].device)
                     for k, a in new.items()}
