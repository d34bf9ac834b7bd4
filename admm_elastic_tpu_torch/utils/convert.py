"""Carry a JAX `System`'s params and state into a port `System`.

`from_reference(system, params_np, state_np)` takes the JAX System's
`params` and `state` trees as numpy (e.g. `jax.device_get(sys.params)`)
and loads them into a port System that was built and initialized from the
same scene. Forces match by their `c{i}_{Type}` names. The JAX Pallas
layout pads per-element planes ((9, E_pad), (3, E_pad), (12, E_pad)) to
the kernel block; the port's planes are unpadded, so the padding is cut
off. A port param that the reference derives on the fly (`w2`, the
squared weight) is derived here from the reference's `weight`; arrays that
only the port keeps (`_PORT_ONLY`) stay as the port built them. Carries
every global mode, the dense inverse included. Takes numpy only: this
module never imports jax.

`banded_from_reference(stepper, state_np, subs, positions)` does the same
for the banded route: it loads a JAX `BandedStepper`'s state into the
port's `BandedStepper` built from the same scene, and
`cloth_from_reference(stepper, state_np)` a JAX `ClothStepper`'s state into
the port's `ClothStepper`, and `lattice_from_reference(stepper, state_np)` a
JAX `LatticeStepper`'s state into the port's `LatticeStepper`.
`sharded_banded_from_reference(stepper, state_np, subs, positions,
cheb_bounds)` loads a JAX `ShardedBandedStepper`'s detached state and its
Chebyshev bounds into the port's `ShardedBandedStepper`.
"""

from __future__ import annotations

import numpy as np
import torch


#: keys of the port's tree that a JAX tree may lack: WindForce's vertex
#: incidence (`inc`), the RHS incidence (`inc_idx`; the JAX dense and cg
#: modes scatter instead) and the whole `_solver` of the cg mode (the port
#: stores its incidence and the Jacobi diagonal; JAX recomputes the
#: diagonal every step)
_PORT_ONLY = ("inc", "inc_idx", "_solver")


def _load(port, ref, where):
    if isinstance(port, dict):
        if not isinstance(ref, dict):
            raise ValueError(f"{where}: expected a dict in the reference tree")
        if "w2" in port and "w2" not in ref and "weight" in ref:
            ref = {**ref, "w2": np.asarray(ref["weight"]) ** 2}
        # arrays that only the port keeps stay the port's own
        ref = {**{k: port[k] for k in _PORT_ONLY if k in port and k not in ref},
               **ref}
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
    planes (the identity in dia mode; in uell mode a diluted spatial
    order, which the port's ELL-mode stepper does not use). The JAX stepper relabels tet corners (`perm`) to pack its
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


def sharded_banded_from_reference(stepper, state_np, subs, positions,
                                  cheb_bounds=None) -> None:
    """Overwrite a port `ShardedBandedStepper`'s state with a JAX
    `ShardedBandedStepper`'s, and adopt its Chebyshev bounds.

    state_np: the JAX stepper's state as its `detach()` writes it into its
    base `BandedStepper` (`jax.device_get(base.state)`), with that base's
    `_subs` and `_positions`, mapped as `banded_from_reference` maps them
    (the port stepper's base takes the same state). cheb_bounds: the JAX
    stepper's `cheb_bounds`, (lmin, lmax): the port rebuilds its schedule
    from them, so both packages run the same recurrence."""
    banded_from_reference(stepper.base, state_np, subs, positions)
    stepper.state = {k: t.clone() for k, t in stepper.base.state.items()}
    if cheb_bounds is not None:
        stepper.set_cheb_bounds(*(float(b) for b in cheb_bounds))


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


def lattice_from_reference(stepper, state_np) -> None:
    """Overwrite a port `LatticeStepper`'s state with a JAX
    `LatticeStepper`'s.

    state_np: the JAX stepper's `state` as numpy: x, v, ancu, colu as (3, N)
    lane-padded planes; u as (n_groups, 16, N) and warm as (n_groups, 8, N)
    group planes (planes 0-8 and 0-2 used), indexed by each cell's corner-0
    vertex, phantom cells included; t. The port keeps only the tets of
    valid cells, in make_beam_tets order: tet e = 5 c + slot of cell c =
    (i ny + j) nz + k, in group 5 parity + slot at base vertex
    (i gy + j) gz + k."""
    n, E = stepper.n_nodes, stepper.n_elements
    nx, ny, nz = stepper.cfg.dims
    cell = np.arange(E) // 5
    i, rem = np.divmod(cell, ny * nz)
    j, k = np.divmod(rem, nz)
    grp = 5 * ((i + j + k) % 2) + np.arange(E) % 5
    base = (i * (ny + 1) + j) * (nz + 1) + k

    def planes(a, rows):
        return np.asarray(a)[grp[None, :], np.arange(rows)[:, None],
                             base[None, :]]

    new = {"x": np.asarray(state_np["x"])[:, :n].T,
           "v": np.asarray(state_np["v"])[:, :n].T,
           "u": planes(state_np["u"], 9),
           "warm": planes(state_np["warm"], 3),
           "au": np.asarray(state_np["ancu"])[:, :n].T,
           "cu": np.asarray(state_np["colu"])[:, :n].T,
           "t": np.asarray(state_np["t"])}
    ref = stepper.state
    stepper.state = {k_: torch.as_tensor(np.array(a, order="C"),
                                         dtype=ref[k_].dtype,
                                         device=ref[k_].device)
                     for k_, a in new.items()}
