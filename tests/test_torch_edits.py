"""Runtime force edits in the port (`System.set_force_param`,
`set_force_state`, `recompute_weights`, `MovingAnchor`), f64 on the CPU.

General route, against the JAX package, on every global mode (dense with
one refinement round, cg, dia, ell with the xla, kernel and general-AMG
solves): poordillo's sequence on a 4 x 2 x 2 beam (springs on its tet
edges, a StaticAnchor face and a MovingAnchor on the free end; the
hyperelastic grab and release is tests/test_torch_hyper_oracle.py's):
the control
points dragged along `smooth_move` for 3 steps, then the release (weight 0,
active False), one step on the matrix the release left stale (dense, dia,
ell; the cg mode's diagonal is fresh), recompute_weights, 3 steps. x, v,
every dual u and the grab's state after each step within 1e-10 of JAX's.

Whole-timestep routes (port twins on the CPU): an anchor release through
recompute_weights continues bitwise as a System built with the released
weights from the start, given the same state, on the banded (dia and ELL),
multigrid and algebraic-multigrid windows; the lattice and cloth windows
read their anchors' weight and the wind from the force objects at routing,
in both packages, so that an edit does not reach them there. Against the
JAX package on one scene: the banded dia and ELL releases (LinearTetStrain,
the banded kernel's arap mode) track the JAX general route's within 1e-10,
the bound tests/test_torch_banded.py holds the banded route to the general
one; the multigrid and algebraic-multigrid hierarchies the rebuilt
steppers hold are the ones JAX's rebuilt steppers were handed, and the
rebuilt lattice and cloth windows pack JAX's planes, at the bounds of
tests/test_torch_mg.py and test_torch_uamg.py. The
JAX package's ValueErrors and 'sparsity pattern changed'; a 'pallas' tet
whose weight and materials are edited before step 1 bitwise a System built
with them (the squared weight w2 follows). `MovingAnchor.project` bitwise
JAX's on random inputs."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as aet
import admm_elastic_tpu_torch as pt
from admm_elastic_tpu_torch.core.banded import BandedStepper
from admm_elastic_tpu.models.anchor import linear_move as jax_linear_move
from admm_elastic_tpu.models.anchor import smooth_move as jax_smooth_move
from admm_elastic_tpu_torch.models import linear_move, smooth_move
from admm_elastic_tpu_torch.utils import from_reference, scenes
from torch_banded_scenes import build as banded_build, jittered_beam
from torch_edit_scenes import FAST, ROUTE, arap_scene, grab_beam, release

torch.set_num_threads(1)

TOL = 1e-10
DRAG, AFTER = 3, 3

MODES = {
    "dense-refine": dict(global_solver="dense", dense_refine_steps=1),
    "cg": dict(global_solver="cg", cg_fixed_iters=30),
    "dia": dict(global_solver="dia", cg_fixed_iters=30),
    "ell-xla": dict(global_solver="ell", cg_fixed_iters=30),
    "ell-kernel": dict(global_solver="ell", cg_fixed_iters=30,
                       cg_backend="kernel"),
    "ell-amg": dict(global_solver="ell", cg_fixed_iters=8,
                    preconditioner="amg"),
}


def snapshot(s, grab):
    """x, v, every force's dual and the grab's state, as numpy."""
    st = s.state
    out = {"x": np.asarray(s.x), "v": np.asarray(s.v)}
    for name, u in st["u"].items():
        out[f"u/{name}"] = np.asarray(u)
    for k, a in st["forces"][grab.name].items():
        out[f"grab/{k}"] = np.asarray(a)
    return out


def poordillo(s, grab, recompute_at_edit=False):
    """Drag, release, one step on the stale matrix, recompute_weights,
    steps: the snapshots after each step. With recompute_at_edit, the
    matrix is recomputed at the release and the run ends after the step
    that follows it."""
    start = np.asarray(s.x)[grab.indices]
    end = start + np.array([0.2, 0.1, 0.0])
    snaps = []
    for _ in range(DRAG):
        s.set_force_state(grab, "pos", smooth_move(
            s.elapsed_s + s.settings.timestep_s, 0.0, 0.12, start, end))
        s.step()
        snaps.append(snapshot(s, grab))
    n = len(grab.indices)
    s.set_force_param(grab, "weight", np.zeros(n))
    s.set_force_state(grab, "active", np.zeros(n, bool))
    if recompute_at_edit:
        s.recompute_weights()
    s.step()
    snaps.append(snapshot(s, grab))
    if recompute_at_edit:
        return snaps
    s.recompute_weights()
    for _ in range(AFTER):
        s.step()
        snaps.append(snapshot(s, grab))
    return snaps


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's snapshots, by mode, made on first use."""
    runs = {}

    def get(mode):
        if mode not in runs:
            runs[mode] = poordillo(*grab_beam(aet, **MODES[mode]))
        return runs[mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_poordillo_matches_jax(mode, jax_runs):
    s, grab = grab_beam(pt, **MODES[mode])
    assert s._solver_mode == mode.split("-")[0]
    assert s._stepper is None, "a MovingAnchor keeps the general route"
    got = poordillo(s, grab)
    for step, (a, b) in enumerate(zip(got, jax_runs(mode))):
        assert set(a) == set(b)
        for k in a:
            err = float(np.abs(a[k].astype(np.float64)
                               - b[k].astype(np.float64)).max())
            assert err <= TOL, f"{mode} step {step} {k}: {err}"
    # the grab held the end near its target, and it fell after the release
    assert got[DRAG]["grab/active"].sum() == 0
    assert got[-1]["x"][grab.indices, 1].mean() < got[DRAG - 1]["x"][
        grab.indices, 1].mean()
    if mode == "dense-refine":
        assert "ell_idx" in s.params["_solver"]
    if mode == "ell-amg":
        assert "amg" in s.params["_solver"]
    # the step between the edit and recompute_weights ran on the stale
    # matrix: recomputing at the edit changes it, except under cg, whose
    # diagonal the edit refreshed and which has no matrix
    fresh = poordillo(*grab_beam(pt, **MODES[mode]), recompute_at_edit=True)
    d = float(np.abs(fresh[DRAG]["x"] - got[DRAG]["x"]).max())
    if mode == "cg":
        assert d == 0.0
    else:
        assert d > 1e-6, d


def test_edit_api_keeps_dtypes_and_host_copy():
    s, grab = grab_beam(pt, global_solver="dia", cg_fixed_iters=30)
    anchor = s.forces[0]
    w = np.linspace(0.0, 1.0, anchor.n_elements)
    s.set_force_param(anchor, "weight", w)
    dev, host = s.params[anchor.name]["weight"], s._params_host[anchor.name]
    assert dev.dtype == torch.float64 and torch.equal(dev, torch.as_tensor(w))
    np.testing.assert_array_equal(host["weight"], w)
    # the force object keeps its constructor's weight, as in JAX
    assert (anchor.weight == 1000.0).all()
    s.set_force_state(grab.name, "active", [0] * grab.n_elements)
    assert s.state["forces"][grab.name]["active"].dtype == torch.bool
    s.set_force_param(s.explicit_forces[0], "direction", (0.0, -1.0, 0.0))
    assert s.params["e0_ExplicitForce"]["direction"].tolist() == [0, -1, 0]


def test_from_reference_updates_host_copy():
    """from_reference loads the reference's params into the host copy
    too, which recompute_weights assembles from: an anchor weight JAX's
    System was edited to reaches the port's matrix."""
    import jax

    j, jgrab = grab_beam(aet, global_solver="dia", cg_fixed_iters=30)
    w = np.linspace(10.0, 1000.0, jgrab.n_elements)
    j.set_force_param(jgrab, "weight", w)
    j.recompute_weights()
    s, grab = grab_beam(pt, global_solver="dia", cg_fixed_iters=30)
    from_reference(s, jax.device_get(j.params), jax.device_get(j.state))
    np.testing.assert_array_equal(s._params_host[grab.name]["weight"], w)
    s.recompute_weights()
    np.testing.assert_allclose(s.params["_solver"]["dia_vals"].numpy(),
                               np.asarray(j.params["_solver"]["dia_vals"]),
                               rtol=1e-14, atol=0)
    j.step()
    s.step()
    assert float(np.abs(s.x - np.asarray(j.x)).max()) < TOL


def test_project_bitwise_jax():
    rng = np.random.default_rng(3)
    E = 37
    Dx, u = rng.standard_normal((2, E, 1, 3))
    pos = rng.standard_normal((E, 3))
    active = rng.random(E) < 0.5
    jz, jst = aet.models.MovingAnchor(np.arange(E)).project(
        jnp.asarray(Dx), jnp.asarray(u), {},
        {"pos": jnp.asarray(pos), "active": jnp.asarray(active)})
    t = torch.as_tensor
    pz, pst = pt.models.MovingAnchor(np.arange(E)).project(
        t(Dx), t(u), {}, {"pos": t(pos), "active": t(active)})
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(pst["pos"].numpy(), np.asarray(jst["pos"]))
    assert torch.equal(pst["active"], t(active))
    for f in (aet.models, pt.models):
        assert not issubclass(f.MovingAnchor, f.StaticAnchor)
    a, b = np.zeros(3), np.ones(3)
    for args in ((0.05, 0.1, 0.3), (0.2, 0.1, 0.3), (0.5, 0.1, 0.3)):
        for port, ref in ((smooth_move, jax_smooth_move),
                          (linear_move, jax_linear_move)):
            np.testing.assert_array_equal(port(*args, a, b),
                                          ref(*args, a, b))


# ------------------------------------------------------ whole-timestep routes

@pytest.mark.parametrize("route", list(FAST))
def test_fast_release(route):
    """A release through recompute_weights on a whole-timestep route: the
    new stepper goes on from the old one's state tensors; it steps bitwise
    as a System built with the released weights given that state (banded,
    mg, uamg), or as the unedited System (lattice, cloth: their windows
    take the anchors' weight from the force objects, as JAX's)."""
    s = FAST[route]()
    assert type(s._stepper) is ROUTE[route]
    anchor = next(f for f in s.forces if type(f).__name__ == "StaticAnchor")
    s.run(1)
    old = s._stepper
    state = {k: t.clone() for k, t in old.state.items()}
    w = release(anchor.weight)
    s.set_force_param(anchor, "weight", w)
    s.recompute_weights()
    assert s._stepper is not old and type(s._stepper) is ROUTE[route]
    assert all(s._stepper.state[k] is t for k, t in old.state.items())
    s.run(2)

    ref = FAST[route]()
    if route not in ("lattice", "cloth"):
        next(f for f in ref.forces
             if type(f).__name__ == "StaticAnchor").weight = w
        assert ref.initialize()
    for k, t in state.items():
        ref._stepper.state[k] = t.clone()
    ref.run(2)
    for k in state:
        assert torch.equal(s._stepper.state[k], ref._stepper.state[k]), k
    if route not in ("banded-dia", "banded-ell"):
        return
    # the released anchors let go: the edit moved the result
    unedited = FAST[route]()
    unedited.run(3)
    assert np.abs(unedited.x - s.x).max() > 1e-6


@pytest.mark.parametrize("mode", ["dia", "ell"])
def test_banded_release_tracks_jax(mode):
    if mode == "dia":
        beam = jittered_beam(4, 2, 2, seed=2)
        mesh = (beam.vertices, beam.tets)
    else:
        mesh = scenes.delaunay_mesh()
    xs = []
    for pkg, fast in ((pt, True), (aet, False)):
        s, a = arap_scene(pkg, mesh, fast, mode)
        if pkg is pt:
            assert isinstance(s._stepper, BandedStepper)
            assert s._stepper.cfg.matrix == mode
        # single steps: JAX compiles one step function, not a rollout
        # for each length
        for k in range(5):
            if k == 2:
                s.set_force_param(a, "weight", release(a.weight))
                s.recompute_weights()
            s.step()
        xs.append(np.asarray(s.x))
    err = float(np.abs(xs[0] - xs[1]).max())
    assert err < TOL, err


MG_LANES = 128  # the JAX multigrid planes' lane width


def _mg_scene(pkg):
    """tests/test_torch_mg.py's beam on the banded route's geometric
    multigrid (levels 210 -> 36 -> 8)."""
    return banded_build(pkg, pkg.geometry.make_beam_tets(6, 5, 4, size=0.05),
                        fast=True, cg=None, preconditioner="amg")


def _uamg_scene(pkg):
    """tests/test_uamg.py's Delaunay scene on the banded ELL route's
    algebraic multigrid (levels 420 -> 112 -> 48)."""
    if pkg is pt:
        return scenes.small_uamg(device="cpu")
    from test_uamg import _delaunay_system

    return _delaunay_system(global_solver="ell", lattice_fast_path=True,
                            preconditioner="amg", cg_fixed_iters=8)


def _a2inv(blocks, np2, nc2):
    """A2^-1 from JAX's (np2, np2, LANES, LANES) blocks (the layout
    tests/test_torch_mg.py and test_torch_uamg.py read)."""
    B = np.asarray(blocks).reshape(np2, np2, MG_LANES, MG_LANES)
    return B.transpose(1, 3, 0, 2).reshape(np2 * MG_LANES, -1)[:nc2, :nc2]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("route", ["mg", "uamg"])
def test_multigrid_release_matches_jax(route, monkeypatch):
    """An anchor release through recompute_weights on the multigrid
    windows, in both packages on one scene: the hierarchy the port's
    rebuilt stepper holds is the one JAX's rebuilt stepper was handed
    (its constructor's mg= / uamg= argument, recorded), at the bounds
    tests/test_torch_mg.py and test_torch_uamg.py hold the two builders
    to: geometric, the level-1 diagonals and omega D^-1 of both levels
    1e-12, A2^-1 1e-12 of its largest magnitude; algebraic, the fine
    positions equal, omega D^-1 of both levels 1e-12 and A2^-1 1e-10,
    relative to each array's largest magnitude. The release reached the
    coarse levels: JAX's A2^-1 moved."""
    import admm_elastic_tpu.core.banded as jb

    handed = []

    class Recorded(jb.BandedStepper):
        def __init__(self, *args, **kw):
            handed.append(kw)
            super().__init__(*args, **kw)

    monkeypatch.setattr(jb, "BandedStepper", Recorded)
    scene = _mg_scene if route == "mg" else _uamg_scene
    j, s = scene(aet), scene(pt)
    for sys_ in (j, s):
        a = next(f for f in sys_.forces
                 if type(f).__name__ == "StaticAnchor")
        sys_.set_force_param(a, "weight", release(a.weight))
        sys_.recompute_weights()
    assert len(handed) == 2 and isinstance(j._lattice, Recorded)
    mine = s._stepper.hierarchy
    assert s._stepper.mg_levels == mine["levels"]
    n, nc1, nc2 = mine["levels"]
    if route == "mg":
        (before, _), (jp, jm) = handed[0]["mg"], handed[1]["mg"]
        assert mine["levels"] == jm["levels"]
        for k in ("l1_offs", "t0_offs", "t1_offs"):
            assert mine[k] == jm[k], k
        for k in ("l1_vals", "om_invd0", "om_invd1", "t0_masks", "t1_masks"):
            np.testing.assert_allclose(mine[k], jp[k][..., :n], rtol=0,
                                       atol=1e-12, err_msg=k)
        want = _a2inv(jp["a2inv_blocks"], jm["np2_rows"], nc2)
        old = _a2inv(before["a2inv_blocks"], jm["np2_rows"], nc2)
        assert np.abs(mine["a2inv"] - want).max() <= 1e-12 * np.abs(
            want).max()
    else:
        (before, _), (up, um) = handed[0]["uamg"], handed[1]["uamg"]
        pos = handed[1]["positions"]
        assert mine["levels"] == um["levels"]
        np.testing.assert_array_equal(mine["positions"], pos)
        want = _a2inv(up["a2inv_blocks"], um["np2"], nc2)
        old = _a2inv(before["a2inv_blocks"], um["np2"], nc2)
        assert _rel(mine["a2inv"], want) < 1e-10
        assert _rel(mine["om_invd0"], up["om_invd0"].ravel()[pos]) < 1e-12
        cpos = np.arange(nc1) + np.arange(nc1) // 8
        assert _rel(mine["om_invd1"], up["om_invd1"].ravel()[cpos]) < 1e-12
    assert _rel(old, want) > 1e-6


def _settings(pkg, **kw):
    if pkg is aet:
        return aet.Settings(verbose=0, dtype=jnp.float64, **kw)
    return pt.Settings(verbose=0, dtype=torch.float64, device="cpu", **kw)


def _lattice_pair(pkg):
    """tet100k's physics on a 4 x 2 x 2 beam (HyperElasticTet on the
    default backend) on the cg mode: the lattice window. Returns (system,
    anchor, None)."""
    mesh = pkg.geometry.make_beam_tets(4, 2, 2, size=0.05)
    n = mesh.n_vertices
    s = pkg.System(_settings(pkg, global_solver="cg", cg_fixed_iters=10,
                             lattice_fast_path=True, admm_iters=3))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    a = s.add_force(pkg.models.StaticAnchor(
        np.flatnonzero(mesh.vertices[:, 0] < 1e-9)))
    s.add_force(pkg.models.HyperElasticTet(mesh.tets, 1e5, 1e5))
    s.add_explicit_force(pkg.models.ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s, a, None


def _cloth_pair(pkg):
    """An 8 x 6 sheet (LimitedTriangleStrain on the default backend, 4
    anchors on its top row, wind) on the dia mode: the cloth window.
    Returns (system, anchor, wind)."""
    sheet = pkg.geometry.make_plane_grid(8, 6)
    n = sheet.n_vertices
    s = pkg.System(_settings(pkg, global_solver="dia", cg_fixed_iters=30,
                             lattice_fast_path=True))
    s.add_nodes(sheet.vertices, np.full(n, 0.5 / n))
    s.add_force(pkg.models.LimitedTriangleStrain(sheet.faces, 100.0, 0.95,
                                                 1.05))
    top = np.flatnonzero(np.abs(sheet.vertices[:, 1]
                                - sheet.vertices[:, 1].max()) < 1e-9)
    a = s.add_force(pkg.models.StaticAnchor(top[:4]))
    wind = s.add_explicit_force(pkg.models.WindForce(
        sheet.faces, direction=(1.5, 0.0, 0.4)))
    assert s.initialize()
    return s, a, wind


def _jax_planes(stepper, n):
    """The JAX lattice or cloth stepper's planes over its n vertices:
    the diagonals of A by offset, the anchors' squared weights, the
    inverse diagonal and the anchor targets."""
    masks = np.asarray(stepper._masks)
    invd = (np.asarray(stepper._invd)[0] if hasattr(stepper, "_invd")
            else masks[2])
    out = {"dia": _by_offset(stepper.dia_offs, np.asarray(stepper._dia)),
           "aw2": masks[0], "invd": invd, "ancz": np.asarray(stepper._ancz).T}
    return {k: ({o: r[:n] for o, r in v.items()} if k == "dia" else v[:n])
            for k, v in out.items()}


def _port_planes(stepper):
    p = {k: stepper.planes[k].numpy() for k in ("aw2", "invd", "ancz")}
    p["dia"] = _by_offset(stepper.cfg.dia_offs, stepper.planes["dia"].numpy())
    return p


def _by_offset(offs, vals):
    """{offset: diagonal} of the diagonals that are not all zero."""
    return {int(o): v for o, v in zip(offs, vals) if v.any()}


def test_lattice_and_cloth_windows_keep_their_weights_in_jax():
    """The lattice and cloth steppers, rebuilt by recompute_weights after
    an anchor edit (and, on the cloth, a wind edit), in both packages on
    one scene: JAX's pack the same planes as before the edit (their
    constructors read the force objects), the cloth window keeps the wind
    it was built with, and the port's rebuilt planes and wind are JAX's
    (the diagonals of A by offset, the anchors' squared weights, the
    inverse diagonal, the anchor targets: 1e-12 relative to each plane's
    largest magnitude). Construction only, no step."""
    for pair in (_lattice_pair, _cloth_pair):
        (j, ja, jw), (s, a, w) = pair(aet), pair(pt)
        before = _jax_planes(j._lattice, j.n_nodes)
        for sys_, anchor, wind in ((j, ja, jw), (s, a, w)):
            sys_.set_force_param(anchor, "weight", release(anchor.weight))
            if wind is not None:
                sys_.set_force_param(wind, "direction",
                                     np.array([-3.0, 0.0, 0.0]))
            sys_.recompute_weights()
        want = _jax_planes(j._lattice, j.n_nodes)
        got = _port_planes(s._stepper)
        assert type(s._stepper) is ROUTE[
            "lattice" if pair is _lattice_pair else "cloth"]
        assert before["dia"].keys() == want["dia"].keys()
        for o in want["dia"]:
            assert np.array_equal(before["dia"][o], want["dia"][o])
        for k in ("aw2", "invd", "ancz"):
            assert np.array_equal(before[k], want[k]), k
        # the JAX cloth stepper keeps the upper diagonals of the symmetric
        # A; the port's window keeps both halves
        assert want["dia"].keys() <= got["dia"].keys() <= (
            want["dia"].keys() | {-o for o in want["dia"]})
        for o in want["dia"]:
            np.testing.assert_allclose(
                got["dia"][o], want["dia"][o], rtol=0,
                atol=1e-12 * np.abs(want["dia"][o]).max(), err_msg=o)
        for k in ("aw2", "invd", "ancz"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-12 * np.abs(want[k]).max(),
                                       err_msg=k)
        if jw is not None:
            np.testing.assert_array_equal(np.asarray(j._lattice.wind_dir),
                                          [1.5, 0.0, 0.4])
            assert s._stepper.cfg.wind_dir == j._lattice.wind_dir


def test_cloth_window_keeps_its_wind():
    """set_force_param(wind, 'direction') moves the general route's wind
    at the next step, and not the cloth window's (JAX's cloth.py:308-316
    bakes it into the window at build)."""
    runs = {}
    for fast in (True, False):
        for edit in (False, True):
            s = scenes.small_cloth(device="cpu", fast=fast)
            if edit:
                wind = next(e for e in s.explicit_forces
                            if type(e).__name__ == "WindForce")
                s.set_force_param(wind, "direction", (-3.0, 0.0, 0.0))
            s.run(2)
            runs[fast, edit] = s.x
    np.testing.assert_array_equal(runs[True, False], runs[True, True])
    assert np.abs(runs[False, False] - runs[False, True]).max() > 1e-4


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_recompute_errors(pkg):
    """The JAX package's errors: another route after the edit (in both
    packages), another state layout (elements removed under ell: the
    port's element state is unpadded, (9, E), where the JAX stepper's lane
    padding absorbs the change, so this edit raises in the port only), a
    changed dia pattern (in both)."""
    p = pt if pkg == "port" else aet
    s, a = arap_scene(p, scenes.delaunay_mesh(), True, "ell")
    s.settings.relaxation = 1.5
    with pytest.raises(ValueError, match="no longer routes"):
        s.recompute_weights()

    if pkg == "port":
        s, a = arap_scene(p, scenes.delaunay_mesh(), True, "ell")
        tet = s.forces[1]
        keep = slice(0, tet.n_elements - 7)
        for k in ("indices", "coeff", "weight", "k"):
            s.set_force_param(tet, k, np.asarray(s.params[tet.name][k])[keep])
        with pytest.raises(ValueError, match="packed state layout"):
            s.recompute_weights()

    beam = jittered_beam(4, 2, 2, seed=2)
    s, a = arap_scene(p, (beam.vertices, beam.tets), False, "dia")
    idx = np.array(s.params[s.forces[1].name]["indices"])
    idx[0] = [0, 1, 2, beam.vertices.shape[0] - 1]
    s.set_force_param(s.forces[1], "indices", idx)
    with pytest.raises(AssertionError, match="sparsity pattern changed"):
        s.recompute_weights()


@pytest.mark.parametrize("fast", [False, True])
def test_pallas_weight_edit_matches_fresh_build(fast):
    """A 'pallas' HyperElasticTet built with mu = lam = 1e4 whose weight,
    k, mu and lam are set to those of a mu = lam = 2e4 build before step 1
    (then recompute_weights) steps bitwise as that build: the squared
    weight w2, which the port keeps beside weight, follows the edit."""
    mesh = jittered_beam(4, 2, 2, seed=6)
    a = banded_build(pt, mesh, fast=fast, mu=1e4, lam=1e4, admm=3, cg=10)
    b = banded_build(pt, mesh, fast=fast, mu=2e4, lam=2e4, admm=3, cg=10)
    tet = a.forces[0]
    w2_before = a.params[tet.name]["w2"]
    for k in ("weight", "k", "mu", "lam"):
        a.set_force_param(tet, k, b._params_host[b.forces[0].name][k])
    assert a.params[tet.name]["w2"] is not w2_before
    assert torch.equal(a.params[tet.name]["w2"], b.params[tet.name]["w2"])
    a.recompute_weights()
    a.run(3)
    b.run(3)
    np.testing.assert_array_equal(a.x, b.x)
