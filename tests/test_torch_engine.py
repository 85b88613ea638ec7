"""The port's engine and app (`spacetpu_torch.engine`, `main`,
`utils/config`, `io/checkpoint`, `render/viewer`, `render/window`) on the
CPU, mirroring tests/test_engine.py: the exchange handshake (with the two
defects of the JAX version that the port fixes, each named), the sim loop,
the solver gates and the auto-select against the JAX package's on the same
scenes, the fallback swap, checkpoints crossing both ways, the command line,
`main` headless and offline, concurrent consumers, the extra physics' flags
and merge_every against the JAX package, and the refusals of --shard
with the solvers still to port."""

import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu import engine as jengine
from spacetpu.models import presets as jpresets
from spacetpu_torch import constants, engine
from spacetpu_torch import make_simulation
from spacetpu_torch.engine import (Exchange, Readback, SimEngine,
                                   make_engine_for, run_sim_loop)
from spacetpu_torch.models import presets
from tests.parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sim_and_state(n=64):
    scene = presets.random_cluster(n, seed=0)
    sim = make_simulation(n, algorithm="direct", softening="plummer",
                          eps=1e-2, g=1.0, device="cpu")
    return sim, scene.state(device="cpu"), scene


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def test_exchange_cas_semantics():
    ex = Exchange(4)
    assert ex.should_store()
    assert not ex.should_store()
    ex.sample()
    assert ex.should_store()


def test_exchange_store_sample_roundtrip():
    ex = Exchange(3)
    data = np.arange(9, dtype=np.float64).reshape(3, 3)
    ex.store(data, tick=17)
    out = ex.sample()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, data)
    assert ex.current_ticks() == 17
    with pytest.raises(ValueError, match="different body count"):
        ex.store(np.zeros((4, 3)), tick=18)


def test_exchange_store_no_longer_rewinds_current_ticks():
    """Fixed in the port: the JAX Exchange.store assigns the tick while
    note_ticks takes a maximum, so a snapshot older than the loop's
    published count rewinds current_ticks() (spacetpu/engine.py:121 against
    193). The port keeps the maximum, and keeps the newer positions when
    two snapshots land out of order."""
    jex, ex = jengine.Exchange(2), Exchange(2)
    for x in (jex, ex):
        x.note_ticks(10)
        x.store(np.ones((2, 3)), tick=5)
    assert jex.current_ticks() == 5  # the JAX package's defect
    assert ex.current_ticks() == 10
    ex.store(np.full((2, 3), 2.0), tick=12)
    ex.store(np.full((2, 3), 3.0), tick=11)  # finished late
    assert ex.current_ticks() == 12
    np.testing.assert_array_equal(ex.sample(), np.full((2, 3), 2.0))


def test_exchange_sync_credit():
    ex = Exchange(3)
    assert ex.synced_tick() == 0
    handle = Readback(torch.arange(9, dtype=torch.float32).reshape(3, 3))
    ex.store_pending(handle, tick=12, wire="f32")
    assert ex.current_ticks() == 12
    np.testing.assert_array_equal(ex.sample(),
                                  np.arange(9).reshape(3, 3))
    assert ex.synced_tick() == 12
    ex.note_synced(20)
    ex.note_synced(5)
    assert ex.synced_tick() == 20
    ex.store_pending(handle, tick=7, wire="f32")
    ex.sample()
    assert ex.synced_tick() == 20


def _blocking(monkeypatch, owner, name):
    """Make owner.name block until released; returns (entered, release)."""
    entered, release = threading.Event(), threading.Event()
    real = getattr(owner, name)

    def slow(*args, **kw):
        entered.set()
        assert release.wait(10.0)
        return real(*args, **kw)

    monkeypatch.setattr(owner, name, slow)
    return entered, release


def _device_lock_free_while(entered, release, t):
    t.start()
    try:
        assert entered.wait(10.0)
        assert engine.TRANSFER_LOCK.locked()
        got = engine.DEVICE_LOCK.acquire(timeout=2.0)
        if got:
            engine.DEVICE_LOCK.release()
        return got
    finally:
        release.set()
        t.join(10.0)


def test_sample_ride_does_not_hold_device_lock(monkeypatch):
    ex = Exchange(3)
    ex.store_pending(Readback(torch.zeros((3, 3))), tick=4, wire="f32")
    entered, release = _blocking(monkeypatch, engine, "_snapshot_finish")
    t = threading.Thread(target=ex.sample, daemon=True)
    assert _device_lock_free_while(entered, release, t)


def test_frame_readback_waits_under_transfer_lock_not_device_lock(
        monkeypatch):
    """Fixed in the port: the JAX viewer reads a frame back under
    DEVICE_LOCK alone while sample() rides under TRANSFER_LOCK
    (spacetpu/render/viewer.py:127), safe with one consumer only. The
    port's frame issues its work under DEVICE_LOCK and waits for its
    readback under TRANSFER_LOCK, outside DEVICE_LOCK."""
    from spacetpu_torch.render.viewer import FrameSource

    sim, state, scene = _sim_and_state(16)
    src = FrameSource(SimEngine(sim, state, delta=1e-3), scene, width=32,
                      height=32)
    entered, release = _blocking(monkeypatch, Readback, "wait")
    out = []
    t = threading.Thread(target=lambda: out.append(src.frame()),
                         daemon=True)
    assert _device_lock_free_while(entered, release, t)
    assert out and out[0].shape == (32, 32, 3)


def test_run_sim_loop_stops_on_token():
    sim, state, _ = _sim_and_state()
    ex = Exchange(64, delta=1e-3)
    stop = threading.Event()
    result = {}
    t = threading.Thread(target=lambda: result.update(
        state=run_sim_loop(sim, state, ex, stop)))
    t.start()
    assert _wait(lambda: (ex.sample() is not None
                          and ex.current_ticks() >= 5))
    stop.set()
    t.join(20)
    assert not t.is_alive()
    assert torch.isfinite(result["state"].pos).all()


def test_engine_live_dt_tuning_and_current_ticks_never_go_back():
    sim, state, _ = _sim_and_state()
    eng = SimEngine(sim, state, delta=1e-3)
    seen = []
    with eng:
        assert _wait(lambda: (eng.exchange.sample() is not None
                              and eng.exchange.current_ticks() > 3))
        eng.exchange.set_delta(2e-3)
        for _ in range(20):
            eng.exchange.sample()
            seen.append(eng.exchange.current_ticks())
            time.sleep(0.002)
    assert eng.exchange.delta() == 2e-3
    assert all(b >= a for a, b in zip(seen, seen[1:]))
    assert eng.final_state is not None


def test_current_ticks_advances_without_consumer():
    sim, state, _ = _sim_and_state()
    with SimEngine(sim, state, delta=1e-3) as eng:
        assert _wait(lambda: eng.exchange.current_ticks() > 4)
        eng.check_health()


def test_engine_surfaces_sim_thread_failure():
    sim, state, _ = _sim_and_state(16)

    class Boom:  # a Simulation whose step always raises
        def __init__(self, inner):
            self.config = inner.config
            self.prime = inner.prime
            self.device = inner.device

        def step(self, s, dt):
            raise RuntimeError("kaboom")

    eng = SimEngine(Boom(sim), state, delta=1e-3)
    eng.start()
    assert _wait(lambda: eng.error is not None, 10)
    with pytest.raises(RuntimeError, match="simulation thread failed"):
        eng.check_health()
    eng.stop()


def test_snapshot_wires():
    sim, state, _ = _sim_and_state(128)
    pos = state.pos.numpy().astype(np.float64)
    exact = engine._snapshot_finish(engine._snapshot_begin(state, "f32"),
                                    "f32")
    assert exact.dtype == np.float32
    np.testing.assert_array_equal(exact, state.pos.numpy())
    quant = engine._snapshot_finish(engine._snapshot_begin(state, "u16"),
                                    "u16")
    assert quant.dtype == np.float32
    step = (pos.max(axis=0) - pos.min(axis=0)) / 65535.0
    assert (np.abs(quant - pos) <= step[None, :] * 0.75 + 1e-12).all()
    with pytest.raises(ValueError, match="snapshot wire"):
        run_sim_loop(sim, state, Exchange(128), threading.Event(),
                     snapshot_wire="bf8")
    eng = SimEngine(sim, state, delta=1e-3, snapshot_wire="u16")
    with eng:
        assert _wait(lambda: (eng.exchange.sample() is not None
                              and eng.exchange.current_ticks() >= 3))
    eng.check_health()
    snap = eng.exchange.sample()
    box = float(pos.max() - pos.min())
    assert np.abs(snap - eng.final_state.pos.numpy()).max() < 0.2 * box


def _scenes():
    """Scenes both packages' gates see alike: clouds, a Plummer sphere, and
    a cloud with two light outliers that only the finer grid resolves."""
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(1500, 3))
    pos[0], pos[1] = (35.0, 0.0, 0.0), (-35.0, 0.0, 0.0)
    outliers = (pos, np.zeros_like(pos), np.ones(1500))
    out = {}
    for name, (torch_scene, jax_scene) in {
            "cloud_64": (presets.random_cluster(64, seed=0),
                         jpresets.random_cluster(64, seed=0)),
            "cloud_1100": (presets.random_cluster(1100, seed=1),
                           jpresets.random_cluster(1100, seed=1)),
            "cloud_8192": (presets.random_cluster(8192, seed=3),
                           jpresets.random_cluster(8192, seed=3)),
            "plummer_1500": (presets.plummer_sphere(1500, seed=3),
                             jpresets.plummer_sphere(1500, seed=3)),
            "plummer_8192": (presets.plummer_sphere(8192, seed=3),
                             jpresets.plummer_sphere(8192, seed=3)),
    }.items():
        out[name] = (torch_scene.state(device="cpu"),
                     jax_scene.state(dtype=jnp.float32))
    from spacetpu.state import make_state as jmake_state
    from spacetpu_torch.state import make_state

    out["outliers_1500"] = (make_state(*outliers, device="cpu"),
                            jmake_state(*outliers, dtype=jnp.float32))
    return out


def test_solver_gates_and_auto_select_agree_with_jax(monkeypatch):
    """mesh_resolves, treepm_saturates and select_solver (both profiles,
    with and without multirate substeps) give the JAX package's answers on
    the same scenes, with MESH_SOLVER_CUTOFF at 1024 in both packages (as
    tests/test_engine.py:176, 203, 678 set it)."""
    from spacetpu import constants as jconstants

    monkeypatch.setattr(jconstants, "MESH_SOLVER_CUTOFF", 1024)
    monkeypatch.setattr(constants, "MESH_SOLVER_CUTOFF", 1024)
    answers = {}
    for name, (st, jst) in _scenes().items():
        for grid in (None, 128, 256):
            assert (engine.mesh_resolves(st, grid=grid)
                    == jengine.mesh_resolves(jst, grid=grid)), (name, grid)
        assert (engine.treepm_saturates(st)
                == jengine.treepm_saturates(jst)), name
        for profile in ("interactive", "accurate"):
            for substeps in (1, 4):
                mine = engine.select_solver(st, profile=profile,
                                            substeps=substeps)
                assert mine == jengine.select_solver(
                    jst, profile=profile, substeps=substeps), name
                answers[name, profile, substeps] = mine
    # the tiers are all exercised
    assert answers["cloud_64", "interactive", 1] == ("direct", {})
    assert answers["cloud_1100", "interactive", 1] == ("pm", {"pm_grid": 32})
    assert answers["outliers_1500", "interactive", 1] == (
        "pm", {"pm_grid": 256})
    assert answers["plummer_1500", "interactive", 1] == ("tree", {})
    assert answers["cloud_8192", "accurate", 1] == ("tree", {})
    assert answers["cloud_8192", "interactive", 4] == ("tree", {})
    assert engine.treepm_saturates(_scenes()["plummer_8192"][0])
    with pytest.raises(ValueError):
        engine.select_solver(_scenes()["cloud_64"][0], profile="nope")


def test_make_engine_for_matches_jax(monkeypatch):
    """The engine make_engine_for builds: the JAX package's solver, theta,
    refresh cadence, grid and fallback wiring, on the state's device."""
    from spacetpu import constants as jconstants

    monkeypatch.setattr(jconstants, "MESH_SOLVER_CUTOFF", 1024)
    monkeypatch.setattr(constants, "MESH_SOLVER_CUTOFF", 1024)
    scenes = _scenes()
    for name, kw in (("cloud_64", {}), ("cloud_1100", {}),
                     ("cloud_1100", {"softening": "ref"}),
                     ("cloud_1100", {"theta": 0.7, "profile": "accurate"}),
                     ("outliers_1500", {}), ("plummer_1500", {})):
        st, jst = scenes[name]
        args = dict(g=1.0, eps=1e-2, **kw)
        mine = make_engine_for(st, **args)
        theirs = jengine.make_engine_for(jst, backend="xla", **args)
        c, jc = mine.sim.config, theirs.sim.config
        assert (mine.algorithm, c.theta, c.tree_refresh_every, c.pm_grid
                ) == (theirs.algorithm, jc.theta, jc.tree_refresh_every,
                      jc.pm_grid), (name, kw)
        assert mine.sim.device.type == "cpu"
        assert ((mine._fallback_factory is None)
                == (theirs._fallback_factory is None)), name
        assert mine._recal_every == theirs._recal_every
    assert engine.resolve_interactive_theta(None) == 0.4
    assert engine.resolve_interactive_theta(None, softening="ref") == 0.3


def test_recheck_solver_swaps_on_degenerate():
    sim, state, _ = _sim_and_state(64)
    state = sim.prime(state)
    replacement, _, _ = _sim_and_state(64)
    calls = []

    def factory(reason):
        calls.append(reason)
        return replacement

    new, _ = engine._recheck_solver(sim, state, factory)
    assert new is None and calls == []
    sim.degenerate = "treepm-saturated"
    new, stale = engine._recheck_solver(sim, state, factory)
    assert new is replacement and stale and calls == ["treepm-saturated"]
    assert engine._recheck_solver(sim, state, lambda r: None)[0] is None


def test_engine_midrun_family_fallback():
    """A TreePM engine flagged degenerate swaps to the tree at its next
    re-check, keeps ticking and keeps the trajectory."""
    n = 1024
    st = presets.random_cluster(n, seed=5).state(device="cpu")
    kw = dict(softening="plummer", eps=1e-2, g=1.0, device="cpu")
    sim = make_simulation(n, algorithm="treepm", **kw)
    st = sim.prime(st)

    def factory(reason):
        assert reason == "treepm-saturated"
        return make_simulation(n, algorithm="tree", theta=0.5, **kw)

    eng = SimEngine(sim, st, delta=1e-4, recal_every=3,
                    fallback_factory=factory)
    sim.degenerate = "treepm-saturated"
    p0 = st.pos.numpy().astype(np.float64)
    with eng:
        assert _wait(lambda: eng.algorithm == "tree", 120)
        at = eng.exchange.current_ticks()
        assert _wait(lambda: eng.exchange.current_ticks() >= at + 3, 120)
    eng.check_health()
    assert eng.sim.config.resolved_algorithm() == "tree"
    assert np.abs(eng.final_state.pos.numpy() - p0).max() < 0.5


def test_checkpoints_cross_both_ways(tmp_path):
    """The npz format is the JAX package's: each package loads the other's
    checkpoints (state, scene, extras), and a resumed run continues as an
    uninterrupted one."""
    from spacetpu.io import checkpoint as jck
    from spacetpu.models import presets as jp
    from spacetpu_torch.io import checkpoint as ck

    scene = presets.fixed_cloud(40)
    jscene = jp.fixed_cloud(40)
    sim = make_simulation(scene.n, algorithm="direct", device="cpu")
    state = sim.run(sim.prime(scene.state(device="cpu", compensated=True)),
                    constants.DELTA, 3)
    mine = str(tmp_path / "port.npz")
    ck.save(mine, state, scene=scene, extra={"steps": 3})
    js, jsc, jex = jck.load(mine)
    assert jex == {"steps": 3} and jsc.names == scene.names
    for f in ("pos", "vel", "mass", "acc", "pos_c", "vel_c"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(state, f).numpy())

    jstate = jscene.state(dtype=jnp.float64)
    theirs = str(tmp_path / "jax.npz")
    jck.save(theirs, jstate, scene=jscene, extra={"dt": 10.0})
    ts, tsc, tex = ck.load(theirs, device="cpu")
    assert tex == {"dt": 10.0} and tsc.names == jscene.names
    assert ts.pos.dtype == torch.float64 and ts.n_active.dtype == torch.int32
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(tsc.radii, jscene.radii)
    ts32, _, _ = ck.load(theirs, dtype=np.float32, device="cpu")
    assert ts32.pos.dtype == torch.float32

    back, _, _ = ck.load(mine, device="cpu")
    a = sim.run(back, constants.DELTA, 2)
    b = sim.run(state, constants.DELTA, 2)
    np.testing.assert_array_equal(a.pos.numpy(), b.pos.numpy())


def test_checkpoint_orbax_roundtrip(tmp_path):
    """save_orbax and load_orbax (the JAX package's names; the port's own
    format, `torch.distributed.checkpoint`, no group needed): every field
    and the extras back bit for bit, with and without like=, and a resumed
    run bit for bit an uninterrupted one (tests/test_engine.py:241)."""
    from spacetpu_torch.io import checkpoint as ck

    sim, state, _ = _sim_and_state()
    state = sim.prime(state)
    path = str(tmp_path / "orbax_ck")
    ck.save_orbax(path, state, extra={"steps": 3})
    for like in (None, state):
        loaded, extra = ck.load_orbax(path, like=like, device="cpu")
        assert extra == {"steps": 3}
        for f in ("pos", "vel", "mass", "acc", "time", "n_active"):
            assert torch.equal(getattr(loaded, f), getattr(state, f)), f
        assert loaded.pos_c is None
    a = sim.run(loaded, constants.DELTA, 3)
    b = sim.run(state, constants.DELTA, 3)
    assert torch.equal(a.pos, b.pos)


def test_cli_config_matches_jax():
    """RunConfig has the JAX package's fields and defaults, and a command
    line parses to the same values (--platform takes gpu for tpu). Fixed in
    the port: the --tree-refresh-every help of the JAX package
    (spacetpu/utils/config.py:179) has every auto tier run 8, while the
    default headless auto keeps 1; the port's help names where 8 engages."""
    import dataclasses

    from spacetpu.utils import config as jconfig
    from spacetpu_torch.utils import config

    assert ([(f.name, f.default) for f in dataclasses.fields(
        config.RunConfig)] == [(f.name, f.default) for f in
                               dataclasses.fields(jconfig.RunConfig)])
    argv = ["--preset", "fixed_shell", "--n", "123", "--frontend", "none",
            "--steps", "7", "--dt", "2.5", "--algorithm", "treepm",
            "--pallas-method", "mxu", "--pm-split", "gauss", "--k-near",
            "auto", "--tree-refresh-every", "4", "--snapshot-wire", "u16",
            "--no-compensated", "--profile", "accurate"]
    cfg, jcfg = config.parse_args(argv), jconfig.parse_args(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert type(cfg).from_json(cfg.to_json()) == cfg
    assert config.parse_args(["--platform", "gpu"]).platform == "gpu"
    with pytest.raises(SystemExit):
        config.parse_args(["--platform", "tpu"])
    assert config.resolved_theta(None) == constants.BARNES_HUT_THETA
    flag = next(a for a in config.build_parser()._actions
                if a.dest == "tree_refresh_every")
    assert "default headless run" in " ".join(flag.help.split())


@pytest.mark.parametrize("argv, err, match", [
    (["--algorithm", "tree"], SystemExit,
     r"--shard 2 but 1 devices are in the group \(\['cpu'\]\)"),
    (["--algorithm", "treepm"], SystemExit,
     r"--shard 2 but 1 devices are in the group \(\['cpu'\]\)"),
    (["--algorithm", "direct"], SystemExit,
     r"--shard 2 but 1 devices are in the group \(\['cpu'\]\)"),
])
def test_shard_refusals(argv, err, match):
    """--shard 2 in a process with no group (one device) exits naming D
    and the devices there are, for the sharded ring, tree and TreePM
    alike."""
    import torch.distributed as dist

    from spacetpu_torch.main import main

    with pytest.raises(err, match=match):
        main(["--platform", "cpu", "--frontend", "none", "--n", "20",
              "--steps", "1", "--shard", "2"] + argv)
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [
    ["--report-encounters"], ["--merge-collisions", "5"],
    ["--substeps", "2"], ["--substeps", "auto"]])
def test_physics_flags_match_jax(argv, tmp_path, capsys):
    """The extra physics' flags on the command line that refused them
    before they were ported (`--n 20 --steps 1`, float64): both packages
    print the same encounter, merge and auto-substeps lines, and write the
    same final state (1e-9)."""
    import re

    from spacetpu.main import main as jmain
    from spacetpu_torch.io import checkpoint as ck
    from spacetpu_torch.main import main

    base = ["--platform", "cpu", "--frontend", "none", "--n", "20",
            "--steps", "1", "--dtype", "float64"] + argv
    lines, states = [], []
    for run, name in ((main, "torch"), (jmain, "jax")):
        path = str(tmp_path / f"{name}.npz")
        run(base + ["--checkpoint", path])
        out = capsys.readouterr().out
        lines.append(re.findall(r"(?:min separation|auto substeps|collisions"
                                r"|  \.\.\. step \d+: merged).*", out))
        states.append(ck.load(path, dtype=torch.float64, device="cpu")[0])
    assert lines[0] == lines[1]
    if argv == ["--report-encounters"]:
        assert len(lines[0]) == 2
    if argv == ["--substeps", "auto"]:
        assert lines[0][0].startswith("auto substeps: ")
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(states[0], f).numpy(),
                                   getattr(states[1], f).numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_engine_merge_every_matches_jax():
    """merge_every, which the port refused before it was ported: a pair
    that overlaps from the start (radii 0.6 at distance 1), one batch of
    four ticks with merge_every=4 and the stop token set beforehand, so
    both packages' loops run exactly four ticks and one merge check: the
    same merged state (1e-9) and radii; and a SimEngine publishes them."""
    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0]])
    vel = np.array([[0.25, 0, 0], [-0.25, 0, 0]])
    mass = np.array([1.0, 2.0])
    radii = np.array([0.6, 0.6])
    kw = dict(algorithm="direct", softening="plummer", eps=1e-3, g=1.0)
    from spacetpu import make_simulation as jmake
    from spacetpu import make_state as jstate
    from spacetpu_torch.state import make_state

    got = {}
    stop = threading.Event()
    stop.set()
    out = run_sim_loop(make_simulation(2, device="cpu", **kw),
                       make_state(pos, vel, mass, dtype=torch.float64,
                                  device="cpu"),
                       Exchange(2, delta=1e-2), stop, check_interval=4,
                       merge_every=4, radii=radii,
                       on_merge=lambda r: got.setdefault("torch", r))
    jout = jengine.run_sim_loop(
        jmake(2, backend="xla", **kw), jstate(pos, vel, mass,
                                              dtype=jnp.float64),
        jengine.Exchange(2, delta=1e-2), stop, check_interval=4,
        merge_every=4, radii=radii,
        on_merge=lambda r: got.setdefault("jax", r))
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert sorted(got["torch"].tolist())[0] == 0.0
    for f in ("pos", "vel", "mass", "acc"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-9,
                                   atol=1e-12)
    eng = SimEngine(make_simulation(2, device="cpu", **kw),
                    make_state(pos, vel, mass, dtype=torch.float64,
                               device="cpu"),
                    delta=1e-2, merge_every=4, radii=radii)
    with eng:
        assert _wait(lambda: eng.radii_snapshot.min() == 0.0)
    eng.check_health()
    np.testing.assert_array_equal(eng.radii_snapshot, got["torch"])


def test_every_preset_runs_headless(tmp_path, capsys):
    from spacetpu_torch.main import main

    for preset in sorted(presets.PRESETS):
        final = main(["--platform", "cpu", "--preset", preset, "--n", "80",
                      "--frontend", "none", "--steps", "3", "--algorithm",
                      "direct", "--dt", "1.0"])
        assert torch.isfinite(final.pos).all()
    ck = str(tmp_path / "end.npz")
    trace = str(tmp_path / "trace")
    main(["--platform", "cpu", "--n", "1200", "--frontend", "none",
          "--steps", "4", "--checkpoint", ck, "--checkpoint-every", "2",
          "--recalibrate-every", "2", "--profile-dir", trace])
    out = capsys.readouterr().out
    assert "tree health" in out and "energy drift" in out
    assert os.path.exists(ck) and os.path.exists(
        os.path.join(trace, "trace.json"))
    resumed = main(["--platform", "cpu", "--n", "1200", "--frontend",
                    "none", "--steps", "1", "--restore", ck])
    assert resumed.n == 1201


def test_headless_rate_leaves_out_the_energy_sums(monkeypatch, capsys):
    """The headless run's printed time and steps/s cover the steps alone:
    `spacetpu/main.py:496-499` takes its clock after the final energy sum,
    the port before it (a recorded divergence, ROADMAP.md Queue C). With
    each energy sum made 0.5 s slower, the printed time stays under 0.5 s
    and the rate above what a clock around one sum would give."""
    from spacetpu_torch.main import main
    from spacetpu_torch.ops import energy

    slow, steps = 0.5, 3
    real = energy.total_energy

    def slow_total_energy(*args, **kw):
        time.sleep(slow)
        return real(*args, **kw)

    monkeypatch.setattr(energy, "total_energy", slow_total_energy)
    t0 = time.perf_counter()
    main(["--platform", "cpu", "--n", "200", "--frontend", "none",
          "--steps", str(steps), "--algorithm", "direct"])
    whole = time.perf_counter() - t0
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith(f"{steps} steps of N="))
    wall = float(line.split(" in ")[1].split("s ")[0])
    rate = float(line.split("(")[1].split()[0])
    assert whole >= 2 * slow  # both sums ran, slowed
    assert wall < slow and rate > steps / slow


def test_offline_app_runs_without_jax(tmp_path):
    """`python -m spacetpu_torch --platform cpu --preset fixed_cloud --n 200
    --frontend offline --frames 3` writes three lit PNGs, in a process
    where no JAX module was ever imported."""
    out = str(tmp_path / "frames")
    code = ("import runpy, sys; sys.argv = ['spacetpu_torch'] + sys.argv[1:];"
            "runpy.run_module('spacetpu_torch', run_name='__main__');"
            "print('jax modules:', sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')))")
    res = subprocess.run(
        [sys.executable, "-c", code, "--platform", "cpu", "--preset",
         "fixed_cloud", "--n", "200", "--frontend", "offline", "--frames",
         "3", "--out-dir", out],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "jax modules: []" in res.stdout
    from tests.test_torch_render import _png_pixels

    pngs = sorted(os.listdir(out))
    assert pngs == [f"frame_{i:05d}.png" for i in range(3)]
    for name in pngs:
        with open(os.path.join(out, name), "rb") as f:
            rgb = _png_pixels(f.read())
        assert rgb.shape == (540, 960, 3) and rgb.max() > 0


def test_frame_source_renders_and_applies_keys():
    from spacetpu_torch.render.viewer import FrameSource, KeyState

    sim, state, scene = _sim_and_state(32)
    eng = SimEngine(sim, state, delta=1e-3)
    src = FrameSource(eng, scene, width=64, height=48)
    assert src.blend == "ordered"  # 32 bodies
    with eng:
        f1 = src.frame()
        assert f1.shape == (48, 64, 3) and f1.dtype == np.uint8
        d0 = np.linalg.norm(src.camera.eye - src.camera.target)
        src.apply_keys(KeyState(plus=True))
        d1 = np.linalg.norm(src.camera.eye - src.camera.target)
        assert d1 == pytest.approx(d0 * 0.9)
        dt0 = eng.exchange.delta()
        src.apply_keys(KeyState(l=True))
        assert eng.exchange.delta() == pytest.approx(dt0 * 0.9)
        src.apply_keys(KeyState(g=True, j=True, space=True))
        assert src.camera.focus == 0 and src.trails.count == 0
        assert src.frame().max() > 0
    lines = src.info_lines()
    assert any("Current time" in ln for ln in lines)
    assert any("Focused object" in ln for ln in lines)


def test_engine_concurrent_consumers_stress():
    """The sim thread and three consumer threads, two of them rendering:
    frames are issued under DEVICE_LOCK and read back under TRANSFER_LOCK;
    nothing deadlocks, fails or tears a frame."""
    from spacetpu_torch.render.viewer import FrameSource, KeyState

    sim, state, scene = _sim_and_state(160)  # additive blend
    eng = SimEngine(sim, state, delta=1e-3)
    src = FrameSource(eng, scene, width=48, height=32)
    assert src.blend == "additive"
    errors, frames = [], []
    switch = sys.getswitchinterval()

    def consumer(kind):
        try:
            for _ in range(12):
                if kind == "render":
                    frames.append(src.frame())
                else:
                    eng.exchange.sample()
                    src.apply_keys(KeyState(plus=True))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        with eng:
            threads = [threading.Thread(target=consumer, args=(k,))
                       for k in ("render", "render", "keys")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads), "consumer hung"
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert eng.error is None
    assert len(frames) == 24
    assert all(f.shape == (32, 48, 3) for f in frames)


def test_window_viewer_headless():
    os.environ["SDL_VIDEODRIVER"] = "dummy"
    pygame = pytest.importorskip("pygame")
    from spacetpu_torch.render.viewer import FrameSource
    from spacetpu_torch.render.window import WindowViewer

    sim, state, scene = _sim_and_state(32)
    eng = SimEngine(sim, state, delta=1e-3)
    src = FrameSource(eng, scene, width=64, height=48)
    with eng:
        viewer = WindowViewer(src, fps=1000.0)
        try:
            dt0 = eng.exchange.delta()
            pygame.event.post(pygame.event.Event(
                pygame.KEYDOWN, key=pygame.key.key_code("l")))
            assert viewer.run(max_frames=2) == 2
            assert eng.exchange.delta() == pytest.approx(dt0 * 0.9)
            pygame.display.init()
            viewer._screen = pygame.display.set_mode((64, 48),
                                                     pygame.RESIZABLE)
            pygame.event.post(pygame.event.Event(pygame.VIDEORESIZE, w=100,
                                                 h=80))
            viewer.run(max_frames=1)
            assert (src.width, src.height) == (100, 80)
        finally:
            pygame.display.quit()
