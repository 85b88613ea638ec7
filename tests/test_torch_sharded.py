"""The port's multi-device solvers (`spacetpu_torch.parallel.ring`,
`pmshard`, and ``main --shard``) on the CPU, in a gloo group of 4 real
processes (`tests/torch_ranks.py`, one launch for the session, shared
with tests/test_torch_dsort.py), against the JAX package's sharded solvers
on 4 devices of the virtual mesh that tests/conftest.py forces and its
single-device ones, on the same inputs (tests/test_sharded.py,
tests/test_pm.py:237-275, tests/test_engine.py::test_cli_sharded_headless).
Then ``--shard 1`` in a group of this process alone against
`make_simulation`, bit for bit, and the refusals."""

import functools
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu import make_simulation as jmake_simulation
from spacetpu.parallel import pmshard as jpmshard
from spacetpu.parallel import ring as jring
from spacetpu.state import make_state as jmake_state
from spacetpu_torch import make_simulation
from spacetpu_torch.parallel import pmshard, ring
from tests import torch_ranks
from tests.parity import one_torch_thread  # noqa: F401

#: float64 holds of the ring against the JAX package (tests/test_sharded.py
#: holds its own sharded rollout to the single-device one at rtol 1e-9,
#: atol 1e-12)
F64 = dict(rtol=1e-10, atol=1e-13)
#: float32 (compensated) after a prime and a step, of the largest value of
#: each field (about 8 ulps): the ring sums its tiles in the JAX package's
#: order, each tile its pairs in its own order
F32_OF_MAX = 1e-6
#: the sharded PM against the JAX package's (tests/test_pm.py:254-257)
PM64 = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.shared(tmp_path_factory)


@functools.cache
def _jax_ring(name, sharded):
    """The JAX package's run of a ring case: (primed acc, final state)."""
    kw = dict(torch_ranks.RING_CASES[name])
    pos, vel, mass = torch_ranks.ring_scene(kw.pop("n"))
    dtype = jnp.float32 if kw.get("dtype") == "float32" else jnp.float64
    st = jmake_state(pos, vel, mass, dtype=dtype,
                     compensated=kw.get("compensated", False),
                     pad_to=kw.get("pad_to"))
    sim_kw = dict(softening="plummer", eps=kw["eps"], g=1.0,
                  integrator=kw.get("integrator", "leapfrog"))
    if sharded:
        sim = jring.ShardedSimulation(jring.make_mesh(4), st.pos.shape[0],
                                      backend="xla", **sim_kw)
        st = sim.prime(sim.shard_state(st))
    else:
        sim = jmake_simulation(st.pos.shape[0], algorithm="direct",
                               backend="xla", **sim_kw)
        st = sim.prime(st)
    acc = np.asarray(st.acc)
    if kw.get("steps"):
        st = sim.run(st, dtype(torch_ranks.DT), kw["steps"])
    return acc, st


@functools.cache
def _jax_pm(sharded):
    """The JAX package's PM run of the rank's case: (h, final state, the
    simulation)."""
    pos, mass = torch_ranks.plummer_cloud(512, seed=11)
    st = jmake_state(pos, np.zeros_like(pos), mass, dtype=jnp.float64)
    if sharded:
        sim = jpmshard.ShardedPMSimulation(jring.make_mesh(4), 512, grid=32,
                                           g=1.0)
        st = sim.prime(sim.shard_state(st))
    else:
        sim = jmake_simulation(n=512, algorithm="pm", backend="xla", g=1.0,
                               pm_grid=32)
        st = sim.prime(st)
    return sim._pm["h"], sim.run(st, 1e-3, 10), sim


def test_sharded_pm_matches_jax(ranks):
    """The sharded PM at D = 4, 10 float64 steps: the cell size of the
    single-device calibration (rel 1e-12), and positions and velocities of
    the JAX package's single-device and sharded runs within rtol 1e-8, atol
    1e-12; no body out of the box."""
    got = ranks.results()
    for sharded in (False, True):
        h, st, _ = _jax_pm(sharded)
        assert got["pm_h"] == pytest.approx(h, rel=1e-12)
        for f in ("pos", "vel"):
            np.testing.assert_allclose(got[f"pm_{f}"],
                                       np.asarray(getattr(st, f)), **PM64)
    assert got["pm_out_of_box"] == 0


def test_sharded_pm_recalibrates(ranks):
    """After the 10 steps, no rebuild for the run's own state; then 30 of
    the 512 starting bodies moved 80 times out: the health summed over the
    ranks triggers the rebuild on every rank, the cell size grows to the
    JAX package's for the same positions, and a prime in the new box has
    no body outside it."""
    got = ranks.results()
    h_old, ts, sh = _jax_pm(True)
    pos, _ = torch_ranks.plummer_cloud(512, seed=11)
    moved = pos.copy()
    moved[:torch_ranks.PM_MOVED] *= torch_ranks.PM_OUT
    assert not sh.maybe_recalibrate(ts)
    assert sh.maybe_recalibrate(ts._replace(pos=jnp.asarray(moved)))
    assert not got["recal_first"] and got["recal_second"]
    assert got["recal_h_new"] == pytest.approx(sh._pm["h"], rel=1e-12)
    assert got["recal_h_new"] > got["pm_h"] == pytest.approx(h_old,
                                                             rel=1e-12)
    assert got["recal_out_of_box"] == 0


def _drift(line):
    return float(re.search(r"drift: (\S+)", line).group(1))


def _drift_free(line):
    return re.sub(r"drift: \S+", "drift: -", line)


@pytest.mark.parametrize("algo", ["direct", "pm", "tree", "treepm"])
def test_main_shard_matches_jax(ranks, algo, tmp_path, capsys):
    """``main --shard 4`` in float64 (direct with --substeps 2 and
    --report-encounters, whose notes both print; pm with
    --recalibrate-every 2; tree, calibrated with --k-near auto, and treepm
    with --recalibrate-every 1): the same sharding, note, telemetry,
    elapsed and drift lines as the JAX package's (the drift within 1e-12),
    and the same checkpointed final state, padded to the shard grain (rtol
    1e-10, atol 1e-13). The sharded tree and TreePM keep their pad rows at
    rest at the origin (`tree2.live_rows`), where the JAX package moves
    them: there the real rows are held, and the pad rows at rest."""
    from spacetpu.main import main as jmain
    from spacetpu_torch.io import checkpoint as ck

    path = str(tmp_path / "jax.npz")
    jmain(torch_ranks.MAIN_ARGS[algo] + ["--checkpoint", path])
    want = re.findall(torch_ranks.SAME_LINES, capsys.readouterr().out)

    got = ranks.results()
    lines = [s for s in json.loads(got["lines"])[algo]
             if re.fullmatch(torch_ranks.SAME_LINES, s)]
    assert [_drift_free(s) for s in lines] == [_drift_free(s) for s in want]
    assert any(s.startswith("sharding N=") for s in want)
    # the drift printed to 4 digits: within 1e-12 (pm's 3 steps of
    # fixed_cloud drift by 4e-14, which is roundoff)
    for a, b in zip(lines, want):
        if "energy drift" in a:
            assert abs(_drift(a) - _drift(b)) <= 1e-12
    mine, scene, _ = ck.load(str(ranks.out_dir / f"main_{algo}.npz"),
                             device="cpu")
    theirs, _, _ = ck.load(path, device="cpu")
    assert mine.n == theirs.n and mine.n % 4 == 0
    n = scene.n if algo in ("tree", "treepm") else mine.n
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(mine, f).numpy()[:n],
                                   getattr(theirs, f).numpy()[:n], **F64)
        assert not getattr(mine, f)[n:].any()


@pytest.mark.parametrize("name, fields", [
    ("rollout", ("prime_acc",)), ("rollout", ("pos", "vel", "acc")),
    ("yoshida4", ("pos", "vel"))], ids=["acc", "rollout", "yoshida4"])
def test_ring_matches_jax(ranks, name, fields):
    """The ring's primed acc, a 10-step leapfrog and an 8-step yoshida4
    rollout in float64 at D = 4: the JAX package's sharded and
    single-device results within rtol 1e-10, atol 1e-13."""
    got = ranks.results()
    for sharded in (True, False):
        acc, st = _jax_ring(name, sharded)
        for f in fields:
            want = acc if f == "prime_acc" else np.asarray(getattr(st, f))
            np.testing.assert_allclose(got[f"{name}_{f}"], want, **F64)


def test_ring_compensated_float32_matches_jax(ranks):
    """Compensated float32 (pos_c, vel_c) through a prime and a step at
    D = 4: pos, vel and acc, and the compensated sums pos + pos_c and
    vel + vel_c (in float64), within F32_OF_MAX of the largest value of
    the JAX package's sharded step."""
    _, want = _jax_ring("compensated", True)
    got = ranks.results()
    for f in ("pos", "vel", "acc"):
        mine, theirs = got[f"compensated_{f}"], np.asarray(getattr(want, f))
        assert mine.dtype == np.float32
        bound = F32_OF_MAX * np.abs(theirs).max()
        assert np.abs(mine - theirs).max() <= bound, f
        if f != "acc":
            c_mine = got[f"compensated_{f}_c"].astype(np.float64)
            c_theirs = np.asarray(getattr(want, f"{f}_c"), np.float64)
            assert np.abs(c_mine).max() > 0
            assert np.abs((mine + c_mine) - (theirs + c_theirs)).max() \
                <= bound, f


def test_ring_pad_rows_at_eps_zero(ranks):
    """250 bodies padded to 252 with zero-mass rows at the origin, plummer
    eps 0: the pad rows' self pairs and pair with each other add exactly 0
    (the r^2 = 0 mask), so every row is finite and matches the JAX
    package's sharded run of the same padded state."""
    _, want = _jax_ring("pad_eps0", True)
    got = ranks.results()
    for f in ("pos", "vel", "acc"):
        assert np.isfinite(got[f"pad_eps0_{f}"]).all()
        np.testing.assert_allclose(got[f"pad_eps0_{f}"],
                                   np.asarray(getattr(want, f)), **F64)
    assert got["pad_eps0_pos"].shape == (252, 3)


@pytest.mark.parametrize("algo", ["direct", "pm"])
def test_shard_one_matches_single_device(algo):
    """``--shard 1`` on the CPU forms a gloo group of this process alone,
    and ends it: the ring at D = 1 is zeros + the tile of the whole state,
    and the PM's all_reduce of one rank is the identity, so the final state
    is make_simulation's bit for bit."""
    import torch.distributed as dist

    from spacetpu_torch.main import main
    from spacetpu_torch.models import presets

    argv = ["--platform", "cpu", "--frontend", "none", "--shard", "1",
            "--algorithm", algo, "--preset", "random_cluster", "--n", "300",
            "--eps", "1e-2", "--dt", "1e-3", "--steps", "4", "--pm-grid",
            "32"]
    got = main(argv)
    assert not dist.is_initialized()
    scene = presets.random_cluster(300, seed=0)
    sim = make_simulation(300, algorithm=algo, eps=1e-2, g=scene.g,
                          pm_grid=32, device="cpu")
    want = sim.run(sim.prime(scene.state(dtype=torch.float32,
                                         compensated=True, device="cpu")),
                   1e-3, 4)
    for f in ("pos", "vel", "acc", "pos_c", "vel_c"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_refusals():
    """The divisibility check, the ring's refusal of the tree pointing to
    the sharded tree's class, and a mesh without a group."""
    mesh = ring.Mesh(size=8, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        ring.ShardedSimulation(mesh, 100)
    with pytest.raises(ValueError, match="divisible"):
        pmshard.ShardedPMSimulation(mesh, 100)
    with pytest.raises(ValueError,
                       match=r"parallel\.tree2\.ShardedTreeSimulation"):
        ring.ShardedSimulation(mesh, 2048, algorithm="tree")
    with pytest.raises(RuntimeError, match="no process group"):
        ring.make_mesh()
