"""The tree through the port's `Simulation` façade against `spacetpu`'s:
the default workload's path (`algorithm="auto"` above the cutoff), the
calibration caps, the choice of partition, `health`, the `degenerate` flag,
the cached-structure rollout, and a `NotImplementedError` for each
configuration that the port leaves out. float64 on the CPU; JAX runs its
plain (XLA) path, with its tree helpers jitted (`tests/parity.py`). The
adaptive partition's own calibration is in test_torch_adaptive.py."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.constants import DELTA
from spacetpu.models import presets as jpresets
from spacetpu.utils import metrics as jmetrics
from spacetpu_torch.models import presets as tpresets
from spacetpu_torch.ops import cuda_tree
from spacetpu_torch.ops import tree as ttree
from spacetpu_torch.utils import metrics as tmetrics
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

#: a small tree whose near lists are measured: 65 clusters of 31
CAL = dict(algorithm="tree", leaf=31, theta=0.5, k_near="auto",
           cluster_mode="equal", softening="plummer", eps=1e-3, g=1.0)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_helpers():
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_tree_helpers(mp)
        yield


def _cluster_states(n=2000, seed=3):
    ts = tpresets.random_cluster(n, seed=seed).state(dtype=torch.float64,
                                                     device="cpu")
    js = jpresets.random_cluster(n, seed=seed).state(dtype=jnp.float64)
    return ts, js


def test_auto_simulation_matches_jax():
    """`make_simulation(n)` with every default on fixed_cloud(2000): "auto"
    picks the tree, strips on the plain path, quadrupoles for plummer. Five
    leapfrog steps; 1e-9 relative on positions and velocities (the forces
    agree to 1e-9 of max|a|, see test_torch_tree_eval.py)."""
    scene, jscene = tpresets.fixed_cloud(2000), jpresets.fixed_cloud(2000)
    n = scene.n
    sim = spacetpu_torch.make_simulation(n, device="cpu")
    assert sim.algorithm == "tree" and sim.backend == "torch"
    assert sim.config.resolved_near_mode(sim.backend) == "strip"
    assert sim.config.resolved_near_mode("cuda") == "pairs"
    assert sim.config.resolved_multipole_order() == 2
    state = sim.prime(scene.state(dtype=torch.float64, device="cpu"))
    before = dict(cuda_tree.LAUNCHES)
    state = sim.run(state, DELTA, 5)
    assert cuda_tree.LAUNCHES == before
    jsim = spacetpu.make_simulation(n)
    jstate = jsim.prime(jscene.state(dtype=jnp.float64))
    for _ in range(5):
        jstate = jsim.step(jstate, DELTA)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(state.vel.numpy(), np.asarray(jstate.vel),
                               rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(
        state.acc.numpy(), np.asarray(jstate.acc), rtol=0,
        atol=1e-9 * float(np.abs(np.asarray(jstate.acc)).max()))
    assert sim.caps == jsim.caps
    assert sim.health(state) == jsim.health(jstate)


@pytest.fixture(scope="module")
def calibrated():
    """The kernel configuration (pair list, measured caps) on CPU tensors,
    where each wrapper takes its plain version, beside the JAX package's
    calibration of the same scene."""
    ts, js = _cluster_states()
    sim = spacetpu_torch.make_simulation(ts.n, backend="cuda", device="cpu",
                                         **CAL)
    jsim = spacetpu.make_simulation(js.n, backend="pallas", **CAL)
    assert sim._needs_calibration and sim.caps["k_near"] is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = sim.prime(ts)
        jsim.calibrate(js)
    return sim, state, jsim, js


def test_calibration_caps_match_jax(calibrated):
    sim, _, jsim, _ = calibrated
    assert not sim._needs_calibration and sim.jit_epoch == 2
    assert sim.caps == jsim.caps
    assert sim.caps["cluster_mode"] == "equal"
    assert sim.caps["near_tiles"] > 0 and sim.caps["k_super"] >= 2
    assert sim.degenerate == jsim.degenerate


def test_health_under_calibrated_caps(calibrated):
    """Measured caps leave nothing over (the JAX package's `health` is held
    in test_auto_simulation_matches_jax, its pair-list overflow count in
    test_torch_tree_prep.py)."""
    sim, state, _, _ = calibrated
    assert sim.health(state) == {"algorithm": "tree", "near_overflow": 0,
                                 "clusters": 65,
                                 "k_near": sim.caps["k_near"]}
    assert sim.maybe_recalibrate(state) is False


def test_calibrated_pair_list_is_accurate(calibrated):
    sim, state, _, _ = calibrated
    exact = spacetpu_torch.make_simulation(
        state.n, algorithm="direct", device="cpu", softening="plummer",
        eps=1e-3, g=1.0).acc_fn(state.pos, state.mass)
    err = torch.linalg.norm(state.acc - exact, dim=1) / torch.linalg.norm(
        exact, dim=1).mean()
    assert float(err.median()) < 5e-4


def test_dense_near_lists_set_degenerate_and_warn():
    """fixed_cloud(2000) at leaf 31: the measured cap covers all 65
    clusters. The flag and the warning stay; nothing is refused."""
    state = tpresets.fixed_cloud(2000).state(dtype=torch.float64,
                                             device="cpu")
    n = state.n
    kw = dict(CAL, eps=None, g=spacetpu_torch.constants.G)
    sim = spacetpu_torch.make_simulation(n, backend="cuda", device="cpu",
                                         **kw)
    assert sim.degenerate is None
    with pytest.warns(UserWarning, match="saturate the scene"):
        sim.calibrate(state)
    assert sim.degenerate == "tree-dense-near"
    assert sim.caps["k_near"] >= 65 // 2
    pinned = spacetpu_torch.make_simulation(n, backend="cuda", device="cpu",
                                            **dict(kw, k_near=40))
    pinned.calibrate(state)
    assert pinned.degenerate is None and pinned.caps["k_near"] == 40


def test_cluster_mode_auto_measures_the_adaptive_partition(monkeypatch):
    """Heavy-tailed near lists: both packages measure the adaptive
    partition next and make the same choice with the same caps."""
    ts, js = _cluster_states()
    kw = dict(CAL, cluster_mode="auto", k_near=16)
    modes = []
    measure = ttree.measure_near
    monkeypatch.setattr(ttree, "measure_near", lambda *a, **k: modes.append(
        k["cluster_mode"]) or measure(*a, **k))
    sim = spacetpu_torch.make_simulation(ts.n, backend="cuda", device="cpu",
                                         **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim.calibrate(ts)
    assert modes[:2] == ["equal", "adaptive"]
    jsim = spacetpu.make_simulation(js.n, backend="pallas", **kw)
    jsim.calibrate(js)
    assert sim.caps == jsim.caps


def test_default_workload_keeps_the_equal_partition_in_jax():
    """fixed_cloud(10000) with every default, float32, kernel backends: the
    heavy-tail trigger fires in both packages; both measure the adaptive
    partition and keep "equal", with the same caps."""
    n = 10_000
    ts = tpresets.fixed_cloud(n).state(dtype=torch.float32, device="cpu")
    js = jpresets.fixed_cloud(n).state(dtype=jnp.float32)
    jsim = spacetpu.make_simulation(js.n, backend="pallas")
    jsim.calibrate(js)
    assert jsim.caps["cluster_mode"] == "equal"
    sim = spacetpu_torch.make_simulation(ts.n, backend="cuda", device="cpu")
    sim.calibrate(ts)
    assert sim.caps == jsim.caps
    assert sim.degenerate is None and jsim.degenerate is None


@pytest.mark.parametrize("kw,match", [
    (dict(near_mode="strip", backend="cuda"), "Queue B item 10"),
    (dict(backend="pallas", near_mode="strip"), "Queue B item 10"),
    (dict(substeps=2), "Queue A item 9"),
])
def test_unported_tree_configurations_raise(kw, match):
    kw = {"n": 2000, "algorithm": "tree", **kw}
    with pytest.raises(NotImplementedError, match=match):
        spacetpu_torch.make_simulation(kw.pop("n"), device="cpu", **kw)


@pytest.mark.parametrize("kw,far_levels,gg,cluster_mode", [
    (dict(far_levels=3), 3, 64, "equal"),
    (dict(n=1_044_226), 3, 4096, "equal"),
    (dict(n=4_000_001), 3, 15744, "equal"),
    (dict(cluster_mode="adaptive"), 2, 24, "adaptive")])
def test_three_levels_and_the_adaptive_partition_construct(
        kw, far_levels, gg, cluster_mode):
    """far_levels=3 (asked for, or "auto" at 4096 clusters and above) and
    the adaptive partition, which the port used to refuse; the adaptive
    partition calibrates before its first step."""
    sim = spacetpu_torch.make_simulation(kw.pop("n", 2000), algorithm="tree",
                                         backend="cuda", device="cpu", **kw)
    p = sim._tree_params()
    assert (p["far_levels"], p["gg"], p["cmode"]) == (
        far_levels, gg, cluster_mode)
    assert sim._needs_calibration


@pytest.mark.parametrize("kw", [
    dict(n=1_044_225), dict(n=1_044_226, far_levels=2),
    dict(n=1_044_226, multipole_order=1), dict(n=1_044_226, softening="ref"),
])
def test_large_trees_that_stay_at_two_levels_construct(kw):
    sim = spacetpu_torch.make_simulation(kw.pop("n"), algorithm="tree",
                                         backend="cuda", device="cpu", **kw)
    assert sim._tree_params()["far_levels"] == 2


def test_tree_config_validation():
    for kw, match in ((dict(cluster_mode="octree"), "cluster_mode"),
                      (dict(near_mode="list"), "near_mode")):
        with pytest.raises(ValueError, match=match):
            spacetpu_torch.make_simulation(2000, device="cpu", **kw)
    sim = spacetpu_torch.make_simulation(
        2000, device="cpu", softening="ref", leaf=31)
    assert sim.config.resolved_multipole_order() == 1
    assert sim._tree_params()["leaf"] == 31
    with pytest.raises(ValueError, match="plummer"):
        spacetpu_torch.make_simulation(
            2000, device="cpu", softening="ref", multipole_order=2).prime(
            tpresets.random_cluster(2000).state(device="cpu"))


def test_cached_structure_rollout_matches_jax():
    """tree_refresh_every=3: the structure is rebuilt at steps 0, 3, 6 and
    reused in between, as the JAX package's scan does."""
    ts, js = _cluster_states(n=600)
    kw = dict(algorithm="tree", leaf=31, theta=0.5, softening="plummer",
              eps=1e-2, g=1.0, tree_refresh_every=3)
    sim = spacetpu_torch.make_simulation(ts.n, device="cpu", **kw)
    built = []
    build = sim.build_structure
    sim.build_structure = lambda s: built.append(1) or build(s)
    state = sim.run(sim.prime(ts), 1e-2, 7)
    assert len(built) == 3
    jsim = spacetpu.make_simulation(js.n, **kw)
    jstate = jsim.run(jsim.prime(js), 1e-2, 7)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=1e-9, atol=1e-12)
    every = spacetpu_torch.make_simulation(
        ts.n, device="cpu", **dict(kw, tree_refresh_every=1))
    fresh = every.run(every.prime(ts), 1e-2, 7)
    assert float((fresh.pos - state.pos).abs().max()) < 1e-4


def test_maybe_recalibrate_stops_on_a_pinned_cap():
    ts, _ = _cluster_states()
    sim = spacetpu_torch.make_simulation(
        ts.n, backend="cuda", device="cpu", **dict(CAL, k_near=2))
    state = sim.prime(ts)
    assert sim.health(state)["near_overflow"] > 0.02 * 65
    with pytest.warns(UserWarning, match="pinned"):
        assert sim.maybe_recalibrate(state) is True
    assert sim.maybe_recalibrate(state) is False
    assert sim.caps["k_near"] == 2


@pytest.mark.parametrize("k_near", [None, 2])
def test_tree_health_matches_jax(k_near):
    ts = tpresets.fixed_cloud(2000).state(dtype=torch.float64, device="cpu")
    js = jpresets.fixed_cloud(2000).state(dtype=jnp.float64)
    got = tmetrics.tree_health(ts.pos, ts.mass, theta=0.5, k_near=k_near)
    want = jmetrics.tree_health(js.pos, js.mass, theta=0.5, k_near=k_near)
    assert got == want and got["clusters"] == 8
    assert (got["near_overflow"] > 0) == (k_near == 2)
