"""The port's adaptive partition (`spacetpu_torch.ops.morton`'s deep keys,
`ops.cluster.adaptive_clusters`, `ops.tree` with cluster_mode="adaptive")
and `Simulation.calibrate`'s choice of partition, against `spacetpu`'s, in
float64. JAX runs its plain (XLA) path with its tree helpers jitted
(`tests/parity.py`).

Keys and cluster plans are integers and are held exactly; near lists as
sets per row; forces to 1e-9 of max|a| for the whole tree (the far field
and the near correction cancel in part).

Scenes: a dense core with a wide halo (a density contrast of 1000, the
Plummer pathology in small). At N=8,000 and leaf 15 it is the smallest
scene found on which the JAX package's calibration prefers the adaptive
partition (0.75x the near tiles); Plummer spheres of 3,800-20,000 bodies
at leaf 15 stay "equal" there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import cluster as jcluster
from spacetpu.ops import morton as jmorton
from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import cluster as tcluster
from spacetpu_torch.ops import morton as tmorton
from spacetpu_torch.ops import tree as ttree
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

LEAF, THETA = 15, 0.5
#: calibration settings of both packages' simulations
CAL = dict(algorithm="tree", near_mode="pairs", leaf=LEAF, theta=THETA,
           k_near="auto", softening="plummer", eps=1e-3, g=1.0)


def _core_halo(n, seed=1):
    rng = np.random.default_rng(seed)
    k = int(n * 0.9)
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.01,
                          rng.normal(size=(n - k, 3)) * 10.0])
    return pos, rng.uniform(0.5, 1.5, n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sets(idx, null):
    return [frozenset(int(v) for v in row if v != null)
            for row in np.asarray(idx)]


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_helpers():
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_tree_helpers(mp)
        yield


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_deep_keys_match_jax(dtype):
    """hilbert_keys_2w: exact in float64. In float32 a body on a cell
    boundary may quantize into the next of the 2^20 cells an axis (the
    operations are the JAX package's, but not every float32 rounding need
    be), so nearly all keys are held. sfc_sort_2w: the same order, ties
    (repeated positions) in body order, and the sorted words."""
    pos, _ = _core_halo(3800, seed=2)
    pos = np.concatenate([pos, pos[:50]]).astype(dtype)
    hi, lo = tmorton.hilbert_keys_2w(_t(pos))
    jhi, jlo = parity.call(jmorton.hilbert_keys_2w, pos)
    assert hi.dtype == torch.int64 and int(hi.max()) < 1 << 30
    same = (hi.numpy() == np.asarray(jhi)) & (lo.numpy() == np.asarray(jlo))
    if dtype == np.float64:
        assert same.all()
        got = tmorton.sfc_sort_2w(_t(pos))
        want = parity.call(jmorton.sfc_sort_2w, pos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (np.diff(got[0].numpy()[got[1].numpy()[:50]]) != 0).all()
    else:
        assert same.mean() > 0.999


@pytest.mark.parametrize("n,leaf,g_cap", [
    (3800, 15, None), (3800, 7, None), (3800, 15, 300), (1, 15, 1)])
def test_adaptive_clusters_match_jax(n, leaf, g_cap):
    """On the same sorted keys, the same gather plan field by field. g_cap
    300 is under the partition's count: the equal-count fallback, with
    overflow 1."""
    pos, _ = _core_halo(max(n, 2), seed=3)
    _, _, hi, lo = parity.call(jmorton.sfc_sort_2w, pos[:n])
    g_cap = g_cap or tcluster.g_cap_for(n, leaf)
    got = tcluster.adaptive_clusters(_t(hi).long(), _t(lo).long(), n, leaf,
                                     g_cap, device="cpu")
    want = parity.call(jcluster.adaptive_clusters, hi, lo, n=n, leaf=leaf,
                       g_cap=g_cap)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got.overflow) == (g_cap == 300)
    if g_cap != 300:
        # every body in exactly one real slot, clusters of at most leaf
        flat = got.slot.numpy()[got.mask.numpy()]
        assert sorted(flat) == list(range(n))
        assert int(got.n_clusters) >= -(-n // leaf)


@pytest.mark.parametrize("far_levels,near_mode", [(2, "pairs"),
                                                  (3, "pairs"),
                                                  (3, "strip")])
def test_adaptive_tree_prep_matches_jax(far_levels, near_mode):
    """Phase 1 with the adaptive partition: the same permutation and gather
    plan, the same statistics, near sets and overflow."""
    pos, mass = _core_halo(3800, seed=4)
    gg = tcluster.g_cap_for(3800, LEAF, ttree.SUPER)
    kw = dict(theta=THETA, k_near=64, gg=gg, leaf=LEAF,
              cluster_mode="adaptive", far_levels=far_levels,
              near_mode=near_mode)
    tp = ttree.tree_prep(_t(pos), _t(mass), **kw)
    jp = parity.call(jtree.tree_prep, pos, mass, **kw)
    for k in ("perm", "inv"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    g2 = gg // ttree.SUPER if far_levels == 3 else 1
    assert _sets(tp["idx2"], g2) == _sets(jp["idx2"], g2)
    for name, g, w in zip(tp["clusters"]._fields, tp["clusters"],
                          jp["clusters"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    # to 1e-13 of each statistic's largest value: the radii of the empty
    # padding clusters are rounding residues of a mean of equal positions
    for k in ("pos_g", "mass_g", "com", "m_tot", "r_src", "r_tgt"):
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                   atol=1e-13 * np.abs(want).max(),
                                   err_msg=k)
    assert _sets(tp["idx"], gg) == _sets(jp["idx"], gg)
    assert int(tp["near_overflow"]) == int(jp["near_overflow"])
    if near_mode == "pairs":
        for k in [k for k in ttree.STRUCTURE_KEYS if k.endswith("ntiles")
                  and k in tp]:
            assert int(tp[k]) == int(jp[k]), k


def test_acc_tree_adaptive_far3_matches_jax():
    """The whole tree with the adaptive partition (345 clusters under a cap
    of 384, 6 supers) and three far-field levels, in strip mode, the CPU's
    default; the pair-mode structures of the partition are held in
    test_adaptive_tree_prep_matches_jax, their forces on the card by
    tests/test_torch_gpu.py::test_far3_path_launches_kernels."""
    pos, mass = _core_halo(3800, seed=4)
    kw = dict(theta=THETA, softening="plummer", eps=1e-3, g=0.7, k_near=64,
              multipole_order=2, leaf=LEAF, cluster_mode="adaptive",
              far_levels=3, near_mode="strip", gg=384)
    want = np.asarray(parity.call(jtree.acc_tree, pos, mass, backend="xla",
                                  **kw))
    clusters = ttree.tree_prep(_t(pos), _t(mass), theta=THETA, k_near=64,
                               gg=384, leaf=LEAF, cluster_mode="adaptive",
                               far_levels=3)["clusters"]
    assert (int(clusters.n_clusters), int(clusters.overflow)) == (345, 0)
    got = ttree.acc_tree(_t(pos), _t(mass), backend="torch", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def _state(pos, mass):
    return spacetpu_torch.make_state(_t(pos), _t(np.zeros_like(pos)),
                                     _t(mass), dtype=torch.float64,
                                     device="cpu")


@pytest.fixture(scope="module")
def calibration():
    """The port's calibration of the core-halo scene at N=8,000, with
    three far-field levels from 512 clusters up (FAR3_CUTOFF), and the
    `measure_near` calls it made: the equal partition with the MID caps,
    the exploratory adaptive one without them, and the adaptive one again
    at the shrunk cluster cap."""
    pos, mass = _core_halo(8000)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttree, "FAR3_CUTOFF", 512)
        measure = ttree.measure_near
        mp.setattr(ttree, "measure_near", lambda *a, **k: calls.append(
            (k, measure(*a, **k))) or calls[-1][1])
        sim = spacetpu_torch.make_simulation(8000, backend="cuda",
                                             device="cpu", **CAL)
        with pytest.warns(UserWarning, match="saturate"):
            sim.calibrate(_state(pos, mass))
        far_levels = sim._tree_params()["far_levels"]
    return dict(pos=pos, mass=mass, sim=sim, far_levels=far_levels,
                calls=calls, jax={})


def _jax_measure(cal, i):
    """The JAX package's measure_near for the port's i-th call, once."""
    if i not in cal["jax"]:
        kw = cal["calls"][i][0]
        cal["jax"][i] = jtree.measure_near(jnp.asarray(cal["pos"]),
                                           jnp.asarray(cal["mass"]), **kw)
    return cal["jax"][i]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_calibration_measurements_match_jax(calibration, i):
    calls = calibration["calls"]
    assert [(k["gg"], k["cluster_mode"], k["measure_mid"])
            for k, _ in calls] == [(576, "equal", True),
                                   (1664, "adaptive", False),
                                   (960, "adaptive", True)]
    assert calls[i][1] == _jax_measure(calibration, i)


def test_calibrate_chooses_adaptive_like_jax(calibration, monkeypatch):
    """The JAX package's calibrate, fed the measurements that
    test_calibration_measurements_match_jax holds equal to the port's,
    makes the same choice: the adaptive partition, the same shrunk cluster
    cap, the same caps, three far-field levels."""
    measured = {(k["gg"], k["cluster_mode"], k["measure_mid"]):
                _jax_measure(calibration, i)
                for i, (k, _) in enumerate(calibration["calls"])}
    monkeypatch.setattr(jtree, "FAR3_CUTOFF", 512)
    monkeypatch.setattr(jtree, "measure_near", lambda pos, mass, **k: dict(
        measured[(k["gg"], k["cluster_mode"], k["measure_mid"])]))
    jsim = spacetpu.make_simulation(8000, backend="xla", **CAL)
    with pytest.warns(UserWarning, match="saturate"):
        jsim.calibrate(spacetpu.make_state(
            jnp.asarray(calibration["pos"]), jnp.zeros((8000, 3)),
            jnp.asarray(calibration["mass"]), dtype=jnp.float64))
    sim = calibration["sim"]
    assert sim.caps == jsim.caps
    assert sim.caps["cluster_mode"] == "adaptive" and sim.caps["gg"] == 960
    assert None not in sim.caps.values()
    assert calibration["far_levels"] == 3
    assert jsim._tree_params()["far_levels"] == 3
    assert sim.degenerate == jsim.degenerate == "tree-dense-near"


def test_health_and_recalibration_follow_the_partition(calibration):
    """`health` rebuilds the calibrated adaptive far3 structure with
    nothing over its caps (its forces are held in
    test_acc_tree_adaptive_far3_matches_jax), and a recalibration on a
    uniform scene goes back to "equal" without keeping the shrunk adaptive
    cluster cap."""
    sim = calibration["sim"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttree, "FAR3_CUTOFF", 512)
        state = _state(calibration["pos"], calibration["mass"])
        assert sim.health(state) == {"algorithm": "tree", "near_overflow": 0,
                                     "clusters": 960,
                                     "k_near": sim.caps["k_near"]}
        uniform = np.random.default_rng(5).uniform(-1, 1, (8000, 3))
        sim.calibrate(_state(uniform, np.ones(8000)))
        assert sim.caps["cluster_mode"] == "equal"
        assert sim.caps["gg"] is None and sim._tree_params()["gg"] == 576
