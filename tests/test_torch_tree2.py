"""The port's sharded tree and TreePM (`spacetpu_torch.parallel.tree2`,
`treepmshard`) and what they need of `ops/`, on the CPU, against the JAX
package on the same inputs.

- In this process: the target slices of the near-list builders
  (`t0`/`n_t`, `s0`/`n2`), `measure_near(n_shards=)` and
  `measure_near_rcut(n_shards=)`, the pool form of
  `treepm.near_pairs_short`, and SUPER read when the aggregations are
  called.
- In the gloo group of 4 real processes that tests/test_torch_sharded.py
  and tests/test_torch_dsort.py share (`tests/torch_ranks.py`, one launch
  for the session): the sharded tree at D = 4 (pairs and strip,
  quadrupole and the ref law's monopole, three far-field levels with SUPER
  shrunk, a halo cap of 1, an npz checkpoint) and the sharded TreePM,
  against the JAX package's ShardedTreeSimulation and
  ShardedTreePMSimulation on 4 devices of the virtual mesh
  (tests/test_tree2.py, tests/test_treepm.py:271-330), computed here
  while the ranks run.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import tree as jtree
from spacetpu.ops import treepm as jtreepm
from spacetpu.parallel import ring as jring
from spacetpu.parallel import tree2 as jtree2
from spacetpu.parallel import treepmshard as jtreepmshard
from spacetpu.state import make_state as jmake_state
from spacetpu_torch.ops import morton
from spacetpu_torch.ops import tree as ttree
from spacetpu_torch.ops import treepm as ttreepm
from tests import parity, torch_ranks
from tests.parity import one_torch_thread  # noqa: F401

LEAF, GG, THETA = 15, 256, 0.5
#: the target slices: whole supers (the hierarchical builders) and a
#: ragged one (the dense builder)
SLICES = [(64, 128), (0, 64), (192, 64)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _stats_scene(seed=0):
    """A clustered scene of GG clusters of LEAF bodies: positions, masses
    and the cluster statistics (com, m_tot, r_src, r_tgt) as numpy."""
    rng = np.random.default_rng(seed)
    n = GG * LEAF
    k = n // 3
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.3,
                          rng.normal(size=(k, 3)) * 2.0,
                          rng.normal(size=(n - 2 * k, 3)) * 0.5
                          + [25.0, 0.0, 0.0]])
    mass = rng.uniform(0.1, 1.0, n)
    perm, _ = morton.morton_order(_t(pos))
    # one massless cluster: never near, a target still
    mass[perm[:LEAF].numpy()] = 0.0
    st = ttree.tree_sorted_stats(_t(pos), _t(mass), perm, GG, LEAF)
    return pos, mass, tuple(st[k].numpy() for k in ("com", "m_tot",
                                                    "r_src", "r_tgt"))


@pytest.fixture(scope="module")
def scene():
    return _stats_scene()


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("t0, n_t", SLICES + [(37, 50)])
def test_near_lists_slice_matches_jax(scene, t0, n_t):
    """The dense builder's target rows [t0, t0 + n_t): the JAX package's
    ids and overflow exactly, and the rows of the full build."""
    stats = scene[2]
    got, over = ttree.near_lists(*(_t(x) for x in stats), THETA, 40, t0=t0,
                                 n_t=n_t)
    want, jover = parity.call(jtree.near_lists, *stats, theta=THETA,
                              k_near=40, t0=t0, n_t=n_t)
    _same(got, want)
    assert int(over) == int(jover)
    full, _ = ttree.near_lists(*(_t(x) for x in stats), THETA, 40)
    _same(got, full[t0:t0 + n_t])


@pytest.mark.parametrize("t0, n_t", SLICES)
def test_hier_slices_match_jax(scene, t0, n_t):
    """The supercluster screen's rows [s0, s0 + n2) and the two-level
    build of a slice of whole supers, with its own screen and with the
    screen's rows given (idx2): the JAX package's ids and counts exactly."""
    stats = scene[2]
    s0, n2 = t0 // ttree.SUPER, n_t // ttree.SUPER
    idx2, over2 = ttree._super_screen(*(_t(x) for x in stats), THETA, 3,
                                      s0=s0, n2=n2)
    j2, jover2 = parity.call(jtree._super_screen, *stats, theta=THETA,
                             k_super=3, s0=s0, n2=n2)
    _same(idx2, j2)
    assert int(over2) == int(jover2)
    for given in (None, idx2):
        got, over = ttree._near_lists_hier(
            *(_t(x) for x in stats), THETA, 40, k_super=3, idx2=given,
            t0=t0, n_t=n_t)
        want, jover = parity.call(
            functools.partial(jtree._near_lists_hier, idx2=(
                None if given is None else jnp.asarray(j2))),
            *stats, theta=THETA, k_near=40, k_super=3, t0=t0, n_t=n_t)
        _same(got, want)
        assert int(over) == int(jover)


@pytest.mark.parametrize("t0, n_t", SLICES)
def test_mid_slices_match_jax(scene, t0, n_t):
    """The union near-MID lists and the cluster lists from their pools for
    a slice of whole supers: the JAX package's ids and counts exactly."""
    stats = scene[2]
    ts = tuple(_t(x) for x in stats)
    s0, n2 = t0 // ttree.SUPER, n_t // ttree.SUPER
    idx2, _ = ttree._super_screen(*ts, THETA, 4, s0=s0, n2=n2)
    mid = ttree._super_stats(*ts, group=ttree.MID)[:3] + (
        ts[1].reshape(-1, ttree.MID).sum(dim=1),)
    got, over = ttree._mid_near_lists(*ts, *mid, idx2, THETA, 12, t0=t0,
                                      n_t=n_t)
    want, jover = parity.call(jtree._mid_near_lists, *stats,
                              *(m.numpy() for m in mid), idx2.numpy(),
                              theta=THETA, k_mid=12, t0=t0, n_t=n_t)
    _same(got, want)
    assert int(over) == int(jover)
    got2, over2 = ttree._near_lists_from_mids(*ts, got, THETA, 40, t0=t0,
                                              n_t=n_t)
    want2, jover2 = parity.call(jtree._near_lists_from_mids, *stats,
                                np.asarray(want), theta=THETA, k_near=40,
                                t0=t0, n_t=n_t)
    _same(got2, want2)
    assert int(over2) == int(jover2)


def test_measure_near_shards_match_jax(scene):
    """measure_near with n_shards=4 (the MID caps too): every cap, the
    worst shard's included, is the JAX package's."""
    pos, mass, _ = scene
    got = ttree.measure_near(_t(pos), _t(mass), theta=THETA, gg=GG,
                             leaf=LEAF, n_shards=4)
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_tree_helpers(mp)
        want = jtree.measure_near(jnp.asarray(pos), jnp.asarray(mass),
                                  theta=THETA, gg=GG, leaf=LEAF, n_shards=4)
    assert got == want
    assert {"near_tiles_shard", "m1_src_tiles_shard",
            "m2_src_tiles_shard"} <= set(got)
    assert got["near_tiles_shard"] < got["near_tiles"]


def test_measure_near_rcut_shards_match_jax(scene):
    """measure_near_rcut with n_shards=4: the JAX package's caps and the
    worst shard's tile total."""
    pos, mass, _ = scene
    got = ttreepm.measure_near_rcut(_t(pos), _t(mass), rcut=0.4, gg=GG,
                                    leaf=LEAF, n_shards=4)
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_treepm_helpers(mp)
        want = jtreepm.measure_near_rcut(pos, mass, rcut=0.4, gg=GG,
                                         leaf=LEAF, n_shards=4)
    assert got.pop("mean_near") == pytest.approx(want.pop("mean_near"),
                                                 rel=1e-12)
    assert got == want
    assert "near_tiles_shard" in got


@pytest.mark.parametrize("split", ["poly", "gauss"])
def test_near_pairs_short_pool_matches_jax(scene, split):
    """The pool form, float64: 48 target clusters against a pool of 80
    source clusters of other bodies (null slot 80), tiles from cutoff
    lists with nulls inside: the JAX package's XLA pass within rtol 1e-10,
    through the kernel wrapper (its plain version on CPU tensors) and the
    plain backend."""
    pos, mass, _ = scene
    pos_g = pos.reshape(GG, LEAF, 3)
    mass_g = mass.reshape(GG, LEAF)
    tgt = pos_g[100:148]
    pool_pos, pool_mass = pos_g[120:200], mass_g[120:200]
    pool_com = np.asarray(ttree._group_stats(_t(pool_pos),
                                             _t(pool_mass))[0])
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 81, size=(48, 20))  # 80 = the null slot
    flat, ttgt, _, _ = ttree.near_pair_segments(
        _t(idx), 80, ttree.NEAR_TILE_J // (LEAF + 1), 200)
    kw = dict(softening="plummer", eps=1e-2, rs=0.2, rcut=0.9, split=split,
              g=0.7)
    want = np.asarray(parity.call(
        functools.partial(jtreepm.near_pairs_short, backend="xla", **kw),
        tgt, pool_pos, pool_mass, pool_com, flat.numpy(), ttgt.numpy()))
    assert np.abs(want).max() > 0
    for backend in ("cuda", "torch"):
        got = ttreepm.near_pairs_short(
            _t(tgt), _t(pool_pos), _t(pool_mass), _t(pool_com), flat, ttgt,
            backend=backend, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_super_read_when_called(scene, monkeypatch):
    """SUPER shrunk to 4 after import (as tests/test_tree2.py:101-125 does):
    `_super_stats` and `_super_multipoles` aggregate 4 clusters a node when
    called, as the JAX package's do; bound when the functions were defined,
    they would take 64."""
    stats = scene[2]
    g = np.random.default_rng(1)
    summ = g.normal(size=(16, GG))
    summ[3] = np.abs(summ[3])
    for mod in (ttree, jtree):
        monkeypatch.setattr(mod, "SUPER", 4)
    got = ttree._super_stats(*(_t(x) for x in stats))
    want = jtree._super_stats(*(jnp.asarray(x) for x in stats))
    for a, b in zip(got, want):
        assert a.shape[0] == GG // 4
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
    sm = ttree._super_multipoles(_t(summ))
    assert sm.shape == (16, GG // 4)
    np.testing.assert_allclose(sm.numpy(), np.asarray(
        jtree._super_multipoles(jnp.asarray(summ))), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind, near_mode, n", [
    ("tree", "pairs", 255), ("tree", "strip", 255), ("treepm", None, 255),
    ("tree", "pairs", 510)])
def test_wrappers_take_the_gathered_tables(kind, near_mode, n):
    """D = 1 in a gloo group of this process: backend "cuda" (the kernels'
    wrappers, which check the layout of their tables, then take the plain
    versions on CPU tensors) primes the forces of backend "torch" bit for
    bit, down to one cluster in all, where the gathered summaries are one
    column wide."""
    from spacetpu_torch.parallel import multihost, ring, tree2, treepmshard
    from spacetpu_torch.state import make_state

    pos, vel, mass = torch_ranks.ball(n, 3)
    state = make_state(pos, vel, mass, dtype=torch.float64, device="cpu")
    assert multihost.local_group("cpu")
    try:
        mesh = ring.make_mesh(1)
        acc = {}
        for backend in ("cuda", "torch"):
            if kind == "tree":
                sim = tree2.ShardedTreeSimulation(
                    mesh, n, eps=1e-3, g=1.0, near_mode=near_mode,
                    backend=backend)
            else:
                sim = treepmshard.ShardedTreePMSimulation(
                    mesh, n, grid=16, eps=1e-2, g=1.0, backend=backend)
            acc[backend] = sim.prime(sim.shard_state(state)).state.acc
    finally:
        multihost.shutdown()
    assert torch.equal(acc["cuda"], acc["torch"])
    assert torch.isfinite(acc["cuda"]).all() and acc["cuda"].abs().max() > 0


# --- the ranks: the sharded tree and TreePM at D = 4 ------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.shared(tmp_path_factory)


@functools.cache
def _jax_tree2(name):
    """The JAX package's ShardedTreeSimulation on a case: {acc, caps,
    diag[, pos, vel]}."""
    n, kw, sizes = torch_ranks.tree2_args(name)
    steps = torch_ranks.TREE2_CASES[name].get("steps")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in sizes.items():
            mp.setattr(jtree, k, v)
        pos, vel, mass = torch_ranks.ball(
            n, torch_ranks.TREE2_CASES[name]["seed"])
        sim = jtree2.ShardedTreeSimulation(jring.make_mesh(4), n,
                                           backend="xla", **kw)
        ts = sim.prime(sim.shard_state(jmake_state(pos, vel, mass,
                                                   dtype=jnp.float64)))
        out = {"acc": np.asarray(sim.user_order(ts).acc), "caps": sim.caps,
               "diag": sim.diagnose(ts)}
        if steps:
            final = sim.user_order(sim.run(ts, torch_ranks.DT, steps))
            out.update(pos=np.asarray(final.pos), vel=np.asarray(final.vel))
    return out


#: tests/test_tree2.py:50-51 and :75-77
ACC = dict(rtol=1e-9, atol=1e-12)
ROLL = dict(rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("name", list(torch_ranks.TREE2_CASES))
def test_tree2_prime_matches_jax(ranks, name):
    """The primed acc at D = 4 within rtol 1e-9, atol 1e-12 of the JAX
    package's sharded tree; the caps after the calibration and the
    diagnose counts its own; finite. Every count is 0 but the halo cap of
    1's drops."""
    want = _jax_tree2(name)
    got = ranks.results()
    assert got[f"t2_{name}_finite"]
    np.testing.assert_allclose(got[f"t2_{name}_acc"], want["acc"], **ACC)
    assert json.loads(got[f"t2_{name}_caps"]) == want["caps"]
    diag = json.loads(got[f"t2_{name}_diag"])
    assert diag == want["diag"]
    halo = torch_ranks.TREE2_CASES[name].get("halo_cap") == 1
    assert (diag["halo_overflow"] > 0) == halo
    assert diag["near_overflow"] == diag["tile_overflow"] == 0


@pytest.mark.parametrize("name", ["pairs", "strip", "ref"])
def test_tree2_prime_matches_one_device(ranks, name):
    """The primed acc at D = 4 (the pool [local | halo]) within rtol 1e-9,
    atol 1e-12 of the port's single-device tree with the same k_near and
    equal LEAF-body clusters on the same bodies, float64: the halo changes
    no near or far decision, only the order of the near sums."""
    import spacetpu_torch
    from spacetpu_torch.parallel import tree2
    from spacetpu_torch.state import make_state

    n, kw, _ = torch_ranks.tree2_args(name)
    kw.pop("halo_cap", None)
    kw.pop("resort_every", None)
    got = ranks.results()
    pos, vel, mass = torch_ranks.ball(n, torch_ranks.TREE2_CASES[name][
        "seed"])
    one = spacetpu_torch.make_simulation(
        n, algorithm="tree", backend="torch", device="cpu",
        cluster_mode="equal", leaf=tree2.LEAF,
        k_near=json.loads(got[f"t2_{name}_caps"])["k_near"], **kw)
    want = one.prime(make_state(pos, vel, mass, dtype=torch.float64,
                                device="cpu")).acc.numpy()
    np.testing.assert_allclose(got[f"t2_{name}_acc"], want, **ACC)


def test_tree2_rollout_matches_jax(ranks):
    """12 leapfrog steps, the resort every 4: positions and velocities
    within rtol 1e-7, atol 1e-10 of the JAX package's sharded rollout."""
    want = _jax_tree2("strip")
    got = ranks.results()
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f"t2_strip_{f}"], want[f], **ROLL)


def test_tree2_checkpoint_roundtrip(ranks):
    """tests/test_tree2.py:312: user_order -> npz -> load -> shard_state ->
    prime gives the checkpointed bodies exactly, and the resumed run stays
    on the continued one's trajectory to clustering accuracy (rtol 5e-5,
    atol 1e-7)."""
    got = ranks.results()
    assert got["t2_strip_restored_same"]
    np.testing.assert_allclose(got["t2_strip_resumed"],
                               got["t2_strip_continued"], rtol=5e-5,
                               atol=1e-7)


@functools.cache
def _jax_treepm(name):
    case = torch_ranks.TREEPM_CASES[name]
    pos, vel, mass = torch_ranks.treepm_scene(name)
    n = jtreepmshard.required_n(case["n"], 4)
    sim = jtreepmshard.ShardedTreePMSimulation(
        jring.make_mesh(4), n, grid=32, eps=1e-2, g=1.0,
        halo_cap=case.get("halo_cap"))
    ts = sim.prime(sim.shard_state(jmake_state(pos, vel, mass,
                                               dtype=jnp.float64, pad_to=n)))
    out = {"diag": sim.diagnose(ts), "k_near": sim._k_near,
           "near_tiles": sim._near_tiles}
    if case.get("steps"):
        out["pos"] = np.asarray(sim.user_order(
            sim.run(ts, torch_ranks.TREEPM_DT, case["steps"])).pos)
    return out


def test_treepm_sharded_matches_jax(ranks):
    """The sharded TreePM at D = 4, 8 float64 steps of 2,000 bodies padded
    to 2,040: the real bodies' positions within atol 1e-12 of the JAX
    package's sharded run (tests/test_treepm.py:271-306 at 3,000 bodies
    on 8 devices), the pad rows at rest at the origin (the JAX package
    moves them), its caps, every telemetry count 0 and no
    recalibration."""
    want = _jax_treepm("rollout")
    got = ranks.results()
    n = torch_ranks.TREEPM_CASES["rollout"]["n"]
    assert got["tpm_rollout_finite"]
    np.testing.assert_allclose(got["tpm_rollout_pos"][:n], want["pos"][:n],
                               rtol=0, atol=1e-12)
    assert not got["tpm_rollout_pos"][n:].any()
    diag = json.loads(got["tpm_rollout_diag"])
    assert diag == want["diag"] and not any(diag.values())
    caps = json.loads(got["tpm_rollout_caps"])
    assert (caps["k_near"], caps["near_tiles"]) == (want["k_near"],
                                                    want["near_tiles"])
    assert not got["tpm_rollout_recal"]


def test_treepm_halo_cap_counted(ranks):
    """A halo cap of 1 drops remote near clusters: counted as the JAX
    package counts them, the forces finite (tests/test_treepm.py:309)."""
    want = _jax_treepm("halo1")
    got = ranks.results()
    diag = json.loads(got["tpm_halo1_diag"])
    assert diag == want["diag"]
    assert diag["halo_overflow"] > 0
    assert got["tpm_halo1_finite"]


def test_halo_cap_fitted_where_the_default_is_short(ranks):
    """With the default cap's floor lowered (tree2.HALO_MIN 0: G_l / 2 = 1
    cluster, where the strip case's scene drops clusters at a cap of 1),
    prime raises the cap to the measured need: no drop, and the tree's
    primed acc, caps and counts are the JAX package's at its default cap
    (G_l = 2), the TreePM rollout's positions within atol 1e-12 of its."""
    got = ranks.results()
    assert json.loads(got["fit_tree_1_diag"])["halo_overflow"] > 0
    want = _jax_tree2("strip")
    np.testing.assert_allclose(got["fit_tree_acc"], want["acc"], **ACC)
    assert json.loads(got["fit_tree_caps"]) == want["caps"]
    assert json.loads(got["fit_tree_None_diag"]) == want["diag"]
    assert not any(want["diag"].values())
    n = torch_ranks.TREEPM_CASES["rollout"]["n"]
    np.testing.assert_allclose(got["fit_tpm_pos"][:n],
                               _jax_treepm("rollout")["pos"][:n], rtol=0,
                               atol=1e-12)
    assert not any(json.loads(got["fit_tpm_diag"]).values())
    assert json.loads(got["fit_tpm_caps"])["halo_cap"] == 2


@pytest.mark.parametrize("given, g_l, need, want", [
    (None, 1000, 0, 500), (None, 100, 0, 64), (None, 1000, 600, 758),
    (None, 1000, 900, 1000), (None, 1000, 300, 500), (7, 1000, 900, 7),
    (None, 40, 0, 40)])
def test_halo_cap_for(given, g_l, need, want):
    """The JAX package's default (G_l / 2, at least HALO_MIN, at most G_l),
    raised to the measured need with HALO_HEADROOM; a given cap kept."""
    from spacetpu_torch.parallel import tree2

    assert tree2.halo_cap_for(given, g_l, need) == want


@pytest.mark.parametrize("halo_cap, d, recal", [
    (None, {"halo_overflow": 1, "near_overflow": 0, "tile_overflow": 0},
     True),
    (5, {"halo_overflow": 1, "near_overflow": 0, "tile_overflow": 0},
     False),
    (5, {"halo_overflow": 0, "near_overflow": 9, "tile_overflow": 0},
     True),
    (None, {"halo_overflow": 0, "near_overflow": 1, "tile_overflow": 0},
     False)])
def test_recalibrate_rule(halo_cap, d, recal):
    """maybe_recalibrate's rule: truncations past frac of the group's 400
    clusters, or any drop of a measured halo cap; then the caps and the
    halo cap measured again."""
    from types import SimpleNamespace

    from spacetpu_torch.parallel import tree2

    calls = []
    sim = SimpleNamespace(
        halo_cap=halo_cap, mesh=SimpleNamespace(size=4), _g_l=100,
        calibrate=lambda ts: calls.append("calibrate"),
        _fit_halo=lambda state, ids: calls.append("fit"))
    ts = SimpleNamespace(state=None, ids=None)
    assert tree2.ShardedTreeFacade._recalibrate(sim, ts, d, 0.02) == recal
    assert calls == (["calibrate", "fit"] if recal else [])


@pytest.mark.parametrize("n, d, far_levels, order", [
    (1_000_000, 4, "auto", 2), (1_000_000, 4, "auto", 1),
    (4_000_000, 1, "auto", 2), (5000, 4, "auto", 2), (5000, 4, 3, 1),
    (100_000, 8, 2, 2)])
def test_required_n_grain(n, d, far_levels, order):
    """tree2.required_n: the JAX package's grain at 2 and 3 levels, and
    "auto" resolved as ShardedTreeSimulation resolves it on the padded
    N's clusters; treepmshard's is the 2-level grain."""
    from spacetpu_torch.parallel import tree2, treepmshard

    got = tree2.required_n(n, d, far_levels=far_levels,
                           multipole_order=order)
    two = jtree2.required_n(n, d, far_levels=2)
    three = (far_levels == 3 or far_levels == "auto" and order == 2
             and two // ttree.LEAF >= ttree.FAR3_CUTOFF)
    assert got == (jtree2.required_n(n, d, far_levels=3) if three else two)
    assert treepmshard.required_n(n, d) == jtreepmshard.required_n(n, d)
