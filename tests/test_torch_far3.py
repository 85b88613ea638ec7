"""The port's 3-level far field (`spacetpu_torch.ops.tree`, far_levels=3)
against `spacetpu.ops.tree` on the same numpy inputs, in float64: the
SUPER and MID multipoles, the masked dense pass, the strip refinement, the
MID level's lists and tile lists, `mid_far_eval`, `tree_prep`, `tree_eval`
on a carried structure, `acc_tree`, `measure_near`'s MID caps and a cached
rollout. JAX runs its plain (XLA) path, jitted to keep its compile time
down.

Scene: 3,833 bodies at leaf 15 and G = 256 clusters (4 superclusters of
64, 32 MIDs; 2 padding clusters): a dense core, a wide halo and a distant
blob, so that some supers are near each other and some are not.

Tolerances, as a share of max|a|: pieces 1e-12 (the same arithmetic,
sums in another order); the whole tree 1e-9 (the far field and the near
correction cancel in part). Integers are held exactly, near lists as sets
per row (`top_k` may order equal distances differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import cuda_tree, direct
from spacetpu_torch.ops import tree as ttree
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

LEAF, GG, THETA, K_NEAR = 15, 256, 0.5, 40
N = GG * LEAF - 7
G2, G_M = GG // ttree.SUPER, GG // ttree.MID
PREP = dict(theta=THETA, k_near=K_NEAR, gg=GG, leaf=LEAF, far_levels=3)
EVAL = dict(softening="plummer", eps=1e-2, g=0.7, multipole_order=2,
            far_levels=3)


def _scene(n=N, seed=0):
    rng = np.random.default_rng(seed)
    k = n // 3
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.3,
                          rng.normal(size=(k, 3)) * 2.0,
                          rng.normal(size=(n - 2 * k, 3)) * 0.5
                          + [25.0, 0.0, 0.0]])
    return pos, rng.uniform(0.1, 1.0, n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(d):
    return {k: (tuple(np.asarray(x) for x in v) if k == "clusters"
                else np.asarray(v)) for k, v in d.items()}


def _sets(idx, null):
    return [frozenset(int(v) for v in row if v != null)
            for row in np.asarray(idx)]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_helpers():
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_tree_helpers(mp)
        yield


@pytest.fixture(scope="module")
def ref():
    """The scene and the JAX package's far3 pair-mode prep of it, as numpy
    (its strip-mode prep comes from `_jax_prep` on first use); the
    summaries and MID statistics of the pair prep."""
    pos, mass = _scene()
    jp = {"pairs": _np(parity.call(jtree.tree_prep, pos, mass,
                                   near_mode="pairs", **PREP))}
    p = jp["pairs"]
    summ = np.asarray(parity.call(
        jtree._cluster_summaries,
        *(p[k] for k in ("pos_g", "mass_g", "com", "m_tot")), 0.7))
    stats = tuple(p[k] for k in ("com", "m_tot", "r_src", "r_tgt"))
    mid = parity.call(jtree._super_stats, *stats, group=ttree.MID)
    mid = tuple(np.asarray(x) for x in mid[:3]) + (
        p["m_tot"].reshape(-1, ttree.MID).sum(1),)
    idx_mid2, _ = parity.call(jtree._mid_near_lists, *stats, *mid,
                              p["idx2"], theta=THETA,
                              k_mid=jtree.default_k_mid(THETA, G_M))
    return dict(pos=pos, mass=mass, jp=jp, summ=summ, stats=stats, mid=mid,
                idx_mid2=np.asarray(idx_mid2))


def _jax_prep(ref, near_mode):
    if near_mode not in ref["jp"]:
        ref["jp"][near_mode] = _np(parity.call(
            jtree.tree_prep, ref["pos"], ref["mass"], near_mode=near_mode,
            **PREP))
    return ref["jp"][near_mode]


@pytest.mark.parametrize("group", [ttree.SUPER, ttree.MID])
def test_super_multipoles_match_jax(ref, group):
    summ = ref["summ"][:, :GG]
    got = ttree._super_multipoles(_t(summ), group=group)
    want = parity.call(jtree._super_multipoles, summ, group=group)
    assert got.shape == (16, GG // group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * np.abs(summ).max())
    # the aggregate stays traceless and keeps the mass
    np.testing.assert_allclose(got[4:7].sum(0).numpy(), 0.0,
                               atol=1e-12 * float(got[4:7].abs().max()))
    np.testing.assert_allclose(got[3].sum().item(), summ[3].sum(),
                               rtol=1e-13)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-5)])
def test_superfar_dense_masked_matches_jax(ref, dtype, tol):
    """The masked dense pass on the JAX package's supercluster near list;
    the wrapper on CPU tensors is the plain version, and launches
    nothing."""
    p = ref["jp"]["pairs"]
    ss = np.asarray(parity.call(jtree._super_multipoles,
                                ref["summ"][:, :GG])).astype(dtype)
    targets = p["pos_g"].reshape(-1, 3).astype(dtype)
    idx2 = p["idx2"]
    assert (idx2 == G2).any() and (idx2 < G2).any()  # masked and kept
    want = parity.call(jtree._superfar_dense_masked, targets, ss, idx2,
                       eps=1e-2, backend="xla", interpret=True)
    got = cuda_tree.acc_cross_quad_masked_plain(_t(targets), _t(ss),
                                                _t(idx2).long(), eps=1e-2)
    _close(got, want, tol)
    before = dict(cuda_tree.LAUNCHES)
    via = ttree.superfar_dense_masked(_t(targets), _t(ss), _t(idx2).long(),
                                      eps=1e-2, backend="cuda")
    assert cuda_tree.LAUNCHES == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_masked_columns_add_exactly_zero(ref):
    """Masking every super leaves exactly 0; masking none is quad_dense."""
    ss = ttree._super_multipoles(_t(ref["summ"][:, :GG]))
    targets = _t(ref["jp"]["pairs"]["pos_g"]).reshape(-1, 3)
    every = torch.arange(G2).expand(G2, G2).contiguous()
    none = torch.full((G2, 1), G2)
    zero = cuda_tree.acc_cross_quad_masked(targets, ss, every, eps=1e-2)
    assert float(zero.abs().max()) == 0.0
    dense = cuda_tree.acc_cross_quad_masked(targets, ss, none, eps=1e-2)
    torch.testing.assert_close(
        dense, cuda_tree.acc_cross_quad_plain(targets, ss, eps=1e-2),
        rtol=1e-14, atol=0)


def test_superfar_refine_strips_match_jax(ref):
    p = _jax_prep(ref, "strip")
    summ = np.asarray(parity.call(
        jtree._cluster_summaries,
        *(p[k] for k in ("pos_g", "mass_g", "com", "m_tot")), 0.7))[:, :GG]
    want_tbl = parity.call(jtree._superfar_refine_table, summ, None,
                           p["idx2"])
    got_tbl = ttree._superfar_refine_table(_t(summ), None,
                                           _t(p["idx2"]).long())
    np.testing.assert_array_equal(got_tbl.numpy(), np.asarray(want_tbl))
    want = parity.call(jtree._superfar_refine_xla, p["pos_g"], want_tbl,
                       eps=1e-2)
    got = ttree.superfar_refine(_t(p["pos_g"]), got_tbl, eps=1e-2,
                                backend="torch")
    _close(got, want, 1e-12)


@pytest.mark.parametrize("k_mid", [None, 8])
def test_mid_near_lists_match_jax_as_sets(ref, k_mid):
    """k_mid=8 overflows (counted; the farthest mids are cut)."""
    stats, mid = ref["stats"], ref["mid"]
    idx2 = ref["jp"]["pairs"]["idx2"]
    assert ttree.default_k_mid(THETA, G_M) == jtree.default_k_mid(THETA, G_M)
    k_mid = k_mid or ttree.default_k_mid(THETA, G_M)
    got, over = ttree._mid_near_lists(*(_t(x) for x in stats + mid),
                                      _t(idx2).long(), THETA, k_mid)
    want, jover = parity.call(jtree._mid_near_lists, *stats, *mid, idx2,
                              theta=THETA, k_mid=k_mid)
    assert got.shape == want.shape == (G2, k_mid)
    assert int(over) == int(jover)
    assert (int(over) > 0) == (k_mid == 8)
    assert _sets(got, G_M) == _sets(want, G_M)


def test_near_lists_from_mids_match_jax_as_sets(ref):
    stats, idx_mid2 = ref["stats"], ref["idx_mid2"]
    got, over = ttree._near_lists_from_mids(
        *(_t(x) for x in stats), _t(idx_mid2), THETA, K_NEAR)
    want, jover = parity.call(jtree._near_lists_from_mids, *stats,
                              idx_mid2, theta=THETA, k_near=K_NEAR)
    assert int(over) == int(jover)
    assert _sets(got, GG) == _sets(want, GG)
    # the pool holds every near cluster: the same sets as the dense build
    dense, _ = ttree._near_lists(*(_t(x) for x in stats), THETA, K_NEAR)
    if int(over) == 0:
        assert _sets(got, GG) == _sets(dense, GG)


@pytest.mark.parametrize("caps", [(None, None), (2, 3)])
def test_mid_pair_segments_match_jax(ref, caps):
    """The same (idx2, idx_mid2) in, the same tile lists out, position by
    position; small source-tile caps drop entries and count them. Each
    target cluster owns one contiguous range of tiles, so
    `cuda_tree.tile_starts` serves the shared-strip kernel."""
    p = ref["jp"]["pairs"]
    idx2, idx_mid2 = _t(p["idx2"]).long(), _t(ref["idx_mid2"])
    m1 = ttree._m1_lists(idx2, idx_mid2, GG)
    jm1 = parity.call(jtree._m1_lists, p["idx2"], ref["idx_mid2"], gg=GG)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1))
    inner = m1[:, :-1] == G_M
    assert bool((inner & (m1[:, 1:] < G_M)).any())  # interior nulls
    kw = dict(m1_src_tiles=caps[0], m2_src_tiles=caps[1])
    segs, dropped = ttree.mid_pair_segments(idx2, idx_mid2, GG, **kw)
    jsegs, jdropped = parity.call(jtree.mid_pair_segments, p["idx2"],
                                  ref["idx_mid2"], gg=GG, **kw)
    assert int(dropped) == int(jdropped)
    assert (int(dropped) > 0) == (caps[0] is not None)
    for k, v in segs.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsegs[k]), k)
    for m in ("m1", "m2"):
        tgt, src = segs[f"{m}_tgt"].numpy(), segs[f"{m}_src"].numpy()
        nt = int(segs[f"{m}_ntiles"])
        assert (np.diff(tgt[:nt]) >= 0).all() and (tgt[nt:] == GG).all()
        starts = cuda_tree.tile_starts(segs[f"{m}_tgt"], GG).numpy()
        for a in range(GG):
            assert (tgt[starts[a]:starts[a + 1]] == a).all()
        # the 64 member clusters of a super read the same source tiles
        n_src_tiles = segs[f"{m}_flat"].shape[0] // ttree.NEAR_QUAD_PJ
        assert src.max() < n_src_tiles
        if caps[0] is None:
            for s in range(G2):
                rows = [set(src[starts[a]:starts[a + 1]])
                        for a in range(s * 64, s * 64 + 64)]
                assert all(r == rows[0] for r in rows)


def test_mid_far_eval_matches_jax(ref):
    p = ref["jp"]["pairs"]
    segs = {k: p[k] for k in p if k[:3] in ("m1_", "m2_")}
    want = parity.call(jtree.mid_far_eval, p["pos_g"], ref["summ"], segs,
                       eps=1e-2, backend="xla")
    tsegs = {k: _t(v).long() for k, v in segs.items()}
    got = ttree.mid_far_eval(_t(p["pos_g"]), _t(ref["summ"]), tsegs,
                             eps=1e-2, backend="torch")
    _close(got, want, 1e-12)
    before = dict(cuda_tree.LAUNCHES)
    via = ttree.mid_far_eval(_t(p["pos_g"]), _t(ref["summ"]), tsegs,
                             eps=1e-2, backend="cuda")
    assert cuda_tree.LAUNCHES == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def _tile_sets(flat, tgt, src, ntiles, n_src):
    """Per target cluster, the set of source ids its live tiles read."""
    pj = ttree.NEAR_QUAD_PJ
    ids = np.asarray(flat).reshape(-1, pj)[np.asarray(src)[:int(ntiles)]]
    out = [set() for _ in range(GG)]
    for a, row in zip(np.asarray(tgt)[:int(ntiles)], ids):
        out[a].update(int(v) for v in row if v < n_src)
    return out


@pytest.mark.parametrize("near_mode", ["pairs", "strip"])
def test_tree_prep_far3_matches_jax(ref, near_mode):
    """The whole of phase 1 with far_levels=3: the same permutation and
    statistics, the same supercluster and near sets, the same overflow and,
    in pair mode, the same M1/M2 work per target cluster."""
    tp = ttree.tree_prep(_t(ref["pos"]), _t(ref["mass"]), near_mode=near_mode,
                         **PREP)
    jp = _jax_prep(ref, near_mode)
    for k in ("perm", "inv"):
        np.testing.assert_array_equal(tp[k].numpy(), jp[k], k)
    for k in ("pos_g", "mass_g", "com", "m_tot", "r_src", "r_tgt"):
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-13,
                                   atol=1e-15, err_msg=k)
    assert _sets(tp["idx2"], G2) == _sets(jp["idx2"], G2)
    assert _sets(tp["idx"], GG) == _sets(jp["idx"], GG)
    assert int(tp["near_overflow"]) == int(jp["near_overflow"])
    keys = [k for k in jtree.STRUCTURE_KEYS if k in jp]
    assert [k for k in ttree.STRUCTURE_KEYS if k in tp] == keys
    if near_mode == "pairs":
        for m, n_src in (("m1", G_M), ("m2", GG)):
            assert int(tp[f"{m}_ntiles"]) == int(jp[f"{m}_ntiles"])
            got = _tile_sets(*(tp[f"{m}_{k}"] for k in ("flat", "tgt", "src",
                                                        "ntiles")), n_src)
            want = _tile_sets(*(jp[f"{m}_{k}"] for k in ("flat", "tgt", "src",
                                                         "ntiles")), n_src)
            assert got == want, m


@pytest.mark.parametrize("near_mode", ["pairs", "strip"])
def test_tree_eval_far3_from_a_carried_structure(ref, near_mode):
    """Both `acc_tree_cached`s on the JAX package's far3 structure (its
    m1_*/m2_* and idx2 entries carried over by `structure_from_numpy`), at
    moved positions: the evaluation half alone, free of sort ties."""
    jp = _jax_prep(ref, near_mode)
    js = {k: jp[k] for k in jtree.STRUCTURE_KEYS if k in jp}
    ts = ttree.structure_from_numpy(js, device="cpu")
    assert set(ts) == set(js)
    assert all(v.dtype == torch.int64 for k, v in ts.items()
               if k != "clusters")
    pos = ref["pos"] + np.random.default_rng(9).normal(
        size=ref["pos"].shape) * 1e-3
    jjs = dict(js, clusters=jtree.cluster_ops.Clusters(*js["clusters"]))
    want = parity.call(jtree.acc_tree_cached, pos, ref["mass"], jjs,
                       backend="xla", near_mode=near_mode, **EVAL)
    got = ttree.acc_tree_cached(_t(pos), _t(ref["mass"]), ts,
                                backend="torch", near_mode=near_mode, **EVAL)
    _close(got, want, 1e-9)


def test_acc_tree_far3_pairs_matches_jax(ref):
    """The whole far3 tree in pair mode, sort and lists included."""
    kw = dict(PREP, **EVAL, near_mode="pairs")
    want = parity.call(jtree.acc_tree, ref["pos"], ref["mass"],
                       backend="xla", **kw)
    got = ttree.acc_tree(_t(ref["pos"]), _t(ref["mass"]), backend="cuda",
                         **kw)
    _close(got, want, 1e-9)


def test_far3_stays_accurate(ref):
    """Pair and strip far3 within the theta budget of the exact force, with
    near lists that do not overflow, and the MID decomposition close to
    the strip refinement (tests/test_tree.py:490)."""
    pos, mass = _t(ref["pos"]), _t(ref["mass"])
    exact = direct.acc_direct(pos, mass, softening="plummer", eps=1e-2,
                              g=0.7)
    scale = torch.linalg.norm(exact, dim=1).mean()
    err = {}
    for mode in ("pairs", "strip"):
        got = ttree.acc_tree(pos, mass, backend="torch", near_mode=mode,
                             **dict(PREP, **EVAL, k_near=GG))
        err[mode] = float((torch.linalg.norm(got - exact, dim=1)
                           / scale).median())
    assert err["pairs"] < 2e-3, err
    assert err["pairs"] < 2 * err["strip"] + 1e-4, err


def test_far3_pairs_mass_partition_exact():
    """tests/test_tree.py:519 on the port: with point-like sources (supers
    far apart, quadrupoles negligible) every cluster's monopole must appear
    exactly once across the dense pass, M1 and M2, or the far field misses
    the direct sum: this catches double counts and holes."""
    rng = np.random.default_rng(8)
    n = GG * LEAF
    centers = rng.standard_normal((G2, 3)) * 1e4
    pos = _t(np.repeat(centers, n // G2, axis=0)
             + rng.standard_normal((n, 3)) * 1e-3)
    mass = _t(rng.uniform(0.5, 1.5, n) / n)
    got = ttree.acc_tree(pos, mass, theta=THETA, softening="plummer",
                         eps=1e-2, g=1.0, backend="cuda", k_near=64,
                         multipole_order=2, leaf=LEAF, gg=GG, far_levels=3,
                         near_mode="pairs")
    exact = direct.acc_direct(pos, mass, softening="plummer", eps=1e-2,
                              g=1.0)
    err = torch.linalg.norm(got - exact, dim=1) / torch.linalg.norm(
        exact, dim=1).mean()
    assert float(err.max()) < 1e-2


def test_measure_near_mid_caps_match_jax(ref):
    """measure_near's k_mid and M1/M2 source-tile caps, and a prep at those
    caps overflows nothing."""
    pos, mass = ref["pos"], ref["mass"]
    got = ttree.measure_near(_t(pos), _t(mass), theta=THETA, gg=GG,
                             leaf=LEAF)
    want = jtree.measure_near(jnp.asarray(pos), jnp.asarray(mass),
                              theta=THETA, gg=GG, leaf=LEAF)
    assert got == want
    assert {"k_mid", "m1_src_tiles", "m2_src_tiles"} <= set(got)
    assert "k_mid" not in ttree.measure_near(_t(pos), _t(mass), theta=THETA,
                                             gg=GG, leaf=LEAF,
                                             measure_mid=False)
    prep = ttree.tree_prep(
        _t(pos), _t(mass), theta=THETA, k_near=got["k_near"], gg=GG,
        leaf=LEAF, far_levels=3, near_mode="pairs", k_super=got["k_super"],
        k_mid=got["k_mid"], m1_src_tiles=got["m1_src_tiles"],
        m2_src_tiles=got["m2_src_tiles"])
    assert int(prep["near_overflow"]) == 0


def test_cached_far3_rollout_matches_jax():
    """tree_refresh_every=2 with far_levels=3 through both façades, in
    strip mode (the pair-mode structure is held on its own above): the
    structure is rebuilt at steps 0 and 2 and reused in between."""
    pos, mass = _scene(n=1900, seed=4)
    kw = dict(algorithm="tree", leaf=LEAF, theta=THETA, softening="plummer",
              eps=1e-2, g=1.0, far_levels=3, near_mode="strip", k_near=48,
              tree_refresh_every=2)
    vel = np.zeros_like(pos)
    sim = spacetpu_torch.make_simulation(1900, device="cpu", **kw)
    assert sim._tree_params()["gg"] == 128
    state = sim.run(sim.prime(spacetpu_torch.state.make_state(
        _t(pos), _t(vel), _t(mass), dtype=torch.float64, device="cpu")),
        1e-2, 3)
    jsim = spacetpu.make_simulation(1900, backend="xla", **kw)
    jstate = jsim.run(jsim.prime(spacetpu.state.make_state(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        dtype=jnp.float64)), 1e-2, 3)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(state.acc.numpy(), np.asarray(jstate.acc),
                               rtol=0, atol=1e-9 * float(
                                   np.abs(np.asarray(jstate.acc)).max()))
