"""The structure half of the port's tree (`spacetpu_torch.ops.tree`: cluster
statistics, near lists, tile lists, summaries, `tree_prep`) against
`spacetpu.ops.tree` on the same numpy inputs, in float64. Integers are held
exactly. Near lists are held as sets per row: `jax.lax.top_k` and
`torch.topk` may order equal distances differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import tree as ttree

N, LEAF = 2048, 15
GG = -(-N // LEAF)  # 137 clusters, 3 superclusters


def _scene(n=N, seed=0):
    """A clustered scene: a dense core, a wide halo, and a compact blob of
    massless tracers off to one side that fills whole clusters."""
    rng = np.random.default_rng(seed)
    n_t = n // 16
    n_m = n - n_t
    pos = np.concatenate([rng.normal(size=(n_m // 2, 3)) * 0.2,
                          rng.normal(size=(n_m - n_m // 2, 3)) * 2.0,
                          rng.normal(size=(n_t, 3)) * 0.05 + 9.0]) + 5.0
    mass = np.concatenate([rng.uniform(0.1, 1.0, n_m), np.zeros(n_t)])
    return pos, mass


def _t(x):
    return torch.from_numpy(np.array(x))


def _sets(idx, null):
    return [frozenset(int(v) for v in row if v != null)
            for row in np.asarray(idx)]


@pytest.fixture(scope="module")
def stats():
    """Cluster statistics from the JAX package, as numpy, handed to both
    packages so that sort ties and summation order cannot differ."""
    pos, mass = _scene()
    perm, _ = jtree.morton.morton_order(jnp.asarray(pos))
    s = jtree.tree_sorted_stats(jnp.asarray(pos), jnp.asarray(mass), perm,
                                GG, LEAF)
    return {k: np.asarray(v) for k, v in s.items()}


@pytest.fixture(scope="module")
def jax_idx(stats):
    idx, over = jtree._near_lists(*(jnp.asarray(stats[k]) for k in
                                    ("com", "m_tot", "r_src", "r_tgt")),
                                  0.5, 40)
    return np.asarray(idx), int(over)


def test_group_stats_match_jax(stats):
    got = ttree._group_stats(_t(stats["pos_g"]), _t(stats["mass_g"]))
    for g, name in zip(got, ("com", "m_tot", "r_src", "r_tgt")):
        np.testing.assert_allclose(g.numpy(), stats[name], rtol=1e-13,
                                   atol=1e-15, err_msg=name)
    massless = stats["m_tot"] == 0
    assert massless.sum() >= 2
    # a massless cluster keeps its centroid as centre, and a target radius
    np.testing.assert_allclose(got[0].numpy()[massless],
                               stats["pos_g"][massless].mean(axis=1))
    assert (got[3].numpy()[massless] > 0).all()
    assert (got[2].numpy()[massless] == 0).all()


def test_sorted_stats_park_padding_at_the_last_body():
    pos, mass = _scene(n=100)
    tpos, tmass = _t(pos), _t(mass)
    perm, _ = ttree.morton.morton_order(tpos)
    s = ttree.tree_sorted_stats(tpos, tmass, perm, 7, LEAF)
    js = jtree.tree_sorted_stats(jnp.asarray(pos), jnp.asarray(mass),
                                 jnp.asarray(perm.numpy()), 7, LEAF)
    assert s["pos_s"].shape == (7 * LEAF, 3)
    np.testing.assert_array_equal(s["pos_s"][100:].numpy(),
                                  np.broadcast_to(pos[perm[-1]], (5, 3)))
    assert float(s["mass_s"][100:].abs().max()) == 0.0
    for k, v in js.items():
        np.testing.assert_allclose(s[k].numpy(), np.asarray(v), rtol=1e-13,
                                   atol=1e-15, err_msg=k)
    c = ttree.cluster_ops.equal_clusters(100, LEAF, 7, device="cpu")
    cs = ttree.cluster_stats(tpos, tmass, perm, c)
    for k in ("com", "m_tot", "r_src", "r_tgt"):
        np.testing.assert_allclose(cs[k].numpy(), s[k].numpy(), rtol=1e-13,
                                   atol=1e-15, err_msg=k)


@pytest.mark.parametrize("theta,k_near", [(0.5, 40), (0.5, 8), (0.3, 300),
                                          (0.8, 137)])
def test_dense_near_lists_match_jax_as_sets(stats, theta, k_near):
    """k_near=8 overflows (nearest kept); k_near=300 takes the full-sort
    branch above k=256 after clamping to G inside `near_lists`."""
    args = ("com", "m_tot", "r_src", "r_tgt")
    idx, over = ttree.near_lists(*(_t(stats[k]) for k in args), theta,
                                 k_near)
    jidx, jover = jtree.near_lists(*(jnp.asarray(stats[k]) for k in args),
                                   theta, k_near)
    assert idx.shape == jidx.shape and idx.dtype == torch.int64
    assert int(over) == int(jover)
    assert _sets(idx, GG) == _sets(jidx, GG)
    massless = set(np.flatnonzero(stats["m_tot"] == 0))
    assert not massless & set().union(*_sets(idx, GG))


def test_smallest_k_full_sort_branch_matches_jax():
    rng = np.random.default_rng(3)
    masked = rng.uniform(size=(5, 400))
    masked[rng.uniform(size=masked.shape) < 0.4] = np.inf
    cand = rng.permutation(400)[None, :].repeat(5, 0)
    got = ttree._smallest_k(_t(masked), _t(cand), 300, 999)
    want = jtree._smallest_k(jnp.asarray(masked),
                             jnp.asarray(cand, jnp.int32), 300, 999)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_near,k_super", [(40, None), (200, 2)])
def test_hier_near_lists_match_jax_as_sets(stats, monkeypatch, k_near,
                                           k_super):
    """The two-level build, engaged in both packages by the cutoff. k_super=2
    truncates the screen (counted, scaled by SUPER), and k_near=200 (137
    after the clamp to G) then exceeds the candidate pool of 128."""
    monkeypatch.setattr(jtree, "HIER_NEAR_CUTOFF", 0)
    monkeypatch.setattr(ttree, "HIER_NEAR_CUTOFF", 0)
    args = ("com", "m_tot", "r_src", "r_tgt")
    idx, over = ttree.near_lists(*(_t(stats[k]) for k in args), 0.5, k_near,
                                 k_super=k_super)
    jidx, jover = jtree.near_lists(*(jnp.asarray(stats[k]) for k in args),
                                   0.5, k_near, k_super=k_super)
    assert idx.shape == jidx.shape
    assert int(over) == int(jover)
    assert _sets(idx, GG) == _sets(jidx, GG)
    if k_super is None:
        dense, _ = ttree._near_lists(*(_t(stats[k]) for k in args), 0.5,
                                     k_near)
        assert _sets(idx, GG) == _sets(dense, GG)


def test_super_screen_matches_jax(stats):
    args = ("com", "m_tot", "r_src", "r_tgt")
    idx2, over2 = ttree._super_screen(*(_t(stats[k]) for k in args), 0.5, 2)
    jidx2, jover2 = jtree._super_screen(
        *(jnp.asarray(stats[k]) for k in args), 0.5, 2)
    assert int(over2) == int(jover2)
    assert _sets(idx2, 3) == _sets(jidx2, 3)
    got = ttree._super_stats(_t(stats["com"]), _t(stats["r_src"]),
                             _t(stats["r_tgt"]))
    want = jtree._super_stats(*(jnp.asarray(stats[k]) for k in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)


def test_measure_near_integers_match_jax(theta=0.5, leaf=LEAF):
    pos, mass = _scene()
    gg = GG
    got = ttree.measure_near(_t(pos), _t(mass), theta=theta, gg=gg,
                             leaf=leaf, chunk=50)
    want = jtree.measure_near(jnp.asarray(pos), jnp.asarray(mass),
                              theta=theta, gg=gg, leaf=leaf,
                              measure_mid=False)
    assert got == want
    assert all(type(v) is int for v in got.values())
    wide = ttree.measure_near(_t(pos), _t(mass), theta=theta, gg=9)
    assert ttree.measure_k_near(_t(pos), _t(mass), theta=theta,
                                gg=9) == wide["k_near"]


@pytest.mark.parametrize("cap_d,cap_q", [(3 * GG, 3 * GG), (3 * GG, 100)])
def test_consistent_tile_lists_match_jax(jax_idx, cap_d, cap_q):
    """Equal near lists in, equal tile lists out, position by position,
    with and without a cap that drops whole targets from BOTH lists."""
    idx, _ = jax_idx
    pj = ttree.NEAR_TILE_J // (LEAF + 1)
    got = ttree.near_pair_segments_consistent(
        _t(idx).long(), GG, pj, cap_d, _t(idx).long(), GG, 16, cap_q)
    want = jtree.near_pair_segments_consistent(
        jnp.asarray(idx), GG, pj, cap_d, jnp.asarray(idx), GG, 16, cap_q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int(got[-1])
    assert (dropped > 0) == (min(cap_d, cap_q) == 100)
    # no force hole: the same clusters in both lists, target by target
    flat_d, tgt_d, nt_d, flat_q, tgt_q, nt_q, _ = (g.numpy() for g in got)
    for a in range(GG):
        in_d = set(flat_d.reshape(-1, pj)[tgt_d == a].ravel()) - {GG}
        in_q = set(flat_q.reshape(-1, 16)[tgt_q == a].ravel()) - {GG}
        assert in_d == in_q
    assert (tgt_d[:nt_d] < GG).all() and (tgt_d[nt_d:] == GG).all()
    assert (np.diff(tgt_d[:nt_d]) >= 0).all()


def test_pair_segments_with_interior_nulls_match_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 20, size=(20, 12))
    idx[rng.uniform(size=idx.shape) < 0.5] = 20
    idx[3] = 20  # a target with no near cluster still gets one tile
    got = ttree.near_pair_segments(_t(idx), 20, 4, 25)
    want = jtree.near_pair_segments(jnp.asarray(idx, jnp.int32), 20, 4, 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0  # the cap of 25 tiles drops entries, and counts them


@pytest.mark.parametrize("g_const", [1.0, 6.674e-11])
def test_summaries_and_source_table_match_jax(stats, g_const):
    names = ("pos_g", "mass_g", "com", "m_tot")
    got = ttree._cluster_summaries(*(_t(stats[k]) for k in names), g_const)
    want = jtree._cluster_summaries(*(jnp.asarray(stats[k]) for k in names),
                                    jnp.asarray(g_const))
    assert got.shape == (16, GG + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-30)
    assert float(got[:, GG].abs().max()) == 0.0
    # traceless
    np.testing.assert_allclose(got[4:7].sum(0).numpy(), 0.0,
                               atol=1e-12 * float(got[4:7].abs().max()))
    for pseudo in (True, False):
        rows = ttree._pack_augmented(*(_t(stats[k]) for k in names), g_const,
                                     monopole_pseudo=pseudo)
        jrows = jtree._pack_augmented(
            *(jnp.asarray(stats[k]) for k in names), jnp.asarray(g_const),
            monopole_pseudo=pseudo)
        assert rows.shape == (4, (GG + 1) * (LEAF + 1))
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows)[:4],
                                   rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def preps():
    pos, mass = _scene(n=1024)
    kw = dict(theta=0.5, k_near=24, gg=69, leaf=LEAF, near_mode="pairs")
    tp = ttree.tree_prep(_t(pos), _t(mass), **kw)
    jp = jtree.tree_prep(jnp.asarray(pos), jnp.asarray(mass), **kw)
    return tp, jp


def test_tree_prep_matches_jax(preps):
    """The whole of phase 1 in float64: the same permutation, the same
    statistics, the same near sets, the same overflow."""
    tp, jp = preps
    for k in ("perm", "inv"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    for k in ("pos_s", "mass_s", "pos_g", "mass_g", "com", "m_tot", "r_src",
              "r_tgt"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-13, atol=1e-15, err_msg=k)
    assert _sets(tp["idx"], 69) == _sets(jp["idx"], 69)
    for k in ("near_overflow", "near_ntiles", "nearq_ntiles"):
        assert int(tp[k]) == int(jp[k]), k
        assert tp[k].dim() == 0
    np.testing.assert_array_equal(tp["near_tile_tgt"].numpy(),
                                  np.asarray(jp["near_tile_tgt"]))
    np.testing.assert_array_equal(tp["nearq_tile_tgt"].numpy(),
                                  np.asarray(jp["nearq_tile_tgt"]))
    assert int(tp["near_overflow"]) > 0  # k_near=24 truncates the core's lists


def test_structure_keys_and_carry_over(preps):
    tp, jp = preps
    pos, mass = _scene()
    kw = dict(theta=0.5, k_near=40, gg=GG, leaf=LEAF, near_mode="pairs")
    s = ttree.tree_structure(_t(pos), _t(mass), **kw)
    assert set(s) == set(ttree.STRUCTURE_KEYS)
    assert set(ttree.STRUCTURE_KEYS) <= set(jtree.STRUCTURE_KEYS)
    js = {k: jp[k] for k in jtree.STRUCTURE_KEYS if k in jp}
    d = {k: (tuple(np.asarray(x) for x in v) if k == "clusters"
             else np.asarray(v)) for k, v in js.items()}
    carried = ttree.structure_from_numpy(d, device="cpu")
    assert set(carried) == set(ttree.STRUCTURE_KEYS)
    for k, v in carried.items():
        if k == "clusters":
            assert v.mask.dtype == torch.bool
            assert v.slot.dtype == torch.int64
            np.testing.assert_array_equal(v.slot.numpy(),
                                          np.asarray(jp["clusters"].slot))
        else:
            assert v.dtype == torch.int64, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(js[k]), k)


def test_tree_prep_rejects_what_is_not_ported():
    pos, mass = (_t(x) for x in _scene(n=200))
    kw = dict(theta=0.5, k_near=8, gg=14, leaf=LEAF)
    with pytest.raises(NotImplementedError, match="far_levels=3"):
        ttree.tree_prep(pos, mass, far_levels=3, **kw)
    with pytest.raises(NotImplementedError, match="adaptive clustering"):
        ttree.tree_prep(pos, mass, cluster_mode="adaptive", **kw)
    with pytest.raises(ValueError, match="cluster_mode"):
        ttree.tree_prep(pos, mass, cluster_mode="octree", **kw)
    with pytest.raises(ValueError, match="near_mode"):
        ttree.tree_prep(pos, mass, near_mode="list", **kw)
    with pytest.raises(ValueError, match="divide"):
        ttree.tree_prep(pos, mass, theta=0.5, k_near=8, gg=10, leaf=20,
                        near_mode="pairs")


@pytest.mark.parametrize("theta,n", [(0.3, 40), (0.5, 3922), (0.8, 2),
                                     (1.0, 10**6)])
def test_default_caps_match_jax(theta, n):
    assert ttree.default_k_near(theta, n) == jtree.default_k_near(theta, n)
    assert ttree.default_k_super(theta, n) == jtree.default_k_super(theta, n)


@pytest.mark.parametrize("n,far,order,leaf", [
    (10_000, "auto", 2, 255), (1_000_000, "auto", 2, 255),
    (1_044_480, "auto", 2, 255), (1_044_480, "auto", 1, 255),
    (1_044_480, 2, 2, 255), (2000, 3, 2, 31), (1, "auto", 1, 255)])
def test_gg_and_far_levels_match_jax(n, far, order, leaf):
    gg = ttree._gg_for(n, far, order, leaf)
    assert gg == jtree._gg_for(n, far, order, leaf)
    assert ttree.resolve_far_levels(far, gg, order) == \
        jtree.resolve_far_levels(far, gg, order)
    assert ttree._gg_for(n, far, order, leaf, "adaptive") == jtree._gg_for(
        n, far, order, leaf, "adaptive")


def test_constants_match_jax():
    for name in ("LEAF", "BLOCK", "SUPER", "NEAR_TILE_J", "NEAR_QUAD_PJ",
                 "HIER_NEAR_CUTOFF", "FAR3_CUTOFF"):
        assert getattr(ttree, name) == getattr(jtree, name), name
