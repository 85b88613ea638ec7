"""The evaluation half of the port's tree (`spacetpu_torch.ops.tree`,
`.cuda_tree`) against `spacetpu.ops.tree` on the same numpy inputs: each
kernel's plain version against its JAX twin, then `acc_tree` and
`acc_tree_cached` as a whole.

Tolerances. float64: both sides do the same arithmetic and differ in the
order of their sums, so pieces agree to 1e-12 of max|a|; the whole tree
adds the far field and the near correction, which cancel in part, so it is
held to 1e-9 of max|a|. float32: 2e-5 of max|a|, the band of
tests/test_pallas.py:26. JAX runs jitted (`tests/parity.py`); the 3-level
far field is in test_torch_far3.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import pallas_direct as jpallas
from spacetpu.ops import tree as jtree
from spacetpu_torch.models import presets
from spacetpu_torch.ops import cuda_tree, direct
from spacetpu_torch.ops import tree as ttree
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

N, LEAF, THETA, K_NEAR = 1024, 15, 0.5, 24
GG = -(-N // LEAF)
PREP = dict(theta=THETA, k_near=K_NEAR, gg=GG, leaf=LEAF, near_mode="pairs")


def _scene(n=N, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(size=(n // 2, 3)) * 0.3,
                          rng.normal(size=(n - n // 2, 3)) * 2.0]) + 1.0
    return pos, rng.uniform(0.1, 1.0, n)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def world():
    """One scene, the JAX package's prep of it, and that prep carried over
    to the port: both evaluation halves then see the same structure."""
    pos, mass = _scene()
    jp = parity.call(jtree.tree_prep, pos, mass, **PREP)
    js = {k: jp[k] for k in jtree.STRUCTURE_KEYS if k in jp}
    d = {k: (tuple(np.asarray(x) for x in v) if k == "clusters"
             else np.asarray(v)) for k, v in js.items()}
    ts = ttree.structure_from_numpy(d, device="cpu")
    tp = dict(ts, **ttree.cluster_stats(_t(pos), _t(mass), ts["perm"],
                                        ts["clusters"]))
    return dict(pos=pos, mass=mass, jp=jp, js=js, ts=ts, tp=tp)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-5)])
def test_quad_plain_matches_jax(world, dtype, tol):
    """`acc_cross_quad_plain` against `acc_cross_quad_xla`, and in float32
    against the Pallas kernel in interpret mode."""
    jp = world["jp"]
    summ = np.asarray(parity.call(
        jtree._cluster_summaries, jp["pos_g"], jp["mass_g"], jp["com"],
        jp["m_tot"], 1.0)).astype(dtype)
    tgt = world["pos"][:300].astype(dtype)
    got = cuda_tree.acc_cross_quad_plain(_t(tgt), _t(summ), eps=1e-2)
    want = parity.call(jpallas.acc_cross_quad_xla, tgt, summ, eps=1e-2)
    _close(got, want, tol)
    if dtype == np.float32:
        kern = parity.call(jpallas.acc_cross_quad, tgt, summ, eps=1e-2,
                           interpret=True)
        _close(got, kern, tol)
    # the wrapper on CPU tensors is the plain version, a column slice too
    before = dict(cuda_tree.LAUNCHES)
    sliced = cuda_tree.acc_cross_quad(_t(tgt), _t(summ)[:, :GG], eps=1e-2)
    assert cuda_tree.LAUNCHES == before
    _close(sliced, got, 1e-15 if dtype == np.float64 else 1e-7)


def test_quad_term_masks_coincidence_and_stays_finite():
    """A target on a cluster's centre adds 0 (d2 <= 1e-18), and a close pair
    (d ~ 1e-7) stays finite in float32: inv^4, never inv^7."""
    summ = torch.zeros(16, 2, dtype=torch.float32)
    summ[3] = 1.0
    summ[4:10] = 0.3
    tgt = torch.tensor([[0.0, 0.0, 0.0], [1e-7, 0.0, 0.0]])
    got = cuda_tree.acc_cross_quad_plain(tgt, summ, eps=0.0)
    assert float(got[0].abs().max()) == 0.0
    assert bool(torch.isfinite(got).all()) and float(got[1].abs().max()) > 0
    want = parity.call(jpallas.acc_cross_quad_xla, tgt.numpy(),
                       summ.numpy(), eps=0.0)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("softening,eps,pseudo", [
    ("plummer", 1e-2, True), ("plummer", 0.0, False), ("ref", 1e-2, True),
    ("ref", 0.0, True)])
def test_pairs_direct_plain_matches_jax(world, softening, eps, pseudo):
    """`near_pairs_direct_plain` (and the wrapper on CPU tensors) against
    `_near_pairs_direct_xla` on the JAX package's own tile list."""
    jp, tp = world["jp"], world["tp"]
    g = 0.7
    aug_pos = jnp.concatenate([jp["pos_g"], jp["com"][:, None, :]], axis=1)
    pseudo_gm = (-jp["m_tot"][:, None] * g if pseudo
                 else jnp.zeros((GG, 1)))
    aug_gm = jnp.concatenate([jp["mass_g"] * g, pseudo_gm], axis=1)
    want = parity.call(jtree._near_pairs_direct_xla, jp["pos_g"], aug_pos,
                       aug_gm, jp["near_flat"], jp["near_tile_tgt"],
                       softening=softening, eps=eps)
    srows = ttree._pack_augmented(tp["pos_g"], tp["mass_g"], tp["com"],
                                  tp["m_tot"], g, monopole_pseudo=pseudo)
    got = cuda_tree.near_pairs_direct_plain(
        tp["pos_g"], srows, tp["near_flat"], tp["near_tile_tgt"],
        softening=softening, eps=eps)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-12)
    before = dict(cuda_tree.LAUNCHES)
    via = cuda_tree.near_pairs_direct(
        tp["pos_g"], srows, tp["near_flat"], tp["near_tile_tgt"],
        softening=softening, eps=eps)
    assert cuda_tree.LAUNCHES == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_pairs_quad_plain_matches_jax(world):
    jp, tp = world["jp"], world["tp"]
    jsumm = jtree._cluster_summaries(jp["pos_g"], jp["mass_g"], jp["com"],
                                     jp["m_tot"], jnp.asarray(0.7))
    want = parity.call(jtree._near_pairs_quad_xla, jp["pos_g"],
                       jsumm.at[3:10].multiply(-1.0), jp["nearq_flat"],
                       jp["nearq_tile_tgt"], eps=1e-2)
    summ = ttree._cluster_summaries(tp["pos_g"], tp["mass_g"], tp["com"],
                                    tp["m_tot"], 0.7)
    neg = ttree._negated(summ)
    torch.testing.assert_close(neg[3:10], -summ[3:10], rtol=0, atol=0)
    torch.testing.assert_close(neg[:3], summ[:3], rtol=0, atol=0)
    got = cuda_tree.near_pairs_quad(tp["pos_g"], neg, tp["nearq_flat"],
                                    tp["nearq_tile_tgt"], eps=1e-2)
    assert got.shape == (GG * LEAF, 3)
    _close(got, want, 1e-12)


def test_tile_starts_mark_each_targets_contiguous_range(world):
    tp = world["tp"]
    for flat, tgt, nt in (("near_flat", "near_tile_tgt", "near_ntiles"),
                          ("nearq_flat", "nearq_tile_tgt", "nearq_ntiles")):
        starts = cuda_tree.tile_starts(tp[tgt], GG).numpy()
        tile_tgt = tp[tgt].numpy()
        assert starts[0] == 0 and starts[GG] == int(tp[nt])
        assert (np.diff(starts) >= 1).all()  # every target owns a tile
        for a in (0, 1, GG // 2, GG - 1):
            assert (tile_tgt[starts[a]:starts[a + 1]] == a).all()
        assert tp[flat].shape[0] % tile_tgt.shape[0] == 0


@pytest.mark.parametrize("softening", ["plummer", "ref"])
def test_strip_plain_matches_jax(world, softening):
    """The strip-mode near correction and multipole subtraction against the
    JAX package's `_xla` forms, on its own near lists."""
    jp, tp = world["jp"], world["tp"]
    aug_pos = jnp.concatenate([jp["pos_g"], jp["com"][:, None, :]], axis=1)
    aug_gm = jnp.concatenate([jp["mass_g"], -jp["m_tot"][:, None]], axis=1)
    want = parity.call(jtree._near_correction_xla, jp["pos_g"], aug_pos,
                       aug_gm, jp["idx"], softening=softening, eps=1e-2)
    got = ttree.near_direct_correction(
        tp["pos_g"], tp["idx"], tp["pos_g"], tp["mass_g"], tp["com"],
        tp["m_tot"], softening=softening, eps=1e-2, g=1.0, backend="torch",
        monopole_pseudo=True)
    _close(got, np.asarray(want).reshape(-1, 3), 1e-12)
    if softening == "plummer":
        jsumm = jtree._cluster_summaries(jp["pos_g"], jp["mass_g"],
                                         jp["com"], jp["m_tot"],
                                         jnp.asarray(1.0))
        want = parity.call(jtree._near_multipole_sub_xla, jp["pos_g"],
                           jsumm.at[3:10].multiply(-1.0), jp["idx"],
                           eps=1e-2)
        summ = ttree._cluster_summaries(tp["pos_g"], tp["mass_g"], tp["com"],
                                        tp["m_tot"], 1.0)
        got = ttree.near_multipole_subtraction(tp["pos_g"], summ, tp["idx"],
                                               eps=1e-2, backend="torch")
        _close(got, want, 1e-12)


@pytest.mark.parametrize("order,softening,near_mode", [
    (1, "plummer", "strip"), (2, "plummer", "strip"), (1, "ref", "strip"),
    (2, "plummer", "pairs"), (1, "ref", "pairs")])
def test_acc_tree_matches_jax(world, order, softening, near_mode):
    """The whole tree in float64, sort and near lists included: 1e-9 of
    max|a| (the far field and the near correction cancel in part, so the
    sum is held looser than its pieces)."""
    pos, mass = world["pos"], world["mass"]
    kw = dict(theta=THETA, softening=softening, eps=1e-2, g=0.7,
              k_near=K_NEAR, multipole_order=order, leaf=LEAF,
              near_mode=near_mode)
    got = ttree.acc_tree(_t(pos), _t(mass), backend="cuda", **kw) \
        if near_mode == "pairs" else ttree.acc_tree(
            _t(pos), _t(mass), backend="torch", **kw)
    want = parity.call(jtree.acc_tree, pos, mass, backend="xla", **kw)
    _close(got, want, 1e-9)


def test_quadrupoles_beat_monopoles(world):
    """With near lists that do not overflow, the tree is within its theta
    budget of the exact force, and order 2 at least 3x closer than order 1
    (tests/test_quadrupole.py:70)."""
    pos, mass = _t(world["pos"]), _t(world["mass"])
    exact = direct.acc_direct(pos, mass, softening="plummer", eps=1e-2, g=1.0)
    scale = torch.linalg.norm(exact, dim=1).mean()
    err = {}
    for order in (1, 2):
        got = ttree.acc_tree(pos, mass, theta=THETA, softening="plummer",
                             eps=1e-2, g=1.0, k_near=GG, leaf=LEAF,
                             multipole_order=order, backend="torch")
        err[order] = float((torch.linalg.norm(got - exact, dim=1)
                            / scale).median())
    assert err[1] < 5e-3 and err[2] < err[1] / 3, err


def test_pairs_and_strip_agree_and_backends_agree(world):
    """Pair list and strips are two walks over the same near sets, and on
    CPU tensors backend="cuda" reaches each kernel's plain version."""
    pos, mass = _t(world["pos"]), _t(world["mass"])
    kw = dict(theta=THETA, softening="plummer", eps=1e-2, g=1.0,
              k_near=K_NEAR, multipole_order=2, leaf=LEAF)
    strip = ttree.acc_tree(pos, mass, backend="torch", near_mode="strip",
                           **kw)
    pairs = ttree.acc_tree(pos, mass, backend="torch", near_mode="pairs",
                           **kw)
    via = ttree.acc_tree(pos, mass, backend="cuda", near_mode="pairs", **kw)
    _close(pairs, strip, 1e-12)
    torch.testing.assert_close(via, pairs, rtol=0, atol=0)


@pytest.mark.parametrize("order,near_mode", [(2, "pairs"), (1, "strip")])
def test_acc_tree_cached_from_a_carried_structure(world, order, near_mode):
    """Both `acc_tree_cached`s on the JAX package's structure, at moved
    positions: the evaluation half alone, free of sort ties."""
    rng = np.random.default_rng(9)
    pos = world["pos"] + rng.normal(size=world["pos"].shape) * 1e-3
    kw = dict(softening="plummer", eps=1e-2, g=0.7, multipole_order=order,
              near_mode=near_mode)
    want = parity.call(jtree.acc_tree_cached, pos, world["mass"],
                       world["js"], backend="xla", **kw)
    got = ttree.acc_tree_cached(_t(pos), _t(world["mass"]), world["ts"],
                                backend="torch", **kw)
    _close(got, want, 1e-12)


def test_acc_tree_float32_holds_the_force(world):
    """In float32 a body on a cell boundary may sort into another cluster
    than in float64 (or than in the JAX package), so the force is held, not
    the permutation: within the float32 band of the float64 tree on nearly
    all bodies, and as close to the exact force."""
    kw = dict(theta=THETA, softening="plummer", eps=1e-2, g=1.0,
              k_near=K_NEAR, multipole_order=2, leaf=LEAF, backend="torch")
    pos, mass = _t(world["pos"]), _t(world["mass"])
    want = ttree.acc_tree(pos, mass, **kw)
    got = ttree.acc_tree(pos.float(), mass.float(), **kw)
    assert got.dtype == torch.float32
    off = (got.double() - want).abs().amax(dim=1) / want.abs().max()
    assert float((off < 2e-5).double().mean()) > 0.98
    exact = direct.acc_direct(pos, mass, softening="plummer", eps=1e-2,
                              g=1.0)
    norm = torch.linalg.norm(exact, dim=1).mean()
    err32 = torch.linalg.norm(got.double() - exact, dim=1).median() / norm
    err64 = torch.linalg.norm(want - exact, dim=1).median() / norm
    assert float(err32) < 1.2 * float(err64) + 1e-6


@pytest.mark.parametrize("near_mode,backend", [("strip", "torch"),
                                               ("pairs", "cuda"),
                                               ("strip", "cuda")])
def test_massless_clusters_offset_system(near_mode, backend):
    """tests/test_tree.py:125 on the port: a system far from the origin with
    whole clusters of massless tracers, which must keep meaningful
    centroids so that massless targets still get near corrections."""
    rng = np.random.default_rng(8)
    center = np.array([50.0, 50.0, 50.0])
    massive = center + rng.uniform(-0.5, 0.5, (300, 3))
    tracers = center + rng.normal(size=(1200, 3)) * 1.2
    pos = _t(np.concatenate([massive, tracers]))
    mass = _t(np.concatenate([np.full(300, 1.0 / 300), np.zeros(1200)]))
    exact = direct.acc_direct(pos, mass, softening="plummer", eps=1e-2,
                              g=1.0)
    got = ttree.acc_tree(pos, mass, theta=0.3, softening="plummer", eps=1e-2,
                         g=1.0, backend=backend, leaf=31,
                         near_mode=near_mode)
    scale = torch.linalg.norm(exact[300:], dim=1).mean()
    err = torch.linalg.norm(got[300:] - exact[300:], dim=1) / scale
    assert float(err.median()) < 2e-3
    assert float(torch.quantile(err, 0.99)) < 5e-2
    all_massless = ttree.acc_tree(pos, torch.zeros_like(mass), theta=0.5,
                                  softening="plummer", eps=1e-3, g=1.0,
                                  backend=backend, leaf=31,
                                  near_mode=near_mode)
    assert float(all_massless.abs().max()) == 0.0


@pytest.mark.parametrize("near_mode,backend", [("strip", "torch"),
                                               ("pairs", "cuda"),
                                               ("strip", "cuda")])
def test_order2_grid_coincidence_float32_is_finite(near_mode, backend):
    """tests/test_quadrupole.py:89 on the port: on a regular grid a cluster's
    centre can coincide with a body; unsoftened float32 must stay finite,
    which needs the same mask in the far field and the near subtraction."""
    scene = presets.fixed_cloud(2000)
    got = ttree.acc_tree(_t(scene.pos, torch.float32),
                         _t(scene.mass, torch.float32), theta=0.3,
                         softening="plummer", eps=0.0, g=float(scene.g),
                         backend=backend, multipole_order=2, leaf=31,
                         near_mode=near_mode)
    assert bool(torch.isfinite(got).all())


def test_tree_eval_rejects_what_is_not_ported(world):
    tp = world["tp"]
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    # strip mode on the kernel backend, which the port used to refuse: the
    # wrappers (here on CPU tensors) give the plain path's result
    strip = ttree.tree_eval(tp, 0, GG, backend="cuda", near_mode="strip",
                            **kw)
    torch.testing.assert_close(
        strip, ttree.tree_eval(tp, 0, GG, backend="torch", near_mode="strip",
                               **kw), rtol=0, atol=0)
    # the hybrid accumulation runs: pairs_accum="mxu" gives the direct
    # sums' force up to the rank-1 algebra, and an unknown name is refused
    hyb = ttree.tree_eval(tp, 0, GG, backend="cuda", near_mode="pairs",
                          pairs_accum="mxu", **kw)
    vpu = ttree.tree_eval(tp, 0, GG, backend="cuda", near_mode="pairs", **kw)
    torch.testing.assert_close(hyb, vpu, rtol=0,
                               atol=1e-10 * float(vpu.abs().max()))
    with pytest.raises(ValueError, match="pairs_accum"):
        ttree.tree_eval(tp, 0, GG, backend="cuda", near_mode="pairs",
                        pairs_accum="tensor", **kw)
    with pytest.raises(ValueError, match="SUPER-aligned"):
        ttree.tree_eval(tp, 0, GG, backend="torch", multipole_order=2,
                        far_levels=3, **kw)
    summ = ttree._cluster_summaries(tp["pos_g"], tp["mass_g"], tp["com"],
                                    tp["m_tot"], 1.0)
    sub = {b: ttree.near_multipole_subtraction(tp["pos_g"], summ, tp["idx"],
                                               eps=1e-2, backend=b)
           for b in ("cuda", "torch")}
    torch.testing.assert_close(sub["cuda"], sub["torch"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires multipole_order=2"):
        ttree.acc_tree(torch.zeros(8, 3), torch.ones(8), far_levels=3)
    with pytest.raises(ValueError, match="cluster_mode"):
        ttree.acc_tree(torch.zeros(8, 3), torch.ones(8),
                       cluster_mode="octree")
    with pytest.raises(ValueError, match="plummer"):
        ttree.tree_eval(tp, 0, GG, backend="torch", multipole_order=2,
                        softening="ref", eps=1e-2, g=1.0)
    with pytest.raises(ValueError, match="full target range"):
        ttree.tree_eval(tp, 1, GG - 1, backend="torch", near_mode="pairs",
                        **kw)
    with pytest.raises(ValueError, match="backend"):
        ttree.tree_eval(tp, 0, GG, backend="pallas", **kw)
    # a slice of target clusters is fine in strip mode
    part = ttree.tree_eval(tp, 3, 5, backend="torch", **kw)
    full = ttree.tree_eval(tp, 0, GG, backend="torch", **kw)
    torch.testing.assert_close(part, full[3 * LEAF:8 * LEAF], rtol=1e-12,
                               atol=0)


def test_wrappers_check_their_arguments(world):
    tp = world["tp"]
    srows = ttree._pack_augmented(tp["pos_g"], tp["mass_g"], tp["com"],
                                  tp["m_tot"], 1.0)
    args = (tp["pos_g"], srows, tp["near_flat"], tp["near_tile_tgt"])
    kw = dict(softening="plummer", eps=1e-2)
    with pytest.raises(TypeError, match="dtype"):
        cuda_tree.near_pairs_direct(tp["pos_g"].half(), *args[1:], **kw)
    with pytest.raises(ValueError, match="share"):
        cuda_tree.near_pairs_direct(args[0], srows.float(), *args[2:], **kw)
    with pytest.raises(TypeError, match="int64"):
        cuda_tree.near_pairs_direct(*args[:2], tp["near_flat"].int(),
                                    args[3], **kw)
    with pytest.raises(ValueError, match="whole number"):
        cuda_tree.near_pairs_direct(*args[:2], tp["near_flat"][:-1], args[3],
                                    **kw)
    with pytest.raises(ValueError, match="clusters"):
        cuda_tree.near_pairs_direct(args[0], srows[:, :-1], *args[2:], **kw)
    with pytest.raises(ValueError, match="softening"):
        cuda_tree.near_pairs_direct(*args, softening="newton", eps=0.0)
    with pytest.raises(ValueError, match="unit column stride"):
        cuda_tree.acc_cross_quad(
            tp["pos_s"], torch.zeros(40, 16, dtype=torch.float64).T,
            eps=1e-2)
    with pytest.raises(ValueError, match=r"\(M, 3\)"):
        cuda_tree.acc_cross_quad(
            tp["pos_g"], torch.zeros(16, 4, dtype=torch.float64), eps=1e-2)
    with pytest.raises(ValueError, match=r"\(G, leaf, 3\)"):
        cuda_tree.near_pairs_quad(
            tp["pos_s"], torch.zeros(16, GG + 1, dtype=torch.float64),
            tp["nearq_flat"], tp["nearq_tile_tgt"], eps=1e-2)
