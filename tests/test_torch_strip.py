"""Strip mode (`near_mode="strip"`) of the port's tree through the kernel
wrappers of `spacetpu_torch.ops.cuda_tree` (`near_strip`, `quad_strip`,
`quad_refine`), which take their plain versions on CPU tensors, against
the JAX package's Pallas launch forms in interpret mode on the same numpy
inputs: `_near_correction_chunk`, `_near_multipole_sub_pallas` and
`_superfar_refine_pallas`; then the whole strip tree with `backend="cuda"`
against `spacetpu`'s with `backend="pallas"` (interpret mode), the
calibrated caps, and the wrappers' argument checks.

Tolerances, as a share of max|a|, in float64: the launch forms 1e-12 (the
same arithmetic, sums in another order); the whole tree 1e-9 (the far
field and the near correction cancel in part). The JAX package runs
jitted (`tests/parity.py`)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import cuda_tree
from spacetpu_torch.ops import tree as ttree
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

LEAF, BLOCK = 15, 16


def _t(x):
    return torch.from_numpy(np.array(x))


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
def pool():
    """Six target clusters against a pool of ten other source clusters
    (the sharded tree's pool contract), lists of 128 slots whose tails are
    null (the pool size) and one list all null."""
    rng = np.random.default_rng(5)
    p, g_t, k = 10, 6, 128
    pos_t = rng.normal(size=(g_t, LEAF, 3))
    pos = rng.normal(size=(p, LEAF, 3)) * 1.5 + 0.3
    mass = rng.uniform(0.1, 1.0, size=(p, LEAF))
    com = (pos * mass[..., None]).sum(1) / mass.sum(1)[:, None]
    idx = rng.integers(0, p, size=(g_t, k))
    idx[:, 40:] = p
    idx[2] = p
    return dict(pos_t=pos_t, pos=pos, mass=mass, com=com, m_tot=mass.sum(1),
                idx=idx)


@pytest.mark.parametrize("softening,pseudo", [("plummer", True),
                                              ("ref", True),
                                              ("plummer", False)])
def test_near_correction_chunk_matches_near_strip(pool, softening, pseudo):
    """`_near_correction_chunk` (the `_kernel` launch over gathered strips)
    against `near_strip` on the same pool and lists."""
    stats = [pool[k] for k in ("pos", "mass", "com", "m_tot")]
    srows = parity.call(jtree._pack_augmented, *stats, 0.7,
                        monopole_pseudo=pseudo)
    tcols = parity.call(jtree._pack_targets, pool["pos_t"])
    want = parity.call(jtree._near_correction_chunk, tcols, srows,
                       pool["idx"].astype(np.int32), softening=softening,
                       eps=1e-2, interpret=True, block=BLOCK)
    got = cuda_tree.near_strip(_t(pool["pos_t"]), _t(pool["idx"]),
                               *map(_t, stats), softening=softening,
                               eps=1e-2, g=0.7, monopole_pseudo=pseudo)
    _close(got, want, 1e-12)
    assert float(got[2].abs().max()) == 0.0  # the empty list adds nothing


def test_near_multipole_sub_pallas_matches_quad_strip(pool):
    """`_near_multipole_sub_pallas` (K padded to 128 with the null column)
    against `quad_strip` on the negated summaries of the pool."""
    stats = [pool[k] for k in ("pos", "mass", "com", "m_tot")]
    summ = np.asarray(parity.call(jtree._cluster_summaries, *stats, 0.7))
    neg = summ.copy()
    neg[3:10] *= -1.0
    idx = pool["idx"][:, :50]
    tcols = parity.call(jtree._pack_targets, pool["pos_t"])
    want = parity.call(jtree._near_multipole_sub_pallas, tcols, neg,
                       idx.astype(np.int32), eps=1e-2, interpret=True,
                       block=BLOCK)
    got = cuda_tree.quad_strip(_t(pool["pos_t"]), _t(neg), _t(idx),
                               eps=1e-2)
    _close(got, want, 1e-12)


def test_superfar_refine_pallas_matches_quad_refine(monkeypatch):
    """tests/test_tree.py:431 on the port: the 3-D launch with SUPER
    patched to 8 and strips of two 512-column tiles, half of each strip
    null, so that clusters past the first of their super and tiles past the
    first both count."""
    monkeypatch.setattr(jtree, "SUPER", 8)
    rng = np.random.default_rng(21)
    g2, group = 2, 8
    gg = g2 * group
    s_pad = 2 * jtree._SUPERFAR_TILE_J
    pos_g = rng.normal(size=(gg, LEAF, 3))
    strips = np.zeros((16, g2 * s_pad))
    live = s_pad // 2 + 37  # into the second tile
    for a2 in range(g2):
        lo = a2 * s_pad
        strips[0:3, lo:lo + live] = rng.normal(size=(3, live)) * 4.0
        strips[3, lo:lo + live] = rng.uniform(0.5, 1.5, size=live)
        strips[4:10, lo:lo + live] = rng.normal(size=(6, live)) * 0.1
    want = jtree._superfar_refine_pallas(
        jtree._pack_targets(jnp.asarray(pos_g)), jnp.asarray(strips),
        eps=0.05, interpret=True, block=BLOCK)
    got = cuda_tree.quad_refine(_t(pos_g), _t(strips), eps=0.05, group=group)
    _close(got, want, 1e-12)


def _scene(n, seed=0):
    """A dense core, a wide halo and a distant blob (tests/test_torch_far3.py):
    some supers are near each other and some are not."""
    rng = np.random.default_rng(seed)
    k = n // 3
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.3,
                          rng.normal(size=(k, 3)) * 2.0,
                          rng.normal(size=(n - 2 * k, 3)) * 0.5
                          + [25.0, 0.0, 0.0]])
    return pos, rng.uniform(0.1, 1.0, n)


@pytest.mark.parametrize("order,softening,far_levels", [
    (1, "plummer", 2), (1, "ref", 2), (2, "plummer", 2), (2, "plummer", 3)])
def test_strip_tree_matches_jax_pallas(order, softening, far_levels):
    """The whole strip tree on the JAX package's structure (256 clusters of
    15, 4 supers), at moved positions: `acc_tree_cached` with
    backend="cuda" against the JAX package's with backend="pallas" in
    interpret mode, every strip launch (and at three levels the masked
    dense pass and the refinement strips) included."""
    pos, mass = _scene(256 * LEAF - 7)
    jp = parity.call(jtree.tree_prep, pos, mass, theta=0.5, k_near=40,
                     gg=256, leaf=LEAF, far_levels=far_levels,
                     near_mode="strip")
    js = {k: jp[k] for k in jtree.STRUCTURE_KEYS if k in jp}
    d = {k: (tuple(np.asarray(x) for x in v) if k == "clusters"
             else np.asarray(v)) for k, v in js.items()}
    moved = pos + np.random.default_rng(9).normal(size=pos.shape) * 1e-3
    kw = dict(softening=softening, eps=1e-2, g=0.7, multipole_order=order,
              far_levels=far_levels, near_mode="strip")
    want = parity.call(jtree.acc_tree_cached, moved, mass, js,
                       backend="pallas", interpret=True, **kw)
    before = dict(cuda_tree.LAUNCHES)
    got = ttree.acc_tree_cached(
        _t(moved), _t(mass), ttree.structure_from_numpy(d, device="cpu"),
        backend="cuda", **kw)
    assert cuda_tree.LAUNCHES == before  # CPU tensors: the plain versions
    _close(got, want, 1e-9)


@pytest.mark.parametrize("far_levels", [2, 3])
def test_strip_calibration_caps_match_jax(far_levels):
    """make_simulation(near_mode="strip", k_near="auto") on the kernel
    backend: the port's calibrated caps equal `spacetpu`'s with
    backend="pallas", and leave no near list over its cap (the force is
    held in test_strip_tree_matches_jax_pallas)."""
    pos, mass = _scene(64 * 31 - 5, seed=2)
    kw = dict(algorithm="tree", leaf=31, theta=0.5, k_near="auto",
              near_mode="strip", far_levels=far_levels, softening="plummer",
              eps=1e-2, g=1.0, cluster_mode="equal")
    state = spacetpu_torch.make_state(_t(pos), torch.zeros_like(_t(pos)),
                                      _t(mass), dtype=torch.float64,
                                      device="cpu")
    sim = spacetpu_torch.make_simulation(state.n, backend="cuda",
                                         device="cpu", **kw)
    jstate = spacetpu.make_state(pos, np.zeros_like(pos), mass,
                                 dtype=jnp.float64)
    jsim = spacetpu.make_simulation(state.n, backend="pallas", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = sim.prime(state)
        jsim.calibrate(jstate)
    assert sim.caps == jsim.caps and sim.caps["k_near"] > 0
    assert sim.health(state)["near_overflow"] == 0
    assert bool(torch.isfinite(state.acc).all())


def test_strip_wrappers_check_their_arguments(pool):
    pos_t = _t(pool["pos_t"])
    stats = [_t(pool[k]) for k in ("pos", "mass", "com", "m_tot")]
    idx = _t(pool["idx"])
    kw = dict(softening="plummer", eps=1e-2, g=1.0, monopole_pseudo=True)
    with pytest.raises(IndexError, match="outside"):
        cuda_tree.near_strip(pos_t, idx + 1, *stats, **kw)
    with pytest.raises(IndexError, match="outside"):
        cuda_tree.near_strip(pos_t, idx - 1, *stats, **kw)
    with pytest.raises(TypeError, match="int64"):
        cuda_tree.near_strip(pos_t, idx.int(), *stats, **kw)
    with pytest.raises(ValueError, match="rows"):
        cuda_tree.near_strip(pos_t, idx[:3], *stats, **kw)
    with pytest.raises(ValueError, match="pool_mass_g"):
        cuda_tree.near_strip(pos_t, idx, stats[0], stats[1][:, :3],
                             *stats[2:], **kw)
    with pytest.raises(ValueError, match="dtype"):
        cuda_tree.near_strip(pos_t, idx, stats[0].float(), *stats[1:], **kw)
    with pytest.raises(ValueError, match="softening"):
        cuda_tree.near_strip(pos_t, idx, *stats, **dict(kw, softening="x"))
    summ = ttree._cluster_summaries(*stats, 1.0)
    with pytest.raises(IndexError, match="outside"):
        cuda_tree.quad_strip(pos_t, summ, idx + 1, eps=1e-2)
    with pytest.raises(ValueError, match=r">= 10"):
        cuda_tree.quad_strip(pos_t, summ[:4], idx, eps=1e-2)
    empty = cuda_tree.near_strip(pos_t, idx[:, :0], *stats, **kw)
    assert empty.shape == pos_t.shape and float(empty.abs().max()) == 0.0
    strips = torch.zeros((16, 2 * 512), dtype=torch.float64)
    with pytest.raises(ValueError, match="supers"):
        cuda_tree.quad_refine(pos_t, strips, eps=1e-2, group=4)
    with pytest.raises(ValueError, match="strip of equal width"):
        cuda_tree.quad_refine(pos_t, strips[:, :1001], eps=1e-2, group=3)
    assert float(cuda_tree.quad_refine(pos_t, strips, eps=1e-2,
                                       group=3).abs().max()) == 0.0
