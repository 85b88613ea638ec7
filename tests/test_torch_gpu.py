"""Card-only tests of the port's CUDA kernels. Each skips where there is no
CUDA card. This file imports neither JAX nor `spacetpu`, so it also runs on
a machine that has only PyTorch (`pair_hold` is tests/pair_hold.py, on the
path as pytest puts this file's directory there):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import spacetpu_torch
from spacetpu_torch import _build
from spacetpu_torch.models import presets
from spacetpu_torch.ops import cuda_direct, cuda_tree
from spacetpu_torch.ops import tree as tree_ops

import pair_hold

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bodies(n, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    return pos, mass


@pytest.mark.parametrize("method", ["vpu", "mxu"])
def test_kernel_matches_plain_in_float64(card, method):
    """float64, so only the order of the sums differs (1e-9 of max|a|);
    each call launches its kernel once."""
    pos, mass = _bodies(1000, seed=10, dtype=torch.float64, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    before = cuda_direct.LAUNCHES[f"direct_{method}"]
    got = cuda_direct.acc_cross_kernel(pos, pos, mass, method=method, **kw)
    assert cuda_direct.LAUNCHES[f"direct_{method}"] == before + 1
    if method == "mxu":
        want = cuda_direct.acc_cross_mxu_plain(pos, pos, mass, eps=1e-2,
                                               g=1.0)
    else:
        want = cuda_direct.acc_cross_plain(pos, pos, mass, **kw)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2), ("ref", 1e-2),
                                           ("plummer", 0.0), ("ref", 0.0)])
def test_vpu_float32_cross_ragged(card, softening, eps):
    """Ragged cross shapes in float32: within 1e-4 of max|a| of the plain
    version where softened, finite where not."""
    pos_i, _ = _bodies(333, seed=11, dtype=torch.float32, dev=card)
    pos_j, mass_j = _bodies(1001, seed=12, dtype=torch.float32, dev=card)
    kw = dict(softening=softening, eps=eps, g=1.0)
    got = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
    want = cuda_direct.acc_cross_plain(pos_i, pos_j, mass_j, **kw)
    assert got.shape == (333, 3)
    assert bool(torch.isfinite(got).all())
    if eps > 0:
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_mxu_float32_within_band_of_vpu(card):
    """The band of tests/test_pallas.py:66-79 on the card."""
    pos, mass = _bodies(4099, seed=4099, dtype=torch.float32, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    a_v = cuda_direct.acc_cross_kernel(pos, pos, mass, **kw)
    a_m = cuda_direct.acc_cross_kernel(pos, pos, mass, method="mxu", **kw)
    band = torch.linalg.norm(a_m - a_v, dim=1).max() / torch.linalg.norm(
        a_v, dim=1).max()
    assert float(band) < 2e-3


def test_cuda_tensors_never_take_the_plain_version(card):
    pos = torch.zeros(8, 3, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        cuda_direct.acc_cross_kernel(pos, pos, pos[:, 0])


def test_build_is_cached(card):
    lib = _build.library("direct")
    assert _build.library("direct") is lib
    assert _build.BUILD_INFO["direct"]["path"].endswith(".so")


def test_main_path_launches_kernel(card):
    n = 2048
    sim = spacetpu_torch.make_simulation(n, algorithm="direct",
                                         softening="plummer", eps=1e-2, g=1.0)
    assert sim.backend == "cuda"
    state = presets.random_cluster(n, seed=0).state()
    cuda_direct.LAUNCHES["direct_vpu"] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    assert cuda_direct.LAUNCHES["direct_vpu"] == 4
    assert state.pos.is_cuda and bool(torch.isfinite(state.pos).all())


# --- the tree's kernels ------------------------------------------------------


def _tree_prep(n, leaf, dtype, dev, theta=0.5):
    """A pair-list prep of a ragged cloud, built by the port on the card."""
    pos, mass = _bodies(n, seed=n, dtype=dtype, dev=dev)
    gg = -(-n // leaf)
    prep = tree_ops.tree_prep(pos, mass, theta=theta,
                              k_near=tree_ops.default_k_near(theta, gg),
                              gg=gg, leaf=leaf, near_mode="pairs")
    return prep, gg


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_quad_dense_matches_plain(card, dtype, tol):
    """Ragged M and S, and a column slice of a wider table. float64: only the
    order of the sums differs; float32: the band of tests/test_pallas.py:26."""
    prep, gg = _tree_prep(4099, 31, dtype, card)
    summ = tree_ops._cluster_summaries(prep["pos_g"], prep["mass_g"],
                                       prep["com"], prep["m_tot"], 1.0)
    tgt = prep["pos_s"][:1000]
    before = cuda_tree.LAUNCHES["quad_dense"]
    got = cuda_tree.acc_cross_quad(tgt, summ[:, :gg], eps=1e-2)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["quad_dense"] == before + 1
    want = cuda_tree.acc_cross_quad_plain(tgt, summ[:, :gg], eps=1e-2)
    assert got.shape == (1000, 3) and _rel(got, want) < tol


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2), ("ref", 1e-2),
                                           ("plummer", 0.0), ("ref", 0.0)])
def test_pairs_direct_matches_plain(card, softening, eps):
    prep, _ = _tree_prep(4099, 31, torch.float64, card)
    srows = tree_ops._pack_augmented(prep["pos_g"], prep["mass_g"],
                                     prep["com"], prep["m_tot"], 1.0)
    args = (prep["pos_g"], srows, prep["near_flat"], prep["near_tile_tgt"])
    before = cuda_tree.LAUNCHES["pairs_direct"]
    got = cuda_tree.near_pairs_direct(*args, softening=softening, eps=eps)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["pairs_direct"] == before + 1
    want = cuda_tree.near_pairs_direct_plain(*args, softening=softening,
                                             eps=eps)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < 1e-9


@pytest.mark.parametrize("leaf", [31, 255])
def test_pairs_quad_matches_plain(card, leaf):
    prep, _ = _tree_prep(20_000, leaf, torch.float64, card)
    summ = tree_ops._negated(tree_ops._cluster_summaries(
        prep["pos_g"], prep["mass_g"], prep["com"], prep["m_tot"], 1.0))
    args = (prep["pos_g"], summ, prep["nearq_flat"], prep["nearq_tile_tgt"])
    before = cuda_tree.LAUNCHES["pairs_quad"]
    got = cuda_tree.near_pairs_quad(*args, eps=1e-2)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["pairs_quad"] == before + 1
    want = cuda_tree.near_pairs_quad_plain(*args, eps=1e-2)
    assert _rel(got, want) < 1e-9


def test_tree_kernels_never_take_the_plain_version(card):
    prep, _ = _tree_prep(1000, 31, torch.float32, card)
    with pytest.raises(TypeError, match="dtype"):
        cuda_tree.acc_cross_quad(prep["pos_s"].half(),
                                 torch.zeros(16, 4, device=card).half(),
                                 eps=0.0)
    with pytest.raises(ValueError, match="share"):
        cuda_tree.near_pairs_quad(prep["pos_g"], torch.zeros(16, 34),
                                  prep["nearq_flat"], prep["nearq_tile_tgt"],
                                  eps=0.0)


#: the kernels of the mesh families and the hybrid sums, launched by none of
#: the tree's "vpu" paths
_NOT_TREE = {"pairs_hybrid": 0, "pairs_short": 0, "pairs_short_hybrid": 0}


@pytest.mark.parametrize("order,want", [
    (2, {"quad_dense": 4, "pairs_direct": 4, "pairs_quad": 4,
         "quad_masked": 0, "pairs_quad_shared": 0, **_NOT_TREE}),
    (1, {"quad_dense": 0, "pairs_direct": 4, "pairs_quad": 0,
         "quad_masked": 0, "pairs_quad_shared": 0, **_NOT_TREE})])
def test_tree_path_launches_kernels(card, order, want):
    """prime + 3 steps of the tree: one launch of each kernel of its order a
    force pass (order 1 takes its far field through `direct_vpu`), and a
    force within the tree's budget of the direct kernel's."""
    n = 20_000
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    sim = spacetpu_torch.make_simulation(n, algorithm="tree", theta=0.5,
                                         multipole_order=order,
                                         cluster_mode="equal", **kw)
    assert sim.backend == "cuda"
    state = presets.random_cluster(n, seed=0).state()
    for key in cuda_tree.LAUNCHES:
        cuda_tree.LAUNCHES[key] = 0
    cuda_direct.LAUNCHES["direct_vpu"] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES == want
    assert cuda_direct.LAUNCHES["direct_vpu"] == (4 if order == 1 else 0)
    assert sim.health(state)["near_overflow"] == 0
    exact = cuda_direct.acc_direct_kernel(state.pos, state.mass, **kw)
    err = torch.linalg.norm(state.acc - exact, dim=1) / torch.linalg.norm(
        exact, dim=1).mean()
    assert float(err.median()) < (5e-3 if order == 1 else 1e-3)


# --- the 3-level far field's kernels -----------------------------------------


def _far3_prep(dtype, dev, n=3833, leaf=15, gg=256):
    """A far3 pair-list prep (4 superclusters of 64 at leaf 15), built by
    the port on the card, and its cluster summaries. The scene (a dense
    core, a wide halo, a distant blob) has supers that are near each other
    and supers that are not, so every pass has work."""
    rng = np.random.default_rng(3)
    k = n // 3
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.3,
                          rng.normal(size=(k, 3)) * 2.0,
                          rng.normal(size=(n - 2 * k, 3)) * 0.5
                          + [25.0, 0.0, 0.0]])
    pos = torch.as_tensor(pos, dtype=dtype, device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=dtype, device=dev)
    prep = tree_ops.tree_prep(pos, mass, theta=0.5, k_near=64, gg=gg,
                              leaf=leaf, far_levels=3, near_mode="pairs")
    summ = tree_ops._cluster_summaries(prep["pos_g"], prep["mass_g"],
                                       prep["com"], prep["m_tot"], 1.0)
    return prep, summ


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_quad_masked_matches_plain(card, dtype, tol):
    """On the port's own supercluster near list, and with a list that masks
    every super (exactly 0) and none (quad_dense's result)."""
    prep, summ = _far3_prep(dtype, card)
    ss = tree_ops._super_multipoles(summ[:, :256])
    tgt = prep["pos_g"].reshape(-1, 3)
    before = cuda_tree.LAUNCHES["quad_masked"]
    got = cuda_tree.acc_cross_quad_masked(tgt, ss, prep["idx2"], eps=1e-2)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["quad_masked"] == before + 1
    want = cuda_tree.acc_cross_quad_masked_plain(tgt, ss, prep["idx2"],
                                                 eps=1e-2)
    assert _rel(got, want) < tol
    every = torch.arange(4, device=card).expand(4, 4).contiguous()
    zero = cuda_tree.acc_cross_quad_masked(tgt, ss, every, eps=1e-2)
    assert float(zero.abs().max()) == 0.0
    none = torch.full((4, 1), 4, device=card)
    dense = cuda_tree.acc_cross_quad_masked(tgt, ss, none, eps=1e-2)
    assert _rel(dense, cuda_tree.acc_cross_quad(tgt, ss, eps=1e-2)) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_pairs_quad_shared_matches_plain(card, dtype, tol):
    """The M1 (mid summaries, lists with interior nulls) and M2 (cluster
    summaries) passes of the port's own far3 prep."""
    prep, summ = _far3_prep(dtype, card)
    mid = tree_ops._super_multipoles(summ[:, :256], group=tree_ops.MID)
    mid = torch.cat([mid, mid.new_zeros((16, 1))], dim=1)
    for m, table in (("m1", mid), ("m2", summ)):
        args = (prep["pos_g"], table, prep[f"{m}_flat"], prep[f"{m}_tgt"],
                prep[f"{m}_src"])
        before = cuda_tree.LAUNCHES["pairs_quad_shared"]
        got = cuda_tree.near_pairs_quad_shared(*args, eps=1e-2)
        torch.cuda.synchronize()
        assert cuda_tree.LAUNCHES["pairs_quad_shared"] == before + 1
        want = cuda_tree.near_pairs_quad_shared_plain(*args, eps=1e-2)
        assert _rel(got, want) < tol, m


@pytest.mark.parametrize("cluster_mode", ["equal", "adaptive"])
def test_far3_path_launches_kernels(card, cluster_mode):
    """prime + 3 steps with far_levels=3: each force pass launches
    quad_masked once, pairs_direct once, pairs_quad once (the near
    subtraction) and pairs_quad_shared twice (M1, M2), and quad_dense never;
    the force stays within the tree's budget of the direct kernel's."""
    n = 20_000
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    sim = spacetpu_torch.make_simulation(n, algorithm="tree", theta=0.5,
                                         far_levels=3, leaf=31,
                                         cluster_mode=cluster_mode, **kw)
    state = presets.random_cluster(n, seed=0).state()
    for key in cuda_tree.LAUNCHES:
        cuda_tree.LAUNCHES[key] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES == {"quad_dense": 0, "pairs_direct": 4,
                                  "pairs_quad": 4, "quad_masked": 4,
                                  "pairs_quad_shared": 8, **_NOT_TREE}
    assert sim.caps["cluster_mode"] == cluster_mode
    assert sim.health(state)["near_overflow"] == 0
    exact = cuda_direct.acc_direct_kernel(state.pos, state.mass, **kw)
    err = torch.linalg.norm(state.acc - exact, dim=1) / torch.linalg.norm(
        exact, dim=1).mean()
    assert float(err.median()) < 1e-3


def test_default_simulation_at_four_million_uses_three_levels(card):
    """make_simulation(4_000_001) with every default (the tree, theta 0.3,
    plummer eps 0, the pair list, "auto" far levels and partition)
    calibrates and steps on the card with three far-field levels."""
    scene = presets.fixed_cloud(4_000_000)
    sim = spacetpu_torch.make_simulation(scene.n)
    assert sim._tree_params()["far_levels"] == 3
    state = sim.step(sim.prime(scene.state()), 1e-3)
    torch.cuda.synchronize()
    assert sim.caps["k_mid"] is not None
    assert sim.caps["cluster_mode"] in ("equal", "adaptive")
    assert sim._tree_params()["far_levels"] == 3
    assert bool(torch.isfinite(state.acc).all())


# --- the hybrid sums and the TreePM short-range kernels ----------------------


def _short_prep(dtype, dev):
    """A TreePM cutoff tile list of a ragged cloud, built on the card, with
    the two source tables (`pair_hold.short_inputs`)."""
    return pair_hold.short_inputs(4099, 31, 0.35, dtype, dev)


def _hold(name, got, want, args, kw):
    """float64: the same arithmetic in another order (1e-9 of max|a|).
    float32, softened or not: target by target within `pair_hold.F32_TOL`
    of the size of what float32 rounds, against the float64 sum; where
    softened and not hybrid also the band of tests/test_pallas.py:26 (2e-5
    of max|a|) against the float32 plain version."""
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), name
    if got.dtype == torch.float64:
        assert _rel(got, want) < 1e-9, name
        return
    held = pair_hold.hold(got, pair_hold.exact_sums(name, args, kw))
    assert held["ok"], (name, held)
    if kw["eps"] > 0.0 and not pair_hold.KERNELS[name][1]:
        assert _rel(got, want) < 2e-5, name


_CASES = [(dtype, law, eps) for dtype in (torch.float32, torch.float64)
          for law in ("plummer", "ref") for eps in (1e-2, 0.0)]


@pytest.mark.parametrize("dtype,softening,eps", _CASES)
def test_pairs_hybrid_matches_plain(card, dtype, softening, eps):
    prep, rows = _short_prep(dtype, card)
    args = (prep["pos_g"], rows[True], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps)
    before = cuda_tree.LAUNCHES["pairs_hybrid"]
    got = cuda_tree.near_pairs_hybrid(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_hybrid"] == before + 1
    _hold("pairs_hybrid", got, cuda_tree.near_pairs_hybrid_plain(*args, **kw),
          args, kw)


@pytest.mark.parametrize("split", ["poly", "gauss"])
@pytest.mark.parametrize("dtype,softening,eps", _CASES)
def test_pairs_short_matches_plain(card, dtype, softening, eps, split):
    prep, rows = _short_prep(dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps, rs=0.35 / 7.875, rcut=0.35,
              split=split)
    before = cuda_tree.LAUNCHES["pairs_short"]
    got = cuda_tree.near_pairs_short(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_short"] == before + 1
    _hold("pairs_short", got, cuda_tree.near_pairs_short_plain(*args, **kw),
          args, kw)


@pytest.mark.parametrize("split", ["poly", "gauss"])
@pytest.mark.parametrize("dtype,softening,eps", _CASES)
def test_pairs_short_hybrid_matches_plain(card, dtype, softening, eps,
                                          split):
    prep, rows = _short_prep(dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps, rs=0.35 / 7.875, rcut=0.35,
              split=split)
    before = cuda_tree.LAUNCHES["pairs_short_hybrid"]
    got = cuda_tree.near_pairs_short_hybrid(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_short_hybrid"] == before + 1
    _hold("pairs_short_hybrid", got,
          cuda_tree.near_pairs_short_hybrid_plain(*args, **kw), args, kw)


@pytest.mark.parametrize("algorithm,method,kernel", [
    ("tree", "mxu", "pairs_hybrid"), ("treepm", "vpu", "pairs_short"),
    ("treepm", "mxu", "pairs_short_hybrid")])
def test_mesh_and_hybrid_paths_launch_kernels(card, algorithm, method,
                                              kernel):
    """prime + 3 steps: each force pass launches the path's pair kernel once
    (and the tree its far-field kernels; TreePM no other tree kernel), the
    health is clean and the force stays within the JAX package's TreePM
    budget (tests/test_treepm.py:142, median 1.5e-2) or the tree's (1e-3)
    of the direct kernel's."""
    n = 20_000
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    sim = spacetpu_torch.make_simulation(n, algorithm=algorithm, theta=0.5,
                                         pallas_method=method, **kw)
    state = presets.random_cluster(n, seed=0).state()
    for key in cuda_tree.LAUNCHES:
        cuda_tree.LAUNCHES[key] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    want = dict.fromkeys(cuda_tree.LAUNCHES, 0)
    want[kernel] = 4
    if algorithm == "tree":
        want.update(quad_dense=4, pairs_quad=4)
    assert cuda_tree.LAUNCHES == want
    h = sim.health(state)
    assert h["near_overflow"] == 0 and h.get("out_of_box", 0) == 0
    exact = cuda_direct.acc_direct_kernel(state.pos, state.mass, **kw)
    err = torch.linalg.norm(state.acc - exact, dim=1) / torch.linalg.norm(
        exact, dim=1)
    assert float(err.median()) < (1e-3 if algorithm == "tree" else 1.5e-2)
