"""Card-only tests of the port's CUDA kernels. Each skips where there is no
CUDA card. This file imports neither JAX nor `spacetpu`, so it also runs on
a machine that has only PyTorch (`pair_hold` and `splat_hold` are
tests/pair_hold.py and tests/splat_hold.py, on the path as pytest puts this
file's directory there):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
import spacetpu_torch
from spacetpu_torch import _build
from spacetpu_torch.models import presets
from spacetpu_torch.ops import cuda_direct, cuda_tree, energy
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.render import cuda_splat, fastsplat

import pair_hold
import potential_sym
import splat_hold
import tf32_split

pytestmark = pytest.mark.gpu

#: an eps whose float32 square is subnormal (float32 plummer takes eps^2 as
#: 0 there, with the eps == 0 mask)
SUBNORMAL_EPS = chip_smoke.SUBNORMAL_EPS


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
                                           ("plummer", 0.0), ("ref", 0.0),
                                           ("plummer", 1e-3),
                                           ("plummer", SUBNORMAL_EPS)])
def test_vpu_float32_cross_ragged(card, softening, eps):
    """Ragged cross shapes in float32: within 1e-4 of max|a| of the plain
    version where softened, finite where not; at the subnormal eps^2,
    eps = 0's bits."""
    pos_i, _ = _bodies(333, seed=11, dtype=torch.float32, dev=card)
    pos_j, mass_j = _bodies(1001, seed=12, dtype=torch.float32, dev=card)
    kw = dict(softening=softening, eps=eps, g=1.0)
    got = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
    want = cuda_direct.acc_cross_plain(pos_i, pos_j, mass_j, **kw)
    assert got.shape == (333, 3)
    assert bool(torch.isfinite(got).all())
    if chip_smoke.softened(eps):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    if eps == SUBNORMAL_EPS:
        assert torch.equal(got, cuda_direct.acc_cross_kernel(
            pos_i, pos_j, mass_j, softening=softening, eps=0.0, g=1.0))


@pytest.mark.parametrize("eps", [1e-2, 1e-3])
@pytest.mark.parametrize("m,k", [(1, 1000), (333, 1001), (513, 257),
                                 (1024, 256), (4099, 4099), (20011, 20011)])
def test_vpu_lean_kernel_ragged_shapes(card, m, k, eps):
    """The lean kernel (two targets a thread, the MUFU rsqrt alone, the C
    entry's choice for float32 plummer at these eps) at M below, at and
    past a block's 512 targets and ragged, K below, at and past a
    256-source tile and ragged, the targets the sources where M = K: one
    launch a call, a second call bit for bit the first, and the plain
    version's 1e-4 of max|a|. Its bits against the one-target kernel's
    are held by tools/compare_parent.py against the parent commit."""
    pos_j, mass_j = _bodies(k, seed=k, dtype=torch.float32, dev=card)
    pos_i = pos_j if m == k else _bodies(m, seed=m + 1, dtype=torch.float32,
                                         dev=card)[0]
    assert cuda_tree.lean_rsqrt(torch.float32, "plummer", eps)
    kw = dict(softening="plummer", eps=eps, g=1.0)
    before = cuda_direct.LAUNCHES["direct_vpu"]
    got = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
    assert cuda_direct.LAUNCHES["direct_vpu"] == before + 1
    assert got.shape == (m, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, cuda_direct.acc_cross_kernel(pos_i, pos_j,
                                                         mass_j, **kw))
    want = cuda_direct.acc_cross_plain(pos_i, pos_j, mass_j, **kw)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_mxu_float32_within_band_of_vpu(card):
    """The band of tests/test_pallas.py:66-79 on the card."""
    pos, mass = _bodies(4099, seed=4099, dtype=torch.float32, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    a_v = cuda_direct.acc_direct_kernel(pos, mass, **kw)
    a_m = cuda_direct.acc_direct_kernel(pos, mass, method="mxu", **kw)
    band = torch.linalg.norm(a_m - a_v, dim=1).max() / torch.linalg.norm(
        a_v, dim=1).max()
    assert float(band) < 2e-3


@pytest.mark.parametrize("m,k", [(4099, 4099), (333, 1001)])
def test_mxu_float32_holds_and_one_pass_tf32_fails(card, m, k):
    """The tensor-core kernel within 1e-4 of the term scale of its plain
    version (chip_smoke.mxu_term_scale), where the one-pass TF32 emulation
    (tests/tf32_split.py), run on the card beside it, fails the same hold
    at N = 4099."""
    pos_j, mass_j = _bodies(k, seed=k, dtype=torch.float32, dev=card)
    pos_i = pos_j if m == k else _bodies(m, seed=m + 1,
                                         dtype=torch.float32, dev=card)[0]
    kw = dict(eps=1e-2, g=1.0)
    got = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, method="mxu",
                                       softening="plummer",
                                       self_offset=0 if m == k else None,
                                       **kw)
    want = cuda_direct.acc_cross_mxu_plain(pos_i, pos_j, mass_j, **kw)
    scale = chip_smoke.mxu_term_scale(pos_i, pos_j, mass_j, 1e-2, 1.0)
    assert got.shape == (m, 3) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) / scale <= tf32_split.F32_TOL
    if m == k:
        one = tf32_split.acc_mxu_tf32(pos_i, pos_j, mass_j, terms=1, **kw)
        assert float((one - want).abs().max()) / scale > tf32_split.F32_TOL


@pytest.mark.parametrize("start,count", [(0, 4099), (1031, 1366)])
def test_mxu_float32_named_targets_do_not_depend_on_aliasing(card, start,
                                                             count):
    """Targets that are a copy or a shard of the sources, named by
    self_offset: a copy of all of them gives the all-pairs call's rows bit
    for bit; a shard (starting inside a 256-source tile) meets the 1e-4
    hold of its term scale and the 2e-3 band against direct_vpu."""
    pos, mass = _bodies(4099, seed=4099, dtype=torch.float32, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    tgt = pos[start:start + count].clone()
    got = cuda_direct.acc_cross_kernel(tgt, pos, mass, method="mxu",
                                       self_offset=start, **kw)
    if count == 4099:
        assert torch.equal(got, cuda_direct.acc_direct_kernel(
            pos, mass, method="mxu", **kw))
    want = cuda_direct.acc_cross_mxu_plain(tgt, pos, mass, eps=1e-2, g=1.0)
    scale = chip_smoke.mxu_term_scale(tgt, pos, mass, 1e-2, 1.0)
    assert float((got - want).abs().max()) / scale <= tf32_split.F32_TOL
    ref = cuda_direct.acc_direct_kernel(pos, mass, **kw)[start:start + count]
    band = torch.linalg.norm(got - ref, dim=1).max() / torch.linalg.norm(
        ref, dim=1).max()
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


#: quad_dense's cases: the tree's own summaries, and `pair_hold`'s ragged
#: (M, S) at eps 1e-2 and 0 (a target on a centre of mass)
_QUAD_DENSE_CASES = ["tree"] + [(m, s, eps) for m, s in pair_hold.QUAD_SIZES
                                for eps in (1e-2, 0.0)]


@pytest.mark.parametrize("case", _QUAD_DENSE_CASES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_quad_dense_matches_plain(card, dtype, tol, case):
    """Ragged M and S, and a column slice of a wider table. float64: only the
    order of the sums differs; float32: the band of tests/test_pallas.py:26.
    A second call gives the same bits."""
    if case == "tree":
        prep, gg = _tree_prep(4099, 31, dtype, card)
        summ = tree_ops._cluster_summaries(prep["pos_g"], prep["mass_g"],
                                           prep["com"], prep["m_tot"], 1.0)
        tgt, summ, eps = prep["pos_s"][:1000], summ[:, :gg], 1e-2
    else:
        m, s, eps = case
        tgt, summ = pair_hold.quad_dense_case(m, s, eps, dtype, card)
    before = cuda_tree.LAUNCHES["quad_dense"]
    got = cuda_tree.acc_cross_quad(tgt, summ, eps=eps)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["quad_dense"] == before + 1
    want = cuda_tree.acc_cross_quad_plain(tgt, summ, eps=eps)
    assert got.shape == tgt.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) < tol
    assert torch.equal(got, cuda_tree.acc_cross_quad(tgt, summ, eps=eps))


#: pairs_direct's cases: the tree's own pair lists at leaf 31, and the near
#: lists of strip preps (leaf 15, 31, 100: even, 255) made into tile lists
#: of 4 source clusters a tile (the tree's lists take a leaf + 1 that
#: divides 2048); each law softened and not, and plummer at the subnormal
#: float32 eps^2
_PAIRS_DIRECT_LISTS = ["tree31", 15, 31, 100, 255]
_PAIRS_DIRECT_LAWS = [("plummer", 1e-2), ("ref", 1e-2), ("plummer", 0.0),
                      ("ref", 0.0), ("plummer", 1e-3),
                      ("plummer", SUBNORMAL_EPS)]


def _pairs_direct_inputs(card, lists, dtype, pseudo):
    """(pos_g, srows, flat_src, tile_tgt) of a pairs_direct case; the strip
    lists with the last cluster's list emptied (`_strip_prep`) and the one
    before's ids nulled."""
    if lists == "tree31":
        prep, _ = _tree_prep(4099, 31, torch.float64, card)
        flat, tgt = prep["near_flat"], prep["near_tile_tgt"]
    else:
        prep, idx = _strip_prep(card, n=STRIP_SIZES[lists], leaf=lists)
        gg = idx.shape[0]
        idx[gg - 2] = gg
        flat, tgt, _, dropped = tree_ops.near_pair_segments(
            idx, gg, 4, gg * (-(-idx.shape[1] // 4)))
        assert int(dropped) == 0
    pool = _pool(prep, dtype)
    srows = tree_ops._pack_augmented(*pool, 1.0, monopole_pseudo=pseudo)
    return pool[0], srows, flat, tgt


@pytest.mark.parametrize("pseudo", [False, True])
@pytest.mark.parametrize("softening,eps", _PAIRS_DIRECT_LAWS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lists", _PAIRS_DIRECT_LISTS)
def test_pairs_direct_matches_plain(card, lists, dtype, softening, eps,
                                    pseudo):
    """Two targets a thread (blocks of `two_target_threads(leaf)`, the
    second target ragged at every leaf here) in `heavy_first` order, the
    MUFU rsqrt alone where `lean_rsqrt`: one launch a call, a second call
    bit for bit the first; float64 within 1e-9 of max|a| of the plain
    version, float32 target by target against the float64 sums (`_hold`,
    and where softened the 2e-5 band against the plain version); a cluster
    without tiles and one with only null ids exactly 0; at the subnormal
    float32 eps^2, eps = 0's bits."""
    args = _pairs_direct_inputs(card, lists, dtype, pseudo)
    leaf = args[0].shape[1]
    assert 2 * cuda_tree.two_target_threads(leaf) > leaf
    kw = dict(softening=softening, eps=eps)
    assert cuda_tree.lean_rsqrt(dtype, softening, eps) == (
        dtype == torch.float32 and softening == "plummer"
        and chip_smoke.softened(eps))
    before = cuda_tree.LAUNCHES["pairs_direct"]
    got = cuda_tree.near_pairs_direct(*args, **kw)
    again = cuda_tree.near_pairs_direct(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["pairs_direct"] == before + 2
    assert torch.equal(got, again)
    if lists != "tree31":
        assert float(got[-2:].abs().max()) == 0.0
    if dtype == torch.float64:
        want = cuda_tree.near_pairs_direct_plain(*args, **kw)
        assert bool(torch.isfinite(got).all()) and _rel(got, want) < 1e-9
    else:
        _hold("pairs_direct", got,
              cuda_tree.near_pairs_direct_plain(*args, **kw), args, kw)
    if eps == SUBNORMAL_EPS and dtype == torch.float32:
        assert torch.equal(got, cuda_tree.near_pairs_direct(
            *args, softening=softening, eps=0.0))


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


#: the kernels of the mesh families, the hybrid sums and strip mode,
#: launched by none of the tree's "vpu" pair-list paths
_NOT_TREE = {"pairs_hybrid": 0, "pairs_short": 0, "pairs_short_hybrid": 0,
             "near_strip": 0, "quad_strip": 0, "quad_refine": 0}


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


def _far3_prep(dtype, dev, n=3833, leaf=15, gg=256, near_mode="pairs"):
    """A far3 prep (pair lists by default; 4 superclusters of 64 at leaf
    15 unless asked otherwise), built by the port on the card, and its
    cluster summaries. The scene (a dense
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
                              leaf=leaf, far_levels=3, near_mode=near_mode)
    summ = tree_ops._cluster_summaries(prep["pos_g"], prep["mass_g"],
                                       prep["com"], prep["m_tot"], 1.0)
    return prep, summ


@pytest.mark.parametrize("case", ["far3", ("wide", 1e-2), ("wide", 0.0)],
                         ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_quad_masked_matches_plain(card, dtype, tol, case):
    """On the port's own supercluster near list (4 supers), and on
    `pair_hold.quad_masked_case` (G2 = 300 > 256, masks across the tile
    boundary, a whole tile masked, a row of nulls; eps 1e-2 and 0). With a
    list that masks every super exactly 0, and bit for bit quad_dense's
    result with none masked; each wide super's rows bit for bit quad_dense
    on the table with its masked columns' g*M and g*Q zeroed."""
    if case == "far3":
        prep, summ = _far3_prep(dtype, card)
        ss = tree_ops._super_multipoles(summ[:, :256])
        tgt, idx2, eps = prep["pos_g"].reshape(-1, 3), prep["idx2"], 1e-2
    else:
        eps = case[1]
        tgt, ss, idx2 = pair_hold.quad_masked_case(eps, dtype, card)
    n2, g2 = idx2.shape[0], ss.shape[1]
    before = cuda_tree.LAUNCHES["quad_masked"]
    got = cuda_tree.acc_cross_quad_masked(tgt, ss, idx2, eps=eps)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["quad_masked"] == before + 1
    want = cuda_tree.acc_cross_quad_masked_plain(tgt, ss, idx2, eps=eps)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    every = torch.arange(g2, device=card).expand(n2, g2).contiguous()
    zero = cuda_tree.acc_cross_quad_masked(tgt, ss, every, eps=eps)
    assert float(zero.abs().max()) == 0.0
    none = torch.full((n2, 1), g2, device=card)
    dense = cuda_tree.acc_cross_quad_masked(tgt, ss, none, eps=eps)
    assert torch.equal(dense, cuda_tree.acc_cross_quad(tgt, ss, eps=eps))
    if case == "far3":
        return
    rows = tgt.shape[0] // n2
    for a in range(n2):
        table = ss.clone()
        table[3:10, idx2[a][idx2[a] < g2]] = 0.0
        lo, hi = a * rows, (a + 1) * rows
        assert torch.equal(got[lo:hi], cuda_tree.acc_cross_quad(
            tgt[lo:hi], table, eps=eps)), a


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


@pytest.mark.parametrize("leaf", [15, 255])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-5)])
def test_pairs_quad_shared_unpaired_list_matches_plain(card, dtype, tol,
                                                       leaf):
    """`pair_hold.unpaired_shared_case`: clusters whose block partner walks
    other tiles, or fewer, or none, at an odd G; at leaf 15 a tile takes
    four passes of the block's 32 threads, at leaf 255 one. The cluster
    with no tiles gets exactly 0."""
    case = pair_hold.unpaired_shared_case(dtype, card, leaf)
    before = cuda_tree.LAUNCHES["pairs_quad_shared"]
    got = cuda_tree.near_pairs_quad_shared(*case["args"], **case["kw"])
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["pairs_quad_shared"] == before + 1
    want = cuda_tree.near_pairs_quad_shared_plain(*case["args"],
                                                  **case["kw"])
    assert _rel(got, want) < tol
    assert float(got.reshape(-1, leaf, 3)[4].abs().max()) == 0.0


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


# --- strip mode's kernels ----------------------------------------------------


def _strip_prep(dev, n=4099, leaf=31):
    """A strip-mode prep of a ragged cloud built on the card, with the
    geometric k_near (so lists end in null slots) and the last target
    cluster's list emptied; float64, cast per test."""
    pos, mass = _bodies(n, seed=n, dtype=torch.float64, dev=dev)
    gg = -(-n // leaf)
    prep = tree_ops.tree_prep(pos, mass, theta=0.5, gg=gg, leaf=leaf,
                              k_near=tree_ops.default_k_near(0.5, gg),
                              near_mode="strip")
    idx = prep["idx"].clone()
    idx[-1] = gg
    return prep, idx


def _pool(prep, dtype):
    return [prep[k].to(dtype) for k in ("pos_g", "mass_g", "com", "m_tot")]


def _strip_hold(name, got, exact, args, kw):
    """float32 target by target within `pair_hold.F32_TOL` of the size of
    what float32 rounds, and the wrong versions outside it."""
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), name
    held = pair_hold.hold(got.reshape(exact.shape[:-1] + (3,)), exact)
    assert held["ok"], (name, held)
    wrong = pair_hold.strip_mutant_ratios(name, args, kw, exact)
    assert all(r > pair_hold.F32_TOL for r in wrong.values()), (name, wrong)


#: the two-target kernels' cases: body counts by cluster size, whose blocks
#: split the targets two a thread unevenly (15, 31: one warp, the second
#: half dead; 100 and 127: 64 threads, the second half ragged; 255: 128
#: threads), each count ragged (the last cluster padded); TreePM's lists,
#: on which pairs_hybrid is held, take a leaf + 1 that divides 2048, so 127
#: there in place of 100; each law unsoftened and at eps 1e-3, and plummer
#: at an eps whose float32 square is subnormal, where the kernels keep
#: rsqrtf (cuda_tree.lean_rsqrt)
STRIP_SIZES = {15: 2003, 31: 4099, 100: 6007, 255: 20011}
HYBRID_SIZES = {15: 2003, 31: 4099, 127: 6007, 255: 20011}
_TWO_TARGET_LAWS = [("plummer", 1e-3), ("plummer", 0.0),
                    ("plummer", SUBNORMAL_EPS), ("ref", 1e-3), ("ref", 0.0)]


@pytest.mark.parametrize("pseudo", [False, True])
@pytest.mark.parametrize("softening,eps", _TWO_TARGET_LAWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("leaf", list(STRIP_SIZES))
def test_near_strip_matches_plain(card, leaf, dtype, softening, eps, pseudo):
    """float64 against the plain version (1e-9 of max|a|); float32 against
    the float64 sums; one launch a call, nothing from the emptied list or
    from K = 0, and `lean_rsqrt`'s route. At the subnormal eps^2 a float32
    pair at r = 0 has an infinite weight times a zero difference in every
    version, so that case takes a body count of whole clusters (no padding
    body on a real one) and lists without the target's own cluster."""
    n = STRIP_SIZES[leaf]
    if eps == SUBNORMAL_EPS:
        n -= n % leaf
    prep, idx = _strip_prep(card, n=n, leaf=leaf)
    if eps == SUBNORMAL_EPS:
        own = torch.arange(idx.shape[0], device=card)[:, None]
        idx = torch.where(idx == own, idx.shape[0], idx)
    kw = dict(softening=softening, eps=eps, g=1.0, monopole_pseudo=pseudo)
    pool = _pool(prep, dtype)
    args = (pool[0], idx, *pool)
    assert cuda_tree.lean_rsqrt(dtype, softening, eps) == (
        dtype == torch.float32 and softening == "plummer" and eps == 1e-3)
    before = cuda_tree.LAUNCHES["near_strip"]
    got = cuda_tree.near_strip(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES["near_strip"] == before + 1
    assert float(got[-1].abs().max()) == 0.0
    none = cuda_tree.near_strip(pool[0], idx[:, :0], *pool, **kw)
    torch.cuda.synchronize()
    assert float(none.abs().max()) == 0.0
    if dtype == torch.float64:
        assert _rel(got, cuda_tree.near_strip_plain(*args, **kw)) < 1e-9
    else:
        _strip_hold("near_strip", got, pair_hold.strip_exact_sums(args, kw),
                    args, kw)


def test_quad_strip_matches_plain(card):
    prep, idx = _strip_prep(card)
    for dtype in (torch.float64, torch.float32):
        pool = _pool(prep, dtype)
        neg = tree_ops._negated(tree_ops._cluster_summaries(*pool, 1.0))
        args = (pool[0], neg, idx)
        got = cuda_tree.quad_strip(*args, eps=1e-2)
        if dtype == torch.float64:
            assert _rel(got, cuda_tree.quad_strip_plain(*args,
                                                        eps=1e-2)) < 1e-9
        else:
            _strip_hold("quad_strip", got,
                        pair_hold.quad_strip_exact_sums(*args, 1e-2), args,
                        dict(eps=1e-2))


def test_quad_refine_matches_plain(card):
    """The far3 strip prep of 15,353 bodies at leaf 15 (16 supers): strips
    of two 512-column tiles with null columns, and clusters past the first
    of their super."""
    prep, _ = _far3_prep(torch.float64, card, n=15_353, gg=1024,
                         near_mode="strip")
    for dtype in (torch.float64, torch.float32):
        pool = _pool(prep, dtype)
        summ = tree_ops._cluster_summaries(*pool, 1.0)
        strips = tree_ops._superfar_refine_table(summ[:, :1024], None,
                                                 prep["idx2"])
        assert strips.shape[1] // 16 >= 1024
        assert bool((strips[3:10] == 0).all(0).any())
        kw = dict(eps=1e-2, group=tree_ops.SUPER)
        got = cuda_tree.quad_refine(pool[0], strips, **kw)
        if dtype == torch.float64:
            assert _rel(got, cuda_tree.quad_refine_plain(pool[0], strips,
                                                         **kw)) < 1e-9
        else:
            exact = pair_hold.quad_refine_exact_sums(
                pool[0], strips, 1e-2, tree_ops.SUPER,
                torch.arange(1024, device=card))
            _strip_hold("quad_refine", got, exact, (pool[0], strips), kw)
        # a block takes two clusters of one super: an odd group is refused
        with pytest.raises(ValueError, match="even"):
            cuda_tree.quad_refine(pool[0], strips, eps=1e-2, group=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quad_refine_terms_are_quad_strips_negated(card, dtype):
    """quad_refine (quad_term, two targets a thread) on a strip
    of one column a super against quad_strip (quad_term) on the negated
    column: exact negatives, target by target."""
    prep, _ = _far3_prep(torch.float64, card, n=15_353, gg=1024,
                         near_mode="strip")
    pool = _pool(prep, dtype)
    summ = tree_ops._cluster_summaries(*pool, 1.0)
    strips = tree_ops._superfar_refine_table(summ[:, :1024], None,
                                             prep["idx2"])
    refine, strip = pair_hold.one_column_terms(pool[0], strips, 1e-2,
                                               tree_ops.SUPER)
    torch.cuda.synchronize()
    assert bool((refine != 0).any())
    assert torch.equal(refine, -strip)


def test_strip_kernels_refuse_what_they_do_not_take(card):
    prep, idx = _strip_prep(card, n=1000)
    pool = _pool(prep, torch.float32)
    kw = dict(softening="plummer", eps=1e-2, g=1.0, monopole_pseudo=True)
    with pytest.raises(IndexError, match="outside"):
        cuda_tree.near_strip(pool[0], idx + 1, *pool, **kw)
    neg = tree_ops._negated(tree_ops._cluster_summaries(*pool, 1.0))
    with pytest.raises(IndexError, match="outside"):
        cuda_tree.quad_strip(pool[0], neg, idx - 1, eps=1e-2)
    with pytest.raises(ValueError, match="share"):
        cuda_tree.near_strip(pool[0], idx, pool[0].cpu(), *pool[1:], **kw)
    none = cuda_tree.near_strip(pool[0], idx[:, :0], *pool, **kw)
    torch.cuda.synchronize()
    assert float(none.abs().max()) == 0.0


@pytest.mark.parametrize("far_levels,want", [
    (2, {"quad_dense": 4, "near_strip": 4, "quad_strip": 4}),
    (3, {"quad_masked": 4, "quad_refine": 4, "near_strip": 4,
         "quad_strip": 4})])
def test_strip_paths_launch_kernels(card, far_levels, want):
    """prime + 3 steps in strip mode: one launch of each strip kernel a
    force pass, no pair-list kernel, and the force within the tree's
    budget of the direct kernel's."""
    n = 20_000
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    sim = spacetpu_torch.make_simulation(n, algorithm="tree", theta=0.5,
                                         near_mode="strip", leaf=31,
                                         far_levels=far_levels,
                                         k_near="auto", **kw)
    state = presets.random_cluster(n, seed=0).state()
    for key in cuda_tree.LAUNCHES:
        cuda_tree.LAUNCHES[key] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    assert cuda_tree.LAUNCHES == dict(dict.fromkeys(cuda_tree.LAUNCHES, 0),
                                      **want)
    assert sim.health(state)["near_overflow"] == 0
    exact = cuda_direct.acc_direct_kernel(state.pos, state.mass, **kw)
    err = torch.linalg.norm(state.acc - exact, dim=1) / torch.linalg.norm(
        exact, dim=1).mean()
    assert float(err.median()) < 1e-3


def test_strip_order2_grid_coincidence_float32_is_finite(card):
    """tests/test_quadrupole.py:89 in strip mode on the card: unsoftened
    float32 on a regular grid, where a cluster's centre can sit on a body,
    stays finite (the coincidence mask of quad_term)."""
    scene = presets.fixed_cloud(2000)
    got = tree_ops.acc_tree(
        torch.as_tensor(scene.pos, dtype=torch.float32, device=card),
        torch.as_tensor(scene.mass, dtype=torch.float32, device=card),
        theta=0.3, softening="plummer", eps=0.0, g=float(scene.g),
        backend="cuda", multipole_order=2, leaf=31, near_mode="strip")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())


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
    if chip_smoke.softened(kw["eps"]) and not pair_hold.KERNELS[name][1]:
        assert _rel(got, want) < 2e-5, name


_CASES = [(dtype, law, eps) for dtype in (torch.float32, torch.float64)
          for law in ("plummer", "ref") for eps in (1e-2, 0.0)]


def _drop_tiles(prep, gone, nulled):
    """The tile list of a prep with target cluster `gone`'s tiles removed
    (K = 0) and every id of cluster `nulled`'s tiles made null."""
    flat, tgt = prep["near_flat"], prep["near_tile_tgt"]
    srcs = flat.reshape(tgt.shape[0], -1).clone()
    srcs[tgt == nulled] = prep["pos_g"].shape[0]
    keep = tgt != gone
    return srcs[keep].reshape(-1), tgt[keep]


@pytest.mark.parametrize("pseudo", [False, True])
@pytest.mark.parametrize("softening,eps", _TWO_TARGET_LAWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("leaf", list(HYBRID_SIZES))
def test_pairs_hybrid_matches_plain(card, leaf, dtype, softening, eps,
                                    pseudo):
    """The TreePM cutoff lists of `pair_hold.short_inputs` with the tree's
    source table (a -M pseudo-body a cluster) or TreePM's (a massless one),
    the last cluster's tiles removed and the one before's ids nulled
    (`_hold`, and exactly 0 for both), one launch a call, and
    `lean_rsqrt`'s route. The r^2 = 0 pairs are masked, so the subnormal
    eps^2 needs no other input."""
    prep, rows = pair_hold.short_inputs(HYBRID_SIZES[leaf], leaf, 0.35,
                                        dtype, card)
    gg = prep["pos_g"].shape[0]
    flat, tgt = _drop_tiles(prep, gg - 1, gg - 2)
    args = (prep["pos_g"], rows[pseudo], flat, tgt)
    kw = dict(softening=softening, eps=eps)
    assert cuda_tree.lean_rsqrt(dtype, softening, eps) == (
        dtype == torch.float32 and softening == "plummer" and eps == 1e-3)
    before = cuda_tree.LAUNCHES["pairs_hybrid"]
    got = cuda_tree.near_pairs_hybrid(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_hybrid"] == before + 1
    torch.cuda.synchronize()
    assert float(got[-2:].abs().max()) == 0.0
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


@pytest.mark.parametrize("dtype,softening,eps", _CASES)
@pytest.mark.parametrize("n,leaf", [(1500, 15), (20_000, 255)])
def test_pairs_short_poly_walk_matches_plain(card, n, leaf, dtype,
                                             softening, eps):
    """The poly split's walk at leaf 15 (a chunk spans two clusters, the
    last one's tail is filled) and at the paths' leaf 255: the hold of
    test_pairs_short_matches_plain, one launch a call, and a second call
    bit for bit the first."""
    prep, rows = pair_hold.short_inputs(n, leaf, 0.35, dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps, rs=0.35 / 4.5, rcut=0.35,
              split="poly")
    before = cuda_tree.LAUNCHES["pairs_short"]
    got = cuda_tree.near_pairs_short(*args, **kw)
    again = cuda_tree.near_pairs_short(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_short"] == before + 2
    _hold("pairs_short", got, cuda_tree.near_pairs_short_plain(*args, **kw),
          args, kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,n,leaf,rcut,inside", [
    (torch.float32, 4099, 31, 0.35, 0.25),
    (torch.float32, 20_000, 255, 0.35, 0.25),
    (torch.float64, 65_536, 255, 0.3, 0.01)])
def test_pairs_short_skip_inside_the_cutoff_fails_its_limit(card, dtype, n,
                                                           leaf, rcut,
                                                           inside):
    """The walk's chunk skip moved `inside` r_cut into the cutoff (its plain
    version, `pair_hold.near_pairs_short_cut_plain`) fails the limit that
    the kernel meets, target by target against the float64 sums: in float32
    `pair_hold.F32_TOL`, 25% inside; in float64 `pair_hold.F64_TOL` (the
    order of the sums alone), 1% inside. (At 1% inside the pairs it drops
    keep under 7.8e-5 of their weight, below what float32 rounds: only the
    float64 hold sees that skip.)"""
    prep, rows = pair_hold.short_inputs(n, leaf, rcut, dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening="plummer", eps=0.0, rs=rcut / 4.5, rcut=rcut,
              split="poly")
    got = cuda_tree.near_pairs_short(*args, **kw)
    exact = pair_hold.exact_sums("pairs_short", args, kw)
    tol = pair_hold.F32_TOL if dtype == torch.float32 else pair_hold.F64_TOL
    assert pair_hold.hold(got, exact, tol)["ok"]
    assert pair_hold.skip_inside_ratio(args, kw, exact, inside) > tol


def test_pairs_short_evaluates_pairs_one_ulp_inside_the_cutoff(card):
    """A pair at r^2 / r_cut^2 = 1 - 2^-24 on each side of a chunk
    boundary, each the one term of its own target cluster
    (`pair_hold.edge_pair_case`): the walk evaluates each chunk (a nonzero
    force in both clusters, the same term bit for bit), and a cluster with
    no list gets exactly 0. A skip one ulp early leaves both at exactly 0."""
    edge = pair_hold.edge_pair_case(torch.float32, card)
    got = cuda_tree.near_pairs_short(*edge["args"], **edge["kw"])
    torch.cuda.synchronize()
    assert pair_hold.edge_pair_checks(got)["ok"]
    early = pair_hold.near_pairs_short_cut_plain(
        *edge["args"], softening="plummer", eps=0.0, rcut=1.0,
        skip_at=1.0 - 2.0 ** -24)
    assert bool((early == 0).all())


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


@pytest.mark.parametrize("dtype,softening,eps", _CASES)
@pytest.mark.parametrize("n,leaf", [(1500, 15), (20_000, 255)])
def test_pairs_short_hybrid_poly_walk_matches_plain(card, n, leaf, dtype,
                                                    softening, eps):
    """pairs_short's walk with the centred sums, at leaf 15 (a chunk spans
    two clusters) and at the paths' leaf 255: the hold of
    test_pairs_short_hybrid_matches_plain, in float64 also target by
    target within `pair_hold.F64_TOL` of the float64 sums; one launch a
    call, and a second call bit for bit the first."""
    prep, rows = pair_hold.short_inputs(n, leaf, 0.35, dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps, rs=0.35 / 4.5, rcut=0.35,
              split="poly")
    before = cuda_tree.LAUNCHES["pairs_short_hybrid"]
    got = cuda_tree.near_pairs_short_hybrid(*args, **kw)
    again = cuda_tree.near_pairs_short_hybrid(*args, **kw)
    assert cuda_tree.LAUNCHES["pairs_short_hybrid"] == before + 2
    _hold("pairs_short_hybrid", got,
          cuda_tree.near_pairs_short_hybrid_plain(*args, **kw), args, kw)
    if dtype == torch.float64:
        exact = pair_hold.exact_sums("pairs_short_hybrid", args, kw)
        assert pair_hold.hold(got, exact, pair_hold.F64_TOL)["ok"]
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,n,leaf,rcut,inside", [
    (torch.float32, 4099, 31, 0.35, 0.25),
    (torch.float64, 65_536, 255, 0.3, 0.01)])
def test_pairs_short_hybrid_skip_inside_the_cutoff_fails_its_limit(
        card, dtype, n, leaf, rcut, inside):
    """The hybrid walk meets the limit that its skip moved `inside` r_cut
    into the cutoff fails (`pair_hold.near_pairs_short_hybrid_cut_plain`),
    as test_pairs_short_skip_inside_the_cutoff_fails_its_limit holds
    pairs_short's."""
    prep, rows = pair_hold.short_inputs(n, leaf, rcut, dtype, card)
    args = (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening="plummer", eps=0.0, rs=rcut / 4.5, rcut=rcut,
              split="poly")
    got = cuda_tree.near_pairs_short_hybrid(*args, **kw)
    exact = pair_hold.exact_sums("pairs_short_hybrid", args, kw)
    tol = pair_hold.F32_TOL if dtype == torch.float32 else pair_hold.F64_TOL
    assert pair_hold.hold(got, exact, tol)["ok"]
    assert pair_hold.skip_inside_ratio(args, kw, exact, inside,
                                       "pairs_short_hybrid") > tol


def test_pairs_short_hybrid_evaluates_pairs_one_ulp_inside_the_cutoff(card):
    """`pair_hold.edge_pair_case` through the hybrid walk: each chunk's
    edge pair is evaluated, and since every target sits at its cluster's
    first body the centred sums give pairs_short's term bit for bit."""
    edge = pair_hold.edge_pair_case(torch.float32, card)
    got = cuda_tree.near_pairs_short_hybrid(*edge["args"], **edge["kw"])
    torch.cuda.synchronize()
    assert pair_hold.edge_pair_checks(got)["ok"]
    assert torch.equal(got, cuda_tree.near_pairs_short(*edge["args"],
                                                       **edge["kw"]))


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


# --- the tile splat kernel (render/cuda_splat.py, csrc/splat.cu) ---


@pytest.mark.parametrize("case", ["rand_3000", "hot_tile_5000",
                                  "app_10000"])
def test_splat_tiles_holds_against_float64_plain(card, case):
    """splat_tiles against its float64 plain version, pixel by pixel within
    splat_hold.F32_TOL of the value plus WINDOW_SHARE of the window's
    maximum; each of the four wrong versions fails the same limit; one
    launch a call. The cases of chip_smoke.py's splat_kernels phase that fit
    a test: tests/test_fastsplat.py's 3,000 entries at 256x96, its hot tile,
    and a frame of the default app's scene (fixed_cloud(10000) at
    960x540)."""
    if case == "app_10000":
        from spacetpu_torch.render import fastsplat
        from spacetpu_torch.render.camera import Camera

        scene = presets.fixed_cloud(10_000)
        cam = Camera(960, 540)
        cam.frame_scene(scene.pos)
        pos = torch.as_tensor(scene.pos, dtype=torch.float32, device=card)
        hist = torch.stack([pos + 1e-3 * k for k in range(5)])
        ages = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=card)
        entries = fastsplat.scene_entries(
            hist, ages, torch.as_tensor(scene.colors, device=card),
            torch.as_tensor(scene.radii, device=card),
            torch.as_tensor(cam.view(), device=card),
            torch.as_tensor(cam.projection(), device=card),
            width=960, height=540)
        keys, p1, p2 = fastsplat.prepare_entries(*entries, width=960,
                                                 height=540)
        n_tiles = 8 * 34
    else:
        entries = (splat_hold.rand_entries(3000, 256, 96)
                   if case == "rand_3000" else splat_hold.hot_entries())
        keys, p1, p2, n_tiles = splat_hold.sorted_entries(entries, 256, 96,
                                                          card)
    before = cuda_splat.LAUNCHES["splat_tiles"]
    got = cuda_splat.splat_tiles(keys, p1, p2, n_tiles=n_tiles)
    torch.cuda.synchronize()
    assert cuda_splat.LAUNCHES["splat_tiles"] == before + 1
    assert got.shape == (n_tiles, 96, 256) and got.is_cuda
    want = cuda_splat.splat_tiles_plain(keys, p1, p2, n_tiles=n_tiles,
                                        dtype=torch.float64)
    row = splat_hold.hold(got, want, splat_hold.swapped_windows(
        keys, p1, p2, n_tiles=n_tiles))
    assert row["ok"], row
    # deterministic: no atomics, the sum runs in entry order
    again = cuda_splat.splat_tiles(keys, p1, p2, n_tiles=n_tiles)
    assert torch.equal(got, again)


@pytest.mark.parametrize("count", ["seg", "seg+1", "5seg+3", 82_332])
def test_splat_tiles_splits_a_hot_tile(card, count):
    """One tile of SEG, SEG + 1 and 5 SEG + 3 entries, and of app-1M's
    fullest tile's 82,332: cut into segments of at most SEG entries whose
    partial windows merge in segment order; held as above, and two calls
    agree bit for bit."""
    seg = cuda_splat.SEG
    m = {"seg": seg, "seg+1": seg + 1, "5seg+3": 5 * seg + 3}.get(count,
                                                                  count)
    keys, p1, p2, n_tiles = splat_hold.sorted_entries(
        splat_hold.hot_entries(m), 256, 96, card)
    table = cuda_splat.segment_table(fastsplat.tile_starts(keys, n_tiles),
                                     n_tiles, keys.shape[0])
    assert int(table["nseg"].sum()) == -(-m // seg)
    assert int((table["hi"] - table["lo"]).max()) <= seg
    got = cuda_splat.splat_tiles(keys, p1, p2, n_tiles=n_tiles)
    want = cuda_splat.splat_tiles_plain(keys, p1, p2, n_tiles=n_tiles,
                                        dtype=torch.float64)
    row = splat_hold.hold(got, want, splat_hold.swapped_windows(
        keys, p1, p2, n_tiles=n_tiles))
    assert row["ok"], row
    assert torch.equal(got, cuda_splat.splat_tiles(keys, p1, p2,
                                                   n_tiles=n_tiles))


def test_splat_tiles_empty_and_refused_inputs(card):
    """No entries: every window zero. Inputs of another dtype are refused,
    not taken by the plain version."""
    keys = torch.full((1024,), 12, dtype=torch.int32, device=card)
    zero = torch.zeros_like(keys)
    assert not cuda_splat.splat_tiles(keys, zero, zero, n_tiles=12).any()
    with pytest.raises(ValueError, match="int32"):
        cuda_splat.splat_tiles(keys.long(), zero, zero, n_tiles=12)


def test_app_frame_launches_splat_once(card):
    """render_scene_auto on CUDA tensors goes to the tile splatter: one
    splat_tiles launch a frame, never the scatter path."""
    from spacetpu_torch.render import fastsplat, rasterizer
    from spacetpu_torch.render.camera import Camera

    scene = presets.fixed_cloud(2000)
    cam = Camera(320, 200)
    cam.frame_scene(scene.pos)
    pos = torch.as_tensor(scene.pos, dtype=torch.float32, device=card)
    args = (torch.stack([pos, pos]), torch.tensor([0.0, 1.0], device=card),
            torch.as_tensor(scene.colors, device=card),
            torch.as_tensor(scene.radii, device=card),
            torch.as_tensor(cam.view(), device=card),
            torch.as_tensor(cam.projection(), device=card))
    before = cuda_splat.LAUNCHES["splat_tiles"]
    frame = fastsplat.render_scene_auto(*args, width=320, height=200)
    torch.cuda.synchronize()
    assert cuda_splat.LAUNCHES["splat_tiles"] == before + 1
    assert frame.shape == (200, 320, 3) and float(frame.max()) > 0
    plain = fastsplat.render_scene_fast(*args, width=320, height=200,
                                        backend="torch")
    assert float((frame - plain).abs().max()) < 1e-4
    assert rasterizer.to_u8(frame).max() > 0


@pytest.mark.parametrize("wire", ["f32", "u16"])
def test_snapshot_wires_on_the_card(card, wire):
    """A snapshot is copied into pinned host memory behind a CUDA event;
    finishing it waits for that event only. f32 is exact; u16 within one
    quantization step of the box."""
    from spacetpu_torch import engine

    state = presets.random_cluster(4096, seed=2).state()
    handle = engine._snapshot_begin(state, wire)
    assert all(a.is_pinned() for a in handle.arrays)
    assert handle.event is not None
    snap = engine._snapshot_finish(handle, wire)
    pos = state.pos.cpu().numpy().astype(np.float64)
    assert snap.dtype == np.float32 and snap.shape == pos.shape
    step = (pos.max(axis=0) - pos.min(axis=0)) / 65535.0
    tol = 0.0 if wire == "f32" else step[None, :] * 0.75 + 1e-12
    assert (np.abs(snap - pos) <= tol).all()


# --- the potential energy's pair sum (ops/energy.py, csrc/direct.cu) ---


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("softening,eps,n", [("plummer", 1e-2, 5003),
                                             ("plummer", 0.0, 256),
                                             ("ref", 0.0, 5003)])
def test_pair_potential_matches_plain(card, dtype, tol, softening, eps, n):
    """Each body's sum against the plain version's, relative to itself
    (every term is >= 0): float64 1e-12, only the order of the sums
    differs; float32 1e-5, a lane's running sums over a band's columns
    joined over warps, bands and slots in a fixed order against torch's
    reduction (a few roundings of 2^-24 at each of a handful of levels).
    N = 5003 is not a multiple of a block's rows. One count a call, and
    potential_energy is -G/2 sum m_i times it."""
    pos, mass = _bodies(n, seed=n + 3, dtype=dtype, dev=card)
    before = energy.LAUNCHES["pair_potential"]
    got = energy.pair_potential(pos, mass, softening=softening, eps=eps)
    torch.cuda.synchronize()
    assert energy.LAUNCHES["pair_potential"] == before + 1
    want = energy.pair_potential_plain(pos, mass, softening=softening,
                                       eps=eps)
    assert float(((got - want).abs() / want.abs()).max()) <= tol
    pe = energy.potential_energy(pos, mass, softening=softening, eps=eps,
                                 g=1.0)
    assert energy.LAUNCHES["pair_potential"] == before + 2
    ref = -0.5 * float(torch.sum(mass.double() * want.double()))
    assert abs(float(pe) - ref) <= tol * abs(ref)


def _potential_id(case):
    dtype, law, eps, blocks, close = case
    return f"{str(dtype)[6:]}-{law}-{eps}-{blocks}-{close}"


@pytest.mark.parametrize("case", chip_smoke.POTENTIAL_CASES,
                         ids=_potential_id)
def test_pair_potential_blocks_and_close_pairs(card, case):
    """chip_smoke.POTENTIAL_CASES: one block (N < its rows), an odd and an
    even count of blocks (the last offset, B / 2, taken by half of them),
    and at eps = 0 a coincident pair (0) and a pair whose float32 d^2 is
    subnormal (the clamp), across blocks and inside one: each body within
    the hold of the plain version's, two calls bit for bit, one count
    each, and the kernel launches that the C entry reports those of the
    schedule (the diagonal, a band each, the join)."""
    dtype, law, eps, blocks, close = case
    rows = energy.potential_rows(dtype)
    n = chip_smoke.potential_size(rows, blocks)
    if close:
        pos, mass = potential_sym.close_pairs_case(
            n, rows, dtype, card, seed=n, across=close == "across")
    else:
        pos, mass = _bodies(n, seed=n + 3, dtype=dtype, dev=card)
    before = energy.LAUNCHES["pair_potential"]
    kernels = energy.KERNEL_LAUNCHES["pair_potential_kernels"]
    got = energy.pair_potential(pos, mass, softening=law, eps=eps)
    again = energy.pair_potential(pos, mass, softening=law, eps=eps)
    assert energy.LAUNCHES["pair_potential"] == before + 2
    assert energy.KERNEL_LAUNCHES["pair_potential_kernels"] == kernels + 2 * (
        potential_sym.launches_per_call(n, rows, energy.POTENTIAL_SLOTS))
    assert torch.equal(got, again)
    want = energy.pair_potential_plain(pos, mass, softening=law, eps=eps)
    assert float(((got - want).abs() / want.abs()).max()) <= (
        chip_smoke.POTENTIAL_TOL[dtype])
    if close:
        assert float(got[3]) > 1e18


def test_pair_potential_many_bands_are_deterministic(card):
    """N = 65,537 float32 (129 blocks of 512, 64 offsets: 4 bands of 16):
    two calls bit for bit, within 1e-5 of the plain version."""
    pos, mass = _bodies(65537, seed=5, dtype=torch.float32, dev=card)
    rows = energy.potential_rows(torch.float32)
    assert len(energy.potential_bands(65537, rows,
                                      energy.POTENTIAL_SLOTS)) >= 4
    got = energy.pair_potential(pos, mass, eps=0.0)
    assert torch.equal(got, energy.pair_potential(pos, mass, eps=0.0))
    want = energy.pair_potential_plain(pos, mass, eps=0.0)
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5


def test_pair_potential_refuses_a_wrong_schedule(card, monkeypatch):
    """The C entry checks that the bands cover the half ring in order, each
    at most `slots` wide; the wrapper raises on its error and counts
    nothing, neither a call nor a kernel."""
    pos, mass = _bodies(5003, seed=8, dtype=torch.float32, dev=card)
    bands = energy.potential_bands
    for wrong in (lambda n, r, s: bands(n, r, s)[1:],
                  lambda n, r, s: bands(n, r, s) + [(r, r)],
                  lambda n, r, s: [(1, 1), (3, n // r // 2 + 1)]):
        monkeypatch.setattr(energy, "potential_bands", wrong)
        before = energy.LAUNCHES["pair_potential"]
        kernels = energy.KERNEL_LAUNCHES["pair_potential_kernels"]
        with pytest.raises(RuntimeError, match="pair_potential"):
            energy.pair_potential(pos, mass, eps=0.0)
        assert energy.LAUNCHES["pair_potential"] == before
        assert energy.KERNEL_LAUNCHES["pair_potential_kernels"] == kernels
