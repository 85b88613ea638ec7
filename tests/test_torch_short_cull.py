"""The walks of the short-range kernels with the poly split
(`spacetpu_torch/csrc/tree.cu`: `pairs_cut_kernel`, which `pairs_short` and
`pairs_short_hybrid` share), on the CPU through the plain helpers of
`spacetpu_torch.ops.cuda_tree` (`short_pair_counts`, `cut_gap_ratio`), on
small TreePM tile lists built by the port's `treepm_prep`
(`tests/pair_hold.py`: `short_inputs`); and the tile lists that
`pairs_quad_shared`'s blocks walk.

- `short_pair_counts` (listed, in-cutoff and evaluated pairs) against a
  numpy brute force that stages, chunks and boxes each tile in loops, as
  the kernel does;
- no in-cutoff pair ever lies in a skipped chunk;
- `tests/pair_hold.py: near_pairs_short_cut_plain` and
  `near_pairs_short_hybrid_cut_plain` (the plain sums over the evaluated
  pairs) equal `near_pairs_short_plain` and
  `near_pairs_short_hybrid_plain` bit for bit, and a skip 25% inside r_cut
  fails the float32 limit of `tests/pair_hold.py`;
- `tree.shared_pair_segments` gives every member cluster of a super the same
  sequence of source tiles (so clusters 2b and 2b + 1 share each staged
  strip), with and without drops, and `pair_hold.unpaired_shared_case`, the
  list that breaks that pairing, is what its plain version says.

The kernels themselves are held on the card (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu_torch.ops import cuda_tree
from spacetpu_torch.ops import tree as tree_ops
from tests import pair_hold
from tests.parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _inputs(n, leaf, rcut, dtype):
    prep, rows = pair_hold.short_inputs(n, leaf, rcut, dtype, CPU)
    return (prep["pos_g"], rows[False], prep["near_flat"],
            prep["near_tile_tgt"])


def _brute_counts(args, rcut):
    """(listed, in_cutoff, evaluated) by loops: each tile's live clusters,
    `cut_cap` a stage, chunks of 32 staged entries, warps of 32 target
    slots; a (warp, chunk) is evaluated unless its boxes' gap^2 / rcut^2 >=
    1. Asserts that no pair inside r_cut lies in a skipped one."""
    pos_g, srows, flat, ttgt = (x.numpy() for x in args)
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    table = srows[:4].reshape(4, -1, block)
    n_src = table.shape[1] - 1
    pj = flat.size // ttgt.size
    cap = max(1, 32768 // (4 * pos_g.itemsize) // block)
    f = pos_g.dtype.type
    inv_rc2 = f(1.0 / (rcut * rcut))
    listed = need = evaluated = 0
    for k, a in enumerate(ttgt):
        if a >= gg:
            continue
        ids = [c for c in flat[k * pj:(k + 1) * pj] if 0 <= c < n_src]
        for s0 in range(0, len(ids), cap):
            src = np.concatenate([table[:, c] for c in ids[s0:s0 + cap]], 1)
            for q0 in range(0, src.shape[1], 32):
                chunk = src[:, q0:q0 + 32]
                lo_s, hi_s = chunk[:3].min(1), chunk[:3].max(1)
                for w0 in range(0, leaf, 32):
                    tgt = pos_g[a, w0:w0 + 32]
                    lo_t, hi_t = tgt.min(0), tgt.max(0)
                    gap = np.maximum(np.maximum(lo_s - hi_t, lo_t - hi_s),
                                     f(0))
                    g2 = gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2]
                    d = chunk[None, :3, :] - tgt[:, :, None]
                    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] \
                        + d[:, 2] * d[:, 2]
                    inside = (chunk[3][None] != 0) & (r2 > 0) \
                        & (r2 * inv_rc2 < 1)
                    listed += r2.size
                    need += int(inside.sum())
                    if g2 * inv_rc2 < 1:
                        evaluated += r2.size
                    else:
                        assert not inside.any()
    return listed, need, evaluated


@pytest.mark.parametrize("n,leaf,rcut,dtype", [
    (1500, 15, 0.35, torch.float32),   # chunks span two clusters
    (1500, 15, 0.8, torch.float64),    # two stages a tile (cap 64 of 128)
    (2000, 31, 0.5, torch.float32),
    (3000, 63, 0.5, torch.float64)])   # two warps, two stages a tile
def test_counts_match_brute_force(n, leaf, rcut, dtype):
    args = _inputs(n, leaf, rcut, dtype)
    got = cuda_tree.short_pair_counts(*args, rcut=rcut)
    listed, need, evaluated = _brute_counts(args, rcut)
    assert got == dict(listed=listed, in_cutoff=need, evaluated=evaluated,
                       in_cutoff_skipped=0)
    valid = int((args[2] < args[0].shape[0]).sum())
    assert listed == valid * leaf * (leaf + 1)
    # the walk leaves out some chunks, and keeps every pair it needs
    assert need < evaluated < listed


def test_stage_capacity():
    """32 KB of staged sources: a whole 2048-entry tile in float32."""
    assert cuda_tree.cut_cap(255, torch.float32) == 8
    assert cuda_tree.cut_cap(255, torch.float64) == 4
    assert cuda_tree.cut_cap(15, torch.float32) == 128
    assert cuda_tree.cut_cap(1023, torch.float64) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("softening,eps", [("plummer", 0.0),
                                           ("plummer", 1e-2), ("ref", 0.0),
                                           ("ref", 1e-2)])
def test_cut_sum_equals_the_full_sum_bit_for_bit(softening, eps, dtype):
    """The pairs of the skipped chunks add exactly 0: leaving them out
    changes no bit of the plain result."""
    args = _inputs(2000, 31, 0.5, dtype)
    kw = dict(softening=softening, eps=eps, rcut=0.5)
    full = cuda_tree.near_pairs_short_plain(*args, rs=0.5 / 4.5,
                                            split="poly", **kw)
    cut = pair_hold.near_pairs_short_cut_plain(*args, **kw)
    assert torch.equal(cut, full)
    assert float(full.abs().max()) > 0.0


def test_a_skip_inside_the_cutoff_fails_the_hold():
    """Chunks whose gap is 25% inside r_cut left out: outside the float32
    limit, where the walk's own skip stays far inside it."""
    args = _inputs(2000, 31, 0.5, torch.float32)
    kw = dict(softening="plummer", eps=0.0, rs=0.5 / 4.5, rcut=0.5,
              split="poly")
    exact = pair_hold.exact_sums("pairs_short", args, kw)
    cut = dict(softening="plummer", eps=0.0, rcut=0.5)
    right = pair_hold.near_pairs_short_cut_plain(*args, **cut)
    wrong = pair_hold.near_pairs_short_cut_plain(*args, **cut,
                                                 skip_at=0.75 ** 2)
    assert pair_hold.hold(right, exact)["ok"]
    assert pair_hold.hold(wrong, exact)["hold_ratio"] > pair_hold.F32_TOL


def test_edge_pairs_are_checked_chunk_by_chunk():
    """`pair_hold.edge_pair_case` on the plain version: each target cluster
    gets its one edge pair's term, from chunk 0 and from chunk 1, the same
    bits; a skip one ulp early leaves both at exactly 0, and a result
    missing either chunk's term fails `edge_pair_checks`."""
    edge = pair_hold.edge_pair_case(torch.float32, CPU)
    got = cuda_tree.near_pairs_short(*edge["args"], **edge["kw"])
    assert pair_hold.edge_pair_checks(got)["ok"]
    early = pair_hold.near_pairs_short_cut_plain(
        *edge["args"], softening="plummer", eps=0.0, rcut=1.0,
        skip_at=1.0 - 2.0 ** -24)
    assert bool((early == 0).all())
    for missing in (0, 1):
        wrong = got.clone()
        wrong[missing] = 0.0
        assert not pair_hold.edge_pair_checks(wrong)["ok"]


@pytest.mark.parametrize("softening,eps,split,flops", [
    ("plummer", 0.0, "poly", 27), ("plummer", 1e-2, "poly", 37),
    ("ref", 0.0, "poly", 37), ("plummer", 0.0, "gauss", 81)])
def test_short_flops_count_the_function(softening, eps, split, flops):
    """The bound of rows 10-11 counts the flops of the function the case
    runs: at plummer eps 0 with the poly split g m (1 - G(y)) / r^3, 13 for
    the weight (pair.cuh: PolyLean) where ShortWeight takes 23; the hybrid
    sums 2 more."""
    kw = dict(softening=softening, eps=eps, split=split)
    assert chip_smoke.short_flops("pairs_short", kw) == flops
    assert chip_smoke.short_flops("pairs_short_hybrid", kw) == flops + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("softening,eps", [("plummer", 0.0),
                                           ("plummer", 1e-2), ("ref", 0.0),
                                           ("ref", 1e-2)])
def test_hybrid_cut_sum_equals_the_full_sum_bit_for_bit(softening, eps,
                                                        dtype):
    """pairs_short_hybrid's walk: every pair of a skipped chunk has w
    exactly 0, so w (x_s - c) and w add exactly 0 to the centred sums, and
    leaving them out changes no bit of the plain result."""
    args = _inputs(1500, 15, 0.35, dtype)
    kw = dict(softening=softening, eps=eps, rcut=0.35)
    full = cuda_tree.near_pairs_short_hybrid_plain(*args, rs=0.35 / 4.5,
                                                   split="poly", **kw)
    cut = pair_hold.near_pairs_short_hybrid_cut_plain(*args, **kw)
    assert torch.equal(cut, full)
    assert float(full.abs().max()) > 0.0


def test_a_hybrid_skip_inside_the_cutoff_fails_the_hold():
    """pairs_short_hybrid's walk with its skip 25% inside r_cut: outside the
    float32 limit of the centred sums, where the walk stays inside it."""
    args = _inputs(2000, 31, 0.5, torch.float32)
    kw = dict(softening="plummer", eps=0.0, rs=0.5 / 4.5, rcut=0.5,
              split="poly")
    exact = pair_hold.exact_sums("pairs_short_hybrid", args, kw)
    right = pair_hold.near_pairs_short_hybrid_cut_plain(
        *args, softening="plummer", eps=0.0, rcut=0.5)
    assert pair_hold.hold(right, exact)["ok"]
    assert pair_hold.skip_inside_ratio(
        args, kw, exact, 0.25, "pairs_short_hybrid") > pair_hold.F32_TOL


def test_hybrid_edge_pairs_are_checked_chunk_by_chunk():
    """`pair_hold.edge_pair_case` in the centred form: the targets sit at
    their cluster's first body, so each gets pairs_short's term bit for bit;
    a skip one ulp early leaves both clusters at exactly 0."""
    edge = pair_hold.edge_pair_case(torch.float32, CPU)
    got = cuda_tree.near_pairs_short_hybrid(*edge["args"], **edge["kw"])
    assert pair_hold.edge_pair_checks(got)["ok"]
    assert torch.equal(got, cuda_tree.near_pairs_short(*edge["args"],
                                                       **edge["kw"]))
    early = pair_hold.near_pairs_short_hybrid_cut_plain(
        *edge["args"], softening="plummer", eps=0.0, rcut=1.0,
        skip_at=1.0 - 2.0 ** -24)
    assert bool((early == 0).all())


@pytest.mark.parametrize("short_by", [None, 1, "last super"])
def test_shared_segments_give_a_super_one_tile_sequence(short_by):
    """The pairing that pairs_quad_shared's blocks rely on: every member
    cluster of a super owns the same sequence of tile_src (so clusters 2b
    and 2b + 1 share each strip), uncapped, with the last super's strip cut
    short by one tile (a partial strip keeps its prefix) and with it
    dropped whole."""
    rng = np.random.default_rng(11)
    g2, w, n_src = 3, 300, 96
    ids = torch.as_tensor(rng.integers(0, n_src + 1, size=(g2, w)))
    st = torch.clamp_min(-(-(ids < n_src).sum(1) // tree_ops.NEAR_QUAD_PJ),
                         1)
    cap = None
    if short_by is not None:
        cap = int(st.sum()) - (int(st[-1]) if short_by == "last super"
                               else short_by)
    _, tgt, src, _, dropped = tree_ops.shared_pair_segments(ids, n_src,
                                                            cap_src=cap)
    assert (int(dropped) > 0) == (cap is not None)
    gg = g2 * tree_ops.SUPER
    starts = cuda_tree.tile_starts(tgt, gg).tolist()
    seqs = [src[starts[c]:starts[c + 1]].tolist() for c in range(gg)]
    kept = [len(seqs[b * tree_ops.SUPER]) for b in range(g2)]
    want = st.tolist()
    if short_by is not None:
        want[-1] -= int(st[-1]) if short_by == "last super" else short_by
    assert kept == want
    for c in range(gg):
        assert seqs[c] == seqs[c - c % tree_ops.SUPER]
    for b in range(gg // 2):
        assert seqs[2 * b] == seqs[2 * b + 1]


def test_unpaired_case_is_each_clusters_own_sum():
    """`pair_hold.unpaired_shared_case` (paired clusters that do not share
    their tiles, an odd G, a cluster with no tiles, an all-null tile) on
    the plain version: each cluster's float64 quadrupole sum over its own
    tiles' ids, within 1e-12 of the largest term."""
    case = pair_hold.unpaired_shared_case(torch.float64, CPU)
    pos_g, summ, flat, _, _ = case["args"]
    got = cuda_tree.near_pairs_quad_shared(*case["args"], **case["kw"])
    got = got.reshape(pos_g.shape)
    strips = flat.reshape(-1, cuda_tree.NEAR_QUAD_PJ)
    for c, tiles in enumerate(pair_hold.UNPAIRED_TILES):
        ids = strips[tiles].reshape(-1)
        want = pair_hold.quad_exact_sums(pos_g[c:c + 1], summ[None, :, ids],
                                         case["kw"]["eps"])[0]
        err = float((got[c] - want[:, :3]).abs().max())
        assert err <= 1e-12 * max(float(want[:, 3:].max()), 1.0), c
    assert float(got[4].abs().max()) == 0.0
