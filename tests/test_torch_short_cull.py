"""The pairs of `pairs_short`'s walk with the poly split
(`spacetpu_torch/csrc/tree.cu`: `pairs_cut_kernel`), on the CPU through the
plain helpers of `spacetpu_torch.ops.cuda_tree` (`short_pair_counts`,
`cut_gap_ratio`), on small TreePM tile lists built by the port's
`treepm_prep` (`tests/pair_hold.py`: `short_inputs`).

- `short_pair_counts` (listed, in-cutoff and evaluated pairs) against a
  numpy brute force that stages, chunks and boxes each tile in loops, as
  the kernel does;
- no in-cutoff pair ever lies in a skipped chunk;
- `tests/pair_hold.py: near_pairs_short_cut_plain` (the plain sum over
  the evaluated pairs) equals `near_pairs_short_plain` bit for bit, and a skip 25% inside r_cut
  fails the float32 limit of `tests/pair_hold.py`.

The kernel itself is held on the card (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu_torch.ops import cuda_tree
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
