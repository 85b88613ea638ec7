"""The quadrupole list kernels on the CPU: `pairs_quad` and `quad_strip`
(spacetpu_torch/csrc/tree.cu: quad_list_kernel, one template for both).

The kernel runs only on the card (tests/test_torch_gpu.py holds it against
the plain versions on `pair_hold`'s ragged cases). Here: the ragged cases
themselves (a live id on each side of a chunk boundary and of a staging
window, a chunk of nulls only, a cluster with no tiles, a range longer than
one window); the plain versions on them against the JAX package's Pallas
launch forms in interpret mode (`tree._near_pairs_quad_pallas`,
`tree._near_multipole_sub_pallas`) on the same numpy inputs, in float64
within 1e-12 of max|a| (the same arithmetic, sums in another order); and
the kernel's order of the sums, emulated on the terms of the plain
version's arithmetic in float32: packing the live slots of each window and
restarting a target's partial sum every `chunk` slots gives the sums of
the one-target kernels it replaced (every slot swept, a null one as a zero
summary) bit for bit, and a wrong schedule does not."""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import cuda_tree
from tests import pair_hold, parity
from tests.parity import one_torch_thread  # noqa: F401

TREE_CU = (pathlib.Path(cuda_tree.__file__).resolve().parents[1] / "csrc"
           / "tree.cu").read_text()
PJ = cuda_tree.NEAR_QUAD_PJ


def _close(got, want, tol=1e-12):
    want = torch.as_tensor(np.array(want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _ranges(kind, leaf, dtype, pj=PJ):
    """(targets (G, leaf, 3), summaries, [slot ids of each cluster's range],
    chunk) of a ragged case, eps 1e-2."""
    if kind == "pairs_quad":
        tgt, summ, flat, tile_tgt = pair_hold.pairs_quad_case(
            leaf, pj, 1e-2, dtype, "cpu")
        tiles = flat.reshape(-1, pj)
        rows = [tiles[tile_tgt == a].reshape(-1) for a in range(tgt.shape[0])]
        return tgt, summ, rows, pj
    tgt, summ, idx = pair_hold.quad_strip_case(leaf, 1e-2, dtype, "cpu")
    return tgt, summ, list(idx), pair_hold.pair_threads(leaf)


def test_pairs_quad_case_covers_the_edges():
    """Cluster 0 live on both sides of its tile boundary, 1 without tiles,
    2 a tile of nulls only, 3 past one staging window with live ids on both
    sides of it, padding aimed at G; at pj = 96 cluster 3's tile 5 straddles
    the window."""
    for pj in (PJ, 96):
        tgt, summ, flat, tile_tgt = pair_hold.pairs_quad_case(
            31, pj, 0.0, torch.float64, "cpu")
        null = summ.shape[1] - 1
        assert null == pair_hold.QUAD_LIST_SRC and summ.stride(0) > null + 1
        assert bool((summ[:, null] == 0).all())
        starts = cuda_tree.tile_starts(tile_tgt, tgt.shape[0])
        rows = [flat[starts[a] * pj:starts[a + 1] * pj]
                for a in range(tgt.shape[0])]
        assert rows[0][pj - 1] < null and rows[0][pj] < null
        assert rows[1].numel() == 0
        assert bool((rows[2][pj:2 * pj] == null).all())
        assert rows[3].numel() > pair_hold.QUAD_LIST_WINDOW
        assert rows[3][511] < null and rows[3][512] < null
        assert bool((rows[4] < null).all()) and bool((rows[5] == null).all())
        assert int((tile_tgt == tgt.shape[0]).sum()) == 2
        assert torch.equal(tgt[0, 0], summ[:3, int(rows[0][pj - 1])])
    assert pair_hold.QUAD_LIST_WINDOW % 96 and (511 // 96) == (512 // 96)


def test_quad_strip_case_covers_the_edges():
    """Row 0 live on both sides of a chunk boundary and of the staging
    window, row 1 nulls only, row 2 a chunk of nulls, K past one window; at
    leaf 95 a chunk of 96 slots straddles the window."""
    for leaf in pair_hold.QUAD_LIST_LEAVES:
        tgt, summ, idx = pair_hold.quad_strip_case(leaf, 0.0, torch.float64,
                                                   "cpu")
        null, chunk = summ.shape[1] - 1, pair_hold.pair_threads(leaf)
        assert idx.shape == (5, pair_hold.QUAD_LIST_K)
        assert pair_hold.QUAD_LIST_K > pair_hold.QUAD_LIST_WINDOW
        assert bool((idx[0, [chunk - 1, chunk, 511, 512]] < null).all())
        assert bool((idx[1] == null).all())
        assert bool((idx[2, chunk:2 * chunk] == null).all())
        assert bool((idx[3] < null).all())
        assert torch.equal(tgt[0, 0], summ[:3, int(idx[0, 0 + chunk - 1])])
    assert pair_hold.pair_threads(95) == 96


@pytest.mark.parametrize("eps", [1e-2, 0.0])
@pytest.mark.parametrize("leaf", [15, 63])
def test_pairs_quad_ragged_plain_matches_jax(monkeypatch, leaf, eps):
    """`_near_pairs_quad_pallas` (interpret mode, 8 tiles a launch so that
    the tile list takes two) against `near_pairs_quad` on the CPU."""
    monkeypatch.setattr(jtree, "NEAR_QUAD_CHUNK", 8)
    tgt, summ, flat, tile_tgt = pair_hold.pairs_quad_case(
        leaf, PJ, eps, torch.float64, "cpu")
    want = parity.call(jtree._near_pairs_quad_pallas, tgt.numpy(),
                       summ.contiguous().numpy(),
                       flat.numpy().astype(np.int32),
                       tile_tgt.numpy().astype(np.int32), eps=eps,
                       interpret=True)
    got = cuda_tree.near_pairs_quad(tgt, summ, flat, tile_tgt, eps=eps)
    _close(got, want)
    assert float(got.reshape(tgt.shape)[1].abs().max()) == 0.0


@pytest.mark.parametrize("eps", [1e-2, 0.0])
@pytest.mark.parametrize("leaf", [15, 95])
def test_quad_strip_ragged_plain_matches_jax(leaf, eps):
    """`_near_multipole_sub_pallas` (interpret mode; K padded to 768 with
    the null column) against `quad_strip` on the CPU."""
    tgt, summ, idx = pair_hold.quad_strip_case(leaf, eps, torch.float64,
                                               "cpu")
    tcols = parity.call(jtree._pack_targets, tgt.numpy())
    want = parity.call(jtree._near_multipole_sub_pallas, tcols,
                       summ.contiguous().numpy(),
                       idx.numpy().astype(np.int32), eps=eps,
                       interpret=True, block=leaf + 1)
    got = cuda_tree.quad_strip(tgt, summ, idx, eps=eps)
    _close(got, want)
    assert float(got.reshape(tgt.shape)[1].abs().max()) == 0.0


def _slot_terms(tgt, summ, ids):
    """(S, leaf, 3): each slot's term on each target, float32, the plain
    version's arithmetic (a null id names the zero null column)."""
    cols = summ[:, ids].T[:, :, None]
    return cuda_tree._quad_terms(tgt[None].expand(len(ids), -1, -1), cols,
                                 1e-2)


def _one_target_order(terms, chunk):
    """The one-target kernels' sums: every slot swept in order, a partial
    sum a chunk added to the total at its end."""
    acc = torch.zeros_like(terms[0])
    for c0 in range(0, terms.shape[0], chunk):
        part = torch.zeros_like(acc)
        for s in range(c0, min(c0 + chunk, terms.shape[0])):
            part = part + terms[s]
        acc = acc + part
    return acc


def _window_order(terms, live, chunk, window):
    """quad_list_kernel's sums: each window's live slots packed in slot
    order and swept, the partial sum added to the total at each chunk end
    that falls inside the window (live_before) and at the range's end."""
    acc = torch.zeros_like(terms[0])
    part = torch.zeros_like(acc)
    for w0 in range(0, len(live), window):
        lv = live[w0:w0 + window]
        packed = [w0 + i for i, x in enumerate(lv) if x]
        e, p = 0, chunk - w0 % chunk
        while True:
            ends = p <= window
            stop = sum(lv[:p]) if ends else len(packed)
            for s in packed[e:stop]:
                part = part + terms[s]
            e = stop
            if not ends:
                break
            acc, part = acc + part, torch.zeros_like(acc)
            p += chunk
    return acc + part


@pytest.mark.parametrize("kind,leaf,pj", [
    ("pairs_quad", 31, PJ), ("pairs_quad", 255, 96), ("quad_strip", 15, 0),
    ("quad_strip", 95, 0), ("quad_strip", 255, 0)])
def test_window_schedule_keeps_the_one_target_order(kind, leaf, pj):
    """Dropping the nulls (a zero summary's term is +-0, and a partial sum
    that starts at +0 is never -0) and restarting at the chunk ends inside
    each window gives the one-target order's float32 bits on every target
    of every cluster; restarting only at the window ends does not."""
    tgt, summ, rows, chunk = _ranges(kind, leaf, torch.float32, pj or PJ)
    null = summ.shape[1] - 1
    wrong = 0
    for a, ids in enumerate(rows):
        if ids.numel() == 0:
            continue
        terms = _slot_terms(tgt[a], summ, ids)
        live = [int(i) < null for i in ids]
        want = _one_target_order(terms, chunk)
        got = _window_order(terms, live, chunk, pair_hold.QUAD_LIST_WINDOW)
        assert torch.equal(got, want), (kind, leaf, a)
        per_window = _window_order(terms, live, pair_hold.QUAD_LIST_WINDOW,
                                   pair_hold.QUAD_LIST_WINDOW)
        wrong += not torch.equal(per_window, want)
    assert wrong > 0


def test_quad_list_instances_and_window():
    """chip_smoke reads the SASS of quad_list_kernel<float, QL_TARGETS>
    for both kernels, whose pair loop is unrolled 16 / NT times over NT
    targets (16 pairs a trip), and the cases' window is the kernel's."""
    nt = int(re.search(r"constexpr int QL_TARGETS = (\d+);",
                       TREE_CU).group(1))
    window = int(re.search(r"constexpr int QL_WINDOW = (\d+);",
                           TREE_CU).group(1))
    assert nt >= 2 and 16 % nt == 0 and "#pragma unroll (16 / NT)" in TREE_CU
    assert window == pair_hold.QUAD_LIST_WINDOW
    for name in ("pairs_quad", "quad_strip"):
        assert chip_smoke.MAIN_INSTANCES[name] == f"quad_list_kernelIfLi{nt}EE"
        assert chip_smoke.PAIRS_PER_LOOP[name] == 16
        assert name not in chip_smoke.LOOP_MUFU
    assert "quad_list_kernel<T, QL_TARGETS>" in TREE_CU
    for gone in ("pairs_quad_kernel", "quad_strip_kernel", "sweep_summaries"):
        assert gone not in TREE_CU
