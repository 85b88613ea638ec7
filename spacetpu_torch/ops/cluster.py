"""Static-shape clusterings of curve-sorted bodies for the clustered tree
(PyTorch).

The counterpart of `spacetpu/ops/cluster.py`. Every partition is expressed
as a `Clusters` gather plan over the sorted body order, so the rest of the
tree (statistics, multipoles, near lists, pair kernels) does not depend on
how the clusters were formed: in equal-count runs (`equal_clusters`) or
adapted to the local density (`adaptive_clusters`).

The adaptive partition restores an octree's density adaptivity without its
pointers or dynamic shapes: every body finds the deepest cell of the deep
Hilbert curve (a prefix of its two-word key, `morton.hilbert_keys_2w`)
that still holds more than `leaf` bodies, its "parent" cell, and each
maximal run of consecutive same-parent bodies is split into equal-count
clusters of at most `leaf`. The cluster count stays below
3 * ceil(N / leaf), and the whole construction is sorts, scans and
gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spacetpu_torch.ops import morton
from spacetpu_torch.state import resolve_device


class Clusters(NamedTuple):
    """Static-shape partition of N sorted bodies into g_cap clusters.

    slot[g, j]   index into the *sorted* body arrays for slot j of cluster
                 g; padded slots repeat a real body (so centroids and radii
                 never see foreign positions).
    mask[g, j]   True where the slot holds a real body.
    body_slot[i] flat (g * leaf + j) slot of sorted body i: the inverse
                 gather that reads per-body results back out of packed
                 (G, leaf) blocks.
    n_clusters   actual cluster count (<= g_cap; trailing clusters empty).
    overflow     1 if an adaptive build exceeded g_cap and fell back to the
                 equal-count split (always 0 for the equal partition).
    """

    slot: torch.Tensor
    mask: torch.Tensor
    body_slot: torch.Tensor
    n_clusters: torch.Tensor
    overflow: torch.Tensor


def equal_clusters(n: int, leaf: int, g_cap: int, *, device=None) -> Clusters:
    """Consecutive equal-count runs of `leaf` sorted bodies, on the card
    unless the caller names another device (raises without a card)."""
    device = resolve_device(device)
    flat = torch.arange(g_cap * leaf, device=device)
    slot = torch.clamp_max(flat, n - 1).reshape(g_cap, leaf)
    mask = (flat < n).reshape(g_cap, leaf)
    body_slot = torch.arange(n, device=device)
    g_used = (n + leaf - 1) // leaf
    return Clusters(
        slot, mask, body_slot,
        torch.tensor(g_used, device=device), torch.tensor(0, device=device),
    )


def _cid_to_clusters(cid, n: int, leaf: int, g_cap: int,
                     overflow) -> Clusters:
    """The gather plan from sorted-order cluster ids (non-decreasing,
    starting at 0)."""
    dev = cid.device
    grange = torch.arange(g_cap, device=dev)
    cstart = torch.searchsorted(cid, grange)
    ccount = torch.searchsorted(cid, grange, right=True) - cstart
    j = torch.arange(leaf, device=dev)[None, :]
    # padded slots repeat the cluster's last real body; empty clusters clamp
    # to body 0 (their mask is all False)
    slot = cstart[:, None] + torch.minimum(
        j, torch.clamp_min(ccount - 1, 0)[:, None])
    slot = torch.clamp(slot, 0, n - 1)
    mask = j < ccount[:, None]
    body_slot = cid * leaf + (torch.arange(n, device=dev) - cstart[cid])
    return Clusters(slot, mask, body_slot, cid[-1] + 1, overflow)


def _runs(flag, idx, n: int):
    """(start, end) of the run that holds each position, for runs that begin
    where `flag` is True (flag[0] must be True): a prefix max of the run
    starts and a suffix min of the next run's start."""
    start = torch.cummax(torch.where(flag, idx, 0), dim=0).values
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(flag, idx, n), (0,)),
                                  dim=0).values, (0,))
    end = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    return start, end


def adaptive_clusters(hi_sorted, lo_sorted, n: int, leaf: int, g_cap: int,
                      *, device=None) -> Clusters:
    """Density-adaptive partition from sorted two-word deep Hilbert keys,
    on the card unless the caller names another device (raises without a
    card).

    For each sorted body: scan depths 1..2*BITS2/2 (10 per key word) for
    the deepest prefix cell holding more than `leaf` bodies (cell start and
    end from boundary flags and prefix scans), then split each run of
    bodies with the same parent cell into ceil(count/leaf) equal buckets.
    Falls back to the equal-count split, and sets ``overflow`` to 1, if the
    partition would exceed g_cap (it cannot when g_cap >= 2*ceil(n/leaf))."""
    dev = resolve_device(device)
    hi, lo = hi_sorted.to(dev), lo_sorted.to(dev)
    idx = torch.arange(n, device=dev)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    parent_start = torch.zeros(n, dtype=torch.int64, device=dev)
    parent_count = torch.full((n,), n, dtype=torch.int64, device=dev)
    bits = morton.BITS2 // 2  # 10 bit-planes a word
    for d in range(1, 2 * bits + 1):
        if d <= bits:
            s = 3 * (bits - d)
            neq = (hi[1:] >> s) != (hi[:-1] >> s)
        else:
            s = 3 * (2 * bits - d)
            neq = (hi[1:] != hi[:-1]) | ((lo[1:] >> s) != (lo[:-1] >> s))
        start, end = _runs(torch.cat([first, neq]), idx, n)
        cnt = end - start
        better = cnt > leaf
        parent_start = torch.where(better, start, parent_start)
        parent_count = torch.where(better, cnt, parent_count)

    # Bodies choosing the same parent cell need not be contiguous: a denser
    # sub-cell inside the parent claims its own bodies and splits the
    # parent's remainder into several runs. Each maximal run of same-parent
    # bodies ((start, count) identifies the cell) is split on its own.
    pflag = torch.cat([first, (parent_start[1:] != parent_start[:-1])
                       | (parent_count[1:] != parent_count[:-1])])
    run_start, run_end = _runs(pflag, idx, n)
    run_len = run_end - run_start
    nsub = -(-run_len // leaf)
    bucket = -(-run_len // nsub)
    sub = (idx - run_start) // bucket
    newflag = pflag | torch.cat([~first, sub[1:] != sub[:-1]])
    cid = torch.cumsum(newflag, dim=0) - 1
    over = cid[-1] + 1 > g_cap
    cid = torch.where(over, idx // leaf, cid)
    return _cid_to_clusters(cid, n, leaf, g_cap, over.to(torch.int64))


def gather_clusters(pos_sorted, mass_sorted, clusters: Clusters):
    """Packed (G, leaf, 3) positions and (G, leaf) masses (zero where
    padded) from sorted body arrays."""
    pos_g = pos_sorted[clusters.slot]
    mass_g = torch.where(clusters.mask, mass_sorted[clusters.slot], 0.0)
    return pos_g, mass_g


def unsort_slots(acc_slots, clusters: Clusters, inv):
    """Read per-body results out of packed (G*leaf, ...) slot-order blocks
    back into the caller's body order. inv: sorted position of body i."""
    return acc_slots[clusters.body_slot[inv]]


def g_cap_for(n: int, leaf: int, multiple: int = 1) -> int:
    """A cluster-count cap that the adaptive partition can never overflow:
    < 3*ceil(n/leaf), rounded up to `multiple`."""
    cap = 3 * ((n + leaf - 1) // leaf)
    return -(-cap // multiple) * multiple
