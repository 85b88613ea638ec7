"""Static-shape clusterings of curve-sorted bodies for the clustered tree
(PyTorch).

The counterpart of `spacetpu/ops/cluster.py`. Every partition is expressed
as a `Clusters` gather plan over the sorted body order, so the rest of the
tree (statistics, multipoles, near lists, pair kernels) does not depend on
how the clusters were formed. Only the equal-count partition is ported;
the density-adaptive one (`adaptive_clusters`) is not yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
