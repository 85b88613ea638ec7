"""Distributed sort over a group of ranks: bitonic merge-exchange (PyTorch).

The counterpart of `spacetpu/parallel/dsort.py`. The sharded tree needs
the global body array in space-filling-curve order with each rank holding
exactly N/D rows. After a local sort, partner ranks exchange whole shards
(one `batch_isend_irecv` each way) and each keeps the lower or upper half
of the merged pair, on the bitonic schedule: log2(D) (log2(D) + 1) / 2
rounds, every shard N/D rows at every round. D must be a power of two.

Every rank of the group calls `bitonic_sort_sharded` with its own shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sort_rows(key, payload):
    """Stable-sort rows by key; the payload rows follow their keys (any
    trailing dims)."""
    perm = torch.sort(key, stable=True).indices
    return key[perm], [p[perm] for p in payload]


def _merge_keep(key_a, pay_a, key_b, pay_b, keep_low: bool,
                mine_first: bool):
    """Merge two locally sorted shards and keep the low or the high half.

    Both partners must sort the same concatenated sequence: with duplicate
    keys, a stable sort of concat(A, B) and of concat(B, A) break ties
    differently, and the two kept halves would not partition the pair.
    `mine_first` pins one order on both sides (the lower rank's shard
    first)."""
    m = key_a.shape[0]
    first, second = ((key_a, pay_a), (key_b, pay_b)) if mine_first else (
        (key_b, pay_b), (key_a, pay_a))
    keys = torch.cat([first[0], second[0]])
    pays = [torch.cat([a, b]) for a, b in zip(first[1], second[1])]
    keys, pays = _sort_rows(keys, pays)
    lo = 0 if keep_low else m
    return keys[lo:lo + m], [p[lo:lo + m] for p in pays]


def _exchange(arrays, peer: int, group):
    """Send `arrays` to `peer` and receive its arrays of the same shapes."""
    got = [torch.empty_like(a) for a in arrays]
    # a tag each: gloo matches a send to its receive by peer and tag
    ops = [dist.P2POp(dist.isend, a.contiguous(), peer, group, tag=t)
           for t, a in enumerate(arrays)]
    ops += [dist.P2POp(dist.irecv, b, peer, group, tag=t)
            for t, b in enumerate(got)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return got


def bitonic_sort_sharded(key, *payload, group=None):
    """Globally sort (key, *payload) rows across the ranks of `group` (None:
    the default group).

    key: (m,) this rank's shard of the sort key; payload: tensors with
    leading dim m that travel with their key. Returns the same structure,
    ascending across the ranks (rank r holds ranks [r*m, (r+1)*m) of the
    global order). The group's size must be a power of two."""
    n_dev = dist.get_world_size(group)
    if n_dev & (n_dev - 1):
        raise ValueError(
            f"bitonic mesh size must be a power of 2, got {n_dev}")
    rank = dist.get_rank(group)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    key, payload = _sort_rows(key, list(payload))
    n_bits = n_dev.bit_length() - 1
    for stage in range(n_bits):  # block size 2^(stage+1)
        for sub in range(stage, -1, -1):  # partner distance 2^sub
            other = _exchange([key, *payload], peer(rank ^ (1 << sub)),
                              group)
            # ascending iff bit stage+1 of the rank is 0; keep the low half
            # iff this rank is the lower partner of an ascending pair (or
            # the upper partner of a descending one)
            ascending = (rank >> (stage + 1)) & 1 == 0
            is_lower = (rank >> sub) & 1 == 0
            key, payload = _merge_keep(key, payload, other[0], other[1:],
                                       ascending == is_lower, is_lower)
    return (key, *payload)
