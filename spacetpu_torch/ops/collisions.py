"""Collision handling: perfectly inelastic merging of overlapping bodies.

The counterpart of `spacetpu/ops/collisions.py`:

- a pair overlaps when its separation is below the sum of its collision
  radii (by default the scene's body radii);
- the merge is perfectly inelastic: the mass-weighted barycentre of
  position and velocity (momentum is conserved by construction), the summed
  mass, and a volume-additive radius ``(r_i^3 + r_j^3)^(1/3)``; the kinetic
  energy of the relative motion, ``0.5 m_i m_j / (m_i + m_j) |v_i - v_j|^2``,
  is lost and returned as ``energy_lost``;
- shapes never change: the absorbed body rides on as a massless tracer at
  the merged barycentre with radius 0. Rows of radius 0 are masked out of
  the pair search, so a dead tracer on its host (at distance 0) never
  shadows another encounter.

`merge_closest` merges the globally closest overlapping pair, if any: the
search (`encounters.min_separation`, the ``nearest_neighbor`` kernels on the
card) and then `merge_pair`, plain tensor ops on the state's device. Nothing
is read back. `merge_all_overlapping` loops on the host, one readback a
merge, because each merge changes the geometry; it makes one full search a
call and keeps the table (least r^2, index) across its merges: after a
merge of (i, j) only {i, j} and the rows whose neighbour was i or j are
searched again (`encounters.nearest_rows`), and every other row compares
its least with the moved body (`encounters.nearest_update`). That is the
table a full search would give, bit for bit, so the merges are those of a
loop of `merge_closest`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spacetpu_torch.ops import encounters
from spacetpu_torch.state import State


class MergeResult(NamedTuple):
    state: State
    radii: torch.Tensor
    merged: torch.Tensor  # bool scalar
    i: torch.Tensor  # the pair examined (meaningful when merged)
    j: torch.Tensor
    energy_lost: torch.Tensor  # relative-motion KE of the merged pair, else 0


def merge_pair(state: State, radii, d, i, j) -> MergeResult:
    """Merge the pair (i, j) at separation d (0-dim tensors, as
    `encounters.min_separation` gives them) where it overlaps: d below the
    sum of their radii, and not both massless. The absorbed body j's Kahan
    rows, and both rows' acceleration cache, are zeroed: refreshing the
    cache (`prime`) is the caller's job."""
    pos = state.pos
    radii = torch.as_tensor(radii, dtype=pos.dtype, device=pos.device)
    merged = d < radii[i] + radii[j]

    mi, mj = state.mass[i], state.mass[j]
    mtot = mi + mj
    # massless-massless contact: nothing to merge dynamically
    merged = merged & (mtot > 0)
    some = mtot > 0
    safe = torch.where(some, mtot, torch.ones_like(mtot))
    wi = torch.where(some, mi / safe, torch.full_like(mtot, 0.5))
    wj = 1.0 - wi
    pos_m = wi * pos[i] + wj * pos[j]
    vel_m = wi * state.vel[i] + wj * state.vel[j]
    r_m = (radii[i] ** 3 + radii[j] ** 3) ** (1.0 / 3.0)
    dv = state.vel[i] - state.vel[j]
    de = torch.where(merged, 0.5 * mi * mj / safe * torch.sum(dv * dv),
                     torch.zeros((), dtype=pos.dtype, device=pos.device))

    def apply(val, row_i, row_j):
        """val with val[i] := row_i and val[j] := row_j where merged."""
        out = val.clone()
        out[i] = torch.where(merged, row_i, val[i])
        out[j] = torch.where(merged, row_j, out[j])
        return out

    zero3 = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=state.mass.dtype, device=pos.device)
    new = state._replace(
        pos=apply(pos, pos_m, pos_m),
        vel=apply(state.vel, vel_m, vel_m),
        mass=apply(state.mass, mtot, zero),
        # the cache is stale for the merged rows: zeroed, so that a leapfrog
        # first kick cannot apply the pre-merge acceleration
        acc=apply(state.acc, zero3, zero3),
        pos_c=None if state.pos_c is None else apply(state.pos_c, zero3,
                                                     zero3),
        vel_c=None if state.vel_c is None else apply(state.vel_c, zero3,
                                                     zero3),
    )
    new_radii = apply(radii, r_m, torch.zeros((), dtype=radii.dtype,
                                              device=pos.device))
    return MergeResult(new, new_radii, merged, i, j, de)


def merge_closest(state: State, radii, *, chunk: int = 4096) -> MergeResult:
    """Merge the globally closest overlapping pair of live bodies, if any.

    radii: (N,) collision radii; a row of radius 0 is dead (what an
    absorbed body becomes) and takes no part in the pair search."""
    radii = torch.as_tensor(radii, dtype=state.pos.dtype,
                            device=state.pos.device)
    d, i, j = encounters.min_separation(state.pos, mask=radii > 0,
                                        chunk=chunk)
    return merge_pair(state, radii, d, i, j)


def merge_all_overlapping(state: State, radii, *, max_merges: int = 8,
                          chunk: int = 4096):
    """Resolve up to max_merges overlapping pairs, the merges of a loop of
    merge_closest, with one full search: the table (least r^2, index) is
    kept across the merges (the module note). A merge's readback also
    brings the number of rows the update left to search again; where they
    are more than half the rows, the full search takes them. Returns
    (state, radii, n_merged, energy_lost)."""
    pos = state.pos
    radii = torch.as_tensor(radii, dtype=pos.dtype, device=pos.device)
    n = pos.shape[0]
    alive = radii > 0
    best, idx = encounters.nearest_table(pos, alive, chunk=chunk)
    none = torch.zeros((), dtype=torch.int32, device=pos.device)
    n_merged = 0
    e_lost = 0.0
    for _ in range(max_merges):
        d, i, j = encounters.closest(best, idx, alive)
        r = merge_pair(state, radii, d, i, j)
        alive_m = r.radii > 0
        last = n_merged + 1 == max_merges
        # the update runs before the readback of `merged`; where the pair
        # did not merge, the table is dropped
        rows, count = ((None, none) if last else encounters.nearest_update(
            r.state.pos, alive_m, best, idx, i, j))
        merged, count, de = torch.stack(
            [r.merged.double(), count.double(),
             r.energy_lost.double()]).tolist()
        if not merged:
            break
        state, radii, alive = r.state, r.radii, alive_m
        e_lost += de
        n_merged += 1
        if last:
            break
        count = int(count)
        if 2 * count > n:
            best, idx = encounters.nearest_table(state.pos, alive,
                                                 chunk=chunk)
        else:
            encounters.nearest_rows(state.pos, alive, rows[:count], best,
                                    idx, chunk=chunk)
    return state, radii, n_merged, e_lost
