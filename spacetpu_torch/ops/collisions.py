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

`merge_closest` merges the globally closest overlapping pair, if any, with
plain tensor ops on the state's device and the nearest-neighbour pass of
`ops/encounters.py` (the ``nearest_neighbor`` kernel on the card). Nothing
is read back. `merge_all_overlapping` loops on the host, one readback of
``merged`` a merge, because each merge changes the geometry.
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


def merge_closest(state: State, radii, *, chunk: int = 4096) -> MergeResult:
    """Merge the globally closest overlapping pair of live bodies, if any.

    radii: (N,) collision radii; a row of radius 0 is dead (what an
    absorbed body becomes) and takes no part in the pair search. The
    absorbed body's Kahan rows, and both rows' acceleration cache, are
    zeroed: refreshing the cache (`prime`) is the caller's job."""
    pos = state.pos
    radii = torch.as_tensor(radii, dtype=pos.dtype, device=pos.device)
    alive = radii > 0
    d, i, j = encounters.min_separation(pos, mask=alive, chunk=chunk)
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


def merge_all_overlapping(state: State, radii, *, max_merges: int = 8,
                          chunk: int = 4096):
    """Resolve up to max_merges overlapping pairs (a host loop of
    merge_closest). Returns (state, radii, n_merged, energy_lost)."""
    n_merged = 0
    e_lost = 0.0
    for _ in range(max_merges):
        r = merge_closest(state, radii, chunk=chunk)
        if not bool(r.merged):
            break
        state, radii = r.state, r.radii
        e_lost += float(r.energy_lost)
        n_merged += 1
    return state, radii, n_merged, e_lost
