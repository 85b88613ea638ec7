"""Body-sharded Barnes-Hut tree over a group of ranks: O(N/D) a rank
(PyTorch).

The counterpart of `spacetpu/parallel/tree2.py` on `torch.distributed`, one
rank a device:

- **Body order**: the sharded state lives in (approximately current) global
  Hilbert order; the distributed bitonic sort (`parallel/dsort.py`)
  re-sorts it every `resort_every` steps, keyed over the box of the group's
  MIN and MAX, pad rows last. An ``ids`` tensor rides along, so that
  `user_order` restores the caller's order. Forces come out in the order
  the state is stored: nothing is permuted a step.
- **Clusters**: each rank cuts its N/D rows into LEAF-body clusters and
  computes their statistics and multipoles itself.
- **Gathers are summaries only**: one `all_gather` of each cluster's
  centre, mass, radii and 16 multipole rows (O(G)), never bodies. The near
  lists are built for the rank's own target clusters against the gathered
  summaries (the target slices of `ops/tree.py`'s builders).
- **Near-field bodies move by a halo exchange** (`_halo_exchange`): a rank
  lists the remote clusters its near lists touch, `all_gather`s per-owner
  request tables of `halo_cap` ids, and every owner answers with the
  (LEAF, 4) body blocks asked of it through one `all_to_all_single`. A
  request beyond `halo_cap` leaves its cluster at far-field accuracy and
  is counted (`diagnose`). Without a given `halo_cap`, the cap is the JAX
  package's default raised to the measured need (`_fit_halo`), at prime and
  wherever `maybe_recalibrate` finds a drop.
- **Far field**: the single-device tree's 2- or 3-level multipole pass
  over the gathered summaries, for the rank's own bodies.

Every shape a collective sees is the same on every rank: it follows from
N, D and the caps alone, and the calibration agrees its caps (the halo cap
too) over the group. The kernels are the single-device tree's
(`ops/cuda_tree.py`, `cuda_direct.acc_cross_kernel`), fed the rank's target
clusters and a pool of source clusters, [local | halo | null]; on CPU
tensors their plain versions.

`run` is a loop of `step`. The resort's tick is a host integer: no readback
a step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from spacetpu_torch import constants
from spacetpu_torch.ops import cuda_direct, cuda_tree, direct, integrators
from spacetpu_torch.ops import morton
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.parallel import dsort, ring
from spacetpu_torch.sim import SimConfig
from spacetpu_torch.state import State

LEAF = tree_ops.LEAF
BLOCK = tree_ops.BLOCK
#: the Hilbert key of a pad row: above every 30-bit key, so pad rows sort
#: last
PAD_KEY = 0xFFFFFFFF
#: the id of a slot that requests nothing (and where ids are never this
#: large)
_BIG = 2 ** 30
#: the floor of the default halo cap (the JAX package's), and the measured
#: cap's headroom over the need (measure_near's)
HALO_MIN = 64
HALO_HEADROOM = 1.25


class TreeShardedState(NamedTuple):
    """This rank's rows of the state in (approximately current) global
    Hilbert order, the caller's row of each (int64), and the resort tick
    (a host integer, the same on every rank)."""

    state: State
    ids: torch.Tensor
    tick: int


def _state_payload(state: State) -> list:
    """The per-body tensors that travel with a resort."""
    return [state.pos, state.vel, state.mass, state.acc] + [
        a for a in (state.pos_c, state.vel_c) if a is not None]


def _rebuild_state(state: State, arrs) -> State:
    it = iter(arrs)
    pos, vel, mass, acc = next(it), next(it), next(it), next(it)
    pos_c = next(it) if state.pos_c is not None else None
    vel_c = next(it) if state.vel_c is not None else None
    return state._replace(pos=pos, vel=vel, mass=mass, acc=acc,
                          pos_c=pos_c, vel_c=vel_c)


def _resort_local(state: State, ids, mesh: ring.Mesh):
    """Re-sort the group's rows globally by their current Hilbert key over
    the box of the group's MIN and MAX (pad rows, ids >= n_active, key
    PAD_KEY). A collective."""
    lo = ring.all_reduce(state.pos.amin(dim=0), dist.ReduceOp.MIN, mesh)
    hi = ring.all_reduce(state.pos.amax(dim=0), dist.ReduceOp.MAX, mesh)
    keys = morton.hilbert_keys(state.pos, lo=lo, hi=hi)
    if state.n_active is not None:
        keys = torch.where(ids >= state.n_active, PAD_KEY, keys)
    out = dsort.bitonic_sort_sharded(keys, *_state_payload(state), ids,
                                     group=mesh.group)
    return _rebuild_state(state, out[1:-1]), out[-1]


def _halo_exchange(idx_mine, pos_g, mass_g, *, mesh: ring.Mesh, g_l: int,
                   halo_cap: int, on_halo=None):
    """Fetch the bodies of the remote clusters that this rank's near lists
    name. idx_mine: (G_l, K) GLOBAL cluster ids (null = G). Returns
    (idx_pool, pool_pos_g, pool_mass_g, overflow, need): idx_pool holds
    slots of the pool [local | halo], null = its length; need is the most
    remote clusters asked of one owner (what a cap without overflow needs
    on this rank). `on_halo(args, kwargs, result)`, where given, sees the
    call (`_fit_halo` reads its need, a timing its inputs). A collective:
    a rank's
    request table goes to every rank, and every rank sends each requester
    the blocks asked of it, in the order asked."""
    d, rank = mesh.size, mesh.rank
    base = rank * g_l
    g = d * g_l
    dev = idx_mine.device

    flat = idx_mine.reshape(-1)
    is_local = (flat >= base) & (flat < base + g_l)
    remote = torch.where(is_local | (flat >= g), _BIG, flat)
    rs = torch.sort(remote).values
    uniq = torch.cat([rs.new_ones(1, dtype=torch.bool), rs[1:] != rs[:-1]])
    u_sorted = torch.sort(torch.where(uniq & (rs < _BIG), rs, _BIG)).values

    bounds = torch.searchsorted(
        u_sorted, torch.arange(d + 1, device=dev) * g_l)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    j = torch.arange(halo_cap, device=dev)
    pos_idx = torch.clamp_max(starts[:, None] + j, u_sorted.shape[0] - 1)
    valid = j < torch.clamp_max(counts, halo_cap)[:, None]
    req = torch.where(valid, u_sorted[pos_idx], -1)  # (D owners, H)
    overflow = torch.sum(torch.clamp_min(counts - halo_cap, 0))
    need = torch.amax(counts)

    # serve: what every requester asks of this rank, in its order
    ids_out = ring.all_gather_rows(req[None], mesh)[:, rank]  # (D, H)
    slot = torch.clamp(ids_out - base, 0, g_l - 1)
    ok = (ids_out >= 0).to(pos_g.dtype)
    payload = torch.cat([pos_g[slot], (mass_g[slot] * ok[..., None])[
        ..., None]], dim=-1).reshape(d * halo_cap, LEAF, 4)
    if d > 1:
        recv = torch.empty_like(payload)
        dist.all_to_all_single(recv, payload, group=mesh.group)
    else:
        recv = payload
    # rows [o H, (o + 1) H) of recv: the blocks asked of owner o, in order
    pool_pos_g = torch.cat([pos_g, recv[..., :3]])
    pool_mass_g = torch.cat([mass_g, recv[..., 3]])

    # global ids -> pool slots through a (G + 1,) inverse table; the null
    # id is written last, so it stays null even where it was scattered to
    p = g_l + d * halo_cap
    table = torch.full((g + 1,), p, dtype=torch.int64, device=dev)
    table[torch.where(req >= 0, req, g).reshape(-1)] = (
        g_l + torch.arange(d * halo_cap, device=dev))
    table[g] = p
    idx_pool = torch.where(is_local, flat - base,
                           table[torch.clamp_max(flat, g)])
    out = (idx_pool.reshape(idx_mine.shape), pool_pos_g, pool_mass_g,
           overflow, need)
    if on_halo is not None:
        on_halo((idx_mine, pos_g, mass_g),
                dict(mesh=mesh, g_l=g_l, halo_cap=halo_cap), out)
    return out


def cluster_stats(pos_g, mass_g, live=None):
    """`tree._group_stats`, with r_tgt taken over the live rows alone where
    `live` (G_l * LEAF,) is given. A pad row (zero mass at the origin,
    `make_state(pad_to=...)`) is no target: in the last cluster of the
    Hilbert order, where the resort puts the pad rows, it would stretch
    r_tgt from that corner of the scene to the origin and make the cluster
    near nearly every other."""
    com, m_tot, r_src, r_tgt = tree_ops._group_stats(pos_g, mass_g)
    if live is not None:
        d = tree_ops._norm(pos_g - com[:, None, :])
        r_tgt = torch.amax(torch.where(live.reshape(d.shape), d, 0.0),
                           dim=1)
    return com, m_tot, r_src, r_tgt


def live_rows(state: State, ids):
    """(rows,) bool: the rows of real bodies (ids below n_active), or None
    for a state without pad rows."""
    return None if state.n_active is None else ids < state.n_active


def _gather_summaries(pos_g, mass_g, g: float, mesh: ring.Mesh,
                      quad: bool, live=None):
    """This rank's cluster statistics (com, m_tot, r_src, r_tgt;
    `cluster_stats`) and the group's, gathered in one `all_gather` with the
    (16, G) multipole summaries where `quad`. Returns (local stats,
    (com_all, m_all, rs_all, rt_all, summ_all or None))."""
    g_l = pos_g.shape[0]
    com, m_tot, r_src, r_tgt = cluster_stats(pos_g, mass_g, live)
    cols = [com, m_tot[:, None], r_src[:, None], r_tgt[:, None]]
    if quad:
        cols.append(tree_ops._cluster_summaries(
            pos_g, mass_g, com, m_tot, g)[:, :g_l].T)
    x = ring.all_gather_rows(torch.cat(cols, dim=1), mesh)
    summ = standard(x[:, 6:].T) if quad else None
    return (com, m_tot, r_src, r_tgt), (
        standard(x[:, :3]), standard(x[:, 3]), standard(x[:, 4]),
        standard(x[:, 5]), summ)


def standard(t):
    """A copy of `t` in the standard (row-major) layout: `contiguous()`
    keeps the stride of a dimension of size 1 (one cluster in all), which
    the kernels' table checks read."""
    return t.clone(memory_format=torch.contiguous_format)


def _tree2_acc(pos_l, mass_l, *, mesh: ring.Mesh, theta: float,
               k_near: int, softening: str, eps: float, g: float,
               backend: str, multipole_order: int, far_levels: int,
               halo_cap: int, near_mode: str = "strip", near_tiles: int = 0,
               near_tiles_q: int = 0, k_super: int = 0, k_mid: int = 0,
               m1_src_tiles: int | None = None,
               m2_src_tiles: int | None = None, live=None,
               with_diag: bool = False, on_halo=None):
    """The tree force on this rank's rows (G_l * LEAF of the group's
    globally Hilbert-sorted state); 0 on the pad rows where `live` marks
    the real ones (`live_rows`). Everything gathered is O(G) cluster
    summaries; bodies move only through the halo exchange. A collective.
    With `with_diag`, also {halo, near, tile}_overflow summed over the
    group. `on_halo` goes to `_halo_exchange`."""
    m = pos_l.shape[0]
    g_l = m // LEAF
    base = mesh.rank * g_l
    dtype = pos_l.dtype
    pos_g = pos_l.reshape(g_l, LEAF, 3)
    mass_g = mass_l.reshape(g_l, LEAF)
    quad = multipole_order == 2
    (com, m_tot, _, _), (com_all, m_all, rs_all, rt_all, summ_all) = (
        _gather_summaries(pos_g, mass_g, float(g), mesh, quad, live))
    gg = com_all.shape[0]
    stats = (com_all, m_all, rs_all, rt_all)

    # near lists for this rank's own target clusters (the sources global)
    mid_pairs = far_levels == 3 and near_mode == "pairs"
    if far_levels == 3:
        sup = tree_ops.SUPER
        idx2_mine, over2 = tree_ops._super_screen(
            *stats, theta,
            k_super or tree_ops.default_k_super(theta, gg // sup),
            s0=base // sup, n2=g_l // sup)
        if mid_pairs:
            com_m, spread_m, rs_max_m, _ = tree_ops._super_stats(
                *stats, group=tree_ops.MID)
            m_tot_m = m_all.reshape(-1, tree_ops.MID).sum(dim=1)
            idx_mid2_mine, over_mid = tree_ops._mid_near_lists(
                *stats, com_m, spread_m, rs_max_m, m_tot_m, idx2_mine, theta,
                k_mid or tree_ops.default_k_mid(theta, gg // tree_ops.MID),
                t0=base, n_t=g_l)
            idx_mine, over_near = tree_ops._near_lists_from_mids(
                *stats, idx_mid2_mine, theta, k_near, t0=base, n_t=g_l)
            over_near = over_near + (over_mid + over2) * sup
        else:
            idx_mine, over_near = tree_ops._near_lists_hier(
                *stats, theta, k_near, idx2=idx2_mine, t0=base, n_t=g_l)
            over_near = over_near + over2 * sup
    elif (gg > tree_ops.HIER_NEAR_CUTOFF and g_l % tree_ops.SUPER == 0
          and gg % tree_ops.SUPER == 0):
        idx_mine, over_near = tree_ops._near_lists_hier(
            *stats, theta, min(k_near, gg), k_super=k_super or None,
            t0=base, n_t=g_l)
    else:
        idx_mine, over_near = tree_ops._near_lists(
            *stats, theta, min(k_near, gg), t0=base, n_t=g_l)

    # the halo exchange before the far field, which it does not feed
    idx_pool, pool_pos_g, pool_mass_g, over_halo, _ = _halo_exchange(
        idx_mine, pos_g, mass_g, mesh=mesh, g_l=g_l, halo_cap=halo_cap,
        on_halo=on_halo)

    # far field: this rank's bodies against the gathered summaries
    over_far = 0
    if quad:
        summ_null = torch.cat([summ_all, summ_all.new_zeros((16, 1))], dim=1)
    if far_levels == 3:
        super_summ = tree_ops._super_multipoles(summ_all)
        acc = tree_ops.superfar_dense_masked(
            pos_l, super_summ, idx2_mine, eps=eps,
            backend=backend).reshape(m, 3)
        if mid_pairs:
            segs, over_far = tree_ops.mid_pair_segments(
                idx2_mine, idx_mid2_mine, gg, m1_src_tiles=m1_src_tiles,
                m2_src_tiles=m2_src_tiles)
            acc = acc + tree_ops.mid_far_eval(pos_g, summ_null, segs,
                                              eps=eps, backend=backend)
        else:
            strips = tree_ops._superfar_refine_table(summ_all, super_summ,
                                                     idx2_mine)
            acc = acc + tree_ops.superfar_refine(pos_g, strips, eps=eps,
                                                 backend=backend)
    elif quad:
        far = (cuda_tree.acc_cross_quad if backend == "cuda"
               else cuda_tree.acc_cross_quad_plain)
        acc = far(pos_l, summ_all, eps=eps)
    elif backend == "cuda":
        acc = cuda_direct.acc_cross_kernel(pos_l, com_all, m_all,
                                           softening=softening, eps=eps, g=g)
    else:
        acc = direct.acc_cross_chunked(pos_l, com_all, m_all,
                                       softening=softening, eps=eps, g=g)

    # near correction over the pool [local | halo]: the local prefix's
    # statistics are this rank's own, so only the halo rows are reduced
    halo_com, halo_m, _, _ = tree_ops._group_stats(pool_pos_g[g_l:],
                                                   pool_mass_g[g_l:])
    pool_com = torch.cat([com, halo_com])
    pool_m = torch.cat([m_tot, halo_m])
    p = pool_pos_g.shape[0]
    # a cluster the halo cap dropped is null in the quadrupole list too:
    # present in one list only, it would leave a hole, not the far field
    idx_q = torch.where(idx_pool >= p, gg, idx_mine)
    kw = dict(eps=eps, backend=backend)
    over_tiles = over_far
    if near_mode == "pairs":
        flat, ttgt, _, flatq, ttgtq, _, drop = (
            tree_ops.near_pair_segments_consistent(
                idx_pool, p, tree_ops.NEAR_TILE_J // BLOCK, near_tiles,
                idx_q, gg, tree_ops.NEAR_QUAD_PJ, near_tiles_q))
        over_tiles = over_tiles + drop
        corr = tree_ops.near_pairs_correction(
            pos_g, pool_pos_g, pool_mass_g, pool_com, pool_m, flat, ttgt,
            softening=softening, g=g, monopole_pseudo=not quad, **kw)
        if quad:
            corr = corr + tree_ops.near_pairs_multipole_subtraction(
                pos_g, summ_null, flatq, ttgtq, **kw)
    else:
        corr = tree_ops.near_direct_correction(
            pos_g, idx_pool, pool_pos_g, pool_mass_g, pool_com, pool_m,
            softening=softening, g=g, monopole_pseudo=not quad, **kw)
        if quad:
            corr = corr + tree_ops.near_multipole_subtraction(
                pos_g, summ_null, idx_q, **kw)
    acc = acc.reshape(m, 3) + corr.reshape(m, 3)
    if live is not None:
        acc = torch.where(live[:, None], acc, 0.0)
    if not with_diag:
        return acc
    counts = torch.stack([torch.as_tensor(c, device=pos_l.device).to(
        torch.int64) for c in (over_halo, over_near, over_tiles)])
    counts = ring.all_reduce(counts, dist.ReduceOp.SUM, mesh).tolist()
    # the keys in the JAX package's (sorted) order, which main prints
    return acc, dict(zip(("halo_overflow", "near_overflow",
                          "tile_overflow"), counts))


def required_n(n: int, n_devices: int, far_levels=3,
               multipole_order: int = 2) -> int:
    """N rounded up so that every shard splits into whole clusters, and
    into whole superclusters where the 3-level far field engages: at
    far_levels 3, or at "auto" where `ShardedTreeSimulation` resolves it to
    3 on the clusters of the padded N. Pass it to make_state(pad_to=...)."""
    unit = n_devices * LEAF
    n_pad = -(-n // unit) * unit
    if tree_ops.resolve_far_levels(far_levels, n_pad // LEAF,
                                   multipole_order) != 3:
        return n_pad
    unit *= tree_ops.SUPER
    return -(-n // unit) * unit


def check_group(mesh: ring.Mesh, n: int, module: str):
    """The bitonic resort's power-of-two group, and whole clusters a
    rank."""
    d = mesh.size
    if d & (d - 1):
        raise ValueError(f"mesh size must be a power of 2, got {d}")
    if n % (d * LEAF):
        raise ValueError(
            f"N={n} must be a multiple of D*LEAF={d * LEAF}; pad with "
            f"make_state(pad_to={module}.required_n(n, {d}))")


def halo_cap_for(halo_cap, g_l: int, need: int = 0) -> int:
    """The halo cap: the given one, else the JAX package's default from the
    clusters a rank, raised to the group's measured `need` (with
    HALO_HEADROOM) where it is larger. Never above g_l. Every rank passes
    the same values, so every request table has one width."""
    if halo_cap is None:
        halo_cap = max(HALO_MIN, g_l // 2)
        if need:
            halo_cap = max(halo_cap, int(need * HALO_HEADROOM) + 8)
    return int(min(halo_cap, g_l))


class ShardedTreeFacade:
    """What the sharded tree and TreePM share: the state's placement and
    its user order, the resort, the halo cap's fit and the rollout. Needs
    `mesh`, `n`, `halo_cap`, `resort_every`, `_g_l`, `_halo_cap`,
    `_stepper` and `_acc`."""

    #: the most remote clusters a rank asked of one owner at the last fit
    #: (`_fit_halo`); a calibration keeps the cap it gives
    _halo_need = 0

    def shard_state(self, state: State) -> TreeShardedState:
        """This rank's rows of a whole State (copied onto its device) with
        their ids; `prime` makes the first global sort."""
        if state.n != self.n:
            raise ValueError(f"state has {state.n} bodies, expected "
                             f"{self.n}")
        local = ring.shard_state(self.mesh, state)
        rows = local.pos.shape[0]
        lo = self.mesh.rank * rows
        ids = torch.arange(lo, lo + rows, device=self.mesh.device)
        return TreeShardedState(local, ids, 0)

    def user_order(self, ts: TreeShardedState) -> State:
        """The whole state in the caller's order, on every rank (a
        collective)."""
        full = ring.gather_state(self.mesh, ts.state)
        ids = ring.all_gather_rows(ts.ids, self.mesh)

        def unsort(v):
            if v is None or v.dim() == 0 or v.shape[0] != ids.shape[0]:
                return v
            out = torch.empty_like(v)
            out[ids] = v
            return out

        return State(**{f: unsort(getattr(full, f)) for f in State._fields})

    def _check(self, ts: TreeShardedState):
        rows = self.n // self.mesh.size
        if ts.state.pos.shape[0] != rows:
            raise ValueError(
                f"a shard has {rows} rows (N={self.n} over {self.mesh.size} "
                f"ranks); got {ts.state.pos.shape[0]}: pass shard_state()")

    def _acc_of(self, state: State, ids):
        """The force of this rank's rows in their current order: pad rows
        feel none, so they rest at the origin."""
        return functools.partial(self._acc, live=live_rows(state, ids))

    def _fit_halo(self, state: State, ids):
        """With no `halo_cap` given, set it from the need that this state's
        near lists measure (`halo_cap_for`): one force pass and an
        all_reduce(MAX), so the cap is one value on every rank. Nothing to
        do on one rank, which asks no halo. A collective."""
        if self.halo_cap is not None or self.mesh.size == 1:
            return
        seen = []
        self._acc_of(state, ids)(state.pos, state.mass,
                                 on_halo=lambda a, kw, out: seen.append(
                                     out[4].reshape(1)))
        need = int(ring.all_reduce(seen[0], dist.ReduceOp.MAX, self.mesh))
        self._halo_need = need
        cap = halo_cap_for(None, self._g_l, need)
        if cap != self._halo_cap:
            self._halo_cap = cap
            self._acc = functools.partial(self._acc, halo_cap=cap)

    def _recalibrate(self, ts: TreeShardedState, d: dict, frac: float, *,
                     also: bool = False):
        """`maybe_recalibrate`'s rule: re-measure where the truncations pass
        `frac` of the group's clusters, where a measured halo cap dropped a
        cluster, or where `also`. Returns True when it did. A
        collective."""
        trunc = sum(d[k] for k in ("halo_overflow", "near_overflow",
                                   "tile_overflow"))
        if (not also and trunc <= frac * self.mesh.size * self._g_l
                and not (self.halo_cap is None and d["halo_overflow"])):
            return False
        self.calibrate(ts)
        self._fit_halo(ts.state, ts.ids)
        return True

    def _prime(self, ts: TreeShardedState) -> TreeShardedState:
        self._check(ts)
        state, ids = _resort_local(ts.state, ts.ids, self.mesh)
        self._fit_halo(state, ids)
        return TreeShardedState(
            integrators.prime(state, self._acc_of(state, ids)), ids, 1)

    def step(self, ts: TreeShardedState, dt) -> TreeShardedState:
        """One step; the state is re-sorted first every `resort_every`
        ticks."""
        self._check(ts)
        state, ids = ts.state, ts.ids
        if ts.tick % self.resort_every == 0:
            state, ids = _resort_local(state, ids, self.mesh)
        return TreeShardedState(
            self._stepper(state, dt, self._acc_of(state, ids)), ids,
            ts.tick + 1)

    def _diagnose(self, ts: TreeShardedState) -> dict:
        self._check(ts)
        return self._acc_of(ts.state, ts.ids)(ts.state.pos, ts.state.mass,
                                              with_diag=True)[1]

    def run(self, ts: TreeShardedState, dt, steps: int) -> TreeShardedState:
        for _ in range(steps):
            ts = self.step(ts, dt)
        return ts

    def _gathered(self, ts_or_state):
        """(pos, mass) of the whole state in its current global order, from
        a TreeShardedState, a rank's State or a whole State."""
        state = getattr(ts_or_state, "state", ts_or_state)
        if state.pos.shape[0] == self.n:
            return state.pos, state.mass
        return (ring.all_gather_rows(state.pos, self.mesh),
                ring.all_gather_rows(state.mass, self.mesh))

    def _agree(self, caps: dict) -> dict:
        """The group's largest of each cap: one value on every rank."""
        keys = sorted(k for k, v in caps.items() if v is not None)
        t = torch.tensor([caps[k] for k in keys], dtype=torch.int64,
                         device=self.mesh.device)
        return dict(caps, **dict(zip(keys, ring.all_reduce(
            t, dist.ReduceOp.MAX, self.mesh).tolist())))


@dataclasses.dataclass
class ShardedTreeSimulation(ShardedTreeFacade):
    """Tree N-body simulation with O(N/D) bodies a rank.

    The state lives in global Hilbert order (see the module docstring):
    `shard_state` places an initial State, `user_order` brings results
    back. `prime`, `step`, `run` and `diagnose` are collectives on this
    rank's `TreeShardedState`."""

    mesh: ring.Mesh
    n: int
    theta: float = constants.BARNES_HUT_THETA
    k_near: Optional[int] = None
    softening: str = "plummer"
    eps: Optional[float] = None
    g: float = constants.G
    integrator: str = "leapfrog"
    backend: str = "auto"  # "cuda" | "torch" | "auto" (JAX names accepted)
    multipole_order: object = "auto"
    far_levels: object = "auto"
    halo_cap: Optional[int] = None
    #: "pairs" (tile lists sized to the worst shard's near pairs; "auto"
    #: where the kernels run) or "strip"
    near_mode: str = "auto"
    near_tiles: Optional[int] = None
    near_tiles_q: Optional[int] = None
    #: supercluster screen cap (None: the geometric default, or measured by
    #: the calibration)
    k_super: Optional[int] = None
    #: the MID far field's caps (far_levels 3 with pairs)
    k_mid: Optional[int] = None
    m1_src_tiles: Optional[int] = None
    m2_src_tiles: Optional[int] = None
    #: re-sort the state globally every this many steps (the near lists are
    #: rebuilt every step regardless)
    resort_every: int = 16

    def __post_init__(self):
        check_group(self.mesh, self.n, "tree2")
        d = self.mesh.size
        self._d = d
        self._g_l = self.n // d // LEAF
        order = self.multipole_order
        if order == "auto":
            order = 2 if self.softening == "plummer" else 1
        self._order = int(order)
        if self._order not in (1, 2):
            raise ValueError(f"multipole_order must be 1 or 2, got {order}")
        if self._order == 2 and self.softening != "plummer":
            raise ValueError("multipole_order=2 requires softening='plummer'")
        gg = self._g_l * d
        self._far_levels = tree_ops.resolve_far_levels(
            self.far_levels, gg, self._order)
        tree_ops._check_far_levels(self._far_levels)
        if self._far_levels == 3 and self._order != 2:
            raise ValueError("far_levels=3 requires multipole_order=2")
        if self._far_levels == 3 and self._g_l % tree_ops.SUPER:
            raise ValueError(
                f"far_levels=3 needs per-device clusters ({self._g_l}) "
                f"divisible by SUPER={tree_ops.SUPER}; pad N to "
                f"required_n(n, {d})")
        self._eps, _ = direct._defaults(self.softening, self.eps, self.g)
        self._backend = SimConfig(n=self.n, backend=self.backend
                                  ).resolved_backend(self.mesh.device)
        # k_near None: calibrated at prime() (measure_near with n_shards=D)
        self._needs_calibration = self.k_near is None
        k = self.k_near
        if k is None:
            k = tree_ops.default_k_near(self.theta, gg)
        self._k_near = int(k)
        self._halo_cap = halo_cap_for(self.halo_cap, self._g_l,
                                      self._halo_need)
        self._near_mode = (
            ("pairs" if self._backend == "cuda" else "strip")
            if self.near_mode == "auto" else self.near_mode)
        if self._near_mode not in ("pairs", "strip"):
            raise ValueError(f"unknown near_mode {self.near_mode!r}")
        pj = tree_ops.NEAR_TILE_J // BLOCK
        self._near_tiles = int(
            self.near_tiles if self.near_tiles is not None
            else self._g_l * max(-(-self._k_near // pj), 1))
        self._near_tiles_q = int(
            self.near_tiles_q if self.near_tiles_q is not None
            else self._g_l * max(-(-self._k_near // tree_ops.NEAR_QUAD_PJ),
                                 1))
        self._stepper = integrators.get_stepper(self.integrator)
        self._acc = functools.partial(
            _tree2_acc, mesh=self.mesh, theta=self.theta,
            k_near=self._k_near, softening=self.softening, eps=self._eps,
            g=self.g, backend=self._backend, multipole_order=self._order,
            far_levels=self._far_levels, halo_cap=self._halo_cap,
            near_mode=self._near_mode, near_tiles=self._near_tiles,
            near_tiles_q=self._near_tiles_q, k_super=int(self.k_super or 0),
            k_mid=int(self.k_mid or 0), m1_src_tiles=self.m1_src_tiles,
            m2_src_tiles=self.m2_src_tiles)

    def calibrate(self, ts_or_state):
        """Measure the scene's near lists once (tree.measure_near with
        n_shards=D on the gathered positions: O(N) a rank, once) and take
        the measured caps: k_near, k_super and the worst shard's tile
        totals, agreed over the group. prime() runs it where k_near was not
        given. A collective."""
        pos, mass = self._gathered(ts_or_state)
        m = tree_ops.measure_near(
            pos, mass, theta=self.theta, gg=self._d * self._g_l, leaf=LEAF,
            cluster_mode="equal", n_shards=self._d,
            measure_mid=(self._far_levels == 3
                         and self._near_mode == "pairs"))
        m = self._agree({k: m.get(k) for k in (
            "k_near", "k_super", "near_tiles_shard", "near_tiles_q_shard",
            "k_mid", "m1_src_tiles_shard", "m2_src_tiles_shard")})
        self.k_near = m["k_near"]
        self.k_super = m["k_super"]
        self.near_tiles = m["near_tiles_shard"]
        self.near_tiles_q = m["near_tiles_q_shard"]
        self.k_mid = m["k_mid"]
        self.m1_src_tiles = m["m1_src_tiles_shard"]
        self.m2_src_tiles = m["m2_src_tiles_shard"]
        self.__post_init__()

    @property
    def caps(self) -> dict:
        """The measured or derived caps, a snapshot."""
        return {"k_near": self._k_near, "k_super": self.k_super,
                "near_tiles": self._near_tiles,
                "near_tiles_q": self._near_tiles_q,
                "halo_cap": self._halo_cap, "far_levels": self._far_levels,
                "near_mode": self._near_mode, "g_l": self._g_l}

    def prime(self, ts: TreeShardedState) -> TreeShardedState:
        """Calibrate where needed, re-sort, and fill the acc cache."""
        if self._needs_calibration:
            self.calibrate(ts)
        return self._prime(ts)

    def diagnose(self, ts: TreeShardedState) -> dict:
        """Overflow telemetry summed over the group: near-list
        truncations, halo-cap drops and tile-cap drops. A collective."""
        return self._diagnose(ts)

    def maybe_recalibrate(self, ts: TreeShardedState, *,
                          frac: float = 0.02) -> bool:
        """Re-measure the evolved scene when the telemetry exceeds `frac`
        of the group's clusters, or when a measured halo cap dropped a
        cluster. Returns True when it did. A collective."""
        return self._recalibrate(ts, self.diagnose(ts), frac)
