"""Body-sharded TreePM over a group of ranks: O(N/D) a rank (PyTorch).

The counterpart of `spacetpu/parallel/treepmshard.py`. Each half of the
force split rides a pattern the other sharded solvers use (`ops/treepm.py`
for the split):

- **Long range**, the sharded PM's (`parallel/pmshard.py`): each rank
  CIC-deposits its own rows onto a compact (G+1)^3 mesh, one
  `all_reduce(SUM)` makes the group's mesh, and the FFT solve against the
  long-range kernel, the gradient and the gather of the rank's own bodies
  run on every rank alike.
- **Short range**, the sharded tree's (`parallel/tree2.py`): the state lives
  in global Hilbert order (the bitonic resort every `resort_every` steps),
  each rank builds cutoff lists for its own clusters against the gathered
  O(G) summaries, fetches the remote near clusters' bodies through tree2's
  halo exchange and runs the short-range pair tiles over the pool
  (`treepm.near_pairs_short`: `pairs_short` on the card). Every truncation
  (list cap, halo cap, tile cap) is counted by `diagnose`. A remote cluster
  that the halo cap drops loses its short-range force entirely, so the
  halo cap, where none is given, is fitted to the measured need as tree2's
  is (`tree2.ShardedTreeFacade._fit_halo`).

The facade is tree2's: `shard_state`, `prime` (calibrates the box from the
group's MIN and MAX in float64, as `pmshard` does, so the cell size is one
device's; the long-range kernel; the worst shard's caps), `step`, `run`,
`diagnose` (with the out-of-box count), `maybe_recalibrate`, `user_order`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from spacetpu_torch import constants
from spacetpu_torch.ops import direct, integrators, pm
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.ops import treepm as treepm_ops
from spacetpu_torch.parallel import ring, tree2
from spacetpu_torch.sim import SimConfig

LEAF = tree_ops.LEAF
TreeShardedState = tree2.TreeShardedState


def required_n(n: int, n_devices: int) -> int:
    """N rounded up so that every shard splits into whole LEAF-body
    clusters (tree2's 2-level grain)."""
    return tree2.required_n(n, n_devices, far_levels=2)


def _treepm_acc(pos_l, mass_l, *, mesh: ring.Mesh, pm_cal: dict, box,
                k_near: int, near_tiles: int, halo_cap: int, softening: str,
                eps: float, g: float, backend: str, live=None,
                with_diag: bool = False, on_halo=None):
    """The TreePM force on this rank's rows (G_l * LEAF of the group's
    globally Hilbert-sorted state); 0 on the pad rows where `live` marks
    the real ones (`tree2.live_rows`). O(G) summaries and one mesh
    all_reduce gathered; bodies move only through the halo exchange. A
    collective. `on_halo` goes to `tree2._halo_exchange`."""
    m = pos_l.shape[0]
    g_l = m // LEAF
    base = mesh.rank * g_l
    pos_g = pos_l.reshape(g_l, LEAF, 3)
    mass_g = mass_l.reshape(g_l, LEAF)
    com, m_tot, _, r_tgt = tree2.cluster_stats(pos_g, mass_g, live)
    x = ring.all_gather_rows(torch.cat(
        [com, m_tot[:, None], r_tgt[:, None]], dim=1), mesh)
    com_all, m_all, rt_all = (tree2.standard(x[:, :3]),
                              tree2.standard(x[:, 3]),
                              tree2.standard(x[:, 4]))

    # cutoff lists for this rank's own target clusters (the sources global)
    rcut = pm_cal["rcut"]
    idx_mine, over_near = treepm_ops.near_lists_rcut(
        com_all, m_all, rt_all, rcut, k_near, t0=base, n_t=g_l)
    idx_pool, pool_pos_g, pool_mass_g, over_halo, _ = tree2._halo_exchange(
        idx_mine, pos_g, mass_g, mesh=mesh, g_l=g_l, halo_cap=halo_cap,
        on_halo=on_halo)

    # long range: local deposit, one all_reduce, the solve on every rank,
    # the gather of this rank's bodies
    grid = pm_cal["grid"]
    box_t, inv_h = pm._scalars(pos_l, box, pm_cal["h"])
    mesh_c = pm.deposit_cic_compact(pos_l, mass_l.to(pos_l.dtype),
                                    box_min=box_t, inv_h=inv_h, grid=grid)
    ring.all_reduce(mesh_c, dist.ReduceOp.SUM, mesh)
    acc = pm.acc_from_mesh_compact(pos_l, mesh_c,
                                   kernel_hat=pm_cal["kernel_hat"],
                                   box_min=box_t, inv_h=inv_h, grid=grid)

    # short range over the pool [local | halo]
    p = pool_pos_g.shape[0]
    flat, ttgt, _, drop = tree_ops.near_pair_segments(
        idx_pool, p, tree_ops.NEAR_TILE_J // (LEAF + 1), near_tiles)
    pool_com = tree_ops._group_stats(pool_pos_g, pool_mass_g)[0]
    acc = acc + treepm_ops.near_pairs_short(
        pos_g, pool_pos_g, pool_mass_g, pool_com, flat, ttgt,
        softening=softening, eps=eps, rs=pm_cal["rs"], rcut=rcut,
        split=pm_cal["split"], g=g, backend=backend).reshape(m, 3)
    if live is not None:
        acc = torch.where(live[:, None], acc, 0.0)
    if not with_diag:
        return acc
    counts = torch.stack([c.to(torch.int64)
                          for c in (over_halo, over_near, drop)])
    ring.all_reduce(counts, dist.ReduceOp.SUM, mesh)
    # the keys in the JAX package's (sorted) order, which main prints
    return acc, dict(zip(("halo_overflow", "near_overflow",
                          "tile_overflow"), counts.tolist()))


@dataclasses.dataclass
class ShardedTreePMSimulation(tree2.ShardedTreeFacade):
    """TreePM N-body simulation with O(N/D) bodies a rank.

    The state lives in global Hilbert order (`tree2.TreeShardedState`):
    `shard_state` places an initial State, `user_order` brings results
    back. `prime`, `step`, `run` and `diagnose` are collectives."""

    mesh: ring.Mesh
    n: int
    grid: object = "auto"  # mesh size per axis (auto | int)
    margin: float = 2.0
    rs_cells: Optional[float] = None  # None: treepm.RS_CELLS
    rcut_rs: Optional[float] = None  # None: treepm.RCUT_RS
    softening: str = "plummer"
    eps: Optional[float] = None
    g: float = constants.G
    integrator: str = "leapfrog"
    backend: str = "auto"  # "cuda" | "torch" | "auto" (JAX names accepted)
    k_near: Optional[int] = None  # None: measured at prime()
    near_tiles: Optional[int] = None  # a rank's tile cap (None: measured)
    halo_cap: Optional[int] = None
    resort_every: int = 16
    split: Optional[str] = None  # the force split (None: treepm.SPLIT)

    def __post_init__(self):
        tree2.check_group(self.mesh, self.n, "treepmshard")
        self._d = self.mesh.size
        self._g_l = self.n // self._d // LEAF
        self._grid = (treepm_ops.default_grid(self.n) if self.grid == "auto"
                      else int(self.grid))
        self._eps, _ = direct._defaults(self.softening, self.eps, self.g)
        self._backend = SimConfig(n=self.n, backend=self.backend
                                  ).resolved_backend(self.mesh.device)
        self._halo_cap = tree2.halo_cap_for(self.halo_cap, self._g_l)
        self._stepper = integrators.get_stepper(self.integrator)
        #: the calibration (box_min, h, grid, kernel_hat, rs, rcut, split);
        #: None until calibrate() or prime() has seen a state
        self._pm: dict | None = None
        self._k_near = self.k_near
        self._near_tiles = self.near_tiles

    def calibrate(self, ts_or_state):
        """Measure the group's box (MIN and MAX of the local extents, in
        float64), build the long-range kernel, and measure the cutoff
        lists' caps on the gathered positions (measure_near_rcut with
        n_shards=D: O(N) a rank, once), agreed over the group. A
        collective."""
        state = getattr(ts_or_state, "state", ts_or_state)
        pos = state.pos
        lo, hi = pos.amin(dim=0).double(), pos.amax(dim=0).double()
        if pos.shape[0] != self.n:
            lo = ring.all_reduce(lo, dist.ReduceOp.MIN, self.mesh)
            hi = ring.all_reduce(hi, dist.ReduceOp.MAX, self.mesh)
        box_min, h = pm.box_from_extent(lo.cpu().numpy(), hi.cpu().numpy(),
                                        grid=self._grid, margin=self.margin)
        rs, rcut = treepm_ops.split_params(
            h, rs_cells=(treepm_ops.RS_CELLS if self.rs_cells is None
                         else float(self.rs_cells)),
            rcut_rs=(treepm_ops.RCUT_RS if self.rcut_rs is None
                     else float(self.rcut_rs)))
        split = treepm_ops.SPLIT if self.split is None else str(self.split)
        kernel_hat = treepm_ops.make_kernel_hat(
            split, self._grid, h, rs, rcut, g=self.g, dtype=pos.dtype,
            device=pos.device)
        all_pos, all_mass = self._gathered(ts_or_state)
        m = treepm_ops.measure_near_rcut(
            all_pos, all_mass, rcut=rcut, gg=self._d * self._g_l, leaf=LEAF,
            n_shards=self._d)
        m = self._agree({"k_near": m["k_near"],
                         "near_tiles": m.get("near_tiles_shard",
                                             m["near_tiles"])})
        if self.k_near is None:
            self._k_near = m["k_near"]
        if self.near_tiles is None:
            self._near_tiles = m["near_tiles"]
        self._pm = dict(box_min=box_min, h=h, grid=self._grid,
                        kernel_hat=kernel_hat, rs=rs, rcut=rcut, split=split)
        # on the device once: a tensor made from the host at every force
        # pass would make the host wait for the card there
        box = torch.as_tensor(box_min, dtype=pos.dtype, device=pos.device)
        self._acc = functools.partial(
            _treepm_acc, mesh=self.mesh, pm_cal=self._pm, box=box,
            k_near=self._k_near, near_tiles=self._near_tiles,
            halo_cap=self._halo_cap, softening=self.softening, eps=self._eps,
            g=self.g, backend=self._backend)

    @property
    def mesh_params(self) -> dict | None:
        """The calibration (box_min, h, grid, kernel_hat, rs, rcut, split),
        a snapshot; None before it."""
        return dict(self._pm) if self._pm else None

    @property
    def caps(self) -> dict:
        """The measured or given caps, a snapshot."""
        return {"k_near": self._k_near, "near_tiles": self._near_tiles,
                "halo_cap": self._halo_cap, "grid": self._grid,
                "g_l": self._g_l}

    def prime(self, ts: TreeShardedState) -> TreeShardedState:
        """Calibrate where needed, re-sort, and fill the acc cache."""
        if self._pm is None:
            self.calibrate(ts)
        return self._prime(ts)

    def step(self, ts: TreeShardedState, dt) -> TreeShardedState:
        if self._pm is None:
            raise RuntimeError(
                "treepm solver is uncalibrated: call prime() (or "
                "calibrate()) first")
        return super().step(ts, dt)

    def diagnose(self, ts: TreeShardedState) -> dict:
        """Truncation telemetry summed over the group (list-cap overflow,
        halo-cap drops, tile-cap drops) and, once calibrated, the bodies
        outside the mesh box. A collective."""
        d = self._diagnose(ts)
        if self._pm is not None:
            n_out = pm.count_out_of_box(ts.state.pos, self._pm["box_min"],
                                        self._pm["h"], self._grid)
            n_out = ring.all_reduce(n_out.to(torch.int64),
                                      dist.ReduceOp.SUM, self.mesh)
            d["out_of_box"] = int(n_out)
        return d

    def maybe_recalibrate(self, ts: TreeShardedState, *,
                          frac: float = 0.02) -> bool:
        """Re-measure the box and the caps when more than `frac` of the
        bodies left the box, the truncations pass `frac` of the group's
        clusters or a measured halo cap dropped a cluster. Returns True
        when it did. A collective."""
        d = self.diagnose(ts)
        return self._recalibrate(ts, d, frac,
                                 also=d.get("out_of_box", 0) > frac * self.n)
