"""TreePM hybrid force solver: PM long-range + exact short-range pairs
(PyTorch).

The counterpart of `spacetpu/ops/treepm.py`. The smooth long-range field
comes from the particle-mesh solve (`ops/pm.py`) with a long-range kernel,
and the mesh-unresolvable short-range part from exact pair interactions
within a cutoff, over Hilbert-clustered pair tiles with the tree's
machinery (`ops/tree.py`).

Two split families (`split`):

- "poly" (the default): w_long(r) = G(y)/r^3, G(y) = y^3 (10 - 15 y + 6 y^2),
  y = (r/r_cut)^2; the long-range potential is closed form and the short
  weight is exactly 0 at r >= r_cut.
- "gauss": the classic erf split, w_long = [erf(u) - (2/sqrt(pi)) u
  e^(-u^2)] / r^3, u = r / (2 rs); the pair kernels take the Chebyshev form
  of the bracket (`_h_long_cheb`).

The short-range pair pass runs through the kernels of `ops/cuda_tree.py`
(`pairs_short`, and `pairs_short_hybrid` for ``pairs_accum="mxu"``) on the
card, through their plain versions otherwise. Cutoff near lists accept
source clusters with com distance <= r_cut + r_tgt_i + r_tgt_j, which holds
every body pair within r_cut; a target whose list overflows its cap falls
back to PM accuracy for the dropped clusters, counted in
``near_overflow``.

The sharded TreePM (`parallel/treepmshard.py`) builds cutoff lists for a
slice of target rows (`near_lists_rcut(t0=, n_t=)`), sizes its caps by the
worst shard (`measure_near_rcut(n_shards=)`) and runs the short-range pass
over a pool of source clusters apart from its targets
(`near_pairs_short`). `measure_near_rcut` reads integers back to the host;
nothing else here does.
"""

from __future__ import annotations

import functools
import math

import torch

from spacetpu_torch import constants
from spacetpu_torch.ops import cluster as cluster_ops
from spacetpu_torch.ops import cuda_tree, direct, morton
from spacetpu_torch.ops import pm as pm_ops
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.state import resolve_device

#: Gaussian split scale in mesh cells: rs = RS_CELLS * h
RS_CELLS = 1.75
#: short-range cutoff in split scales: r_cut = RCUT_RS * rs
RCUT_RS = 4.5
_TWO_OVER_SQRTPI = 2.0 / math.sqrt(math.pi)
#: force-split family: "poly" or "gauss"
SPLIT = "poly"

#: auto-grid bounds (TREEPM_GRID_MAX_LARGE at and above TREEPM_GRID_LARGE_N)
TREEPM_GRID_MIN = 32
TREEPM_GRID_MAX = 256
TREEPM_GRID_LARGE_N = 8_000_000
TREEPM_GRID_MAX_LARGE = 512

#: grid at or above which the JAX package builds the poly spectrum on its
#: device instead of the host. Here every spectrum is built on the device
#: (`pm.kernel_hat_from_corner`), so nothing reads it; it is kept for the
#: JAX package's callers.
KERNEL_DEVICE_MIN_GRID = 384

#: the Chebyshev form of the gauss split's long-range bracket, shared with
#: the kernels' plain versions
_HLONG_VMAX = cuda_tree.HLONG_VMAX
_HLONG_CHEB = cuda_tree.HLONG_CHEB
_h_long_cheb = cuda_tree.h_long_cheb


def default_grid(n: int) -> int:
    """Power-of-two TreePM mesh: ~2 cells a body spacing (grid ~ 2 N^(1/3)),
    clamped to [TREEPM_GRID_MIN, TREEPM_GRID_MAX] (TREEPM_GRID_MAX_LARGE
    from TREEPM_GRID_LARGE_N bodies)."""
    g = 1
    target = 2.0 * n ** (1.0 / 3.0)
    while g < target:
        g *= 2
    cap = (TREEPM_GRID_MAX_LARGE if n >= TREEPM_GRID_LARGE_N
           else TREEPM_GRID_MAX)
    return max(TREEPM_GRID_MIN, min(cap, g))


def split_params(h: float, *, rs_cells: float = RS_CELLS,
                 rcut_rs: float = RCUT_RS) -> tuple[float, float]:
    """(rs, r_cut) for a mesh cell size h."""
    rs = float(rs_cells) * float(h)
    return rs, float(rcut_rs) * rs


def pm_kernel_hat_long(grid: int, h: float, rs: float, *, g: float = None,
                       dtype=torch.float32, device=None):
    """rFFT of the gauss split's LONG-RANGE Green's function
    K = -G erf(r / (2 rs)) / r, K(0) = -G / (sqrt(pi) rs), on the doubled
    mesh: a real (2G, 2G, G+1) table built in float64 on `device`."""
    if g is None:
        g = constants.G
    r = pm_ops.corner_distances(grid, h, device=resolve_device(device))
    rs = float(rs)
    kern = torch.where(r > 0.0,
                       torch.special.erf(r / (2.0 * rs))
                       / torch.clamp_min(r, 1e-300),
                       1.0 / (math.sqrt(math.pi) * rs))
    return pm_ops.kernel_hat_from_corner(-float(g) * kern, grid, dtype)


def _poly_corner(grid, h, rcut, g, device):
    """The poly split's long-range potential on the min-image corner:
    -(32/21)/rc + 2 r^5/rc^6 - (15/7) r^7/rc^8 + (2/3) r^9/rc^10 inside the
    cutoff, -1/r beyond (times G), in float64."""
    r = pm_ops.corner_distances(grid, h, device=resolve_device(device))
    rc = float(rcut)
    inside = ((-32.0 / 21.0) / rc + 2.0 * r ** 5 / rc ** 6
              - (15.0 / 7.0) * r ** 7 / rc ** 8
              + (2.0 / 3.0) * r ** 9 / rc ** 10)
    outside = -1.0 / torch.where(r > 0.0, r, 1.0)
    return float(g) * torch.where(r < rc, inside, outside)


def pm_kernel_hat_poly(grid: int, h: float, rcut: float, *, g: float = None,
                       dtype=torch.float32, device=None):
    """rFFT of the poly split's LONG-RANGE Green's function (see
    `_poly_corner`) on the doubled mesh, built in float64 on `device`."""
    if g is None:
        g = constants.G
    return pm_ops.kernel_hat_from_corner(
        _poly_corner(grid, h, rcut, g, device), grid, dtype)


#: the JAX package's device build of the poly spectrum: here the same build
#: as `pm_kernel_hat_poly`
pm_kernel_hat_poly_device = pm_kernel_hat_poly


def make_kernel_hat(split: str, grid: int, h: float, rs: float, rcut: float,
                    *, g: float = None, dtype=torch.float32, device=None):
    """Long-range mesh kernel for the chosen split family."""
    if split == "poly":
        return pm_kernel_hat_poly(grid, h, rcut, g=g, dtype=dtype,
                                  device=device)
    if split == "gauss":
        return pm_kernel_hat_long(grid, h, rs, g=g, dtype=dtype,
                                  device=device)
    raise ValueError(f"unknown treepm split {split!r}")


def _inv_r(r2):
    return torch.where(r2 > 0, torch.rsqrt(torch.clamp_min(r2, 1e-38)), 0.0)


def _w_long_poly(r2, rcut):
    """Poly-split long-range force weight G(y)/r^3, y = r^2/rcut^2, clamped
    to the Newtonian weight (G = 1) beyond the cutoff."""
    y = torch.clamp_max(r2 * (1.0 / (rcut * rcut)), 1.0)
    gp = y * y * y * (10.0 + y * (-15.0 + 6.0 * y))
    inv_r = _inv_r(r2)
    return gp * inv_r * inv_r * inv_r


def _w_long(r2, rs):
    """Long-range force weight [erf(u) - (2/sqrt(pi)) u e^(-u^2)] / r^3
    with the exact erf; 0 at r = 0."""
    inv_r = _inv_r(r2)
    u = r2 * inv_r / (2.0 * rs)
    num = torch.special.erf(u) - _TWO_OVER_SQRTPI * u * torch.exp(-u * u)
    return num * inv_r * inv_r * inv_r


def _w_long_fast(r2, rs):
    """`_w_long` with the erf/exp bracket replaced by the Chebyshev fit:
    h(v) / (8 rs^3) inside the fitted range, 1/r^3 beyond it."""
    inv4rs2 = 1.0 / (4.0 * rs * rs)
    v = r2 * inv4rs2
    # clamp the Clenshaw argument: out-of-range entries would overflow
    x = torch.clamp_max(v * (2.0 / _HLONG_VMAX) - 1.0, 1.0)
    w_in = _h_long_cheb(x) * (inv4rs2 * (0.5 / rs))
    inv_r = _inv_r(r2)
    return torch.where(v <= _HLONG_VMAX, w_in, inv_r * inv_r * inv_r)


def w_short(r2, softening: str, eps, rs, *, rcut=None, split: str = "gauss",
            fast: bool = True):
    """Short-range pair weight: the softened law minus the long-range part
    the mesh carries. split="poly": exactly 0 at and beyond rcut (needs
    rcut). split="gauss": the erf complement, with the Chebyshev bracket
    (fast=True) or the exact erf (fast=False)."""
    w_pair = direct._pair_weight(r2, softening, float(eps))
    if split == "poly":
        if rcut is None:
            raise ValueError("split='poly' needs rcut")
        yc = r2 * (1.0 / (rcut * rcut))
        return torch.where(yc < 1.0, w_pair - _w_long_poly(r2, rcut), 0.0)
    if split != "gauss":
        raise ValueError(f"unknown treepm split {split!r}")
    wl = _w_long_fast if fast else _w_long
    return w_pair - wl(r2, rs)


def acc_cross_short(pos_i, pos_j, mass_j, *, softening: str = "plummer",
                    eps=None, rs: float = 1.0, rcut=None,
                    split: str = "gauss", g=None):
    """Short-range acceleration of targets `pos_i` from sources
    `pos_j`/`mass_j`: `direct.acc_cross` with the split weight."""
    eps, g = direct._defaults(softening, eps, g)
    rel = pos_j[None, :, :] - pos_i[:, None, :]
    r2 = torch.sum(rel * rel, dim=-1)
    w = w_short(r2, softening, eps, rs, rcut=rcut, split=split)
    w = w * mass_j[None, :] * g
    return torch.einsum("ij,ijk->ik", w, rel)


# Abramowitz & Stegun 7.1.26 rational erf (|err| < 1.5e-7)
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _erf_as(x):
    """erf(x) for x >= 0 via A&S 7.1.26 (exp and rationals only)."""
    t = 1.0 / (1.0 + _AS_P * x)
    poly = t * (_AS_A[0] + t * (_AS_A[1] + t * (
        _AS_A[2] + t * (_AS_A[3] + t * _AS_A[4]))))
    return 1.0 - poly * torch.exp(-x * x)


def near_pairs_short(pos_g_t, pool_pos_g, pool_mass_g, pool_com, flat_src,
                     tile_tgt, *, softening, eps, rs, g, backend: str,
                     rcut=None, split: str = "gauss", accum: str = "vpu"):
    """Short-range pair pass with SEPARATE target and source cluster
    tables: the sharded TreePM's, whose sources are the [local | halo]
    pool of the halo exchange (`parallel/tree2.py`) and whose flat_src
    indexes pool slots (len(pool) = the null cluster). Returns (G_t, leaf,
    3) in slot order. The source table carries a massless pseudo slot a
    cluster (`tree._pack_augmented(monopole_pseudo=False)`); the
    single-device pass, `_short_eval`, is the case pool = targets.
    accum="mxu" sums in the centred form (`pairs_short_hybrid`)."""
    tree_ops._check_backend(backend)
    tree_ops._check_accum(accum)
    srows = tree_ops._pack_augmented(pool_pos_g, pool_mass_g, pool_com,
                                     torch.sum(pool_mass_g, dim=1), float(g),
                                     monopole_pseudo=False)
    if accum == "mxu":
        fn = (cuda_tree.near_pairs_short_hybrid if backend == "cuda"
              else cuda_tree.near_pairs_short_hybrid_plain)
    else:
        fn = (cuda_tree.near_pairs_short if backend == "cuda"
              else cuda_tree.near_pairs_short_plain)
    return fn(pos_g_t, srows, flat_src, tile_tgt, softening=softening,
              eps=eps, rs=rs, rcut=0.0 if rcut is None else rcut,
              split=split)


# --- cutoff near lists and calibration ---------------------------------------


def _rcut_near(com_r, r_r, com, m_tot, r_tgt, rcut: float):
    """(rows, G) distances and the cutoff acceptance mask of target rows."""
    dist = tree_ops._pair_dist(com_r, com)
    near = dist <= rcut + r_r[:, None] + r_tgt[None, :]
    return dist, near & (m_tot[None, :] > 0)


def near_lists_rcut(com, m_tot, r_tgt, rcut, k_near: int,
                    row_chunk: int = 1024, t0=None, n_t: int | None = None):
    """(G_t, K) ids of the clusters within the short-range cutoff
    (symmetric acceptance: com distance <= rcut + r_tgt_i + r_tgt_j;
    massless sources skipped), nearest first, null = G, and the count of
    targets whose accepted set exceeded k_near. t0/n_t restrict the TARGET
    rows to [t0, t0 + n_t) (the sharded TreePM's own clusters; the sources
    stay global); default all G. Chunked over target rows."""
    g = com.shape[0]
    t0 = 0 if t0 is None else t0
    t1 = g if n_t is None else t0 + n_t
    rcut = float(rcut)
    cand = torch.arange(g, device=com.device)[None, :]
    ids, overflow = [], com.new_zeros((), dtype=torch.int64)
    for r0 in range(t0, t1, row_chunk):
        r1 = min(r0 + row_chunk, t1)
        dist, near = _rcut_near(com[r0:r1], r_tgt[r0:r1], com, m_tot, r_tgt,
                                rcut)
        overflow = overflow + torch.sum(torch.sum(near, dim=1) > k_near)
        masked = torch.where(near, dist, float("inf"))
        ids.append(tree_ops._smallest_k(masked, cand, k_near, g))
    return torch.cat(ids), overflow


def measure_near_rcut(pos, mass, *, rcut: float, gg: int, leaf: int,
                      headroom: float = 1.25, n_shards: int = 1) -> dict:
    """The scene's cutoff near-list shape for static sizing: k_near = max
    accepted clusters a row and near_tiles = total pair tiles, both with
    `headroom`. n_shards > 1 adds near_tiles_shard: the worst shard's tile
    total under a D-way equal split of the sorted cluster rows, the one
    cap of every rank of the sharded TreePM. One O(G^2) pass in row chunks
    of 1024 on the device; the counts come back to the host once."""
    n = pos.shape[0]
    perm, _ = morton.morton_order(pos)
    stats = tree_ops.tree_sorted_stats(pos, mass, perm, gg, leaf)
    com, m_tot, r_tgt = stats["com"], stats["m_tot"], stats["r_tgt"]
    k_i = torch.cat([
        torch.sum(_rcut_near(com[r0:r0 + 1024], r_tgt[r0:r0 + 1024], com,
                             m_tot, r_tgt, float(rcut))[1], dim=1)
        for r0 in range(0, gg, 1024)])
    pj = tree_ops.NEAR_TILE_J // (leaf + 1)
    tiles_i = torch.clamp_min(-(-k_i // pj), 1)
    k_max, tiles, k_sum = torch.stack(
        [k_i.max(), tiles_i.sum(), k_i.sum()]).tolist()
    k_near = min(max(int(math.ceil(k_max * headroom)), 2), gg)
    near_tiles = int(math.ceil(float(tiles) * headroom)) + 8
    out = dict(k_near=k_near, near_tiles=near_tiles, n_clusters=gg,
               mean_near=k_sum / gg, n=n)
    if n_shards > 1:
        if gg % n_shards:
            raise ValueError(f"gg={gg} not divisible by n_shards={n_shards}")
        per_shard = int(tiles_i.reshape(n_shards, -1).sum(dim=1).max())
        out["near_tiles_shard"] = int(
            math.ceil(float(per_shard) * headroom)) + 8
    return out


# --- structure and the full solver --------------------------------------------

#: `treepm_prep` keys that stay valid across steps: the sort, the gather plan
#: and the flattened cutoff pair tiles; cluster statistics are recomputed
STRUCTURE_KEYS = ("perm", "inv", "clusters", "near_flat", "near_tile_tgt",
                  "near_ntiles", "near_overflow")


def treepm_prep(pos, mass, *, rcut: float, k_near: int, gg: int, leaf: int,
                near_tiles: int | None = None):
    """Sort, equal clusters, statistics, cutoff near lists and the flattened
    pair tiles. ``near_overflow`` is a 0-d tensor; nothing is read back."""
    block = leaf + 1
    if tree_ops.NEAR_TILE_J % block:
        raise ValueError(
            f"TreePM pair tiles need leaf+1 to divide "
            f"{tree_ops.NEAR_TILE_J}, got leaf={leaf}")
    perm, inv = morton.morton_order(pos)
    clusters = cluster_ops.equal_clusters(pos.shape[0], leaf, gg,
                                          device=pos.device)
    stats = tree_ops.tree_sorted_stats(pos, mass, perm, gg, leaf)
    idx, overflow = near_lists_rcut(stats["com"], stats["m_tot"],
                                    stats["r_tgt"], rcut, k_near)
    pj = tree_ops.NEAR_TILE_J // block
    if near_tiles is None:
        near_tiles = gg * max(-(-k_near // pj), 1)
    flat, ttgt, ntiles, dropped = tree_ops.near_pair_segments(
        idx, gg, pj, near_tiles)
    return dict(perm=perm, inv=inv, clusters=clusters, near_flat=flat,
                near_tile_tgt=ttgt, near_ntiles=ntiles,
                near_overflow=overflow + dropped, **stats)


def treepm_structure(pos, mass, *, rcut: float, k_near: int, gg: int,
                     leaf: int, near_tiles: int | None = None):
    """The cacheable part (STRUCTURE_KEYS) of `treepm_prep`."""
    p = treepm_prep(pos, mass, rcut=rcut, k_near=k_near, gg=gg, leaf=leaf,
                    near_tiles=near_tiles)
    return {k: p[k] for k in STRUCTURE_KEYS}


structure_from_numpy = functools.partial(tree_ops.structure_from_numpy,
                                         keys=STRUCTURE_KEYS)
structure_from_numpy.__doc__ = (
    "A structure for `acc_treepm_cached` from the `spacetpu` package's "
    "`treepm_structure` dict as numpy arrays (see "
    "`tree.structure_from_numpy`).")


def _short_eval(prep: dict, *, softening: str, eps, g, rs: float,
                rcut=None, split: str = "gauss", backend: str,
                accum: str = "vpu"):
    """Short-range pair pass over the prep's tile list -> (G, leaf, 3) in
    slot order: `near_pairs_short` with the targets as the pool."""
    return near_pairs_short(prep["pos_g"], prep["pos_g"], prep["mass_g"],
                            prep["com"], prep["near_flat"],
                            prep["near_tile_tgt"], softening=softening,
                            eps=eps, rs=rs, g=g, backend=backend, rcut=rcut,
                            split=split, accum=accum)


def _acc_total(pos, mass, prep, clusters, inv, *, kernel_hat, box_min, h,
               grid, rs, rcut, split, softening, eps, g, backend,
               pairs_accum):
    gg, leaf = prep["pos_g"].shape[:2]
    acc_short = _short_eval(prep, softening=softening, eps=eps, g=g, rs=rs,
                            rcut=rcut, split=split, backend=backend,
                            accum=pairs_accum)
    acc_short = cluster_ops.unsort_slots(acc_short.reshape(gg * leaf, 3),
                                         clusters, inv)
    return acc_short + pm_ops.acc_pm(pos, mass, kernel_hat=kernel_hat,
                                     box_min=box_min, h=h, grid=grid)


def acc_treepm(pos, mass, *, kernel_hat, box_min, h, grid: int, rs: float,
               rcut: float, split: str = "gauss",
               softening: str = "plummer", eps=None, g=None,
               k_near: int = 64, gg: int | None = None,
               leaf: int = None, near_tiles: int | None = None,
               backend: str = "torch", pairs_accum: str = "vpu"):
    """TreePM acceleration (N, 3), (N,) -> (N, 3). kernel_hat must be the
    long-range kernel of the same split (`make_kernel_hat`) for the same
    (grid, h, rs/rcut, g)."""
    eps, g = direct._defaults(softening, eps, g)
    if leaf is None:
        leaf = tree_ops.LEAF
    if gg is None:
        gg = -(-pos.shape[0] // leaf)
    prep = treepm_prep(pos, mass, rcut=rcut, k_near=k_near, gg=gg, leaf=leaf,
                       near_tiles=near_tiles)
    return _acc_total(pos, mass, prep, prep["clusters"], prep["inv"],
                      kernel_hat=kernel_hat, box_min=box_min, h=h, grid=grid,
                      rs=rs, rcut=rcut, split=split, softening=softening,
                      eps=eps, g=g, backend=backend, pairs_accum=pairs_accum)


def acc_treepm_cached(pos, mass, structure, *, kernel_hat, box_min, h,
                      grid: int, rs: float, rcut: float = 0.0,
                      split: str = "gauss", softening: str = "plummer",
                      eps=None, g=None, backend: str = "torch",
                      pairs_accum: str = "vpu"):
    """`acc_treepm` with a cached `treepm_structure`: the sort and the
    cutoff pair tiles are reused, cluster statistics follow the current
    positions."""
    eps, g = direct._defaults(softening, eps, g)
    clusters = structure["clusters"]
    gg, leaf = clusters.slot.shape
    stats = tree_ops.tree_sorted_stats(pos, mass, structure["perm"], gg,
                                       leaf)
    prep = dict(structure, **stats)
    return _acc_total(pos, mass, prep, clusters, structure["inv"],
                      kernel_hat=kernel_hat, box_min=box_min, h=h, grid=grid,
                      rs=rs, rcut=rcut, split=split, softening=softening,
                      eps=eps, g=g, backend=backend, pairs_accum=pairs_accum)
