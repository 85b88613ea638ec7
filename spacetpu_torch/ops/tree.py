"""Barnes-Hut as a curve-sorted clustered treecode (PyTorch).

The counterpart of `spacetpu/ops/tree.py`: the O(N * crit) physics of an
octree walk as a dense, statically shaped three-phase algorithm.

1. **Sort**: order the bodies along the Hilbert curve (`ops/morton.py`) and
   cut the sorted order into leaf clusters of `leaf` bodies. Centre of
   mass, mass and radii per cluster are segment reductions.
2. **Far field**: every body against every cluster's multipole (monopole,
   or monopole + quadrupole): one dense (N x G) pass, no opening tests.
3. **Near correction**: for cluster pairs that fail the theta criterion
   (r_src >= theta * (d - r_tgt)), replace the multipole by exact pairwise
   forces. With monopoles each source cluster carries a pseudo-body at its
   centre of mass with mass -M, so one direct pass gives direct minus
   monopole; with quadrupoles a second pass over negated summaries takes
   the multipole back out. Near lists have a static cap; a target whose
   near set overflows it falls back to far-field accuracy for the dropped
   clusters, and is counted in ``near_overflow``.

Massless bodies exert no force in any phase.

Ported: two far-field levels (``far_levels=2``), the equal-count partition,
multipole orders 1 and 2, the near phase as a pair list
(``near_mode="pairs"``, through the kernels of `ops/cuda_tree.py`) and as
per-cluster strips (``near_mode="strip"``, plain PyTorch only). The
three-level far field, the adaptive partition, the hybrid accumulation and
strip mode on the card raise `NotImplementedError`.

Index tensors are int64. `measure_near` reads integers back to the host;
`tree_prep`, `tree_eval`, `acc_tree` and `acc_tree_cached` do not: the
live tile counts and the overflow count stay tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spacetpu_torch import constants
from spacetpu_torch.ops import cluster as cluster_ops
from spacetpu_torch.ops import cuda_direct, cuda_tree, direct, morton
from spacetpu_torch.state import resolve_device

#: default real bodies per leaf cluster; +1 slot for the -M pseudo-body
#: gives a 256-wide block. block = leaf + 1 must divide NEAR_TILE_J, i.e.
#: leaf in {31, 63, 127, 255, ...}, for the pair list.
LEAF = 255
BLOCK = LEAF + 1
#: clusters per supercluster in the two-level near-list build
SUPER = 64
#: use the hierarchical near-list build above this many clusters
HIER_NEAR_CUTOFF = 2048
#: source bodies per tile of the direct pair list (pj = NEAR_TILE_J / block
#: source clusters a tile)
NEAR_TILE_J = 2048
#: summary columns per tile of the quadrupole pair list
NEAR_QUAD_PJ = 128
#: the JAX package switches to three far-field levels at this many clusters
FAR3_CUTOFF = 4096

_FAR3 = ("ROADMAP.md Queue A item 6 (tree: the 3-level far field, "
         "far_levels=3)")
_ADAPTIVE = "ROADMAP.md Queue A item 6 (tree: adaptive clustering)"
_HYBRID = ("ROADMAP.md Queue B item 8 (_kernel_pairs_hybrid, "
           "pairs_accum='mxu')")
_STRIP = ("ROADMAP.md Queue B item 10 (strip mode on the card: "
          "_near_correction_chunk and _near_multipole_sub_pallas)")

#: elements of one temporary of the chunked passes below
_CHUNK_ELEMS = 1 << 24


def default_k_near(theta: float, n_groups: int) -> int:
    """Static near-list cap: clusters within d <= r*(1 + 1/theta) of each
    other are near. Hilbert-ordered clusters of a uniform cloud have about
    1.7x the ideal sphere-packing radius, so the geometric (1 + 1/theta)^3
    estimate carries a 2.5x factor."""
    k = int(2.5 * (1.0 + 1.0 / theta) ** 3) + 16
    return max(2, min(n_groups, k))


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _pair_dist(a, b):
    """Distances (..., A, B) between points a (..., A, 3) and b (..., B, 3),
    summed as (x^2 + y^2) + z^2 without an (A, B, 3) temporary."""
    d2 = None
    for k in range(3):
        d = a[..., :, None, k] - b[..., None, :, k]
        d2 = d * d if d2 is None else d2 + d * d
    return torch.sqrt(d2)


def _group_stats(pos_g, mass_g):
    """Per-cluster centre of mass, total mass, and two radii. pos_g:
    (G, leaf, 3).

    A massless cluster gets its geometric centroid as centre, so near-list
    distances stay meaningful: otherwise its centre collapses to the world
    origin and massless *targets* lose their near corrections.

    r_src bounds only force-exerting (massive) bodies: it drives the
    source-side opening error. r_tgt bounds ALL bodies: any body is a force
    target whose distance to a source can undershoot the centre distance by
    up to r_tgt."""
    m_tot = torch.sum(mass_g, dim=1)  # (G,)
    com_mass = torch.sum(pos_g * mass_g[..., None], dim=1) / torch.clamp_min(
        m_tot, 1e-30)[..., None]
    centroid = torch.mean(pos_g, dim=1)
    com = torch.where(m_tot[..., None] > 0, com_mass, centroid)
    d = _norm(pos_g - com[:, None, :])
    r_src = torch.amax(torch.where(mass_g > 0, d, 0.0), dim=1)
    r_tgt = torch.amax(d, dim=1)
    return com, m_tot, r_src, r_tgt


def _smallest_k(masked, cand, k: int, null_id: int):
    """Ids `cand` of the k smallest entries per row of `masked` (inf =
    invalid -> null_id), nearest first. top-k for small k and a full stable
    row sort above 256, as in the JAX package; equal distances may come out
    in another order than there."""
    inf = float("inf")
    cand = cand.expand_as(masked)
    if k <= 256:
        neg_d, j = torch.topk(-masked, k, dim=1)
        return torch.where(neg_d > -inf, torch.gather(cand, 1, j), null_id)
    d_sorted, order = torch.sort(masked, dim=1, stable=True)
    return torch.where(d_sorted[:, :k] < inf,
                       torch.gather(cand, 1, order[:, :k]), null_id)


def _near_lists(com, m_tot, r_src, r_tgt, theta: float, k_near: int):
    """(G, K) ids of the nearest clusters failing the opening test, and the
    count of targets whose accepted set exceeded k_near.

    Invalid slots point to the null cluster (id G). Sources with zero total
    mass are never near. Dense O(G^2) build, exact; `_near_lists_hier` is
    the two-level build for large G."""
    g = com.shape[0]
    dist = _pair_dist(com, com)  # (G, G) target x source
    near = r_src[None, :] >= theta * (dist - r_tgt[:, None])
    near = near & (m_tot[None, :] > 0)
    overflow = torch.sum(torch.sum(near, dim=1) > k_near)
    masked = torch.where(near, dist, float("inf"))
    cand = torch.arange(g, device=com.device)[None, :]
    return _smallest_k(masked, cand, k_near, g), overflow


def default_k_super(theta: float, n_super: int) -> int:
    """Static cap on near superclusters per target supercluster. A
    supercluster spans about SUPER^(1/3) = 4x a cluster's linear size."""
    k = int(2.5 * (1.0 + 1.0 / (2.0 * theta)) ** 3) + 8
    return max(4, min(n_super, k))


def _super_stats(com, r_src, r_tgt):
    """Aggregate cluster summaries into bounds for SUPER-cluster nodes:
    (com2, c_spread, rs_max, rt_max) per node, where c_spread bounds the
    distance of a member's centre from the node centroid."""
    g = com.shape[0]
    g2 = -(-g // SUPER)
    pad = g2 * SUPER - g
    if pad:
        # padding members collapse onto the last real centre with zero radii
        com = torch.cat([com, com[-1].expand(pad, 3)])
        r_src = torch.cat([r_src, r_src.new_zeros(pad)])
        r_tgt = torch.cat([r_tgt, r_tgt.new_zeros(pad)])
    com_g = com.reshape(g2, SUPER, 3)
    com2 = torch.mean(com_g, dim=1)
    c_spread = torch.amax(_norm(com_g - com2[:, None, :]), dim=1)
    rs_max = torch.amax(r_src.reshape(g2, SUPER), dim=1)
    rt_max = torch.amax(r_tgt.reshape(g2, SUPER), dim=1)
    return com2, c_spread, rs_max, rt_max


def _super_accept(com2, spread, rs_max, rt_max, theta: float):
    """(G2, G2) target x source conservative supercluster accept matrix,
    and the pair distances. Shared by the runtime screen and
    measure_near's k_super sizing: were the two to differ, the screen
    would truncate silently."""
    d2 = _pair_dist(com2, com2)
    possible = (rs_max[None, :] + spread[None, :]) >= theta * (
        d2 - spread[:, None] - rt_max[:, None])
    return possible, d2


def _super_screen(com, m_tot, r_src, r_tgt, theta: float, k_super: int):
    """Supercluster-level near lists: (G2, K2) super ids and the count of
    truncated rows. For target t in super A and source s in super B,
    d(t, s) >= D_AB - spread_A - spread_B, so B is accepted whenever
    rs_max_B + spread_B >= theta * (D_AB - spread_A - rt_max_A): no false
    negatives for the per-cluster test, since theta <= 1."""
    g2 = -(-com.shape[0] // SUPER)
    com2, spread, rs_max, rt_max = _super_stats(com, r_src, r_tgt)
    possible, d2 = _super_accept(com2, spread, rs_max, rt_max, theta)
    over2 = torch.sum(torch.sum(possible, dim=1) > k_super)
    masked2 = torch.where(possible, d2, float("inf"))
    cand2 = torch.arange(g2, device=com.device)[None, :]
    return _smallest_k(masked2, cand2, min(k_super, g2), g2), over2


def _near_lists_hier(com, m_tot, r_src, r_tgt, theta: float, k_near: int,
                     k_super: int | None = None):
    """Two-level near-list build: an O(G2^2) supercluster screen, then the
    exact test over the K2*SUPER member clusters of each target
    supercluster's near supers, in place of the (G, G) distance matrix.
    Returns (idx, overflow) like `_near_lists`; overflow also counts
    truncated screen rows, scaled by SUPER."""
    g = com.shape[0]
    g2 = -(-g // SUPER)
    if k_super is None:
        k_super = default_k_super(theta, g2)
    idx2, over2 = _super_screen(com, m_tot, r_src, r_tgt, theta, k_super)

    # Candidate cluster ids per target supercluster: the members of its
    # near supers; members past G (and invalid supers) map to the null id G.
    members = idx2[:, :, None] * SUPER + torch.arange(SUPER,
                                                      device=com.device)
    cand = torch.clamp_max(members.reshape(g2, -1), g)  # (G2, K2*SUPER)
    n_cand = cand.shape[1]

    # the null row: zero mass already keeps it out of the near test
    com_n = torch.cat([com, com.new_zeros((1, 3))])
    m_n = torch.cat([m_tot, m_tot.new_zeros(1)])
    rs_n = torch.cat([r_src, r_src.new_zeros(1)])

    pad = g2 * SUPER - g
    com_t, rt_t = com, r_tgt
    if pad:
        com_t = torch.cat([com, com[-1].expand(pad, 3)])
        rt_t = torch.cat([r_tgt, r_tgt.new_zeros(pad)])
    com_t = com_t.reshape(g2, SUPER, 3)
    rt_t = rt_t.reshape(g2, SUPER)

    # k_near can exceed the pool (dense scenes at small leaf): the true near
    # set is still inside the pool, so take all of it and pad with null ids
    k_eff = min(k_near, n_cand)
    rows, over = [], over2 * SUPER
    step = max(1, _CHUNK_ELEMS // (SUPER * n_cand))
    for s0 in range(0, g2, step):
        cb = cand[s0:s0 + step]  # (B, C)
        dist = _pair_dist(com_t[s0:s0 + step], com_n[cb])  # (B, SUPER, C)
        near = (rs_n[cb][:, None, :] >= theta * (
            dist - rt_t[s0:s0 + step, :, None])) & (m_n[cb][:, None, :] > 0)
        over = over + torch.sum(torch.sum(near, dim=-1) > k_near)
        masked = torch.where(near, dist, float("inf")).reshape(-1, n_cand)
        cand_rows = cb[:, None, :].expand(-1, SUPER, -1).reshape(-1, n_cand)
        rows.append(_smallest_k(masked, cand_rows, k_eff, g))
    idx = torch.cat(rows)
    if k_eff < k_near:
        idx = torch.cat(
            [idx, idx.new_full((idx.shape[0], k_near - k_eff), g)], dim=1)
    return idx[:g], over


def near_lists(com, m_tot, r_src, r_tgt, theta: float, k_near: int,
               k_super: int | None = None):
    """(G, K) near-cluster lists and the on-device overflow count."""
    k_near = min(k_near, com.shape[0])
    if com.shape[0] > HIER_NEAR_CUTOFF:
        return _near_lists_hier(com, m_tot, r_src, r_tgt, theta, k_near,
                                k_super=k_super)
    return _near_lists(com, m_tot, r_src, r_tgt, theta, k_near)


def measure_near(pos, mass, *, theta: float, gg: int, leaf: int = LEAF,
                 cluster_mode: str = "equal", headroom: float = 1.25,
                 chunk: int = 2048) -> dict:
    """Measure the scene's near-list shape for static sizing: per-cluster
    near counts -> the k_near cap, the pair-list tile capacities, the
    supercluster screen cap and the cluster count. Equal-count clusters in
    sparse regions of a high-density-contrast scene (a Plummer sphere) have
    huge radii, where the geometric `default_k_near` underestimates badly.

    Counts in chunks on the device, O(chunk * G) memory, and reads the
    counts back to the host: call it when a simulation is set up, not in
    its step. Returns dict(k_near, near_tiles, near_tiles_q, n_clusters,
    k_super) of Python ints, all scaled by `headroom`."""
    _, _, clusters, stats = _build_clustering(pos, mass, gg, leaf,
                                              cluster_mode)
    com, m_tot = stats["com"], stats["m_tot"]
    r_src, r_tgt = stats["r_src"], stats["r_tgt"]
    counts = []
    for c0 in range(0, gg, chunk):
        dist = _pair_dist(com[c0:c0 + chunk], com)
        near = (r_src[None, :] >= theta * (
            dist - r_tgt[c0:c0 + chunk, None])) & (m_tot[None, :] > 0)
        counts.append(torch.sum(near, dim=1))
    exact = torch.cat(counts).cpu().numpy().astype(np.int64)
    k = int(int(exact.max()) * headroom) + 8
    k = max(8, min(gg, -(-k // 8) * 8))
    pj = NEAR_TILE_J // (leaf + 1)
    tiles_i = np.maximum(-(-exact // pj), 1)
    tiles_q_i = np.maximum(-(-exact // NEAR_QUAD_PJ), 1)
    out = dict(
        k_near=k,
        near_tiles=int(tiles_i.sum() * headroom) + 8,
        near_tiles_q=int(tiles_q_i.sum() * headroom) + 8,
        n_clusters=int(clusters.n_clusters),
    )
    # The geometric default_k_super truncates once G2 outgrows it, and a
    # truncated screen under-covers the refinement pool, so near lists
    # would drop true near clusters: measure the accept counts exactly.
    g2 = -(-gg // SUPER)
    com2, spread, rs_max, rt_max = _super_stats(com, r_src, r_tgt)
    possible, _ = _super_accept(com2, spread, rs_max, rt_max, theta)
    cnt2 = int(torch.sum(possible, dim=1).max())
    out["k_super"] = max(4, min(g2, int(cnt2 * headroom) + 4))
    return out


def measure_k_near(pos, mass, *, theta: float, gg: int,
                   headroom: float = 1.25, chunk: int = 2048) -> int:
    """The measured k_near cap only."""
    return measure_near(pos, mass, theta=theta, gg=gg, headroom=headroom,
                        chunk=chunk)["k_near"]


def _augmented(pos_g, mass_g, com, m_tot, g_const, monopole_pseudo: bool):
    """Source clusters with their pseudo-body slot: positions
    (G, block, 3) and g*m (G, block). The pseudo-body sits at the centre of
    mass and carries -g*M (monopole_pseudo) or nothing."""
    aug_pos = torch.cat([pos_g, com[:, None, :]], dim=1)
    pseudo_gm = (-m_tot[:, None] * g_const if monopole_pseudo
                 else torch.zeros_like(m_tot[:, None]))
    aug_gm = torch.cat([mass_g * g_const, pseudo_gm], dim=1)
    return aug_pos, aug_gm


def _pack_augmented(pos_g, mass_g, com, m_tot, g_const, *,
                    monopole_pseudo: bool = True):
    """Source table (4, (G + 1) * block), rows x, y, z, g*m: per cluster
    `leaf` bodies and the pseudo-body slot (see `_augmented`), then an
    all-zero null cluster. These are rows 0-3 of the JAX package's 8-row
    operand; its other rows are padding for the TPU's tiling."""
    gg, leaf = pos_g.shape[:2]
    n_cols = gg * (leaf + 1)
    aug_pos, aug_gm = _augmented(pos_g, mass_g, com, m_tot, g_const,
                                 monopole_pseudo)
    rows = pos_g.new_zeros((4, (gg + 1) * (leaf + 1)))
    rows[:3, :n_cols] = aug_pos.reshape(n_cols, 3).T
    rows[3, :n_cols] = aug_gm.reshape(n_cols)
    return rows


def _cluster_summaries(pos_g, mass_g, com, m_tot, g_const):
    """(16, G + 1) multipole summaries: centre of mass, g*M and the
    traceless g*Q quadrupole per cluster (rows as `cuda_tree.acc_cross_quad`
    reads them), plus a null column."""
    gg = pos_g.shape[0]
    x = pos_g - com[:, None, :]  # (G, leaf, 3) centred
    m = mass_g
    r2 = torch.sum(x * x, dim=-1)
    qxx = torch.sum(m * (3 * x[..., 0] * x[..., 0] - r2), dim=1)
    qyy = torch.sum(m * (3 * x[..., 1] * x[..., 1] - r2), dim=1)
    qzz = torch.sum(m * (3 * x[..., 2] * x[..., 2] - r2), dim=1)
    qxy = torch.sum(m * 3 * x[..., 0] * x[..., 1], dim=1)
    qxz = torch.sum(m * 3 * x[..., 0] * x[..., 2], dim=1)
    qyz = torch.sum(m * 3 * x[..., 1] * x[..., 2], dim=1)
    s = pos_g.new_zeros((16, gg + 1))
    s[:3, :gg] = com.T
    s[3, :gg] = g_const * m_tot
    for row, q in zip(range(4, 10), (qxx, qyy, qzz, qxy, qxz, qyz)):
        s[row, :gg] = g_const * q
    return s


def _negated(summaries):
    """The summary table with g*M and g*Q negated."""
    neg = summaries.clone()
    neg[3:10] *= -1.0
    return neg


# --- strip-mode near phase (plain PyTorch) -----------------------------------


def _near_correction_plain(pos_g, aug_pos, aug_gm, idx, *, softening, eps):
    """Strip-mode near correction: each target cluster against the gathered
    bodies of its K near clusters -> (G_t, leaf, 3). idx: (G_t, K) into
    aug_*; invalid slots = len(aug_pos) (a null cluster is appended)."""
    aug_pos = torch.cat([aug_pos, aug_pos.new_zeros((1,) + aug_pos.shape[1:])])
    aug_gm = torch.cat([aug_gm, aug_gm.new_zeros((1,) + aug_gm.shape[1:])])
    n_t, leaf = pos_g.shape[:2]
    strip = idx.shape[1] * aug_pos.shape[1]
    step = max(1, _CHUNK_ELEMS // max(leaf * strip, 1))
    out = []
    for c0 in range(0, n_t, step):
        near_idx = idx[c0:c0 + step]
        tgt = pos_g[c0:c0 + step]
        sp = aug_pos[near_idx].reshape(tgt.shape[0], strip, 3)
        sm = aug_gm[near_idx].reshape(tgt.shape[0], strip)
        dx = sp[:, None, :, 0] - tgt[:, :, 0:1]
        dy = sp[:, None, :, 1] - tgt[:, :, 1:2]
        dz = sp[:, None, :, 2] - tgt[:, :, 2:3]
        r2 = dx * dx + dy * dy + dz * dz
        w = direct._pair_weight(r2, softening, float(eps)) * sm[:, None, :]
        out.append(torch.stack([torch.sum(w * dx, dim=-1),
                                torch.sum(w * dy, dim=-1),
                                torch.sum(w * dz, dim=-1)], dim=-1))
    return torch.cat(out)


def _near_multipole_sub_plain(pos_g, summaries_neg, idx, *, eps):
    """Strip-mode multipole subtraction: each target cluster against the
    (negated) summaries of its K near clusters -> (G_t * leaf, 3)."""
    n_t, leaf = pos_g.shape[:2]
    step = max(1, _CHUNK_ELEMS // max(16 * leaf * idx.shape[1], 1))
    out = []
    for c0 in range(0, n_t, step):
        summ = summaries_neg[:, idx[c0:c0 + step]].permute(1, 0, 2)
        out.append(cuda_tree._quad_terms(pos_g[c0:c0 + step], summ,
                                         float(eps)))
    return torch.cat(out).reshape(-1, 3)


# --- pair-list near phase ----------------------------------------------------
#
# Strip mode pays G * k_cap * block^2 pairs: the static cap must cover the
# WORST cluster, so scenes with skewed near counts burn most of the near
# phase on null-cluster padding. The pair list flattens the near lists into
# tiles, ceil(k_i / pj) tiles per target, ordered by target, so the cost
# follows the actual near-pair total.


def _pack_rows_flat(ids, n_src: int, pj: int, cap: int, offs, k_i):
    """Fill the (cap * pj,) flat source table for ragged row lists packed at
    per-row tile offsets `offs` (strictly increasing, offs[0] = 0, in tiles
    of width pj). Each row's valid entries are first compacted to a prefix,
    keeping their order (rows may contain interior nulls), then every
    output slot gathers its (row, rank).

    Returns (flat (cap * pj,), row_of_tile (cap,), dropped); row_of_tile is
    clamped to row G-1 past the live tiles."""
    w = ids.shape[1]
    col = torch.arange(w, device=ids.device)[None, :]
    key = torch.where(ids < n_src, col, w + col)
    order = torch.argsort(key, dim=1, stable=True)
    return _flat_from_compact(torch.gather(ids, 1, order), n_src, pj, cap,
                              offs, k_i)


def _flat_from_compact(ids_c, n_src: int, pj: int, cap: int, offs, k_i):
    """The gather half of `_pack_rows_flat`, for callers that already hold
    the prefix-compacted rows `ids_c`."""
    w = ids_c.shape[1]
    dev = ids_c.device
    t_range = torch.arange(cap, device=dev)
    row = torch.searchsorted(offs, t_range, right=True) - 1
    j = (t_range - offs[row])[:, None] * pj + torch.arange(pj, device=dev)
    ok = j < k_i[row][:, None]
    j_safe = torch.clamp_max(j, w - 1)
    vals = ids_c.reshape(-1)[(row[:, None] * w + j_safe).reshape(-1)]
    flat = torch.where(ok.reshape(-1), vals, n_src)
    kept = torch.minimum(torch.clamp_min(cap * pj - offs * pj, 0), k_i)
    dropped = torch.sum(k_i) - torch.sum(kept)
    return flat, row, dropped


def near_pair_segments(idx, n_src: int, pj: int, cap_tiles: int,
                       ids_c=None):
    """Flatten (G, K) near lists into the pair-kernel tile list.

    idx: invalid slots = n_src (the null source). Every target gets
    max(ceil(k_i / pj), 1) tiles. Returns (flat_src (cap_tiles * pj,),
    tile_tgt (cap_tiles,), n_tiles, dropped): flat_src pads with n_src,
    tile_tgt pads with G, dropped counts valid entries beyond cap_tiles
    (those targets fall back to far-field accuracy for the dropped sources;
    `tree_prep` adds it to ``near_overflow``)."""
    g = idx.shape[0]
    k_i = torch.sum(idx < n_src, dim=1)
    tiles_i = torch.clamp_min(-(-k_i // pj), 1)
    csum = torch.cumsum(tiles_i, dim=0)
    offs = torch.cat([csum.new_zeros(1), csum[:-1]])
    n_tiles = csum[-1]
    if ids_c is None:
        flat, row, dropped = _pack_rows_flat(idx, n_src, pj, cap_tiles, offs,
                                             k_i)
    else:
        flat, row, dropped = _flat_from_compact(ids_c, n_src, pj, cap_tiles,
                                                offs, k_i)
    t_range = torch.arange(cap_tiles, device=idx.device)
    tile_tgt = torch.where(t_range < n_tiles, row, g)
    return flat, tile_tgt, n_tiles, dropped


def near_pair_segments_consistent(idx_d, n_src_d: int, pj_d: int, cap_d: int,
                                  idx_q, n_src_q: int, pj_q: int, cap_q: int):
    """Build the direct and the quadrupole-subtraction tile lists
    CONSISTENTLY.

    The quadrupole pass subtracts each near cluster's multipole on the
    premise that the direct pass adds its exact force: a cluster present in
    only one list leaves a force hole or a double count, both worse than
    the far-field fallback. The two lists have different tile widths and
    caps, so their positional overflow would drop different clusters.
    Instead, targets whose tiles do not fit BOTH caps are dropped from BOTH
    lists entirely; `dropped` counts their valid entries.

    idx_d and idx_q must mark the same slots invalid (>= their n_src)."""
    k_i = torch.sum(idx_d < n_src_d, dim=1)
    t_d = torch.clamp_min(-(-k_i // pj_d), 1)
    t_q = torch.clamp_min(-(-k_i // pj_q), 1)
    fit = (torch.cumsum(t_d, 0) <= cap_d) & (torch.cumsum(t_q, 0) <= cap_q)
    dropped = torch.sum(torch.where(fit, 0, k_i))
    idx_d = torch.where(fit[:, None], idx_d, n_src_d)
    idx_q = torch.where(fit[:, None], idx_q, n_src_q)
    # the two tables mark the same slots invalid, so one rank-packing
    # permutation serves both
    w = idx_d.shape[1]
    col = torch.arange(w, device=idx_d.device)[None, :]
    key = torch.where(idx_d < n_src_d, col, w + col)
    order = torch.argsort(key, dim=1, stable=True)
    flat_d, ttgt_d, nt_d, d1 = near_pair_segments(
        idx_d, n_src_d, pj_d, cap_d, ids_c=torch.gather(idx_d, 1, order))
    flat_q, ttgt_q, nt_q, d2 = near_pair_segments(
        idx_q, n_src_q, pj_q, cap_q, ids_c=torch.gather(idx_q, 1, order))
    # d1 and d2 are zero by construction; counted anyway
    return flat_d, ttgt_d, nt_d, flat_q, ttgt_q, nt_q, dropped + d1 + d2


# --- structure ---------------------------------------------------------------


def tree_sorted_stats(pos, mass, perm, gg: int, leaf: int = LEAF):
    """Gather bodies into the sorted order and compute cluster statistics
    from the CURRENT positions for the equal-count partition. O(N)."""
    n = pos.shape[0]
    n_pad = gg * leaf
    pos_sorted = pos[perm]
    # zero-mass padding parked at the last body's position (not the origin,
    # which would corrupt the last cluster's centroid and target radius)
    pos_s = torch.cat([pos_sorted, pos_sorted[-1].expand(n_pad - n, 3)])
    mass_s = torch.cat([mass[perm], mass.new_zeros(n_pad - n)])
    pos_g = pos_s.reshape(gg, leaf, 3)
    mass_g = mass_s.reshape(gg, leaf)
    com, m_tot, r_src, r_tgt = _group_stats(pos_g, mass_g)
    return dict(pos_s=pos_s, mass_s=mass_s, pos_g=pos_g, mass_g=mass_g,
                com=com, m_tot=m_tot, r_src=r_src, r_tgt=r_tgt)


def cluster_stats(pos, mass, perm, clusters):
    """Cluster statistics from the current positions through a `Clusters`
    gather plan. Padded slots repeat a real body with zero mass, so
    centroids and radii see no foreign positions."""
    pos_sorted = pos[perm]
    mass_sorted = mass[perm]
    pos_g, mass_g = cluster_ops.gather_clusters(pos_sorted, mass_sorted,
                                                clusters)
    com, m_tot, r_src, r_tgt = _group_stats(pos_g, mass_g)
    return dict(pos_s=pos_sorted, mass_s=mass_sorted, pos_g=pos_g,
                mass_g=mass_g, com=com, m_tot=m_tot, r_src=r_src,
                r_tgt=r_tgt)


def _build_clustering(pos, mass, gg: int, leaf: int, cluster_mode: str):
    """(perm, inv, clusters, stats) for the partition mode."""
    if cluster_mode == "adaptive":
        raise NotImplementedError(
            f"cluster_mode='adaptive' is not ported yet: {_ADAPTIVE}")
    if cluster_mode != "equal":
        raise ValueError(f"unknown cluster_mode {cluster_mode!r}")
    perm, inv = morton.morton_order(pos)
    clusters = cluster_ops.equal_clusters(pos.shape[0], leaf, gg,
                                          device=pos.device)
    stats = tree_sorted_stats(pos, mass, perm, gg, leaf)
    return perm, inv, clusters, stats


def _check_far_levels(far_levels):
    if far_levels == 3:
        raise NotImplementedError(
            f"far_levels=3 is not ported yet: {_FAR3}; pass far_levels=2")
    if far_levels != 2:
        raise ValueError(f"far_levels must be 2 or 3, got {far_levels}")


def tree_prep(pos, mass, *, theta: float, k_near: int, gg: int,
              far_levels: int = 2, leaf: int = LEAF,
              cluster_mode: str = "equal", near_mode: str = "strip",
              near_tiles: int | None = None,
              near_tiles_q: int | None = None,
              k_super: int | None = None):
    """Phase 1: sort, clustering, statistics, near lists. Returns a dict of
    sorted and packed tensors plus perm/inv/clusters/idx, the flattened
    tile lists when near_mode="pairs" (see `near_pair_segments`), and
    ``near_overflow``, a 0-d tensor. Reads nothing back to the host."""
    _check_far_levels(far_levels)
    perm, inv, clusters, stats = _build_clustering(pos, mass, gg, leaf,
                                                   cluster_mode)
    idx, overflow = near_lists(stats["com"], stats["m_tot"], stats["r_src"],
                               stats["r_tgt"], theta, k_near,
                               k_super=k_super)
    prep = dict(idx=idx, perm=perm, inv=inv, clusters=clusters, **stats)
    if near_mode == "pairs":
        block = leaf + 1
        if NEAR_TILE_J % block:
            raise ValueError(
                f"near_mode='pairs' needs block=leaf+1 to divide "
                f"{NEAR_TILE_J}, got leaf={leaf}")
        pj = NEAR_TILE_J // block
        if near_tiles is None:
            near_tiles = gg * max(-(-k_near // pj), 1)
        if near_tiles_q is None:
            near_tiles_q = gg * max(-(-k_near // NEAR_QUAD_PJ), 1)
        flat, ttgt, ntd, flatq, ttgtq, ntq, drop = (
            near_pair_segments_consistent(
                idx, gg, pj, near_tiles, idx, gg, NEAR_QUAD_PJ,
                near_tiles_q))
        prep.update(near_flat=flat, near_tile_tgt=ttgt, near_ntiles=ntd,
                    nearq_flat=flatq, nearq_tile_tgt=ttgtq,
                    nearq_ntiles=ntq)
        overflow = overflow + drop
    elif near_mode != "strip":
        raise ValueError(f"unknown near_mode {near_mode!r}")
    prep["near_overflow"] = overflow + clusters.overflow
    return prep


#: keys of the tree_prep entries that stay valid across steps (bodies move
#: a tiny fraction of a cluster radius per step); everything else is a
#: statistic of the current positions, recomputed by `acc_tree_cached`.
STRUCTURE_KEYS = ("perm", "inv", "clusters", "idx",
                  "near_flat", "near_tile_tgt", "near_ntiles",
                  "nearq_flat", "nearq_tile_tgt", "nearq_ntiles")


def tree_structure(pos, mass, **kw):
    """The cacheable part of tree construction: the curve sort, the
    clustering and the near lists with their tile lists. Takes the keyword
    arguments of `tree_prep`; returns the STRUCTURE_KEYS present."""
    p = tree_prep(pos, mass, **kw)
    return {k: p[k] for k in STRUCTURE_KEYS if k in p}


def structure_from_numpy(d: dict, *, device=None) -> dict:
    """A structure for `acc_tree_cached` from the `spacetpu` package's
    `tree_structure` dict given as numpy arrays, with ``clusters`` as the
    tuple of its five fields. Integers become int64. Entries of the
    three-level far field (idx2, m1_*, m2_*) are left out. The structure
    goes to the card unless the caller names another device, as
    `state_from_numpy` does; without a card that raises."""
    dev = resolve_device(device)

    def conv(x):
        t = torch.as_tensor(np.array(x), device=dev)
        return t if t.dtype == torch.bool else t.to(torch.int64)

    out = {k: conv(d[k]) for k in STRUCTURE_KEYS
           if k in d and k != "clusters"}
    out["clusters"] = cluster_ops.Clusters(*(conv(x) for x in d["clusters"]))
    return out


# --- evaluation --------------------------------------------------------------


def _check_backend(backend: str):
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (want 'cuda' or "
                         "'torch')")


def _check_accum(accum: str):
    if accum == "mxu":
        raise NotImplementedError(
            f"pairs_accum='mxu' is not ported yet: {_HYBRID}")
    if accum != "vpu":
        raise ValueError(f"unknown pairs_accum {accum!r}")


def tree_eval(prep: dict, c0: int, n_clusters: int, *, softening: str,
              eps, g, backend: str, multipole_order: int = 1,
              far_levels: int = 2, near_mode: str = "strip",
              pairs_accum: str = "vpu"):
    """Phases 2 and 3 for target clusters [c0, c0 + n_clusters): far-field
    multipoles plus near correction, (n_clusters * leaf, 3) in slot order.
    near_mode="pairs" (full range only) drives the near phase through the
    tile lists in `prep`.

    multipole_order=1: monopole far field; the near correction embeds a -M
    pseudo-body per source cluster, so direct minus monopole is one pass.
    multipole_order=2: monopole + quadrupole far field (plummer only); the
    near correction is direct pairs plus a negated-multipole evaluation over
    each cluster's near list.

    backend="cuda" goes through the kernel wrappers of `cuda_tree` and
    `cuda_direct` (which take their plain versions for CPU tensors),
    backend="torch" through the plain versions."""
    _check_backend(backend)
    _check_accum(pairs_accum)
    _check_far_levels(far_levels)
    if multipole_order not in (1, 2):
        raise ValueError(
            f"multipole_order must be 1 or 2, got {multipole_order}")
    if multipole_order == 2 and softening != "plummer":
        raise ValueError("multipole_order=2 requires softening='plummer'")
    if near_mode not in ("strip", "pairs"):
        raise ValueError(f"unknown near_mode {near_mode!r}")
    if near_mode == "strip" and backend == "cuda":
        raise NotImplementedError(
            f"near_mode='strip' has no kernels yet: {_STRIP}; use "
            "near_mode='pairs' or backend='torch'")
    gg, leaf = prep["pos_g"].shape[:2]
    if near_mode == "pairs" and (c0 != 0 or n_clusters != gg):
        raise ValueError("near_mode='pairs' supports the full target range "
                         "only (c0=0, n_clusters=G)")
    pos_g = prep["pos_g"][c0:c0 + n_clusters]
    targets = pos_g.reshape(n_clusters * leaf, 3)
    g = float(g)

    if multipole_order == 2:
        summaries = _cluster_summaries(prep["pos_g"], prep["mass_g"],
                                       prep["com"], prep["m_tot"], g)

    # Phase 2: dense far field.
    if multipole_order == 2:
        far = (cuda_tree.acc_cross_quad if backend == "cuda"
               else cuda_tree.acc_cross_quad_plain)
        acc = far(targets, summaries[:, :gg], eps=eps)
    elif backend == "cuda":
        acc = cuda_direct.acc_cross_kernel(
            targets, prep["com"], prep["m_tot"], softening=softening,
            eps=eps, g=g)
    else:
        acc = direct.acc_cross_chunked(
            targets, prep["com"], prep["m_tot"], softening=softening,
            eps=eps, g=g)

    # Phase 3: near-field correction.
    monopole_pseudo = multipole_order == 1
    if near_mode == "pairs":
        corr = near_pairs_correction(
            prep["pos_g"], prep["pos_g"], prep["mass_g"], prep["com"],
            prep["m_tot"], prep["near_flat"], prep["near_tile_tgt"],
            softening=softening, eps=eps, g=g, backend=backend,
            monopole_pseudo=monopole_pseudo)
        if multipole_order == 2:
            corr = corr + near_pairs_multipole_subtraction(
                prep["pos_g"], summaries, prep["nearq_flat"],
                prep["nearq_tile_tgt"], eps=eps, backend=backend)
    else:
        idx = prep["idx"][c0:c0 + n_clusters]
        corr = near_direct_correction(
            pos_g, idx, prep["pos_g"], prep["mass_g"], prep["com"],
            prep["m_tot"], softening=softening, eps=eps, g=g,
            backend=backend, monopole_pseudo=monopole_pseudo)
        if multipole_order == 2:
            corr = corr + near_multipole_subtraction(
                pos_g, summaries, idx, eps=eps, backend=backend)
    return acc + corr


def near_direct_correction(pos_g_t, idx, pool_pos_g, pool_mass_g, pool_com,
                           pool_m_tot, *, softening, eps, g, backend,
                           monopole_pseudo: bool):
    """Strip-mode near correction of target clusters against a pool of
    source clusters. idx: (G_t, K) slots into the pool; invalid slots
    point to len(pool). Returns (G_t * leaf, 3). Plain PyTorch only."""
    _check_backend(backend)
    if backend == "cuda":
        raise NotImplementedError(
            f"near_mode='strip' has no kernels yet: {_STRIP}")
    aug_pos, aug_gm = _augmented(pool_pos_g, pool_mass_g, pool_com,
                                 pool_m_tot, float(g), monopole_pseudo)
    return _near_correction_plain(
        pos_g_t, aug_pos, aug_gm, idx, softening=softening, eps=eps
    ).reshape(-1, 3)


def near_multipole_subtraction(pos_g_t, summaries, idx, *, eps, backend):
    """Strip-mode subtraction of the quadrupole far field of each target
    cluster's near list (idx indexes `summaries` columns; invalid = the
    trailing null column). Returns (G_t * leaf, 3). Plain PyTorch only."""
    _check_backend(backend)
    if backend == "cuda":
        raise NotImplementedError(
            f"near_mode='strip' has no kernels yet: {_STRIP}")
    return _near_multipole_sub_plain(pos_g_t, _negated(summaries), idx,
                                     eps=eps)


def near_pairs_correction(pos_g_t, pool_pos_g, pool_mass_g, pool_com,
                          pool_m_tot, flat_src, tile_tgt, *, softening, eps,
                          g, backend, monopole_pseudo: bool, accum="vpu"):
    """Pair-list near correction of target clusters against a pool of source
    clusters (flat_src, tile_tgt from `near_pair_segments` over pool slots).
    Returns (G_t * leaf, 3). There is no live-tile count to pass:
    tile_tgt's padding already marks the live range."""
    _check_backend(backend)
    _check_accum(accum)
    srows = _pack_augmented(pool_pos_g, pool_mass_g, pool_com, pool_m_tot,
                            float(g), monopole_pseudo=monopole_pseudo)
    fn = (cuda_tree.near_pairs_direct if backend == "cuda"
          else cuda_tree.near_pairs_direct_plain)
    return fn(pos_g_t, srows, flat_src, tile_tgt, softening=softening,
              eps=eps).reshape(-1, 3)


def near_pairs_multipole_subtraction(pos_g_t, summaries, flat_src, tile_tgt,
                                     *, eps, backend):
    """Pair-list subtraction of the near clusters' multipoles (flat_src
    slots into `summaries` columns; invalid = the trailing null column).
    Returns (G_t * leaf, 3)."""
    _check_backend(backend)
    fn = (cuda_tree.near_pairs_quad if backend == "cuda"
          else cuda_tree.near_pairs_quad_plain)
    return fn(pos_g_t, _negated(summaries), flat_src, tile_tgt, eps=eps)


def resolve_far_levels(far_levels, gg: int, multipole_order: int) -> int:
    """The JAX package's rule: "auto" is 3 levels for quadrupoles at
    FAR3_CUTOFF clusters and above, else 2."""
    if far_levels == "auto":
        return 3 if (multipole_order == 2 and gg >= FAR3_CUTOFF) else 2
    return int(far_levels)


def _gg_for(n: int, far_levels, multipole_order: int, leaf: int = LEAF,
            cluster_mode: str = "equal") -> int:
    """Cluster-count cap for N bodies; SUPER-aligned where the JAX package
    would engage the 3-level far field."""
    if cluster_mode == "adaptive":
        gg = cluster_ops.g_cap_for(n, leaf)
    else:
        gg = max(1, math.ceil(n / leaf))
    if resolve_far_levels(far_levels, gg, multipole_order) == 3:
        gg = -(-gg // SUPER) * SUPER
    return gg


def acc_tree(pos, mass, *, theta: float = constants.BARNES_HUT_THETA,
             softening: str = "plummer", eps=None, g=None,
             backend: str = "torch", k_near: int | None = None,
             multipole_order: int = 1, far_levels="auto",
             leaf: int = LEAF, cluster_mode: str = "equal",
             near_mode: str = "strip", near_tiles: int | None = None,
             near_tiles_q: int | None = None, gg: int | None = None,
             k_super: int | None = None, pairs_accum: str = "vpu"):
    """Clustered Barnes-Hut acceleration: (N, 3), (N,) -> (N, 3)."""
    if softening not in direct.SOFTENINGS:
        raise ValueError(f"unknown softening {softening!r}")
    eps, g = direct._defaults(softening, eps, g)
    if gg is None:
        gg = _gg_for(pos.shape[0], far_levels, multipole_order, leaf,
                     cluster_mode)
    far_levels = resolve_far_levels(far_levels, gg, multipole_order)
    if k_near is None:
        k_near = default_k_near(theta, gg)
    prep = tree_prep(pos, mass, theta=theta, k_near=k_near, gg=gg,
                     far_levels=far_levels, leaf=leaf,
                     cluster_mode=cluster_mode, near_mode=near_mode,
                     near_tiles=near_tiles, near_tiles_q=near_tiles_q,
                     k_super=k_super)
    acc = tree_eval(prep, 0, gg, softening=softening, eps=eps, g=g,
                    backend=backend,
                    multipole_order=multipole_order, far_levels=far_levels,
                    near_mode=near_mode, pairs_accum=pairs_accum)
    return cluster_ops.unsort_slots(acc, prep["clusters"], prep["inv"])


def acc_tree_cached(pos, mass, structure, *, softening: str, eps, g,
                    backend: str, multipole_order: int = 1,
                    far_levels: int = 2, near_mode: str = "strip",
                    pairs_accum: str = "vpu"):
    """`acc_tree` with a cached `tree_structure` dict: statistics are
    recomputed from the current positions; the sort, the clustering and the
    near lists are reused."""
    clusters = structure["clusters"]
    gg = structure["idx"].shape[0]
    stats = cluster_stats(pos, mass, structure["perm"], clusters)
    prep = dict(structure, **stats)
    acc = tree_eval(prep, 0, gg, softening=softening, eps=eps, g=g,
                    backend=backend,
                    multipole_order=multipole_order, far_levels=far_levels,
                    near_mode=near_mode, pairs_accum=pairs_accum)
    return cluster_ops.unsort_slots(acc, clusters, structure["inv"])
