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

With quadrupoles, ``far_levels=3`` replaces the dense (N x G) far field by
a pass over SUPER-cluster multipoles in which each target super masks out
its near supers, and puts those back at finer resolution: in pair mode as
MID-node multipoles (M1) and, for the near MIDs, cluster multipoles (M2);
in strip mode as the member clusters of the near supers.

Ported: far_levels 2 and 3, the equal-count and the adaptive partition,
multipole orders 1 and 2, the near phase as a pair list
(``near_mode="pairs"``, through the kernels of `ops/cuda_tree.py`) and as
per-cluster strips (``near_mode="strip"``, plain PyTorch only), and the
pair list's near correction summed directly or in the hybrid rank-1 form
(``pairs_accum="mxu"``). Strip mode on the card raises
`NotImplementedError`.

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
#: summary columns per tile of the quadrupole pair lists
NEAR_QUAD_PJ = cuda_tree.NEAR_QUAD_PJ
#: switch the far field to three levels at this many clusters
FAR3_CUTOFF = 4096
#: clusters per MID node, the middle level of the pair-mode 3-level far
#: field (SUPER is a multiple): a near SUPER decomposes into its MID
#: multipoles, and only near MIDs decompose further into cluster multipoles
MID = 8

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


def _super_stats(com, m_tot, r_src, r_tgt, group: int = SUPER):
    """Aggregate cluster summaries into bounds for `group`-cluster nodes
    (SUPER, or MID for the pair-mode 3-level far field): (com2, c_spread,
    rs_max, rt_max) per node, where c_spread bounds the distance of a
    member's centre from the node centroid. m_tot is taken for the JAX
    package's signature; the bounds do not read it."""
    del m_tot
    g = com.shape[0]
    g2 = -(-g // group)
    pad = g2 * group - g
    if pad:
        # padding members collapse onto the last real centre with zero radii
        com = torch.cat([com, com[-1].expand(pad, 3)])
        r_src = torch.cat([r_src, r_src.new_zeros(pad)])
        r_tgt = torch.cat([r_tgt, r_tgt.new_zeros(pad)])
    com_g = com.reshape(g2, group, 3)
    com2 = torch.mean(com_g, dim=1)
    c_spread = torch.amax(_norm(com_g - com2[:, None, :]), dim=1)
    rs_max = torch.amax(r_src.reshape(g2, group), dim=1)
    rt_max = torch.amax(r_tgt.reshape(g2, group), dim=1)
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
    com2, spread, rs_max, rt_max = _super_stats(com, m_tot, r_src, r_tgt)
    possible, d2 = _super_accept(com2, spread, rs_max, rt_max, theta)
    over2 = torch.sum(torch.sum(possible, dim=1) > k_super)
    masked2 = torch.where(possible, d2, float("inf"))
    cand2 = torch.arange(g2, device=com.device)[None, :]
    return _smallest_k(masked2, cand2, min(k_super, g2), g2), over2


def _pool_near_lists(com, m_tot, r_src, r_tgt, cand, theta: float,
                     k_near: int):
    """Exact near lists of each SUPER's member clusters against a candidate
    pool shared by the super: cand (G2, C) cluster ids, null = G. Runs over
    chunks of supers whose temporaries stay near _CHUNK_ELEMS elements.
    Returns ((G, k_near) ids, overflow)."""
    g = com.shape[0]
    g2, n_cand = cand.shape

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
    rows, over = [], com.new_zeros((), dtype=torch.int64)
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


def _near_lists_hier(com, m_tot, r_src, r_tgt, theta: float, k_near: int,
                     k_super: int | None = None, idx2=None):
    """Two-level near-list build: an O(G2^2) supercluster screen, then the
    exact test over the K2*SUPER member clusters of each target
    supercluster's near supers, in place of the (G, G) distance matrix.
    idx2: a supercluster near list to reuse instead of the screen (the
    3-level far field in strip mode shares it, so that its refinement set
    holds every near cluster). Returns (idx, overflow) like `_near_lists`;
    overflow also counts truncated screen rows, scaled by SUPER."""
    g = com.shape[0]
    g2 = -(-g // SUPER)
    if idx2 is None:
        if k_super is None:
            k_super = default_k_super(theta, g2)
        idx2, over2 = _super_screen(com, m_tot, r_src, r_tgt, theta, k_super)
    else:
        over2 = 0
    # Candidate cluster ids per target supercluster: the members of its
    # near supers; members past G (and invalid supers) map to the null id G.
    members = idx2[:, :, None] * SUPER + torch.arange(SUPER,
                                                      device=com.device)
    cand = torch.clamp_max(members.reshape(g2, -1), g)  # (G2, K2*SUPER)
    idx, over = _pool_near_lists(com, m_tot, r_src, r_tgt, cand, theta,
                                 k_near)
    return idx, over + over2 * SUPER


def near_lists(com, m_tot, r_src, r_tgt, theta: float, k_near: int,
               k_super: int | None = None):
    """(G, K) near-cluster lists and the on-device overflow count."""
    k_near = min(k_near, com.shape[0])
    if com.shape[0] > HIER_NEAR_CUTOFF:
        return _near_lists_hier(com, m_tot, r_src, r_tgt, theta, k_near,
                                k_super=k_super)
    return _near_lists(com, m_tot, r_src, r_tgt, theta, k_near)


# --- the MID level of the pair-mode 3-level far field ------------------------


def default_k_mid(theta: float, g_m: int) -> int:
    """Static cap on the union of near MID nodes of one SUPER: the union
    spans the super's hull plus the MID-level accept radius, so the cap
    sits in the hundreds. `measure_near` measures it instead."""
    k = int(24.0 * (1.0 + 1.0 / (2.0 * theta)) ** 3) + 16
    return max(16, min(g_m, k))


def _mid_near_lists(com, m_tot, r_src, r_tgt, com_m, spread_m, rs_max_m,
                    m_tot_m, idx2, theta: float, k_mid: int):
    """Per-target-SUPER union near-MID lists (G2, k_mid), null = G_m, and
    the count of rows that overflowed k_mid.

    Candidates are the MID nodes of the super's near supers (idx2 rows;
    the null super G2 maps to the null mid G_m). A mid M is near the super
    iff it is near ANY member cluster t: (rs_max_M + spread_M) >= theta *
    (d(t, M) - rt_t). With theta <= 1 every cluster-level accept implies
    this one, so the cluster near lists built from the kept mids' members
    hold every near cluster. Rows are ascending in the worst member's
    margin min_t(d - rt_t), so an overflowing row drops its farthest mids,
    which the M1 pass then evaluates as mid multipoles. Runs over chunks of
    supers whose temporaries stay near _CHUNK_ELEMS elements."""
    g = com.shape[0]
    g2, k2 = idx2.shape
    if g % SUPER:
        raise ValueError(f"G={g} not SUPER-aligned")
    spm = SUPER // MID
    g_m = g // MID
    dev = com.device
    cand = torch.clamp_max(
        idx2[:, :, None] * spm + torch.arange(spm, device=dev), g_m
    ).reshape(g2, k2 * spm)
    n_cand = cand.shape[1]
    cm = torch.cat([com_m, com_m.new_zeros((1, 3))])
    reach = torch.cat([rs_max_m + spread_m, rs_max_m.new_zeros(1)])
    mm = torch.cat([m_tot_m, m_tot_m.new_zeros(1)])
    com_t = com.reshape(g2, SUPER, 3)
    rt_t = r_tgt.reshape(g2, SUPER)
    k_eff = min(k_mid, n_cand)
    rows, over = [], com.new_zeros((), dtype=torch.int64)
    step = max(1, _CHUNK_ELEMS // (SUPER * n_cand))
    for s0 in range(0, g2, step):
        cb = cand[s0:s0 + step]  # (B, C)
        dist = _pair_dist(com_t[s0:s0 + step], cm[cb])  # (B, SUPER, C)
        margin = torch.amin(dist - rt_t[s0:s0 + step, :, None], dim=1)
        near = (reach[cb] >= theta * margin) & (mm[cb] > 0)
        over = over + torch.sum(torch.sum(near, dim=1) > k_mid)
        masked = torch.where(near, margin, float("inf"))
        rows.append(_smallest_k(masked, cb, k_eff, g_m))
    idx = torch.cat(rows)
    if k_eff < k_mid:
        idx = torch.cat([idx, idx.new_full((g2, k_mid - k_eff), g_m)], dim=1)
    return idx, over


def _near_lists_from_mids(com, m_tot, r_src, r_tgt, idx_mid2, theta: float,
                          k_near: int):
    """Exact per-cluster near lists from each super's near-MID pool: the
    k_mid * MID member clusters of its idx_mid2 row, shared by its SUPER
    target clusters. Every near cluster's mid is in its super's union
    near-mid list (see `_mid_near_lists`), so the pool covers it.
    Returns ((G, k_near) ids, overflow)."""
    g = com.shape[0]
    g2 = idx_mid2.shape[0]
    cand = torch.clamp_max(
        idx_mid2[:, :, None] * MID + torch.arange(MID, device=com.device), g
    ).reshape(g2, -1)  # (G2, k_mid * MID), null = G
    return _pool_near_lists(com, m_tot, r_src, r_tgt, cand, theta, k_near)


def _m1_lists(idx2, idx_mid2, gg: int):
    """Per-SUPER M1 source lists (G2, K2 * SUPER/MID): the MID nodes of the
    super's near supers MINUS the super's near mids, which M2 covers at
    cluster resolution. The exclusion uses exactly the kept idx_mid2
    entries: a mid in both passes would count twice, one in neither would
    leave a hole. Null = G_m."""
    g2, k2 = idx2.shape
    spm = SUPER // MID
    g_m = gg // MID
    dev = idx2.device
    mids_sup = torch.clamp_max(
        idx2[:, :, None] * spm + torch.arange(spm, device=dev), g_m
    ).reshape(g2, k2 * spm)
    mask = torch.zeros((g2, g_m + 1), dtype=torch.bool, device=dev)
    mask[torch.arange(g2, device=dev)[:, None],
         torch.clamp_max(idx_mid2, g_m)] = True
    mask[:, g_m] = False  # the null mid is never near
    hit = torch.gather(mask, 1, mids_sup)
    return torch.where(hit, g_m, mids_sup)


def shared_pair_segments(ids, n_src: int, cap_src: int | None = None):
    """Flatten per-SUPER source lists (G2, W) into shared-strip pair tiles
    for `cuda_tree.near_pairs_quad_shared`: each super's valid ids pack into
    max(ceil(c / NEAR_QUAD_PJ), 1) source tiles, and each of its SUPER
    member clusters gets one pair tile per source tile, which reads the
    shared strip through `tile_src`. Rows may hold interior nulls (>=
    n_src, M1's exclusion holes); entries are rank-packed.

    cap_src bounds the SOURCE tiles (default: the worst case
    G2 * ceil(W / pj)); entries beyond it are dropped tail first and
    counted (each drop loses one source node's far contribution for the
    super's SUPER member clusters). tile_tgt = a * SUPER + i is
    non-decreasing, so every target cluster owns one contiguous range of
    tiles (`cuda_tree.tile_starts`).

    Returns (flat_src (cap_src * pj,), tile_tgt (cap_src * SUPER,), tile_src
    (the same), n_tiles, dropped); tile_tgt pads with G2 * SUPER, tile_src
    with 0."""
    g2, w = ids.shape
    pj = NEAR_QUAD_PJ
    gg = g2 * SUPER
    dev = ids.device
    if cap_src is None:
        cap_src = g2 * max(-(-w // pj), 1)
    c = torch.sum(ids < n_src, dim=1)
    st = torch.clamp_min(-(-c // pj), 1)
    csum_s = torch.cumsum(st, dim=0)
    src_offs = torch.cat([csum_s.new_zeros(1), csum_s[:-1]])
    flat, _, dropped = _pack_rows_flat(ids, n_src, pj, cap_src, src_offs, c)
    # per-super KEPT source tiles (a partial strip keeps its prefix)
    st_k = torch.minimum(torch.clamp_min(cap_src - src_offs, 0), st)
    csum_t = torch.cumsum(SUPER * st_k, dim=0)
    toffs = torch.cat([csum_t.new_zeros(1), csum_t[:-1]])
    n_tiles = csum_t[-1]
    t_range = torch.arange(cap_src * SUPER, device=dev)
    a = torch.searchsorted(toffs, t_range, right=True) - 1
    w_in = t_range - toffs[a]
    st_a = torch.clamp_min(st_k[a], 1)
    i = w_in // st_a
    live = t_range < n_tiles
    tile_tgt = torch.where(live, a * SUPER + i, gg)
    tile_src = torch.where(live, src_offs[a] + (w_in - i * st_a), 0)
    return flat, tile_tgt, tile_src, n_tiles, dropped


def mid_pair_segments(idx2, idx_mid2, gg: int, *, m1_src_tiles=None,
                      m2_src_tiles=None):
    """The M1 and M2 shared-strip tile lists of the pair-mode MID far field:
    M1 evaluates mid multipoles (near supers' mids minus near mids), M2 the
    cluster multipoles of the near mids. Returns (segs, dropped): segs is
    the dict of m1_/m2_ flat/tgt/src/ntiles tensors that `mid_far_eval`
    reads; dropped is the overflow count, scaled by SUPER (a dropped source
    entry loses one node's far term for the super's SUPER member
    clusters)."""
    g_m = gg // MID
    f1, t1, s1, n1, d1 = shared_pair_segments(
        _m1_lists(idx2, idx_mid2, gg), g_m, cap_src=m1_src_tiles)
    m2_ids = torch.clamp_max(
        idx_mid2[:, :, None] * MID + torch.arange(MID, device=idx2.device),
        gg).reshape(idx_mid2.shape[0], -1)
    f2, t2, s2, n2, d2 = shared_pair_segments(m2_ids, gg,
                                              cap_src=m2_src_tiles)
    segs = dict(m1_flat=f1, m1_tgt=t1, m1_src=s1, m1_ntiles=n1,
                m2_flat=f2, m2_tgt=t2, m2_src=s2, m2_ntiles=n2)
    return segs, (d1 + d2) * SUPER


def measure_near(pos, mass, *, theta: float, gg: int, leaf: int = LEAF,
                 cluster_mode: str = "equal", headroom: float = 1.25,
                 chunk: int = 2048, measure_mid: bool = True) -> dict:
    """Measure the scene's near-list shape for static sizing: per-cluster
    near counts -> the k_near cap, the pair-list tile capacities, the
    supercluster screen cap and the cluster count. Equal-count clusters in
    sparse regions of a high-density-contrast scene (a Plummer sphere) have
    huge radii, where the geometric `default_k_near` underestimates badly.

    With measure_mid and a SUPER-aligned gg, also the caps of the pair-mode
    3-level far field: k_mid (the per-super union near-MID count over all
    mids, a superset of the runtime pool), and the M1 and M2 source-tile
    totals of the lists the scene actually builds.

    Counts in chunks on the device, O(chunk * G) memory, and reads the
    counts back to the host: call it when a simulation is set up, not in
    its step. Returns dict(k_near, near_tiles, near_tiles_q, n_clusters,
    k_super[, k_mid, m1_src_tiles, m2_src_tiles]) of Python ints, all
    scaled by `headroom`."""
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
    com2, spread, rs_max, rt_max = _super_stats(com, m_tot, r_src, r_tgt)
    possible, _ = _super_accept(com2, spread, rs_max, rt_max, theta)
    cnt2 = int(torch.sum(possible, dim=1).max())
    out["k_super"] = max(4, min(g2, int(cnt2 * headroom) + 4))
    if measure_mid and gg % SUPER == 0:
        out.update(_measure_mid(com, m_tot, r_src, r_tgt, theta,
                                out["k_super"], headroom))
    return out


def _measure_mid(com, m_tot, r_src, r_tgt, theta: float, k_super: int,
                 headroom: float) -> dict:
    """`measure_near`'s caps of the MID far field: k_mid from the union
    near-MID count of each super over ALL mids (conservative), then the
    M1 and M2 source-tile totals of the lists built at that cap, sized to
    what the scene needs instead of the worst case G2 * ceil(W / pj)."""
    gg = com.shape[0]
    g_m = gg // MID
    g2s = gg // SUPER
    com_m, spread_m, rs_max_m, _ = _super_stats(com, m_tot, r_src, r_tgt,
                                                group=MID)
    reach_m = rs_max_m + spread_m
    m_tot_m = m_tot.reshape(-1, MID).sum(dim=1)
    com_s = com.reshape(g2s, SUPER, 3)
    rt_s = r_tgt.reshape(g2s, SUPER)
    cu = []
    step = max(1, _CHUNK_ELEMS // (SUPER * g_m))
    for a0 in range(0, g2s, step):
        dist = _pair_dist(com_s[a0:a0 + step], com_m)  # (B, SUPER, G_m)
        margin = torch.amin(dist - rt_s[a0:a0 + step, :, None], dim=1)
        near = (reach_m >= theta * margin) & (m_tot_m > 0)
        cu.append(torch.sum(near, dim=1))
    k_mid = max(16, min(g_m, int(int(torch.cat(cu).max()) * headroom) + 8))
    idx2, _ = _super_screen(com, m_tot, r_src, r_tgt, theta, k_super)
    idx_mid2, _ = _mid_near_lists(com, m_tot, r_src, r_tgt, com_m, spread_m,
                                  rs_max_m, m_tot_m, idx2, theta, k_mid)
    c1 = torch.sum(_m1_lists(idx2, idx_mid2, gg) < g_m, dim=1)
    c2 = torch.sum(idx_mid2 < g_m, dim=1) * MID
    st1, st2 = (torch.clamp_min(-(-c // NEAR_QUAD_PJ), 1).sum().item()
                for c in (c1, c2))
    return dict(k_mid=k_mid, m1_src_tiles=int(st1 * headroom) + 8,
                m2_src_tiles=int(st2 * headroom) + 8)


def measure_k_near(pos, mass, *, theta: float, gg: int,
                   headroom: float = 1.25, chunk: int = 2048) -> int:
    """The measured k_near cap only."""
    return measure_near(pos, mass, theta=theta, gg=gg, headroom=headroom,
                        chunk=chunk, measure_mid=False)["k_near"]


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


def _super_multipoles(summaries, group: int = SUPER):
    """Aggregate cluster summaries (16, G) into `group`-cluster node
    summaries (16, G / group) about the mass-weighted node centre (SUPER
    nodes for the dense pass, MID nodes for M1), with the parallel-axis
    theorem for the traceless quadrupole:
        Q2 = sum_i [Q_i + m_i (3 d_i d_i^T - |d_i|^2 I)],  d_i = com_i - com2.
    G must be a multiple of `group`."""
    g = summaries.shape[1]
    if g % group:
        raise ValueError(f"G={g} not a multiple of group={group}")
    s = summaries.reshape(16, g // group, group)
    com, gm = s[0:3], s[3]
    gm2 = torch.sum(gm, dim=-1)
    com2 = torch.sum(com * gm[None], dim=-1) / torch.clamp_min(gm2, 1e-30)
    d = com - com2[:, :, None]  # (3, G2, group)
    d2 = torch.sum(d * d, dim=0)
    out = summaries.new_zeros((16, g // group))
    out[0:3] = com2
    out[3] = gm2
    # rows 4-9: xx yy zz xy xz yz
    for row, (i, j) in zip(range(4, 7), ((0, 0), (1, 1), (2, 2))):
        out[row] = torch.sum(s[row] + gm * (3 * d[i] * d[j] - d2), dim=-1)
    for row, (i, j) in zip(range(7, 10), ((0, 1), (0, 2), (1, 2))):
        out[row] = torch.sum(s[row] + gm * 3 * d[i] * d[j], dim=-1)
    return out


def superfar_dense_masked(targets, super_summaries, idx2_t, *, eps,
                          backend):
    """Dense supercluster far field with each target super's near supers
    masked out (their g*M and g*Q zeroed, which adds exactly 0): their
    contribution comes only from the finer levels, so no near super's
    multipole is ever summed and then cancelled. targets: (n2 * SUPER *
    leaf, 3) slot-order bodies of n2 target supers; idx2_t: (n2, K2) near
    super ids, null = G2."""
    _check_backend(backend)
    fn = (cuda_tree.acc_cross_quad_masked if backend == "cuda"
          else cuda_tree.acc_cross_quad_masked_plain)
    return fn(targets, super_summaries, idx2_t, eps=eps)


#: strip width of the strip-mode refinement tables, as the JAX package pads
#: them (zero columns add exactly 0)
_SUPERFAR_TILE_J = 512


def _superfar_refine_table(summaries, super_summaries, idx2):
    """Per-supercluster refinement strips of the strip-mode 3-level far
    field: for target super A, the cluster summaries of A's K2 near supers,
    which `superfar_dense_masked` leaves out. Returns (16, G2 * S_pad) with
    S_pad = K2 * SUPER rounded up to _SUPERFAR_TILE_J."""
    del super_summaries  # near supers are masked out of the dense pass
    g = summaries.shape[1]
    g2, k2 = idx2.shape
    table = torch.cat([summaries, summaries.new_zeros((16, 1))], dim=1)
    cols = torch.clamp_max(
        idx2[:, :, None] * SUPER + torch.arange(SUPER, device=idx2.device),
        g).reshape(g2, k2 * SUPER)
    s_pad = -(-cols.shape[1] // _SUPERFAR_TILE_J) * _SUPERFAR_TILE_J
    if s_pad != cols.shape[1]:
        cols = torch.cat(
            [cols, cols.new_full((g2, s_pad - cols.shape[1]), g)], dim=1)
    return table[:, cols.reshape(-1)]


def _superfar_refine_plain(pos_g, strips, *, eps):
    """Each target super's clusters against its own refinement strip:
    pos_g (G, leaf, 3) with G a multiple of SUPER, strips (16, G2 * S_pad)
    -> (G * leaf, 3). Plain PyTorch only (strip mode on the card is Queue
    B 10)."""
    gg, leaf = pos_g.shape[:2]
    g2 = gg // SUPER
    s_pad = strips.shape[1] // g2
    strips = strips.reshape(16, g2, s_pad).permute(1, 0, 2)
    targets = pos_g.reshape(g2, SUPER * leaf, 3)
    step = max(1, _CHUNK_ELEMS // (SUPER * leaf * s_pad))
    out = [cuda_tree._quad_terms(targets[a:a + step], strips[a:a + step],
                                 float(eps)) for a in range(0, g2, step)]
    return torch.cat(out).reshape(gg * leaf, 3)


def mid_far_eval(pos_g, summaries_null, segs, *, eps, backend: str):
    """The M1 + M2 passes of the pair-mode MID far field over the tile lists
    of `mid_pair_segments`: M1 against MID multipoles, M2 against cluster
    multipoles. summaries_null: (16, G + 1) cluster summaries with a
    trailing null column. Returns (G * leaf, 3)."""
    _check_backend(backend)
    gg = summaries_null.shape[1] - 1
    mid = _super_multipoles(summaries_null[:, :gg], group=MID)
    mid_ext = torch.cat([mid, mid.new_zeros((16, 1))], dim=1)
    fn = (cuda_tree.near_pairs_quad_shared if backend == "cuda"
          else cuda_tree.near_pairs_quad_shared_plain)
    return (fn(pos_g, mid_ext, segs["m1_flat"], segs["m1_tgt"],
               segs["m1_src"], eps=eps)
            + fn(pos_g, summaries_null, segs["m2_flat"], segs["m2_tgt"],
                 segs["m2_src"], eps=eps))


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
    n = pos.shape[0]
    if cluster_mode == "adaptive":
        perm, inv, hi_s, lo_s = morton.sfc_sort_2w(pos)
        clusters = cluster_ops.adaptive_clusters(hi_s, lo_s, n, leaf, gg,
                                                 device=pos.device)
        stats = cluster_stats(pos, mass, perm, clusters)
    elif cluster_mode == "equal":
        perm, inv = morton.morton_order(pos)
        clusters = cluster_ops.equal_clusters(n, leaf, gg, device=pos.device)
        stats = tree_sorted_stats(pos, mass, perm, gg, leaf)
    else:
        raise ValueError(f"unknown cluster_mode {cluster_mode!r}")
    return perm, inv, clusters, stats


def _check_far_levels(far_levels):
    if far_levels not in (2, 3):
        raise ValueError(f"far_levels must be 2 or 3, got {far_levels}")


def tree_prep(pos, mass, *, theta: float, k_near: int, gg: int,
              far_levels: int = 2, leaf: int = LEAF,
              cluster_mode: str = "equal", near_mode: str = "strip",
              near_tiles: int | None = None,
              near_tiles_q: int | None = None,
              k_super: int | None = None, k_mid: int | None = None,
              m1_src_tiles: int | None = None,
              m2_src_tiles: int | None = None):
    """Phase 1: sort, clustering, statistics, near lists. Returns a dict of
    sorted and packed tensors plus perm/inv/clusters/idx, idx2 (with
    far_levels=3 the supercluster near list that the far field masks and
    refines, so that the refined set holds every near cluster; a (1, 1)
    placeholder otherwise), the flattened tile lists when near_mode="pairs"
    (see `near_pair_segments`), for far_levels=3 in pair mode the m1_*/m2_*
    tile lists of the MID far field (see `mid_pair_segments`), and
    ``near_overflow``, a 0-d tensor. Reads nothing back to the host."""
    _check_far_levels(far_levels)
    perm, inv, clusters, stats = _build_clustering(pos, mass, gg, leaf,
                                                   cluster_mode)
    com, m_tot = stats["com"], stats["m_tot"]
    r_src, r_tgt = stats["r_src"], stats["r_tgt"]
    mid_pairs = far_levels == 3 and near_mode == "pairs"
    if far_levels == 3:
        if gg % SUPER:
            raise ValueError(f"far_levels=3 needs gg % {SUPER} == 0, got {gg}")
        idx2, over2 = _super_screen(
            com, m_tot, r_src, r_tgt, theta,
            k_super or default_k_super(theta, gg // SUPER))
        if mid_pairs:
            # near supers decompose into MID multipoles (M1) and only near
            # MIDs into cluster multipoles (M2); the cluster near lists come
            # from the near-MID pool
            com_m, spread_m, rs_max_m, _ = _super_stats(
                com, m_tot, r_src, r_tgt, group=MID)
            m_tot_m = m_tot.reshape(-1, MID).sum(dim=1)
            if k_mid is None:
                k_mid = default_k_mid(theta, gg // MID)
            idx_mid2, over_mid = _mid_near_lists(
                com, m_tot, r_src, r_tgt, com_m, spread_m, rs_max_m,
                m_tot_m, idx2, theta, k_mid)
            idx, over_near = _near_lists_from_mids(
                com, m_tot, r_src, r_tgt, idx_mid2, theta, k_near)
            overflow = over_near + (over_mid + over2) * SUPER
        else:
            idx, overflow = _near_lists_hier(com, m_tot, r_src, r_tgt,
                                             theta, k_near, idx2=idx2)
            overflow = overflow + over2 * SUPER
    else:
        idx2 = torch.zeros((1, 1), dtype=torch.int64, device=pos.device)
        idx, overflow = near_lists(com, m_tot, r_src, r_tgt, theta, k_near,
                                   k_super=k_super)
    prep = dict(idx=idx, idx2=idx2, perm=perm, inv=inv, clusters=clusters,
                **stats)
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
        if mid_pairs:
            segs, dropped = mid_pair_segments(
                idx2, idx_mid2, gg, m1_src_tiles=m1_src_tiles,
                m2_src_tiles=m2_src_tiles)
            prep.update(segs)
            overflow = overflow + dropped
    elif near_mode != "strip":
        raise ValueError(f"unknown near_mode {near_mode!r}")
    prep["near_overflow"] = overflow + clusters.overflow
    return prep


#: keys of the tree_prep entries that stay valid across steps (bodies move
#: a tiny fraction of a cluster radius per step); everything else is a
#: statistic of the current positions, recomputed by `acc_tree_cached`.
STRUCTURE_KEYS = ("perm", "inv", "clusters", "idx", "idx2",
                  "near_flat", "near_tile_tgt", "near_ntiles",
                  "nearq_flat", "nearq_tile_tgt", "nearq_ntiles",
                  "m1_flat", "m1_tgt", "m1_src", "m1_ntiles",
                  "m2_flat", "m2_tgt", "m2_src", "m2_ntiles")


def tree_structure(pos, mass, **kw):
    """The cacheable part of tree construction: the curve sort, the
    clustering and the near lists with their tile lists. Takes the keyword
    arguments of `tree_prep`; returns the STRUCTURE_KEYS present."""
    p = tree_prep(pos, mass, **kw)
    return {k: p[k] for k in STRUCTURE_KEYS if k in p}


def structure_from_numpy(d: dict, *, device=None,
                         keys=STRUCTURE_KEYS) -> dict:
    """A structure for `acc_tree_cached` from the `spacetpu` package's
    `tree_structure` dict given as numpy arrays, with ``clusters`` as the
    tuple of its five fields (`keys`: the structure keys to carry, the
    tree's by default). Integers become int64. The structure goes to
    the card unless the caller names another device, as `state_from_numpy`
    does; without a card that raises."""
    dev = resolve_device(device)

    def conv(x):
        t = torch.as_tensor(np.array(x), device=dev)
        return t if t.dtype == torch.bool else t.to(torch.int64)

    out = {k: conv(d[k]) for k in keys if k in d and k != "clusters"}
    out["clusters"] = cluster_ops.Clusters(*(conv(x) for x in d["clusters"]))
    return out


# --- evaluation --------------------------------------------------------------


def _check_backend(backend: str):
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (want 'cuda' or "
                         "'torch')")


#: near-pair accumulations: "vpu" sums w (x_j - x_i) directly, "mxu" in the
#: hybrid rank-1 form of `tree._kernel_pairs_hybrid` (kernel pairs_hybrid)
PAIRS_ACCUMS = ("vpu", "mxu")


def _check_accum(accum: str):
    if accum not in PAIRS_ACCUMS:
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

    far_levels=3 (multipole_order=2; G, c0 and n_clusters multiples of
    SUPER): the dense pass runs against SUPER-cluster multipoles with each
    target super's near supers (prep["idx2"]) masked out, and those come
    back finer: through the MID far field (`mid_far_eval`) where prep holds
    its tile lists, else through per-super strips of their member
    clusters (plain PyTorch only). O(N (G2 + K2 * SUPER/MID + k_mid * MID))
    in pair mode instead of O(N G).

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
    if far_levels == 3 and multipole_order != 2:
        raise ValueError("far_levels=3 requires multipole_order=2")
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
    if far_levels == 3:
        if gg % SUPER or c0 % SUPER or n_clusters % SUPER:
            raise ValueError("far_levels=3 needs SUPER-aligned blocks")
        super_summaries = _super_multipoles(summaries[:, :gg])
        s2, n2 = c0 // SUPER, n_clusters // SUPER
        acc = superfar_dense_masked(targets, super_summaries,
                                    prep["idx2"][s2:s2 + n2], eps=eps,
                                    backend=backend)
        if "m1_tgt" in prep:
            acc = acc + mid_far_eval(pos_g, summaries, prep, eps=eps,
                                     backend=backend)
        elif backend == "cuda":
            raise NotImplementedError(
                "the strip refinement of far_levels=3 has no kernel yet: "
                f"{_STRIP}; build the structure with near_mode='pairs'")
        else:
            strips = _superfar_refine_table(summaries[:, :gg],
                                            super_summaries, prep["idx2"])
            s_pad = strips.shape[1] // (gg // SUPER)
            acc = acc + _superfar_refine_plain(
                pos_g, strips[:, s2 * s_pad:(s2 + n2) * s_pad], eps=eps)
    elif multipole_order == 2:
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
            monopole_pseudo=monopole_pseudo, accum=pairs_accum)
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
    tile_tgt's padding already marks the live range. accum="mxu" sums in
    the hybrid rank-1 form (`cuda_tree.near_pairs_hybrid`)."""
    _check_backend(backend)
    _check_accum(accum)
    srows = _pack_augmented(pool_pos_g, pool_mass_g, pool_com, pool_m_tot,
                            float(g), monopole_pseudo=monopole_pseudo)
    if accum == "mxu":
        fn = (cuda_tree.near_pairs_hybrid if backend == "cuda"
              else cuda_tree.near_pairs_hybrid_plain)
    else:
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
             k_super: int | None = None, k_mid: int | None = None,
             m1_src_tiles: int | None = None,
             m2_src_tiles: int | None = None, pairs_accum: str = "vpu"):
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
                     k_super=k_super, k_mid=k_mid, m1_src_tiles=m1_src_tiles,
                     m2_src_tiles=m2_src_tiles)
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
