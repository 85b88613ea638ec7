"""How closely the body pair kernels of `spacetpu_torch.ops.cuda_tree`
(`pairs_direct`, `pairs_hybrid`, `pairs_short`, `pairs_short_hybrid`) must
match exact sums in float32, and the inputs they are held on.

Without softening, close pairs make a target's force a small difference of
large terms; the short-range law is itself a difference, the softened
weight minus the long-range one; and in the hybrid form every pair rides
two sums at about a cluster's radius. A share of max|a| bounds none of
these. So a float32 result is held target by target and axis by axis
against the same sum taken in float64 on the same inputs, over the size of
what its arithmetic rounds: sum_j W_j |x_j - x_i|, plus in the centred
rank-1 form sum_j W_j (|x_j - c| + |x_i - c|), where W_j is |w_j| for the
direct law and |w_pair| + |w_long| (both times g m_j) for the short-range
law. A kernel that is right up to float32 rounding stays far below
`F32_TOL` of that size; one that drops a term, the subtraction or the
split does not (`mutant_ratios`).

Also the ragged inputs the far field's dense kernels (`quad_dense`,
`quad_masked`) and the quadrupole list kernels (`pairs_quad`, `quad_strip`)
are held on (`quad_dense_case`, `quad_masked_case`, `pairs_quad_case`,
`quad_strip_case`).

Shared by tests/test_torch_gpu.py, tests/test_torch_pair_hold.py,
chip_smoke.py and tools/compare_parent.py. Imports neither JAX nor
`spacetpu`.
"""

import math

import numpy as np
import torch

from spacetpu_torch.ops import cuda_tree, direct
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.ops import treepm as treepm_ops

#: float32: |result - float64 sum| <= F32_TOL * term size, every target, axis
F32_TOL = 1e-5
#: float64 against the float64 sums (the same arithmetic in another order):
#: pairs_short's poly walk, whose skipped pairs add exactly 0, held target
#: by target within F64_TOL of the term size
F64_TOL = 1e-12

#: (short-range law, hybrid sums) of each body kernel
KERNELS = {"pairs_direct": (False, False), "pairs_hybrid": (False, True),
           "pairs_short": (True, False), "pairs_short_hybrid": (True, True)}


def short_inputs(n, leaf, rcut, dtype, dev):
    """A TreePM cutoff tile list of a uniform cloud built by the port's own
    treepm_prep (every cluster's list uncapped), with the tree's source
    table (a -M pseudo-body a cluster) under True and TreePM's (a massless
    pseudo slot) under False."""
    rng = np.random.default_rng(n)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    gg = -(-n // leaf)
    prep = treepm_ops.treepm_prep(pos, mass, rcut=rcut, k_near=gg, gg=gg,
                                  leaf=leaf)
    stats = (prep["pos_g"], prep["mass_g"], prep["com"], prep["m_tot"])
    return prep, {p: tree_ops._pack_augmented(*stats, 1.0, monopole_pseudo=p)
                  for p in (True, False)}


def _weight(softening, eps, rs=None, rcut=None, split=None):
    if split is None:
        return lambda r2: direct._pair_weight(r2, softening, float(eps))
    return cuda_tree._short_weight(softening, eps, rs, rcut, split)


def _walk(pos_g, srows, flat_src, tile_tgt, contrib, channels):
    """Sum contrib(targets (C, leaf, 3), sources (4, C, cols), the three
    differences, r^2) over the tile list into (G, leaf, channels), as
    `cuda_tree._pairs_plain` walks it."""
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    table = srows[:4].reshape(4, -1, block)
    srcs = flat_src.reshape(tile_tgt.shape[0], -1)
    pos_ext = torch.cat([pos_g, pos_g.new_zeros((1, leaf, 3))])
    out = pos_g.new_zeros((gg + 1, leaf, channels))
    chunk = max(1, cuda_tree._PLAIN_ELEMS // (leaf * srcs.shape[1] * block))
    for t0 in range(0, tile_tgt.shape[0], chunk):
        ids, tgt_ids = srcs[t0:t0 + chunk], tile_tgt[t0:t0 + chunk]
        tgt = pos_ext[tgt_ids]
        src = table[:, ids].reshape(4, ids.shape[0], -1)
        d = [src[k, :, None, :] - tgt[:, :, k:k + 1] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        out.index_add_(0, tgt_ids, contrib(tgt, src, d, r2))
    return out[:gg]


def _masked_weights(weight, src, r2):
    return torch.where(r2 > 0.0, weight(r2) * src[3, :, None, :], 0.0)


def exact_sums(name, args, kw):
    """The float64 sums of kernel `name` on `args` (pos_g, srows, flat_src,
    tile_tgt, in any dtype) with weight parameters `kw`: (G, leaf, 6), the
    sum sum_j w_j (x_j - x_i) in [..., :3] and the size of what the
    kernel's float32 arithmetic rounds (the module's docstring) in
    [..., 3:]."""
    short, hybrid = KERNELS[name]
    weight = _weight(**kw)
    pair = _weight(kw["softening"], kw["eps"])
    pos_g, srows, flat_src, tile_tgt = args

    def contrib(tgt, src, d, r2):
        w = _masked_weights(weight, src, r2)
        if short:
            wp = _masked_weights(pair, src, r2)
            size_w = torch.where(w != 0.0, wp.abs() + (wp - w).abs(), 0.0)
        else:
            size_w = w.abs()
        sums = [torch.sum(w * dk, dim=-1) for dk in d]
        size = [torch.sum(size_w * dk.abs(), dim=-1) for dk in d]
        if hybrid:
            c = tgt[:, 0:1, :]
            sw = torch.sum(size_w, dim=-1)
            size = [size[k] + torch.sum(size_w * torch.abs(
                src[k, :, None, :] - c[:, :, k:k + 1]), dim=-1)
                + sw * torch.abs(tgt[:, :, k] - c[:, :, k]) for k in range(3)]
        return torch.stack(sums + size, dim=-1)

    return _walk(pos_g.double(), srows.double(), flat_src, tile_tgt, contrib,
                 6)


def hold(got, exact, tol=F32_TOL) -> dict:
    """`got` against `exact_sums`: `ratio` is the worst |got - sum| over
    the term size (an error where the size is 0 counts as infinite; a NaN
    stays NaN, so `ok` is False), `term_over_a` the largest term size over
    max|a|."""
    err = (got.double() - exact[..., :3]).abs()
    size = exact[..., 3:]
    ratio = torch.where(size > 0.0, err / size,
                        torch.where(err > 0.0, math.inf, 0.0))
    worst = float(ratio.max())
    return {"hold_ratio": worst, "hold_tol": tol, "ok": worst <= tol,
            "term_over_a": float(size.max() / exact[..., :3].abs().max())}


def near_pairs_short_cut_plain(pos_g, srows, flat_src, tile_tgt, *,
                               softening, eps, rcut=None, rs=None,
                               split="poly", skip_at=1.0, hybrid=False):
    """`cuda_tree.near_pairs_short_plain`, in its arithmetic, over the pairs
    of the (warp, chunk)s that pairs_short's walk evaluates: poly, where
    gap^2 / rcut^2 (`cuda_tree.cut_gap_ratio`) is below `skip_at`; gauss,
    where gap^2 / (4 rs^2) (`cuda_tree.walk_gap2`) is at most `skip_at`
    HLONG_VMAX. At 1, the walk: the pairs it leaves out add exactly 0, so
    this equals the full sum bit for bit. Below 1 it also leaves out chunks
    whose weight is not 0: a wrong walk. With `hybrid`, the same for
    `near_pairs_short_hybrid_plain` (`near_pairs_short_hybrid_cut_plain`)."""
    block = pos_g.shape[1] + 1
    table = srows[:4].reshape(4, -1, block)
    if split == "poly":
        rcut = float(rcut)
        weight = cuda_tree._short_weight(softening, eps, 0.0, rcut, "poly")

        def keep(tgt, ids):
            return cuda_tree.cut_gap_ratio(tgt, ids, table,
                                           rcut=rcut) < skip_at
    else:
        rs = float(rs)
        weight = cuda_tree._short_weight(softening, eps, rs, 0.0, "gauss")

        def keep(tgt, ids):
            return cuda_tree.walk_gap2(tgt, ids, table) * (
                1.0 / (4.0 * rs * rs)) <= skip_at * cuda_tree.HLONG_VMAX

    def cut_weight(tgt, ids, r2):
        return torch.where(keep(tgt, ids), weight(r2), 0.0)

    return cuda_tree._body_pairs_plain(pos_g, srows, flat_src, tile_tgt,
                                       None, hybrid, pair_weight=cut_weight)


def near_pairs_short_hybrid_cut_plain(pos_g, srows, flat_src, tile_tgt, *,
                                      softening, eps, rcut=None, rs=None,
                                      split="poly", skip_at=1.0):
    """pairs_short_hybrid's walk: the centred rank-1 sums of
    `cuda_tree.near_pairs_short_hybrid_plain`, in its arithmetic, over the
    pairs of the (warp, chunk)s that `near_pairs_short_cut_plain` keeps (at
    `skip_at` 1 the kernel's walk, which equals the full sum bit for bit:
    every pair it leaves out has w exactly 0)."""
    return near_pairs_short_cut_plain(pos_g, srows, flat_src, tile_tgt,
                                      softening=softening, eps=eps,
                                      rcut=rcut, rs=rs, split=split,
                                      skip_at=skip_at, hybrid=True)


def skip_inside_ratio(args, kw, exact, inside,
                      name="pairs_short") -> float:
    """`hold`'s ratio of a wrong walk of `name` (pairs_short or
    pairs_short_hybrid) with the split of `kw`: a chunk skipped where its
    gap to the warp's targets is within `inside` (a share of the distance)
    of where the weight's exact zero starts (poly: r_cut; gauss: u = r / (2
    rs) = 3.5), where the kernel skips at it and beyond; the plain version
    (`near_pairs_short_cut_plain`) on `args`, in their dtype. Poly: at 1%
    inside, the pairs it drops keep at most 1 - G(0.99^2) = 7.8e-5 of their
    pair weight, below what float32 rounds: only the float64 hold (F64_TOL)
    sees that skip; at 25% inside they keep 38% and more, which the float32
    hold sees. Gauss: at 25% inside (u = 2.625) they keep at most 3e-3 of
    it, which the float32 hold sees only at the edge of its limit; at 50%
    inside (u = 1.75) up to 0.11; the float64 hold sees 1% inside."""
    got = near_pairs_short_cut_plain(
        *args, softening=kw["softening"], eps=kw["eps"], rcut=kw["rcut"],
        rs=kw["rs"], split=kw["split"], skip_at=(1.0 - inside) ** 2,
        hybrid=name == "pairs_short_hybrid")
    return hold(got, exact)["hold_ratio"]


def edge_pair_case(dtype, dev) -> dict:
    """Four clusters of 63 bodies (block 64: two chunks of 32 a cluster).
    Clusters 0 and 1 have all their bodies at the origin; cluster 0 lists
    cluster 2 alone and cluster 1 lists cluster 3 alone; 2 and 3 list
    nothing. The bodies of clusters 2 and 3 sit beyond r_cut = 1 except one
    at (1 - 2^-24, 2^-12, 0): slot 31 of cluster 2, the last of its first
    chunk, and slot 32 of cluster 3, the first of its second. There the
    kernel's r^2, fma(dy, dy, dx * dx), is 1 - 2^-24, one ulp below
    r_cut^2, and so is the gap^2 of that chunk's box (every body of 2 and 3
    has y = 2^-12). Its weight, 1 - G(y) at y = 1 - 2^-24, is float32's
    rounding and not 0 (in float64 it rounds to 0, so `hold` has no term
    size to hold it to). So each target of cluster 0 gets exactly the one
    term of chunk 0 and each of cluster 1 the same term from chunk 1
    (`edge_pair_checks`); a walk that skips either chunk leaves that
    cluster's force at exactly 0. Returns the arguments and keywords of
    `near_pairs_short` (plummer, eps 0, the poly split)."""
    leaf, edge = 63, 1.0 - 2.0 ** -24
    pos = torch.zeros((4, leaf, 3), dtype=torch.float64)
    pos[2:, :, 0] = 5.0 + 0.01 * torch.arange(leaf)
    pos[2:, :, 1] = 2.0 ** -12
    pos[2, 31, 0] = edge
    pos[3, 32, 0] = edge
    pos, mass = pos.to(dtype).to(dev), torch.ones((4, leaf), dtype=dtype,
                                                  device=dev)
    m_tot = mass.sum(1)
    com = (pos * mass[..., None]).sum(1) / m_tot[:, None]
    srows = tree_ops._pack_augmented(pos, mass, com, m_tot, 1.0,
                                     monopole_pseudo=False)
    pj = tree_ops.NEAR_TILE_J // (leaf + 1)
    flat = torch.full((4 * pj,), 4, dtype=torch.int64, device=dev)
    flat[0] = 2
    flat[pj] = 3
    tiles = torch.arange(4, device=dev)
    return {"args": (pos, srows, flat, tiles),
            "kw": dict(softening="plummer", eps=0.0, rs=1.0 / 4.5, rcut=1.0,
                       split="poly")}


def edge_pair_checks(got) -> dict:
    """`edge_pair_case`'s result (4, 63, 3) held: the edge pair's term in
    each target of cluster 0 (chunk 0 evaluated) and of cluster 1 (chunk 1
    evaluated), nonzero in x and y; the two the same term bit for bit;
    exactly 0 in the clusters that list nothing; finite."""
    out = {"chunk_0_evaluated": bool((got[0, :, :2] != 0).all()),
           "chunk_1_evaluated": bool((got[1, :, :2] != 0).all()),
           "same_term": bool(torch.equal(got[0], got[1])),
           "unlisted_zero": bool((got[2:] == 0).all()),
           "finite": bool(torch.isfinite(got).all())}
    out["ok"] = all(out.values())
    return out


#: the hand-made list of `unpaired_shared_case`: the source tiles (by their
#: index in flat_src) each cluster walks, in order. Clusters 0 and 1 share
#: theirs; 2 and 3 share their first tile only and differ in length; 4 has
#: none; 6 is the odd one out, its partner absent.
UNPAIRED_TILES = ([0, 1, 2], [0, 1, 2], [3, 4], [3, 5, 6], [], [7], [1, 7])


def unpaired_shared_case(dtype, dev, leaf=15) -> dict:
    """A tile list for `cuda_tree.near_pairs_quad_shared` whose paired
    clusters do not share their tiles, at an odd G: seven clusters of `leaf`
    targets walking `UNPAIRED_TILES` over eight source tiles of
    NEAR_QUAD_PJ column ids into 300 random summaries (null id 300, a fifth
    of the slots, interior and at the tails; tile 7 all null), with two
    padding tiles aimed at G. Returns the arguments and keywords (eps
    1e-2)."""
    rng = np.random.default_rng(9)
    pj, n_src = cuda_tree.NEAR_QUAD_PJ, 300
    gg = len(UNPAIRED_TILES)
    pos_g = rng.uniform(-1, 1, size=(gg, leaf, 3))
    summ = np.zeros((16, n_src + 1))
    summ[:3, :n_src] = rng.uniform(-3, 3, size=(3, n_src))
    summ[3, :n_src] = rng.uniform(0.1, 1.0, size=n_src)
    summ[4:10, :n_src] = rng.normal(scale=0.02, size=(6, n_src))
    flat = rng.integers(0, n_src, size=(8, pj))
    flat[rng.uniform(size=(8, pj)) < 0.2] = n_src
    flat[7] = n_src
    tile_src = [k for tiles in UNPAIRED_TILES for k in tiles] + [0, 0]
    tile_tgt = [c for c, tiles in enumerate(UNPAIRED_TILES)
                for _ in tiles] + [gg, gg]

    def put(x, kind):
        return torch.as_tensor(np.asarray(x), dtype=kind, device=dev)

    return {"args": (put(pos_g, dtype), put(summ, dtype),
                     put(flat.reshape(-1), torch.int64),
                     put(tile_tgt, torch.int64), put(tile_src, torch.int64)),
            "kw": dict(eps=1e-2)}


def mutant_ratios(name, args, kw, exact) -> dict:
    """`hold`'s ratio of deliberately wrong float32 versions of kernel
    `name`, to show that the limit fails them: a result of zeros; for the
    short-range law the other split; for the hybrid sums the rank-1 form
    without its subtraction of (sum_j w_j)(x_i - c). (pairs_short's skip
    moved inside r_cut, `skip_inside_ratio`, drops a share of the sum that
    depends on the geometry: it is held where it is called.)"""
    short, hybrid = KERNELS[name]
    out = {"zeros": hold(torch.zeros_like(args[0]), exact)["hold_ratio"]}
    if short:
        other = dict(kw, split={"poly": "gauss", "gauss": "poly"}[kw["split"]])
        got = getattr(cuda_tree, f"near_{name}_plain")(*args, **other)
        out["other_split"] = hold(got, exact)["hold_ratio"]
    if hybrid:
        weight = _weight(**kw)

        def no_subtraction(tgt, src, d, r2):
            w = _masked_weights(weight, src, r2)
            c = tgt[:, 0:1, :]
            return torch.stack([
                torch.sum(w * (src[k, :, None, :] - c[:, :, k:k + 1]), dim=-1)
                for k in range(3)], dim=-1)

        got = _walk(*args, no_subtraction, 3)
        out["no_subtraction"] = hold(got, exact)["hold_ratio"]
    return out


# --- the strip kernels (near_strip, quad_strip, quad_refine) ----------------
#
# The same measure for strip mode's kernels. near_strip's terms are the
# direct law's, over the bodies and pseudo-bodies of each target cluster's
# near clusters: size sum_j |w_j| |x_j - x_i|. A quadrupole term (quad_strip,
# quad_refine) is gM inv^3 rel + inv^4 (2.5 (n.Q.n) n - Q n): its size is
# |gM| inv^3 |rel| + inv^4 (2.5 (|n|.|Q|.|n|) |n| + |Q| |n|), each product
# of the sum taken in absolute value.


def strip_exact_sums(args, kw):
    """The float64 sums of `cuda_tree.near_strip` on `args` (pos_g_t, idx,
    pool_pos_g, pool_mass_g, pool_com, pool_m_tot, in any dtype) with
    keywords `kw` (softening, eps, g, monopole_pseudo): (G_t, leaf, 6), the
    sums in [..., :3] and their sizes in [..., 3:]."""
    pos_g_t, idx, *pool = args
    pool = [x.double() for x in pool]
    aug_pos, aug_gm = cuda_tree.augmented_pool(*pool, float(kw["g"]),
                                               kw["monopole_pseudo"])
    aug_pos = torch.cat([aug_pos, aug_pos.new_zeros((1,) + aug_pos.shape[1:])])
    aug_gm = torch.cat([aug_gm, aug_gm.new_zeros((1,) + aug_gm.shape[1:])])
    weight = _weight(kw["softening"], kw["eps"])
    tgt_all = pos_g_t.double()
    n_t, leaf = tgt_all.shape[:2]
    strip = idx.shape[1] * aug_pos.shape[1]
    step = max(1, cuda_tree._PLAIN_ELEMS // max(leaf * strip, 1))
    out = [tgt_all.new_zeros((0, leaf, 6))]
    for c0 in range(0, n_t, step):
        tgt = tgt_all[c0:c0 + step]
        sp = aug_pos[idx[c0:c0 + step]].reshape(tgt.shape[0], strip, 3)
        sm = aug_gm[idx[c0:c0 + step]].reshape(tgt.shape[0], strip)
        d = [sp[:, None, :, k] - tgt[:, :, k:k + 1] for k in range(3)]
        w = weight(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * sm[:, None, :]
        out.append(torch.stack(
            [torch.sum(w * dk, dim=-1) for dk in d]
            + [torch.sum(w.abs() * dk.abs(), dim=-1) for dk in d], dim=-1))
    return torch.cat(out)


def quad_exact_sums(tgt, summ, eps):
    """The float64 quadrupole sums of targets tgt (B, M, 3) over summary
    tables summ (B, >= 10, S), with their sizes: (B, M, 6)."""
    tgt, summ = tgt.double(), summ.double()
    xj, yj, zj, gm = (summ[:, r, None, :] for r in range(4))
    q = [summ[:, r, None, :] for r in range(4, 10)]  # xx yy zz xy xz yz
    qm = ((q[0], q[3], q[4]), (q[3], q[1], q[5]), (q[4], q[5], q[2]))
    d = [c - tgt[:, :, k:k + 1] for k, c in enumerate((xj, yj, zj))]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + float(eps) ** 2
    inv = torch.where(d2 > 1e-18, torch.rsqrt(torch.clamp_min(d2, 1e-30)),
                      0.0)
    inv3, inv4 = inv ** 3, inv ** 4
    n = [dk * inv for dk in d]
    qn = [sum(qm[r][c] * n[c] for c in range(3)) for r in range(3)]
    aqn = [sum(qm[r][c].abs() * n[c].abs() for c in range(3))
           for r in range(3)]
    s = sum(n[k] * qn[k] for k in range(3))
    a_s = sum(n[k].abs() * aqn[k] for k in range(3))
    wm = gm * inv3
    sums = [torch.sum(wm * d[k] + 2.5 * s * inv4 * n[k] - qn[k] * inv4,
                      dim=-1) for k in range(3)]
    size = [torch.sum((wm * d[k]).abs() + 2.5 * a_s * inv4 * n[k].abs()
                      + aqn[k] * inv4, dim=-1) for k in range(3)]
    return torch.stack(sums + size, dim=-1)


#: quad_dense's ragged cases (M targets, S summaries): M odd or below a
#: block's 512 targets, S of 1 and about the 256-column tile whose sums
#: each target keeps apart
QUAD_SIZES = ((1, 1), (333, 255), (511, 256), (1001, 257), (4099, 513))


def quad_table(s, seed, dtype, dev):
    """A (16, S) summary table that is a column slice of a wider one (row
    stride S + 7): centres of mass in [-1, 1)^3, g*M in [0.1, 1), a
    traceless g*Q of up to a tenth of it, rows 10-15 zero."""
    rng = np.random.default_rng(seed)
    w = s + 7
    t = np.zeros((16, w))
    t[:3] = rng.uniform(-1, 1, size=(3, w))
    t[3] = rng.uniform(0.1, 1.0, size=w)
    t[[4, 5, 7, 8, 9]] = rng.uniform(-0.1, 0.1, size=(5, w)) * t[3]
    t[6] = -(t[4] + t[5])
    return torch.as_tensor(t, dtype=dtype, device=dev)[:, :s]


def quad_dense_case(m, s, eps, dtype, dev):
    """`quad_dense`'s arguments: targets (M, 3) in [-1.5, 1.5)^3 and a
    `quad_table` of S columns. At eps = 0 and S > 1 target 0 sits on column
    0's centre of mass (d2 = 0 <= 1e-18: that term is 0; the other columns
    keep its force nonzero)."""
    rng = np.random.default_rng(1000 * m + s)
    tgt = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(m, 3)), dtype=dtype,
                          device=dev)
    summ = quad_table(s, s, dtype, dev)
    if eps == 0.0 and s > 1:
        tgt[0] = summ[:3, 0]
    return tgt, summ


#: quad_masked's wide case: G2 = 300 super summaries (a full 256-column
#: tile and a ragged one), N2 target supers of ROWS rows (odd, below a
#: block's 512 targets), near lists of K2 slots (null = G2)
QUAD_MASKED_G2, QUAD_MASKED_N2, QUAD_MASKED_ROWS, QUAD_MASKED_K2 = (
    300, 5, 333, 48)


def quad_masked_case(eps, dtype, dev):
    """`quad_masked`'s arguments (targets, summaries, idx2) on the wide case.
    Super 0 masks columns 240-271, across the tile boundary; super 1 24
    random columns with nulls between them; super 2 all of the second tile
    (256-299), so that tile stages nothing; super 3 nothing (a row of
    nulls); super 4 columns 0-47. At eps = 0 super 0's first target sits on
    the centre of mass of column 5 (kept) and its second on column 250's
    (masked)."""
    g2, n2, rows, k2 = (QUAD_MASKED_G2, QUAD_MASKED_N2, QUAD_MASKED_ROWS,
                        QUAD_MASKED_K2)
    rng = np.random.default_rng(g2)
    idx2 = np.full((n2, k2), g2)
    idx2[0, :32] = np.arange(240, 272)
    idx2[1, :24] = rng.choice(g2, size=24, replace=False)
    idx2[1] = rng.permutation(idx2[1])
    idx2[2, :44] = np.arange(256, 300)
    idx2[4] = np.arange(48)
    tgt = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(n2 * rows, 3)),
                          dtype=dtype, device=dev)
    summ = quad_table(g2, g2 + 1, dtype, dev)
    if eps == 0.0:
        tgt[0] = summ[:3, 5]
        tgt[1] = summ[:3, 250]
    return tgt, summ, torch.as_tensor(idx2, dtype=torch.int64, device=dev)


#: the quadrupole list kernels' ragged cases (`pairs_quad_case`,
#: `quad_strip_case`): cluster sizes (15 and 31 one warp, 63 and 255 an
#: odd leaf whose last thread has one dead target, 95 a quad_strip chunk of
#: 96 slots that straddles a staging window), the summary columns the lists
#: name (a null column past them), quad_strip's K (two staging windows, the
#: second ragged), and csrc/tree.cu's QL_WINDOW
QUAD_LIST_LEAVES = (15, 31, 63, 95, 255)
QUAD_LIST_SRC = 300
QUAD_LIST_K = 700
QUAD_LIST_WINDOW = 512


def pair_threads(leaf):
    """The threads of a one-target pair block (csrc/tree.cu: pair_threads),
    leaf + 1 in whole warps: quad_strip's sums restart every this many
    slots of a row, as its one-target kernel's passes did."""
    return (leaf + 1 + 31) // 32 * 32


def _list_table(dtype, dev):
    """A (16, QUAD_LIST_SRC + 1) `quad_table` whose last column, the null
    one, is zero (the plain versions gather it)."""
    summ = quad_table(QUAD_LIST_SRC + 1, QUAD_LIST_SRC, dtype, dev)
    summ[:, QUAD_LIST_SRC] = 0.0
    return summ


def _list_row(rng, n, share):
    """n slots, each a live id with probability `share`, else null."""
    ids = rng.integers(0, QUAD_LIST_SRC, size=n)
    return np.where(rng.uniform(size=n) < share, ids, QUAD_LIST_SRC)


def pairs_quad_case(leaf, pj, eps, dtype, dev):
    """`cuda_tree.near_pairs_quad`'s arguments (pos_g, summaries, flat_src,
    tile_tgt) on a ragged tile list of pj slots a tile, six target
    clusters: 0 two tiles with live ids at the last slot of the first and
    the first of the second (a chunk boundary); 1 no tiles; 2 three tiles,
    the middle one nulls only; 3 six tiles (past one staging window), half
    live, with live ids at slots 511 and 512; 4 one tile, every slot live;
    5 one tile of nulls; then two padding tiles of nulls aimed at G. At
    eps = 0 cluster 0's first target sits on the centre of a summary its
    list names."""
    null = QUAD_LIST_SRC
    rng = np.random.default_rng(1000 * leaf + pj)
    c0 = _list_row(rng, 2 * pj, 0.1)
    c0[[pj - 1, pj]] = (7, 8)
    c2 = _list_row(rng, 3 * pj, 0.5)
    c2[pj:2 * pj] = null
    c3 = _list_row(rng, 6 * pj, 0.5)
    c3[[511, 512]] = (11, 12)
    c4 = rng.integers(0, null, size=pj)
    flat = np.concatenate([c0, c2, c3, c4, np.full(3 * pj, null)])
    tiles = (2, 0, 3, 6, 1, 1)
    g = len(tiles)
    tile_tgt = np.concatenate([np.repeat(np.arange(g), tiles), [g, g]])
    tgt = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(g, leaf, 3)),
                          dtype=dtype, device=dev)
    summ = _list_table(dtype, dev)
    if eps == 0.0:
        tgt[0, 0] = summ[:3, 7]
    return (tgt, summ,
            torch.as_tensor(flat, dtype=torch.int64, device=dev),
            torch.as_tensor(tile_tgt, dtype=torch.int64, device=dev))


def quad_strip_case(leaf, eps, dtype, dev):
    """`cuda_tree.quad_strip`'s arguments (pos_g_t, summaries_neg, idx) on
    five rows of QUAD_LIST_K slots, chunk = `pair_threads(leaf)`: 0 a
    third live, with live ids at slots chunk - 1 and chunk and at 511 and
    512 (both sides of a staging window); 1 nulls only; 2 half live with
    the chunk [chunk, 2 chunk) null; 3 every slot live; 4 15% live. At
    eps = 0 row 0's first target sits on the centre of a summary its list
    names."""
    null, k, chunk = QUAD_LIST_SRC, QUAD_LIST_K, pair_threads(leaf)
    rng = np.random.default_rng(leaf)
    idx = np.stack([_list_row(rng, k, 0.3), np.full(k, null),
                    _list_row(rng, k, 0.5), rng.integers(0, null, size=k),
                    _list_row(rng, k, 0.15)])
    idx[0, [chunk - 1, chunk, 511, 512]] = (7, 8, 9, 10)
    idx[2, chunk:2 * chunk] = null
    tgt = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(5, leaf, 3)),
                          dtype=dtype, device=dev)
    summ = _list_table(dtype, dev)
    if eps == 0.0:
        tgt[0, 0] = summ[:3, 7]
    return tgt, summ, torch.as_tensor(idx, dtype=torch.int64, device=dev)


def pairs_quad_exact_sums(pos_g, summ, flat_src, tile_tgt, eps):
    """`quad_exact_sums` of `cuda_tree.near_pairs_quad`'s arguments: each
    target cluster against the columns its tiles name, nulls and padding
    as the null column (G, leaf, 6)."""
    gg = pos_g.shape[0]
    pj = flat_src.numel() // tile_tgt.numel()
    tiles = flat_src.reshape(-1, pj)
    rows = [tiles[tile_tgt == a].reshape(-1) for a in range(gg)]
    ids = flat_src.new_full((gg, max([1] + [r.numel() for r in rows])),
                            summ.shape[1] - 1)
    for a, r in enumerate(rows):
        ids[a, :r.numel()] = r
    step = max(1, cuda_tree._PLAIN_ELEMS // (pos_g.shape[1] * ids.shape[1]))
    return torch.cat([quad_exact_sums(
        pos_g[a:a + step], summ[:, ids[a:a + step]].permute(1, 0, 2), eps)
        for a in range(0, gg, step)])


def quad_strip_exact_sums(pos_g_t, summaries_neg, idx, eps):
    """`quad_exact_sums` of `cuda_tree.quad_strip`'s arguments:
    (G_t, leaf, 6)."""
    return quad_exact_sums(pos_g_t, summaries_neg[:, idx].permute(1, 0, 2),
                           eps)


def quad_refine_exact_sums(pos_g, strips, eps, group, clusters):
    """`quad_exact_sums` of `cuda_tree.quad_refine`'s arguments, for the
    named clusters only (each against its super's strip): (C, leaf, 6)."""
    g2 = pos_g.shape[0] // group
    s_pad = strips.shape[1] // g2
    tables = strips.reshape(-1, g2, s_pad)[:10].permute(1, 0, 2)
    clusters = torch.as_tensor(clusters, device=pos_g.device)
    return quad_exact_sums(pos_g[clusters], tables[clusters // group], eps)


def one_column_terms(pos_g, strips, eps, group):
    """quad_refine on a strip of one column a super (each super's first
    live column of `strips`, (16, G2 * S_pad)) and quad_strip on the same
    columns negated, each cluster's near list the one column of its super:
    the two results, (G * leaf, 3) each. Both kernels take the one
    quad_term (quad_refine two targets a thread), so they must be exact
    negatives target by target."""
    g2 = pos_g.shape[0] // group
    tables = strips.reshape(strips.shape[0], g2, -1)
    live = (tables[3:10] != 0).any(0).to(torch.int8)
    first = torch.argmax(live, dim=1)
    one = tables[:, torch.arange(g2, device=strips.device), first]
    refine = cuda_tree.quad_refine(pos_g, one.contiguous(), eps=eps,
                                   group=group)
    summ = torch.cat([one, one.new_zeros((one.shape[0], 1))], 1)
    idx = (torch.arange(pos_g.shape[0], device=pos_g.device)
           // group)[:, None]
    strip = cuda_tree.quad_strip(pos_g, tree_ops._negated(summ), idx,
                                 eps=eps)
    return refine, strip


def strip_mutant_ratios(name, args, kw, exact, rows=None) -> dict:
    """`hold`'s ratio of deliberately wrong float32 versions of strip
    kernel `name` (on `args`, float32; `rows`: the target clusters `exact`
    covers, all by default), each of which the limit must fail: a result of
    zeros; for quad_strip, and near_strip with massless pseudo-bodies, a
    null slot read as the last real source instead of skipped (what an
    unchecked read past the table would add); for near_strip with -g M
    pseudo-bodies the pseudo-body's sign flipped instead (there a far
    cluster read in place of the null adds only its direct-minus-monopole
    remainder, below what the limit sees); for quad_refine the sums zeroed
    at each 512-column strip tile (the TPU refine's round-3 fault, which
    kept only the last tile)."""
    def pick(x):
        return x if rows is None else x[rows]

    out = {"zeros": hold(torch.zeros_like(exact[..., :3]), exact)[
        "hold_ratio"]}
    if name == "near_strip":
        pos_g_t, idx, *pool = args
        p = pool[0].shape[0]
        if kw["monopole_pseudo"]:
            flipped = pool[:3] + [-pool[3]]
            got = cuda_tree.near_strip_plain(pick(pos_g_t), pick(idx),
                                             *flipped, **kw)
            out["pseudo_sign"] = hold(got, exact)["hold_ratio"]
        else:
            got = cuda_tree.near_strip_plain(
                pick(pos_g_t), torch.clamp_max(pick(idx), p - 1), *pool,
                **kw)
            out["null_read"] = hold(got, exact)["hold_ratio"]
    elif name == "quad_strip":
        pos_g_t, summ, idx = args
        n_src = summ.shape[1] - 1
        got = cuda_tree.quad_strip_plain(
            pick(pos_g_t), summ, torch.clamp_max(pick(idx), n_src - 1), **kw)
        out["null_read"] = hold(got.reshape(exact.shape[:2] + (3,)),
                                exact)["hold_ratio"]
    else:
        pos_g, strips = args
        g2 = pos_g.shape[0] // kw["group"]
        s_pad = strips.shape[1] // g2
        last = strips.reshape(-1, g2, s_pad).clone()
        last[:, :, :s_pad - s_pad % 512 if s_pad % 512 else s_pad - 512] = 0
        got = cuda_tree.quad_refine_plain(
            pos_g, last.reshape(strips.shape[0], -1), **kw).reshape(
                pos_g.shape)
        out["zeroed_per_tile"] = hold(pick(got), exact)["hold_ratio"]
    return out


def horner_literals() -> list:
    """The coefficients of csrc/pair.cuh's h_long_horner, lowest power
    first (the kernels' form of the gauss split's series)."""
    import re

    src = (cuda_tree._build.CSRC / "pair.cuh").read_text()
    body = src[src.index("h_long_horner(T x) {"):]
    body = body[:body.index("\n}\n")]
    return [float(v) for v in re.findall(r"T\(([-0-9.e]+)\)", body)][::-1]


def monomial_coefficients(cheb) -> list:
    """sum_k c_k T_k(x) as a polynomial in x, lowest power first: computed
    exactly (fractions) and rounded once to float64."""
    from fractions import Fraction

    c = [Fraction(v) for v in cheb]
    polys = [[Fraction(1)], [Fraction(0), Fraction(1)]]
    for _ in range(2, len(c)):
        t = [Fraction(0)] + [2 * v for v in polys[-1]]
        for i, v in enumerate(polys[-2]):
            t[i] -= v
        polys.append(t)
    return [float(sum(ck * (tk[j] if j < len(tk) else 0)
                      for ck, tk in zip(c, polys))) for j in range(len(c))]
