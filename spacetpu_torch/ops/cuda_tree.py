"""The tree's force kernels through hand-written CUDA (``csrc/tree.cu``).

- ``quad_dense`` replaces ``pallas_direct._kernel_quad`` as
  ``acc_cross_quad`` launches it: targets against (16, S) cluster summaries
  (centre of mass, g*M and the traceless g*Q), monopole + quadrupole.
- ``pairs_direct`` replaces ``tree._kernel_pairs`` with its launcher
  ``_near_pairs_call``: the pair-list near correction, exact forces of the
  bodies of each target cluster's near clusters; two targets a thread.
- ``pairs_quad`` replaces ``tree._kernel_quad_pairs`` with the same
  launcher: the multipole evaluation over the pair list (with negated
  summaries it takes the near clusters' far-field term back out).
- ``quad_masked`` replaces ``pallas_direct._kernel_quad`` as
  ``tree._superfar_dense_masked`` launches it: every target against every
  SUPER-cluster summary, with the g*M and g*Q of its own super's near
  supers zeroed (the 3-level far field's dense pass). It and
  ``quad_dense`` are one kernel, two targets a thread, which stages only
  the columns that add to the sums (inside S, and kept by the mask).
- ``pairs_quad_shared`` replaces ``tree._kernel_quad_pairs`` as
  ``tree.mid_far_eval`` launches it through ``_near_pairs_call`` with
  ``tile_src``: the pair-list multipole evaluation where each tile reads its
  source ids from a strip shared by the clusters of one super (the MID far
  field's M1 and M2 passes). A block takes two consecutive clusters and
  stages each strip they share once for both, packing its live columns to
  the front; any other tile list is walked correctly too.
- ``pairs_hybrid`` replaces ``tree._kernel_pairs_hybrid`` (``pairs_accum=
  "mxu"``): ``pairs_direct``'s weights summed in the centred rank-1 form
  sum_j w_j (x_j - c) - (sum_j w_j)(x_i - c), c the target cluster's first
  body, pairs at r^2 = 0 masked; two targets a thread.
- ``pairs_short`` replaces ``treepm._kernel_pairs_short``: the TreePM
  short-range pass (the softened law minus the long-range weight that the
  mesh carries, poly or gauss split) over the cutoff tile list. With the
  poly split, whose weight is exactly 0 beyond r_cut, each warp skips the
  chunks of 32 staged sources whose bounding box lies r_cut or more from
  its targets' (`short_pair_counts` counts the pairs it evaluates).
- ``pairs_short_hybrid`` replaces ``treepm._kernel_pairs_short_hybrid``:
  ``pairs_short``'s weights with ``pairs_hybrid``'s sums; with the poly
  split, ``pairs_short``'s walk, which skips the same chunks.
- ``near_strip`` replaces ``tree._near_correction_chunk`` (``_kernel``
  over gathered strips, through ``_near_correction_pallas``): strip mode's
  near correction, each target cluster against the bodies of the clusters
  of its near list, read from a source pool through the list; two targets a
  thread.
- ``quad_strip`` replaces ``tree._near_multipole_sub_pallas``
  (``_kernel_quad``): each target cluster against the negated summaries of
  its near list.
- ``quad_refine`` replaces ``tree._superfar_refine_pallas``
  (``_kernel_quad`` on its 3-D grid): the strip refinement of the 3-level
  far field, each cluster against its super's strip of summaries; a block
  takes two clusters of one super, so on the card the super's size
  (``group``) is even.

What bounds them on an H100: arithmetic, 58 flops a (target, summary) pair
and 22 or 23 a (target, body) pair of the direct law, 21 in the hybrid
sums, 37 (poly; 27 at plummer eps 0) or 81 (gauss) of the short-range law (counted in
``csrc/pair.cuh`` and ``csrc/tree.cu``), against
a few bytes per target and source. One thread owns a target and keeps its
sums in registers (two: one in each of two clusters in `quad_refine` and
`pairs_quad_shared`, two of one cluster in `near_strip`, `pairs_direct` and
`pairs_hybrid`, `two_target_threads`; each staged source is read once for
both); sources go through shared memory. `near_strip`, `pairs_direct` and
`pairs_hybrid` take the MUFU rsqrt alone where it gives rsqrtf's bits
(`lean_rsqrt`), and their blocks in `heavy_first` order. The pair kernels
run one block per target cluster (``pairs_quad_shared``: two) over that
cluster's own contiguous range of the tile list (the body kernels are three
templated bodies over the pair weight: the two-target sweep of the direct
law, plain (`pairs_direct`) or centred (`pairs_hybrid`), the poly split's
walk, and the gauss split's sweep of every pair), so nothing is shared
between blocks: no atomics, no dummy target block, and the result is
deterministic (``csrc/tree.cu``). No single PyTorch call computes any of
these functions.

A CPU tensor takes the plain PyTorch version beside each kernel. A CUDA
tensor launches the kernel or raises; nothing falls back. No wrapper reads
a value back to the host, except that `near_strip` and `quad_strip` read
the least and the largest id of their near lists to refuse an id out of
range.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build
from spacetpu_torch.ops import direct

#: summary columns a source tile of the quadrupole pair lists: the width of
#: `tree.near_pair_segments`' tiles for `near_pairs_quad` and of the shared
#: strips of `tree.shared_pair_segments` for `near_pairs_quad_shared`
NEAR_QUAD_PJ = 128

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"quad_dense": 0, "pairs_direct": 0, "pairs_quad": 0,
            "quad_masked": 0, "pairs_quad_shared": 0, "pairs_hybrid": 0,
            "pairs_short": 0, "pairs_short_hybrid": 0, "near_strip": 0,
            "quad_strip": 0, "quad_refine": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_LAWS = {"plummer": 0, "ref": 1}
_SPLITS = {"poly": 0, "gauss": 1}

#: Chebyshev coefficients of the gauss split's long-range bracket
#: h(v) = [erf(u) - (2/sqrt(pi)) u e^(-u^2)] / u^3 in v = u^2 on
#: [0, HLONG_VMAX] (`spacetpu.ops.treepm._HLONG_CHEB`; csrc/pair.cuh holds
#: the same numbers)
HLONG_VMAX = 12.25
HLONG_CHEB = (
    0.192113856961219, -0.2717257282102824, 0.1563599597336091,
    -0.07770857221021463, 0.03409713282293515, -0.013376761116476876,
    0.0047356367163482625, -0.001524426605379348, 0.00044916418572923115,
    -0.00012184889023613674, 3.059320288310997e-05, -7.143091319246147e-06,
    1.5567925396196247e-06, -3.1826850806844793e-07, 6.023877228414106e-08,
    -1.0951542449936198e-08,
)
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

#: elements of one temporary of the plain versions (they work in chunks)
_PLAIN_ELEMS = 1 << 22

#: pairs_short's walk with the poly split (csrc/tree.cu: pairs_cut_kernel):
#: staged sources a chunk, the unit a warp skips, and bytes of staged
#: sources a stage
CUT_CHUNK = 32
CUT_STAGE_BYTES = 32 * 1024


def two_target_threads(leaf: int) -> int:
    """Threads of a `near_strip`, `pairs_direct` or `pairs_hybrid` block at
    cluster size `leaf`: ceil(leaf / 2) in whole warps. Thread t owns
    targets t and t + threads of its cluster, those below leaf live
    (csrc/tree.cu)."""
    return ((leaf + 1) // 2 + 31) // 32 * 32


def heavy_first(work):
    """The block order of `near_strip`, `pairs_direct` and `pairs_hybrid`:
    target clusters by descending work (valid list entries, or tiles), so
    that the longest blocks start first. Near lists are skewed, and a
    two-target block takes as long as a one-target block of twice its work
    would, so the blocks that start last otherwise set the kernel's end. The
    order changes no result: each block writes its own cluster."""
    return torch.argsort(work, descending=True)


def lean_rsqrt(dtype, softening: str, eps) -> bool:
    """Whether the direct law's kernels (`near_strip`, `pairs_direct`,
    `pairs_hybrid`, and `direct_vpu`, whose C entry takes the same choice:
    csrc/pair.cuh lean_ok) take its weight with the MUFU rsqrt alone
    (csrc/pair.cuh: DirectLean): float32 plummer where eps^2, rounded to
    float32 as the kernel takes it, is at least the least normal float32.
    Then r^2 + eps^2 is never subnormal and the MUFU rsqrt gives rsqrtf's
    bits. Elsewhere (eps^2 below it, which counts as 0: `direct.
    plummer_eps2`; float64; the ref law) the kernels keep rsqrtf, rsqrt or
    the ref law's sqrt."""
    return (dtype == torch.float32 and softening == "plummer"
            and direct.plummer_eps2(float(eps), dtype) > 0.0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("tree")
    if lib.spacetpu_quad_dense.argtypes is None:
        lib.spacetpu_quad_dense.argtypes = [
            _INT, _P, _P, _I64, _P, _I64, _I64, ctypes.c_double, _P]
        lib.spacetpu_quad_dense.restype = _INT
        lib.spacetpu_pairs_quad.argtypes = [
            _INT, _P, _P, _I64, _P, _P, _P, _I64, _INT, _INT, _I64,
            ctypes.c_double, _P]
        lib.spacetpu_pairs_quad.restype = _INT
        lib.spacetpu_quad_masked.argtypes = [
            _INT, _P, _P, _I64, _P, _P, _I64, _I64, _I64, ctypes.c_double,
            _P]
        lib.spacetpu_quad_masked.restype = _INT
        lib.spacetpu_pairs_quad_shared.argtypes = [
            _INT, _P, _P, _I64, _P, _P, _P, _P, _I64, _INT, _INT, _I64,
            ctypes.c_double, _P]
        lib.spacetpu_pairs_quad_shared.restype = _INT
        for name in ("pairs_direct", "pairs_hybrid"):
            fn = getattr(lib, f"spacetpu_{name}")
            fn.argtypes = [_INT, _INT, _INT, _P, _P, _I64, _P, _P, _P, _P,
                           _I64, _INT, _INT, _I64, ctypes.c_double, _INT, _P]
            fn.restype = _INT
        for name in ("pairs_short", "pairs_short_hybrid"):
            fn = getattr(lib, f"spacetpu_{name}")
            fn.argtypes = [_INT, _INT, _INT, _P, _P, _I64, _P, _P, _P, _I64,
                           _INT, _INT, _I64, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, _P]
            fn.restype = _INT
        lib.spacetpu_near_strip.argtypes = [
            _INT, _INT, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT,
            _I64, _I64, ctypes.c_double, ctypes.c_double, _INT, _P]
        lib.spacetpu_near_strip.restype = _INT
        lib.spacetpu_quad_strip.argtypes = [
            _INT, _P, _P, _I64, _P, _P, _I64, _INT, _I64, _I64,
            ctypes.c_double, _P]
        lib.spacetpu_quad_strip.restype = _INT
        lib.spacetpu_quad_refine.argtypes = [
            _INT, _P, _P, _I64, _P, _I64, _INT, _INT, _I64, ctypes.c_double,
            _P]
        lib.spacetpu_quad_refine.restype = _INT
    return lib


# --- plain versions ---------------------------------------------------------


def _quad_terms(tgt, summ, eps: float):
    """tgt (B, M, 3) against summ (B, 16, S) -> (B, M, 3): the arithmetic of
    the kernels' quad_term, step by step."""
    xj, yj, zj, gm = (summ[:, r, None, :] for r in range(4))
    qxx, qyy, qzz, qxy, qxz, qyz = (summ[:, r, None, :] for r in range(4, 10))
    dx = xj - tgt[:, :, 0:1]
    dy = yj - tgt[:, :, 1:2]
    dz = zj - tgt[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz + eps * eps
    # coincidence floor: below d2 ~ 1e-18, inv^4 overflows float32
    inv = torch.where(d2 > 1e-18, torch.rsqrt(torch.clamp_min(d2, 1e-30)),
                      0.0)
    inv2 = inv * inv
    inv3 = inv2 * inv
    inv4 = inv2 * inv2
    # unit-vector form: inv^4 (2.5 (n.Q.n) n - Q n), never inv^7
    nx, ny, nz = dx * inv, dy * inv, dz * inv
    qn_x = qxx * nx + qxy * ny + qxz * nz
    qn_y = qxy * nx + qyy * ny + qyz * nz
    qn_z = qxz * nx + qyz * ny + qzz * nz
    s = nx * qn_x + ny * qn_y + nz * qn_z
    wm = gm * inv3
    t2 = 2.5 * s * inv4
    return torch.stack([
        torch.sum(wm * dx + t2 * nx - qn_x * inv4, dim=-1),
        torch.sum(wm * dy + t2 * ny - qn_y * inv4, dim=-1),
        torch.sum(wm * dz + t2 * nz - qn_z * inv4, dim=-1),
    ], dim=-1)


def acc_cross_quad_plain(pos_i, summaries, *, eps):
    """The plain version of ``quad_dense``: (M, 3) targets against (16, S)
    summaries -> (M, 3), over chunks of targets."""
    m, s = pos_i.shape[0], summaries.shape[1]
    chunk = max(1, _PLAIN_ELEMS // max(s, 1))
    summ = summaries[None]
    out = [_quad_terms(pos_i[None, i0:i0 + chunk], summ, float(eps))[0]
           for i0 in range(0, m, chunk)]
    return torch.cat(out) if out else pos_i.new_zeros((0, 3))


def _keep_mask(idx2, g2: int):
    """(n2, G2) bool: False where column j is one of row a's near supers
    (idx2 (n2, K2), null = G2), by one scatter."""
    n2 = idx2.shape[0]
    hit = torch.zeros((n2, g2 + 1), dtype=torch.bool, device=idx2.device)
    hit[torch.arange(n2, device=idx2.device)[:, None],
        torch.clamp(idx2, 0, g2)] = True
    return ~hit[:, :g2]


def acc_cross_quad_masked_plain(targets, summaries, idx2, *, eps):
    """The plain version of ``quad_masked``: same arguments and result as
    `acc_cross_quad_masked`, one target super's table at a time."""
    n2 = idx2.shape[0]
    g2 = summaries.shape[1]
    rows = targets.shape[0] // n2
    keep = _keep_mask(idx2, g2).to(summaries.dtype)
    tgt = targets.reshape(n2, rows, 3)
    chunk = max(1, _PLAIN_ELEMS // max(rows * g2, 1))
    out = []
    for a0 in range(0, n2, chunk):
        k = keep[a0:a0 + chunk, None, :]
        tbl = torch.cat([summaries[None, :3].expand(k.shape[0], 3, g2),
                         summaries[None, 3:10] * k], dim=1)
        out.append(_quad_terms(tgt[a0:a0 + chunk], tbl, float(eps)))
    return torch.cat(out).reshape(n2 * rows, 3)


def _pairs_plain(pos_g, flat_src, tile_tgt, width: int, contrib,
                 tile_src=None, pj=None, channels=3):
    """Sum contrib(targets (C, leaf, 3), source ids (C, pj)) over the tile
    list into (G, leaf, channels); tiles aimed at target G (padding) are
    dropped.
    With tile_src, tile k reads its ids from source tile tile_src[k] of
    flat_src (pj ids a tile)."""
    gg, leaf = pos_g.shape[:2]
    n_tiles = tile_tgt.shape[0]
    if tile_src is None:
        pj = flat_src.shape[0] // n_tiles
        srcs = flat_src.reshape(n_tiles, pj)
    else:
        srcs = flat_src.reshape(-1, pj)[tile_src]
    pos_ext = torch.cat([pos_g, pos_g.new_zeros((1, leaf, 3))])
    acc = pos_g.new_zeros((gg + 1, leaf, channels))
    chunk = max(1, _PLAIN_ELEMS // (leaf * pj * width))
    for t0 in range(0, n_tiles, chunk):
        tgt_ids = tile_tgt[t0:t0 + chunk]
        acc.index_add_(0, tgt_ids, contrib(pos_ext[tgt_ids],
                                           srcs[t0:t0 + chunk]))
    return acc[:gg]


def h_long_cheb(x):
    """Clenshaw evaluation of the HLONG_CHEB series at x = 2 v / HLONG_VMAX
    - 1 (adds and multiplies only)."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    two_x = 2.0 * x
    for c in HLONG_CHEB[:0:-1]:
        b1, b2 = two_x * b1 - b2 + c, b1
    return x * b1 - b2 + HLONG_CHEB[0]


def w_short_tile(r2, *, softening: str, eps, rs, rcut, split: str):
    """Per-pair short-range weight without the g*m factor: the arithmetic
    of the short-range kernels (`spacetpu.ops.treepm._w_short_tile`), the
    softened law minus the long-range weight. poly: 0 at r >= rcut; gauss:
    the Chebyshev bracket inside HLONG_VMAX, 1/r^3 beyond."""
    eps = float(eps)
    if softening == "plummer":
        d2 = r2 + eps * eps
        inv = torch.rsqrt(d2)
        w_pair = torch.where(d2 > 0.0, inv * inv * inv, 0.0)
    elif softening == "ref":
        denom = r2 * torch.sqrt(r2) + eps
        w_pair = torch.where(denom > 0.0, 1.0 / denom, 0.0)
    else:
        raise ValueError(f"unknown softening {softening!r}")
    inv_r = torch.where(r2 > 0.0, torch.rsqrt(torch.clamp_min(r2, 1e-38)),
                        0.0)
    if split == "poly":
        yc = r2 * (1.0 / (rcut * rcut))
        y = torch.clamp_max(yc, 1.0)
        gp = y * y * y * (10.0 + y * (-15.0 + 6.0 * y))
        return torch.where(yc < 1.0, w_pair - gp * (inv_r * inv_r * inv_r),
                           0.0)
    if split == "gauss":
        inv4rs2 = 1.0 / (4.0 * rs * rs)
        v = r2 * inv4rs2
        x = torch.clamp_max(v * (2.0 / HLONG_VMAX) - 1.0, 1.0)
        w_in = h_long_cheb(x) * (inv4rs2 * (0.5 / rs))
        w_long = torch.where(v <= HLONG_VMAX, w_in, inv_r * inv_r * inv_r)
        return w_pair - w_long
    raise ValueError(f"unknown treepm split {split!r}")


def _body_pairs_plain(pos_g, srows, flat_src, tile_tgt, weight, hybrid,
                      pair_weight=None):
    """The plain version of the body kernels: sum over the tile list of
    weight(r^2) * g*m_j times (x_j - x_i), or with `hybrid` the centred
    rank-1 form sum_j w_j (x_j - c) - (sum_j w_j)(x_i - c) with c the
    target cluster's first body and r^2 = 0 pairs masked, tile by tile.
    pair_weight(targets (C, leaf, 3), source ids (C, pj), r^2), where given,
    takes the place of weight(r^2) (the tests' walks that leave chunks
    out)."""
    leaf = pos_g.shape[1]
    block = leaf + 1
    table = srows[:4].reshape(4, -1, block)  # (4, n_src + 1, block)

    def contrib(tgt, ids):
        src = table[:, ids].reshape(4, ids.shape[0], -1)  # (4, C, pj*block)
        d = [src[k, :, None, :] - tgt[:, :, k:k + 1] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        w = (weight(r2) if pair_weight is None
             else pair_weight(tgt, ids, r2)) * src[3, :, None, :]
        if not hybrid:
            return torch.stack([torch.sum(w * dk, dim=-1) for dk in d],
                               dim=-1)
        w = torch.where(r2 > 0.0, w, 0.0)
        c = tgt[:, 0:1, :]  # (C, 1, 3)
        sw = torch.sum(w, dim=-1)
        return torch.stack([
            torch.sum(w * (src[k, :, None, :] - c[:, :, k:k + 1]), dim=-1)
            - sw * (tgt[:, :, k] - c[:, :, k]) for k in range(3)], dim=-1)

    return _pairs_plain(pos_g, flat_src, tile_tgt, block, contrib)


def near_pairs_direct_plain(pos_g, srows, flat_src, tile_tgt, *, softening,
                            eps):
    """The plain version of ``pairs_direct``: same arguments and result as
    `near_pairs_direct`, over chunks of tiles."""
    return _body_pairs_plain(
        pos_g, srows, flat_src, tile_tgt,
        lambda r2: direct._pair_weight(r2, softening, float(eps)), False)


def near_pairs_hybrid_plain(pos_g, srows, flat_src, tile_tgt, *, softening,
                            eps):
    """The plain version of ``pairs_hybrid``: same arguments and result as
    `near_pairs_hybrid`, over chunks of tiles."""
    return _body_pairs_plain(
        pos_g, srows, flat_src, tile_tgt,
        lambda r2: direct._pair_weight(r2, softening, float(eps)), True)


def _short_weight(softening, eps, rs, rcut, split):
    return lambda r2: w_short_tile(r2, softening=softening, eps=eps,
                                   rs=float(rs), rcut=float(rcut),
                                   split=split)


def near_pairs_short_plain(pos_g, srows, flat_src, tile_tgt, *, softening,
                           eps, rs, rcut, split):
    """The plain version of ``pairs_short``: same arguments and result as
    `near_pairs_short`, over chunks of tiles."""
    return _body_pairs_plain(pos_g, srows, flat_src, tile_tgt,
                             _short_weight(softening, eps, rs, rcut, split),
                             False)


def cut_cap(leaf: int, dtype) -> int:
    """Source clusters a stage of pairs_short's poly walk: as many as fit
    CUT_STAGE_BYTES (leaf + 1 entries of 4 values a cluster), at least 1."""
    entries = CUT_STAGE_BYTES // (4 * torch.finfo(dtype).bits // 8)
    return max(1, entries // (leaf + 1))


def cut_gap_ratio(tgt, ids, table, *, rcut):
    """gap^2 / rcut^2 of the (warp, chunk) that holds each (target, source
    slot) pair of a batch of tiles in pairs_short's poly walk: (C, leaf,
    pj * block), for targets tgt (C, leaf, 3) and source cluster ids (C, pj)
    into table (4, n_src + 1, block). The walk evaluates the pairs where it
    is below 1; a dead slot's pairs read inf.

    As csrc/tree.cu stages them: a tile's live clusters (ids in [0, n_src))
    in order, `cut_cap` clusters a stage, block entries each; a chunk is 32
    consecutive entries of a stage. A warp is 32 consecutive target slots of
    a block of whole warps (its live targets: slots < leaf). gap is the
    per-axis distance between the two bounding boxes, squared and summed as
    the plain versions sum r^2: so every pair of a chunk the walk skips has
    r^2 / rcut^2 >= 1 under the plain versions' arithmetic, where the poly
    split's weight is exactly 0."""
    c, leaf = tgt.shape[:2]
    pj, block = ids.shape[1], table.shape[2]
    n_src = table.shape[1] - 1
    dev, inf = tgt.device, float("inf")
    cap = cut_cap(leaf, tgt.dtype)
    per_stage = -(-cap * block // CUT_CHUNK)  # chunks a stage
    n_keys = -(-pj // cap) * per_stage
    live = (ids >= 0) & (ids < n_src)
    rank = torch.cumsum(live, dim=1) - 1
    entry = (rank % cap)[:, :, None] * block + torch.arange(block, device=dev)
    key = (rank // cap)[:, :, None] * per_stage + entry // CUT_CHUNK
    key = torch.where(live[:, :, None], key, n_keys).reshape(c, -1)
    src = table[:3, torch.clamp(ids, 0, n_src)].reshape(3, c, -1).permute(
        1, 2, 0)  # (C, pj * block, 3)
    at = key[:, :, None].expand(-1, -1, 3)
    lo_s = src.new_full((c, n_keys + 1, 3), inf).scatter_reduce_(
        1, at, src, "amin")
    hi_s = src.new_full((c, n_keys + 1, 3), -inf).scatter_reduce_(
        1, at, src, "amax")
    warps = -(-block // 32)
    pad = tgt.new_full((c, warps * 32 - leaf, 3), inf)
    lo_t = torch.cat([tgt, pad], 1).reshape(c, warps, 32, 3).amin(2)
    hi_t = torch.cat([tgt, -pad], 1).reshape(c, warps, 32, 3).amax(2)
    gap = torch.clamp_min(torch.maximum(
        lo_s[:, None] - hi_t[:, :, None], lo_t[:, :, None] - hi_s[:, None]),
        0.0)  # (C, warps, n_keys + 1, 3)
    g2 = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] \
        + gap[..., 2] * gap[..., 2]
    ratio = g2 * (1.0 / (rcut * rcut))  # (C, warps, n_keys + 1)
    ratio = ratio[:, torch.arange(leaf, device=dev) // 32]  # (C, leaf, keys)
    return torch.gather(ratio, 2, key[:, None, :].expand(-1, leaf, -1))


def short_pair_counts(pos_g, srows, flat_src, tile_tgt, *, rcut) -> dict:
    """The pairs of pairs_short's poly walk on a tile list (the arguments of
    `near_pairs_short`), counted on the device and read back once:
    ``listed`` (target, source slot) pairs of the live ids, ``in_cutoff``
    those the function needs (a source with g*m != 0 at 0 < r^2 / rcut^2 <
    1), ``evaluated`` those in the (warp, chunk) pairs the walk evaluates
    (`cut_gap_ratio` below 1) and ``in_cutoff_skipped`` the needed ones it leaves out
    (0 by construction)."""
    rcut = float(rcut)
    inv_rc2 = 1.0 / (rcut * rcut)
    block = pos_g.shape[1] + 1
    table = srows[:4].reshape(4, -1, block)
    n_src = table.shape[1] - 1

    def contrib(tgt, ids):
        src = table[:, ids].reshape(4, ids.shape[0], -1)
        d = [src[k, :, None, :] - tgt[:, :, k:k + 1] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        listed = ((ids >= 0) & (ids < n_src)).repeat_interleave(block, 1)
        listed = listed[:, None, :].expand_as(r2)
        need = listed & (src[3, :, None, :] != 0.0) & (r2 > 0.0) \
            & (r2 * inv_rc2 < 1.0)
        keep = (cut_gap_ratio(tgt, ids, table, rcut=rcut) < 1.0) & listed
        return torch.stack([x.sum(-1) for x in (
            listed, need, keep, need & ~keep)], dim=-1).to(pos_g.dtype)

    counts = _pairs_plain(pos_g, flat_src, tile_tgt, block, contrib,
                          channels=4)
    names = ("listed", "in_cutoff", "evaluated", "in_cutoff_skipped")
    return dict(zip(names, (int(v) for v in counts.double().sum((0, 1)))))


def near_pairs_short_hybrid_plain(pos_g, srows, flat_src, tile_tgt, *,
                                  softening, eps, rs, rcut, split):
    """The plain version of ``pairs_short_hybrid``: same arguments and
    result as `near_pairs_short_hybrid`, over chunks of tiles."""
    return _body_pairs_plain(pos_g, srows, flat_src, tile_tgt,
                             _short_weight(softening, eps, rs, rcut, split),
                             True)


def near_pairs_quad_plain(pos_g, summaries_signed, flat_src, tile_tgt, *,
                          eps):
    """The plain version of ``pairs_quad``: same arguments and result as
    `near_pairs_quad`, over chunks of tiles."""
    gg, leaf = pos_g.shape[:2]

    def contrib(tgt, ids):
        summ = summaries_signed[:, ids].permute(1, 0, 2)  # (C, 16, pj)
        return _quad_terms(tgt, summ, float(eps))

    acc = _pairs_plain(pos_g, flat_src, tile_tgt, 1, contrib)
    return acc.reshape(gg * leaf, 3)


def near_pairs_quad_shared_plain(pos_g, summaries, flat_src, tile_tgt,
                                 tile_src, *, eps):
    """The plain version of ``pairs_quad_shared``: same arguments and
    result as `near_pairs_quad_shared`, over chunks of tiles."""
    gg, leaf = pos_g.shape[:2]

    def contrib(tgt, ids):
        return _quad_terms(tgt, summaries[:, ids].permute(1, 0, 2),
                           float(eps))

    acc = _pairs_plain(pos_g, flat_src, tile_tgt, 1, contrib,
                       tile_src=tile_src, pj=NEAR_QUAD_PJ)
    return acc.reshape(gg * leaf, 3)


def augmented_pool(pool_pos_g, pool_mass_g, pool_com, pool_m_tot, g_const,
                   monopole_pseudo: bool):
    """Source clusters with their pseudo-body slot: positions
    (P, block, 3) and g*m (P, block). The pseudo-body sits at the centre of
    mass and carries -g*M (monopole_pseudo) or nothing."""
    aug_pos = torch.cat([pool_pos_g, pool_com[:, None, :]], dim=1)
    pseudo_gm = (-pool_m_tot[:, None] * g_const if monopole_pseudo
                 else torch.zeros_like(pool_m_tot[:, None]))
    aug_gm = torch.cat([pool_mass_g * g_const, pseudo_gm], dim=1)
    return aug_pos, aug_gm


def near_strip_plain(pos_g_t, idx, pool_pos_g, pool_mass_g, pool_com,
                     pool_m_tot, *, softening, eps, g, monopole_pseudo):
    """The plain version of ``near_strip``: same arguments and result as
    `near_strip`. Gathers each chunk of target clusters' near clusters
    (the null id P picks an appended all-zero cluster)."""
    aug_pos, aug_gm = augmented_pool(pool_pos_g, pool_mass_g, pool_com,
                                     pool_m_tot, float(g), monopole_pseudo)
    aug_pos = torch.cat([aug_pos, aug_pos.new_zeros((1,) + aug_pos.shape[1:])])
    aug_gm = torch.cat([aug_gm, aug_gm.new_zeros((1,) + aug_gm.shape[1:])])
    n_t, leaf = pos_g_t.shape[:2]
    strip = idx.shape[1] * aug_pos.shape[1]
    step = max(1, _PLAIN_ELEMS // max(leaf * strip, 1))
    out = [pos_g_t.new_zeros((0, leaf, 3))]
    for c0 in range(0, n_t, step):
        near_idx = idx[c0:c0 + step]
        tgt = pos_g_t[c0:c0 + step]
        sp = aug_pos[near_idx].reshape(tgt.shape[0], strip, 3)
        sm = aug_gm[near_idx].reshape(tgt.shape[0], strip)
        d = [sp[:, None, :, k] - tgt[:, :, k:k + 1] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        w = direct._pair_weight(r2, softening, float(eps)) * sm[:, None, :]
        out.append(torch.stack([torch.sum(w * dk, dim=-1) for dk in d],
                               dim=-1))
    return torch.cat(out)


def quad_strip_plain(pos_g_t, summaries_neg, idx, *, eps):
    """The plain version of ``quad_strip``: same arguments and result as
    `quad_strip`, over chunks of target clusters."""
    n_t, leaf = pos_g_t.shape[:2]
    step = max(1, _PLAIN_ELEMS // max(16 * leaf * idx.shape[1], 1))
    out = [pos_g_t.new_zeros((0, 3))]
    for c0 in range(0, n_t, step):
        summ = summaries_neg[:, idx[c0:c0 + step]].permute(1, 0, 2)
        out.append(_quad_terms(pos_g_t[c0:c0 + step], summ,
                               float(eps)).reshape(-1, 3))
    return torch.cat(out)


def quad_refine_plain(pos_g, strips, *, eps, group):
    """The plain version of ``quad_refine``: same arguments and result as
    `quad_refine`, one chunk of supers at a time."""
    gg, leaf = pos_g.shape[:2]
    g2 = gg // group
    s_pad = strips.shape[1] // g2
    strips = strips[:, :g2 * s_pad].reshape(-1, g2, s_pad)[:10].permute(
        1, 0, 2)
    targets = pos_g.reshape(g2, group * leaf, 3)
    step = max(1, _PLAIN_ELEMS // max(group * leaf * s_pad, 1))
    out = [_quad_terms(targets[a:a + step], strips[a:a + step], float(eps))
           for a in range(0, g2, step)]
    return torch.cat(out).reshape(gg * leaf, 3)


# --- wrappers ---------------------------------------------------------------


def _check_float(name: str, x, like=None):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not supported "
                        "(want float32 or float64)")
    if like is not None and (x.dtype != like.dtype
                             or x.device != like.device):
        raise ValueError(f"{name} must share the targets' dtype and device "
                         f"({like.dtype}, {like.device}), got {x.dtype}, "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_table(name: str, x, rows: int):
    if x.dim() != 2 or x.shape[0] < rows or x.stride(1) != 1:
        raise ValueError(f"{name} must be a (>= {rows}, columns) table with "
                         f"unit column stride, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")


def _check_index(name: str, x, like):
    if x.dtype != torch.int64 or x.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int64 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, the targets on "
                         f"{like.device}")


def _check_clusters(name: str, x, like=None):
    if x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"{name} must be (G, leaf, 3), got "
                         f"{tuple(x.shape)}")
    _check_float(name, x, like)


def _check_leaf(leaf: int):
    if leaf + 1 > 1024:
        raise ValueError(f"leaf={leaf}: a cluster block must fit one CUDA "
                         "block of 1024 threads")


def _check_tiles(pos_g, flat_src, tile_tgt) -> int:
    """Validate a tile list against its targets; returns pj."""
    _check_clusters("pos_g", pos_g)
    _check_index("flat_src", flat_src, pos_g)
    _check_index("tile_tgt", tile_tgt, pos_g)
    n_tiles = tile_tgt.shape[0]
    if n_tiles == 0 or flat_src.shape[0] % n_tiles:
        raise ValueError(f"flat_src ({flat_src.shape[0]}) is not a whole "
                         f"number of columns for {n_tiles} tiles")
    return flat_src.shape[0] // n_tiles


def tile_starts(tile_tgt, gg: int):
    """(G + 1,) first tile of each target cluster in a tile list ordered by
    target and padded with the id G; cluster a owns the tiles
    [starts[a], starts[a + 1]). Computed on the device."""
    return torch.searchsorted(
        tile_tgt, torch.arange(gg + 1, device=tile_tgt.device))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def acc_cross_quad(pos_i, summaries, *, eps):
    """Targets (M, 3) against multipole summaries (16, S) -> (M, 3), with
    plummer softening `eps`. Rows of `summaries`: 0-2 centre of mass, 3 g*M,
    4-9 the traceless g*Q (xx, yy, zz, xy, xz, yz); g is folded in by the
    caller. With rel = COM - target and d2 = |rel|^2 + eps^2:

        a += gM rel d2^-3/2 - (gQ rel) d2^-5/2 + 2.5 (rel.gQ.rel) rel d2^-7/2

    `summaries` may be a column slice of a wider table."""
    if pos_i.dim() != 2 or pos_i.shape[1] != 3:
        raise ValueError(f"pos_i must be (M, 3), got {tuple(pos_i.shape)}")
    _check_float("pos_i", pos_i)
    _check_float("summaries", summaries, pos_i)
    _check_table("summaries", summaries, 10)
    if pos_i.device.type == "cpu":
        return acc_cross_quad_plain(pos_i, summaries, eps=eps)
    m, s = pos_i.shape[0], summaries.shape[1]
    out = pos_i.new_empty((m, 3))
    if m == 0:
        return out
    tgt = pos_i.contiguous()
    with torch.cuda.device(pos_i.device):
        rc = _lib().spacetpu_quad_dense(
            _DTYPES[pos_i.dtype], tgt.data_ptr(), summaries.data_ptr(),
            summaries.stride(0), out.data_ptr(), m, s, float(eps),
            _stream(pos_i.device))
    if rc != 0:
        raise RuntimeError(f"quad_dense launch failed: CUDA error {rc}")
    LAUNCHES["quad_dense"] += 1
    return out


def acc_cross_quad_masked(targets, summaries, idx2, *, eps):
    """The 3-level far field's dense pass: the targets of n2 target supers
    against G2 super summaries, each super with the g*M and g*Q of its own
    near supers zeroed (its centre of mass kept) -> (n2 * rows, 3).

    targets: (n2 * rows, 3), target super a in rows [a * rows, (a + 1) *
    rows). summaries: (16, G2) as for `acc_cross_quad`. idx2: (n2, K2)
    int64 near-super ids, null = G2. A zeroed column adds exactly 0, so the
    result is `acc_cross_quad` against super a's masked table, row block by
    row block. The keep mask is built on the device by one scatter."""
    if targets.dim() != 2 or targets.shape[1] != 3:
        raise ValueError(f"targets must be (M, 3), got "
                         f"{tuple(targets.shape)}")
    _check_float("targets", targets)
    _check_float("summaries", summaries, targets)
    _check_table("summaries", summaries, 10)
    if idx2.dtype != torch.int64 or idx2.dim() != 2:
        raise TypeError(f"idx2 must be a 2-D int64 tensor, got {idx2.dtype} "
                        f"{tuple(idx2.shape)}")
    if idx2.device != targets.device:
        raise ValueError(f"idx2 is on {idx2.device}, the targets on "
                         f"{targets.device}")
    n2 = idx2.shape[0]
    if n2 == 0 or targets.shape[0] % n2:
        raise ValueError(f"{targets.shape[0]} targets are not a whole number "
                         f"of rows for {n2} target supers")
    if targets.device.type == "cpu":
        return acc_cross_quad_masked_plain(targets, summaries, idx2, eps=eps)
    rows, g2 = targets.shape[0] // n2, summaries.shape[1]
    out = targets.new_empty((n2 * rows, 3))
    if rows == 0:
        return out
    tgt = targets.contiguous()
    keep = _keep_mask(idx2, g2).contiguous()
    with torch.cuda.device(targets.device):
        rc = _lib().spacetpu_quad_masked(
            _DTYPES[targets.dtype], tgt.data_ptr(), summaries.data_ptr(),
            summaries.stride(0), keep.data_ptr(), out.data_ptr(), n2, rows,
            g2, float(eps), _stream(targets.device))
    if rc != 0:
        raise RuntimeError(f"quad_masked launch failed: CUDA error {rc}")
    LAUNCHES["quad_masked"] += 1
    return out


def _body_pairs(name, plain, pos_g, srows, flat_src, tile_tgt, softening,
                scalars, split=None, two_targets=False):
    """Check the arguments of a body kernel, then run its plain version on a
    CPU tensor or launch the kernel (C entry spacetpu_<name>; the split
    follows the law where given, the float `scalars` follow n_src; a
    `two_targets` kernel takes `lean_rsqrt` after the law, the block order
    `heavy_first` after tile_start and `two_target_threads` after the
    scalars) on a CUDA tensor."""
    if softening not in _LAWS:
        raise ValueError(f"unknown softening {softening!r}")
    pj = _check_tiles(pos_g, flat_src, tile_tgt)
    _check_float("srows", srows, pos_g)
    _check_table("srows", srows, 4)
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    if srows.shape[1] % block or srows.shape[1] < block:
        raise ValueError(f"srows has {srows.shape[1]} columns, not a whole "
                         f"number of {block}-column clusters")
    if pos_g.device.type == "cpu":
        return plain()
    _check_leaf(leaf)
    out = pos_g.new_empty((gg, leaf, 3))
    if gg == 0:
        return out
    tgt = pos_g.contiguous()
    flat = flat_src.contiguous()
    starts = tile_starts(tile_tgt, gg)
    n_src = srows.shape[1] // block - 1
    head = () if split is None else (_SPLITS[split],)
    order, tail = [], ()
    if two_targets:
        head = (int(lean_rsqrt(pos_g.dtype, softening, scalars[0])),)
        order = [heavy_first(starts[1:] - starts[:-1])]
        tail = (two_target_threads(leaf),)
    with torch.cuda.device(pos_g.device):
        rc = getattr(_lib(), f"spacetpu_{name}")(
            _DTYPES[pos_g.dtype], _LAWS[softening], *head, tgt.data_ptr(),
            srows.data_ptr(), srows.stride(0), flat.data_ptr(),
            starts.data_ptr(), *(o.data_ptr() for o in order),
            out.data_ptr(), gg, leaf, pj, n_src,
            *scalars, *tail, _stream(pos_g.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def near_pairs_direct(pos_g, srows, flat_src, tile_tgt, *, softening, eps):
    """Pair-list near correction -> (G, leaf, 3).

    pos_g: (G, leaf, 3) target clusters. srows: (>= 4, (n_src + 1) * block)
    source table from `tree._pack_augmented` (rows x, y, z, g*m; block =
    leaf + 1 columns a cluster, the last cluster null). flat_src,
    tile_tgt: the tile list of `tree.near_pair_segments`, ordered by target;
    ids >= n_src are null, tiles aimed at target G are padding. Two
    targets a thread (`two_target_threads`), blocks in `heavy_first` order,
    the MUFU rsqrt alone where `lean_rsqrt`."""
    return _body_pairs(
        "pairs_direct",
        lambda: near_pairs_direct_plain(pos_g, srows, flat_src, tile_tgt,
                                        softening=softening, eps=eps),
        pos_g, srows, flat_src, tile_tgt, softening, (float(eps),),
        two_targets=True)


def near_pairs_hybrid(pos_g, srows, flat_src, tile_tgt, *, softening, eps):
    """`near_pairs_direct`'s function summed in the centred rank-1 form of
    `tree._kernel_pairs_hybrid`: per target, sum_j w_j (x_j - c) minus
    (sum_j w_j)(x_i - c), c the first body of the target cluster, pairs at
    r^2 = 0 masked. Same arguments and result shape. Two targets a thread
    (`two_target_threads`), blocks in `heavy_first` order, the MUFU rsqrt
    alone where `lean_rsqrt`."""
    return _body_pairs(
        "pairs_hybrid",
        lambda: near_pairs_hybrid_plain(pos_g, srows, flat_src, tile_tgt,
                                        softening=softening, eps=eps),
        pos_g, srows, flat_src, tile_tgt, softening, (float(eps),),
        two_targets=True)


def _short_args(rs, rcut, split):
    if split not in _SPLITS:
        raise ValueError(f"unknown treepm split {split!r}")
    if split == "poly" and not float(rcut) > 0.0:
        raise ValueError(f"split='poly' needs rcut > 0, got {rcut}")
    if split == "gauss" and not float(rs) > 0.0:
        raise ValueError(f"split='gauss' needs rs > 0, got {rs}")
    return float(rs), float(rcut)


def near_pairs_short(pos_g, srows, flat_src, tile_tgt, *, softening, eps,
                     rs, rcut, split):
    """The TreePM short-range pair pass -> (G, leaf, 3): the tile-list
    contract of `near_pairs_direct`, with the pair weight g*m_j *
    `w_short_tile` (split "poly" with rcut > 0, or "gauss" with rs > 0).
    srows comes from `tree._pack_augmented(monopole_pseudo=False)`: its
    pseudo slot is massless and adds exactly 0."""
    rs, rcut = _short_args(rs, rcut, split)
    return _body_pairs(
        "pairs_short",
        lambda: near_pairs_short_plain(pos_g, srows, flat_src, tile_tgt,
                                       softening=softening, eps=eps, rs=rs,
                                       rcut=rcut, split=split),
        pos_g, srows, flat_src, tile_tgt, softening, (float(eps), rs, rcut),
        split)


def near_pairs_short_hybrid(pos_g, srows, flat_src, tile_tgt, *, softening,
                            eps, rs, rcut, split):
    """`near_pairs_short`'s function summed as `near_pairs_hybrid` sums.
    Same arguments and result shape."""
    rs, rcut = _short_args(rs, rcut, split)
    return _body_pairs(
        "pairs_short_hybrid",
        lambda: near_pairs_short_hybrid_plain(
            pos_g, srows, flat_src, tile_tgt, softening=softening, eps=eps,
            rs=rs, rcut=rcut, split=split),
        pos_g, srows, flat_src, tile_tgt, softening, (float(eps), rs, rcut),
        split)


def near_pairs_quad(pos_g, summaries_signed, flat_src, tile_tgt, *, eps):
    """Pair-list multipole evaluation -> (G * leaf, 3).

    summaries_signed: (16, n_src + 1), the table the caller chose (negated
    g*M and g*Q rows to subtract the near clusters' far-field term), last
    column null. flat_src holds column ids, `pj` a tile; ids >= n_src are
    null."""
    pj = _check_tiles(pos_g, flat_src, tile_tgt)
    _check_float("summaries_signed", summaries_signed, pos_g)
    _check_table("summaries_signed", summaries_signed, 10)
    gg, leaf = pos_g.shape[:2]
    if pos_g.device.type == "cpu":
        return near_pairs_quad_plain(pos_g, summaries_signed, flat_src,
                                     tile_tgt, eps=eps)
    _check_leaf(leaf)
    out = pos_g.new_empty((gg * leaf, 3))
    if gg == 0:
        return out
    tgt = pos_g.contiguous()
    flat = flat_src.contiguous()
    starts = tile_starts(tile_tgt, gg)
    n_src = summaries_signed.shape[1] - 1
    with torch.cuda.device(pos_g.device):
        rc = _lib().spacetpu_pairs_quad(
            _DTYPES[pos_g.dtype], tgt.data_ptr(),
            summaries_signed.data_ptr(), summaries_signed.stride(0),
            flat.data_ptr(), starts.data_ptr(), out.data_ptr(), gg, leaf, pj,
            n_src, float(eps), _stream(pos_g.device))
    if rc != 0:
        raise RuntimeError(f"pairs_quad launch failed: CUDA error {rc}")
    LAUNCHES["pairs_quad"] += 1
    return out


def near_pairs_quad_shared(pos_g, summaries, flat_src, tile_tgt, tile_src,
                           *, eps):
    """Pair-list multipole evaluation over shared source strips -> (G *
    leaf, 3).

    As `near_pairs_quad`, but tile k reads its pj = NEAR_QUAD_PJ column ids
    from flat_src[tile_src[k] * pj : (tile_src[k] + 1) * pj], so the SUPER
    member clusters of one super share its strips
    (`tree.shared_pair_segments`).
    summaries: (16, n_src + 1), last column null; ids >= n_src are null;
    tile_tgt is ordered by target and padded with G."""
    _check_index("tile_src", tile_src, pos_g)
    _check_clusters("pos_g", pos_g)
    _check_index("flat_src", flat_src, pos_g)
    _check_index("tile_tgt", tile_tgt, pos_g)
    if tile_src.shape != tile_tgt.shape:
        raise ValueError(f"tile_src {tuple(tile_src.shape)} and tile_tgt "
                         f"{tuple(tile_tgt.shape)} differ in shape")
    pj = NEAR_QUAD_PJ
    if flat_src.shape[0] % pj:
        raise ValueError(f"flat_src ({flat_src.shape[0]}) is not a whole "
                         f"number of {pj}-column source tiles")
    _check_float("summaries", summaries, pos_g)
    _check_table("summaries", summaries, 10)
    gg, leaf = pos_g.shape[:2]
    if pos_g.device.type == "cpu":
        return near_pairs_quad_shared_plain(pos_g, summaries, flat_src,
                                            tile_tgt, tile_src, eps=eps)
    _check_leaf(leaf)
    out = pos_g.new_empty((gg * leaf, 3))
    if gg == 0:
        return out
    tgt = pos_g.contiguous()
    flat = flat_src.contiguous()
    tsrc = tile_src.contiguous()
    starts = tile_starts(tile_tgt, gg)
    n_src = summaries.shape[1] - 1
    with torch.cuda.device(pos_g.device):
        rc = _lib().spacetpu_pairs_quad_shared(
            _DTYPES[pos_g.dtype], tgt.data_ptr(), summaries.data_ptr(),
            summaries.stride(0), flat.data_ptr(), tsrc.data_ptr(),
            starts.data_ptr(), out.data_ptr(), gg, leaf, pj, n_src,
            float(eps), _stream(pos_g.device))
    if rc != 0:
        raise RuntimeError(f"pairs_quad_shared launch failed: CUDA error {rc}")
    LAUNCHES["pairs_quad_shared"] += 1
    return out


def _check_near_list(name: str, idx, like, n_rows: int, null: int):
    """A (n_rows, K) int64 list of ids in [0, null] (null = the null id) on
    the targets' device. Reads the least and the largest id back to the
    host."""
    if idx.dtype != torch.int64 or idx.dim() != 2:
        raise TypeError(f"{name} must be a 2-D int64 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != like.device:
        raise ValueError(f"{name} is on {idx.device}, the targets on "
                         f"{like.device}")
    if idx.shape[0] != n_rows:
        raise ValueError(f"{name} has {idx.shape[0]} rows for {n_rows} "
                         "target clusters")
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi > null:
            raise IndexError(f"{name} holds ids in [{lo}, {hi}], outside "
                             f"[0, {null}] ({null} = the null id)")


def near_strip(pos_g_t, idx, pool_pos_g, pool_mass_g, pool_com, pool_m_tot,
               *, softening, eps, g, monopole_pseudo):
    """Strip-mode near correction -> (G_t, leaf, 3): target cluster a
    against the bodies of pool clusters idx[a] and, for each, a pseudo-body
    at its centre of mass carrying -g*M (monopole_pseudo) or nothing, with
    the direct law `softening`.

    pos_g_t: (G_t, leaf, 3) targets. The pool of P source clusters:
    pool_pos_g (P, leaf, 3), pool_mass_g (P, leaf), pool_com (P, 3) and
    pool_m_tot (P,). idx: (G_t, K) int64 pool ids, P = the null cluster
    (adds 0). The kernel reads the sources through idx; nothing is
    gathered. Two targets a thread (`two_target_threads`), blocks in
    `heavy_first` order, the MUFU rsqrt alone where `lean_rsqrt`."""
    if softening not in _LAWS:
        raise ValueError(f"unknown softening {softening!r}")
    _check_clusters("pos_g_t", pos_g_t)
    _check_clusters("pool_pos_g", pool_pos_g, pos_g_t)
    n_t, leaf = pos_g_t.shape[:2]
    p = pool_pos_g.shape[0]
    for name, x, shape in (("pool_mass_g", pool_mass_g, (p, leaf)),
                           ("pool_com", pool_com, (p, 3)),
                           ("pool_m_tot", pool_m_tot, (p,))):
        _check_float(name, x, pos_g_t)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
    if pool_pos_g.shape[1] != leaf:
        raise ValueError(f"pool clusters hold {pool_pos_g.shape[1]} bodies, "
                         f"the targets' {leaf}")
    _check_near_list("idx", idx, pos_g_t, n_t, p)
    if pos_g_t.device.type == "cpu":
        return near_strip_plain(pos_g_t, idx, pool_pos_g, pool_mass_g,
                                pool_com, pool_m_tot, softening=softening,
                                eps=eps, g=g,
                                monopole_pseudo=monopole_pseudo)
    _check_leaf(leaf)
    out = pos_g_t.new_empty((n_t, leaf, 3))
    if n_t == 0:
        return out
    order = heavy_first((idx < p).sum(1))
    args = [x.contiguous() for x in (pos_g_t, pool_pos_g, pool_mass_g,
                                     pool_com, pool_m_tot, idx, order)]
    with torch.cuda.device(pos_g_t.device):
        rc = _lib().spacetpu_near_strip(
            _DTYPES[pos_g_t.dtype], _LAWS[softening], int(monopole_pseudo),
            int(lean_rsqrt(pos_g_t.dtype, softening, eps)),
            *(x.data_ptr() for x in args), out.data_ptr(), n_t, leaf,
            idx.shape[1], p, float(g), float(eps), two_target_threads(leaf),
            _stream(pos_g_t.device))
    if rc != 0:
        raise RuntimeError(f"near_strip launch failed: CUDA error {rc}")
    LAUNCHES["near_strip"] += 1
    return out


def quad_strip(pos_g_t, summaries_neg, idx, *, eps):
    """Strip-mode multipole subtraction -> (G_t * leaf, 3): target cluster
    a against summary columns idx[a] of `summaries_neg` (16, n_src + 1),
    the table with g*M and g*Q negated and a null column n_src (adds 0).
    idx: (G_t, K) int64 column ids in [0, n_src]."""
    _check_clusters("pos_g_t", pos_g_t)
    _check_float("summaries_neg", summaries_neg, pos_g_t)
    _check_table("summaries_neg", summaries_neg, 10)
    n_t, leaf = pos_g_t.shape[:2]
    n_src = summaries_neg.shape[1] - 1
    _check_near_list("idx", idx, pos_g_t, n_t, n_src)
    if pos_g_t.device.type == "cpu":
        return quad_strip_plain(pos_g_t, summaries_neg, idx, eps=eps)
    _check_leaf(leaf)
    out = pos_g_t.new_empty((n_t * leaf, 3))
    if n_t == 0:
        return out
    tgt, ids = pos_g_t.contiguous(), idx.contiguous()
    with torch.cuda.device(pos_g_t.device):
        rc = _lib().spacetpu_quad_strip(
            _DTYPES[pos_g_t.dtype], tgt.data_ptr(), summaries_neg.data_ptr(),
            summaries_neg.stride(0), ids.data_ptr(), out.data_ptr(), n_t,
            leaf, idx.shape[1], n_src, float(eps), _stream(pos_g_t.device))
    if rc != 0:
        raise RuntimeError(f"quad_strip launch failed: CUDA error {rc}")
    LAUNCHES["quad_strip"] += 1
    return out


def quad_refine(pos_g, strips, *, eps, group):
    """The strip refinement of the 3-level far field -> (G * leaf, 3):
    cluster c of super c // group against its super's strip of summaries.

    pos_g: (G, leaf, 3), G a multiple of `group` (SUPER; even on a CUDA
    tensor). strips: (>= 10, (G / group) * S_pad), super b's strip in
    columns [b * S_pad, (b + 1) * S_pad) (`tree._superfar_refine_table`); a
    column with g*M = 0 and g*Q = 0 adds exactly 0."""
    _check_clusters("pos_g", pos_g)
    _check_float("strips", strips, pos_g)
    _check_table("strips", strips, 10)
    gg, leaf = pos_g.shape[:2]
    group = int(group)
    if group <= 0 or gg % group:
        raise ValueError(f"G={gg} is not a whole number of {group}-cluster "
                         "supers")
    g2 = gg // group
    if g2 == 0 or strips.shape[1] % g2:
        raise ValueError(f"strips ({strips.shape[1]} columns) is not one "
                         f"strip of equal width for each of {g2} supers")
    if pos_g.device.type == "cpu":
        return quad_refine_plain(pos_g, strips, eps=eps, group=group)
    _check_leaf(leaf)
    if group % 2:
        raise ValueError(f"quad_refine takes two clusters of one super a "
                         f"block: group={group} must be even")
    out = pos_g.new_empty((gg * leaf, 3))
    tgt = pos_g.contiguous()
    with torch.cuda.device(pos_g.device):
        rc = _lib().spacetpu_quad_refine(
            _DTYPES[pos_g.dtype], tgt.data_ptr(), strips.data_ptr(),
            strips.stride(0), out.data_ptr(), gg, leaf, group,
            strips.shape[1] // g2, float(eps), _stream(pos_g.device))
    if rc != 0:
        raise RuntimeError(f"quad_refine launch failed: CUDA error {rc}")
    LAUNCHES["quad_refine"] += 1
    return out
