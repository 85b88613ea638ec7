"""The tree's force kernels through hand-written CUDA (``csrc/tree.cu``).

- ``quad_dense`` replaces ``pallas_direct._kernel_quad`` as
  ``acc_cross_quad`` launches it: targets against (16, S) cluster summaries
  (centre of mass, g*M and the traceless g*Q), monopole + quadrupole.
- ``pairs_direct`` replaces ``tree._kernel_pairs`` with its launcher
  ``_near_pairs_call``: the pair-list near correction, exact forces of the
  bodies of each target cluster's near clusters.
- ``pairs_quad`` replaces ``tree._kernel_quad_pairs`` with the same
  launcher: the multipole evaluation over the pair list (with negated
  summaries it takes the near clusters' far-field term back out).
- ``quad_masked`` replaces ``pallas_direct._kernel_quad`` as
  ``tree._superfar_dense_masked`` launches it: every target against every
  SUPER-cluster summary, with the g*M and g*Q of its own super's near
  supers zeroed (the 3-level far field's dense pass).
- ``pairs_quad_shared`` replaces ``tree._kernel_quad_pairs`` as
  ``tree.mid_far_eval`` launches it through ``_near_pairs_call`` with
  ``tile_src``: the pair-list multipole evaluation where each tile reads its
  source ids from a strip shared by the clusters of one super (the MID far
  field's M1 and M2 passes).

What bounds them on an H100: arithmetic, 59 flops a (target, summary) pair
and 22 or 23 a (target, body) pair (counted in ``csrc/pair.cuh``), against
a few bytes per target and source. One thread owns a target and keeps its
sums in registers; sources go through shared memory. The two pair kernels
run one block per target cluster over that cluster's own contiguous range
of the tile list, so nothing is shared between blocks: no atomics, no
dummy target block, and the result is deterministic (``csrc/tree.cu``).
No single PyTorch call computes any of these functions.

A CPU tensor takes the plain PyTorch version beside each kernel. A CUDA
tensor launches the kernel or raises; nothing falls back. No wrapper reads
a value back to the host.
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
            "quad_masked": 0, "pairs_quad_shared": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_LAWS = {"plummer": 0, "ref": 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

#: elements of one temporary of the plain versions (they work in chunks)
_PLAIN_ELEMS = 1 << 22


def _lib() -> ctypes.CDLL:
    lib = _build.library("tree")
    if lib.spacetpu_quad_dense.argtypes is None:
        lib.spacetpu_quad_dense.argtypes = [
            _INT, _P, _P, _I64, _P, _I64, _I64, ctypes.c_double, _P]
        lib.spacetpu_quad_dense.restype = _INT
        lib.spacetpu_pairs_direct.argtypes = [
            _INT, _INT, _P, _P, _I64, _P, _P, _P, _I64, _INT, _INT, _I64,
            ctypes.c_double, _P]
        lib.spacetpu_pairs_direct.restype = _INT
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
                 tile_src=None, pj=None):
    """Sum contrib(targets (C, leaf, 3), source ids (C, pj)) over the tile
    list into (G, leaf, 3); tiles aimed at target G (padding) are dropped.
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
    acc = pos_g.new_zeros((gg + 1, leaf, 3))
    chunk = max(1, _PLAIN_ELEMS // (leaf * pj * width))
    for t0 in range(0, n_tiles, chunk):
        tgt_ids = tile_tgt[t0:t0 + chunk]
        acc.index_add_(0, tgt_ids, contrib(pos_ext[tgt_ids],
                                           srcs[t0:t0 + chunk]))
    return acc[:gg]


def near_pairs_direct_plain(pos_g, srows, flat_src, tile_tgt, *, softening,
                            eps):
    """The plain version of ``pairs_direct``: same arguments and result as
    `near_pairs_direct`, over chunks of tiles."""
    leaf = pos_g.shape[1]
    block = leaf + 1
    table = srows[:4].reshape(4, -1, block)  # (4, n_src + 1, block)

    def contrib(tgt, ids):
        src = table[:, ids].reshape(4, ids.shape[0], -1)  # (4, C, pj*block)
        dx = src[0, :, None, :] - tgt[:, :, 0:1]
        dy = src[1, :, None, :] - tgt[:, :, 1:2]
        dz = src[2, :, None, :] - tgt[:, :, 2:3]
        r2 = dx * dx + dy * dy + dz * dz
        w = direct._pair_weight(r2, softening, float(eps)) * src[3, :, None, :]
        return torch.stack([torch.sum(w * dx, dim=-1),
                            torch.sum(w * dy, dim=-1),
                            torch.sum(w * dz, dim=-1)], dim=-1)

    return _pairs_plain(pos_g, flat_src, tile_tgt, block, contrib)


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


def _check_tiles(pos_g, flat_src, tile_tgt) -> int:
    """Validate a tile list against its targets; returns pj."""
    if pos_g.dim() != 3 or pos_g.shape[2] != 3:
        raise ValueError(f"pos_g must be (G, leaf, 3), got "
                         f"{tuple(pos_g.shape)}")
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


def near_pairs_direct(pos_g, srows, flat_src, tile_tgt, *, softening, eps):
    """Pair-list near correction -> (G, leaf, 3).

    pos_g: (G, leaf, 3) target clusters. srows: (>= 4, (n_src + 1) * block)
    source table from `tree._pack_augmented` (rows x, y, z, g*m; block =
    leaf + 1 columns a cluster, the last cluster null). flat_src,
    tile_tgt: the tile list of `tree.near_pair_segments`, ordered by target;
    ids >= n_src are null, tiles aimed at target G are padding."""
    if softening not in _LAWS:
        raise ValueError(f"unknown softening {softening!r}")
    pj = _check_tiles(pos_g, flat_src, tile_tgt)
    _check_float("pos_g", pos_g)
    _check_float("srows", srows, pos_g)
    _check_table("srows", srows, 4)
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    if srows.shape[1] % block or srows.shape[1] < block:
        raise ValueError(f"srows has {srows.shape[1]} columns, not a whole "
                         f"number of {block}-column clusters")
    if pos_g.device.type == "cpu":
        return near_pairs_direct_plain(pos_g, srows, flat_src, tile_tgt,
                                       softening=softening, eps=eps)
    if block > 1024:
        raise ValueError(f"leaf={leaf}: a cluster block must fit one CUDA "
                         "block of 1024 threads")
    out = pos_g.new_empty((gg, leaf, 3))
    if gg == 0:
        return out
    tgt = pos_g.contiguous()
    flat = flat_src.contiguous()
    starts = tile_starts(tile_tgt, gg)
    n_src = srows.shape[1] // block - 1
    with torch.cuda.device(pos_g.device):
        rc = _lib().spacetpu_pairs_direct(
            _DTYPES[pos_g.dtype], _LAWS[softening], tgt.data_ptr(),
            srows.data_ptr(), srows.stride(0), flat.data_ptr(),
            starts.data_ptr(), out.data_ptr(), gg, leaf, pj, n_src,
            float(eps), _stream(pos_g.device))
    if rc != 0:
        raise RuntimeError(f"pairs_direct launch failed: CUDA error {rc}")
    LAUNCHES["pairs_direct"] += 1
    return out


def near_pairs_quad(pos_g, summaries_signed, flat_src, tile_tgt, *, eps):
    """Pair-list multipole evaluation -> (G * leaf, 3).

    summaries_signed: (16, n_src + 1), the table the caller chose (negated
    g*M and g*Q rows to subtract the near clusters' far-field term), last
    column null. flat_src holds column ids, `pj` a tile; ids >= n_src are
    null."""
    pj = _check_tiles(pos_g, flat_src, tile_tgt)
    _check_float("pos_g", pos_g)
    _check_float("summaries_signed", summaries_signed, pos_g)
    _check_table("summaries_signed", summaries_signed, 10)
    gg, leaf = pos_g.shape[:2]
    if pos_g.device.type == "cpu":
        return near_pairs_quad_plain(pos_g, summaries_signed, flat_src,
                                     tile_tgt, eps=eps)
    if leaf + 1 > 1024:
        raise ValueError(f"leaf={leaf}: a cluster block must fit one CUDA "
                         "block of 1024 threads")
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
    if pos_g.dim() != 3 or pos_g.shape[2] != 3:
        raise ValueError(f"pos_g must be (G, leaf, 3), got "
                         f"{tuple(pos_g.shape)}")
    _check_index("flat_src", flat_src, pos_g)
    _check_index("tile_tgt", tile_tgt, pos_g)
    if tile_src.shape != tile_tgt.shape:
        raise ValueError(f"tile_src {tuple(tile_src.shape)} and tile_tgt "
                         f"{tuple(tile_tgt.shape)} differ in shape")
    pj = NEAR_QUAD_PJ
    if flat_src.shape[0] % pj:
        raise ValueError(f"flat_src ({flat_src.shape[0]}) is not a whole "
                         f"number of {pj}-column source tiles")
    _check_float("pos_g", pos_g)
    _check_float("summaries", summaries, pos_g)
    _check_table("summaries", summaries, 10)
    gg, leaf = pos_g.shape[:2]
    if pos_g.device.type == "cpu":
        return near_pairs_quad_shared_plain(pos_g, summaries, flat_src,
                                            tile_tgt, tile_src, eps=eps)
    if leaf + 1 > 1024:
        raise ValueError(f"leaf={leaf}: a cluster block must fit one CUDA "
                         "block of 1024 threads")
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
