"""Tile splatting: sorted entries, one window a tile (PyTorch + CUDA).

The counterpart of `spacetpu/render/fastsplat.py`. A frame is cut into
tiles of 16x128 pixels; each tile owns a 32x256 window (the tile plus a
margin of 8 rows and 64 columns), and the windows are overlap-added into
the frame:

1. **Pack** (`pack_entries`): each splat entry (subpixel position, radius,
   weighted colour) is quantized into two int32 payloads and an int32 tile
   key, exactly as the JAX version packs its uint32 ones (every bitfield
   is below 2^31). Off-screen and invalid entries take the sentinel key T.
2. **Sort** (`sort_entries`): a stable sort of the keys and a gather of the
   payloads, so the entries of tile t are one contiguous range, in the same
   order as the JAX package's stable `lax.sort`.
3. **Splat** (`render.cuda_splat.splat_tiles`): each tile's
   (WIN_H*3, WIN_W) window, the separable falloff (1 - d^2)^2 of every
   entry of the tile, summed. On the card a hand-written CUDA kernel; on
   the CPU its plain version.
4. **Overlap-add** (`overlap_add`): the windows summed into the frame by
   four shifted dense adds.

`render_scene_fast` draws trails as polylines with a fixed stamp budget a
body (`_trail_stamp_entries`) and bodies as sized splats. `render_scene_auto`
takes it on the card and the scatter path (`rasterizer.render_scene`) on
the CPU, as the JAX version does on and off a TPU.
"""

from __future__ import annotations

import torch

from spacetpu_torch.constants import MIN_CIRCLE_SIZE
from spacetpu_torch.render import rasterizer

# --- geometry ---------------------------------------------------------------
TILE_H = 16     # tile rows
TILE_W = 128    # tile cols
WIN_H = 32      # window rows  (margin 8 above/below)
WIN_W = 256     # window cols  (margin 64 left/right)
MARGIN_Y = (WIN_H - TILE_H) // 2
MARGIN_X = (WIN_W - TILE_W) // 2
#: max splat radius the window margin supports (px)
MAX_RADIUS = float(MARGIN_Y)
MIN_RADIUS = 1.0

#: entries are padded to a multiple of this (the JAX version's chunk size)
E1, E2 = 8, 128
SEGK = E1 * E2

# --- quantization -----------------------------------------------------------
_SUB = 16           # subpixel steps (4 bits)
_RAD_Q = 4          # radius steps per px; 6-bit field covers [0.25, 15.75]
_COL_Q = 1023       # 10-bit color channels
_QY_BITS = 9        # wy in [0, 32) at 1/16 px -> 9 bits
_QR_BITS = 6


def tiles_for(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE_W), -(-height // TILE_H)  # ceil div


def pack_entries(px, py, radius, rgbw, valid, *, width: int, height: int):
    """Quantize splat entries -> (key, pay1, pay2) int32 tensors.

    px/py: (M,) float pixel centres; radius: (M,) px in [MIN, MAX];
    rgbw: (M, 3) weighted colour in [0, 1]; valid: (M,) bool.
    Off-screen and invalid entries get the sentinel tile key (sorted last).
    """
    tx_n, ty_n = tiles_for(width, height)
    n_tiles = tx_n * ty_n

    tx = torch.floor(px / TILE_W).to(torch.int32)
    ty = torch.floor(py / TILE_H).to(torch.int32)
    ok = (valid
          & (px >= -MARGIN_X) & (px < width + MARGIN_X)
          & (py >= -MARGIN_Y) & (py < height + MARGIN_Y))
    # clamp edge splats whose centre is just off-screen into border tiles
    # (their profile tail still reaches visible pixels through the margin)
    tx = torch.clamp(tx, 0, tx_n - 1)
    ty = torch.clamp(ty, 0, ty_n - 1)
    key = torch.where(ok, ty * tx_n + tx, n_tiles).to(torch.int32)

    # window-local coordinates (window origin = tile origin - margin)
    wx = px - (tx * TILE_W - MARGIN_X).to(px.dtype)
    wy = py - (ty * TILE_H - MARGIN_Y).to(py.dtype)
    qx = torch.clamp(wx * _SUB + 0.5, 0, WIN_W * _SUB - 1).to(torch.int32)
    qy = torch.clamp(wy * _SUB + 0.5, 0, WIN_H * _SUB - 1).to(torch.int32)
    qr = torch.clamp(radius * _RAD_Q + 0.5, MIN_RADIUS * _RAD_Q, 63
                     ).to(torch.int32)
    pay1 = (qx << (_QY_BITS + _QR_BITS)) | (qy << _QR_BITS) | qr
    qc = torch.clamp(rgbw * _COL_Q + 0.5, 0, _COL_Q).to(torch.int32)
    pay2 = (qc[:, 0] << 20) | (qc[:, 1] << 10) | qc[:, 2]
    return key, pay1, pay2


def pad_entries(key, pay1, pay2, n_tiles: int):
    """Pad the entries to a multiple of SEGK with sentinel entries."""
    pad = -key.shape[0] % SEGK
    if not pad:
        return key, pay1, pay2
    return (torch.cat([key, key.new_full((pad,), n_tiles)]),
            torch.cat([pay1, pay1.new_zeros((pad,))]),
            torch.cat([pay2, pay2.new_zeros((pad,))]))


def sort_entries(key, pay1, pay2):
    """Stable sort by tile key, the payloads gathered along."""
    key_s, order = torch.sort(key, stable=True)
    return key_s, pay1[order], pay2[order]


def tile_starts(keys_sorted, n_tiles: int):
    """(T + 1,) int64: tile t owns the sorted entries
    [starts[t], starts[t + 1]); the sentinel entries lie from starts[T]."""
    ids = torch.arange(n_tiles + 1, dtype=keys_sorted.dtype,
                       device=keys_sorted.device)
    return torch.searchsorted(keys_sorted, ids)


def decode(pay1, pay2):
    """int32 payloads (any shape) -> (wx, wy, inv_r, (r, g, b)) float32,
    as the JAX version's `_decode` computes them."""
    def f(u):
        return u.to(torch.float32)

    wx = f(pay1 >> (_QY_BITS + _QR_BITS)) * (1.0 / _SUB)
    wy = f((pay1 >> _QR_BITS) & ((1 << _QY_BITS) - 1)) * (1.0 / _SUB)
    inv_r = _RAD_Q / torch.clamp_min(f(pay1 & ((1 << _QR_BITS) - 1)), 1.0)
    inv_cq = torch.tensor(1.0 / _COL_Q, dtype=torch.float32)
    red = f((pay2 >> 20) & 0x3FF) * inv_cq
    grn = f((pay2 >> 10) & 0x3FF) * inv_cq
    blu = f(pay2 & 0x3FF) * inv_cq
    return wx, wy, inv_r, (red, grn, blu)


def profile(d):
    """Separable falloff (1 - d^2)^2."""
    t = torch.clamp_min(1.0 - d * d, 0.0)
    return t * t


def overlap_add(windows, *, width: int, height: int):
    """(T, WIN_H*3, WIN_W) tile windows -> (height, width, 3) frame.

    Windows sit at stride (TILE_H, TILE_W) with margins; each is cut into
    2x2 tile-sized quadrants and each quadrant set is placed with one dense
    shifted add."""
    tx_n, ty_n = tiles_for(width, height)
    win = windows.reshape(ty_n, tx_n, WIN_H, 3, WIN_W)
    pad_h = ty_n * TILE_H + WIN_H - TILE_H
    pad_w = tx_n * TILE_W + WIN_W - TILE_W
    buf = windows.new_zeros((pad_h, pad_w, 3))
    for qy in range(WIN_H // TILE_H):
        for qx in range(WIN_W // TILE_W):
            quad = win[:, :, qy * TILE_H:(qy + 1) * TILE_H, :,
                       qx * TILE_W:(qx + 1) * TILE_W]
            img = quad.permute(0, 2, 1, 4, 3).reshape(
                ty_n * TILE_H, tx_n * TILE_W, 3)
            buf[qy * TILE_H:qy * TILE_H + img.shape[0],
                qx * TILE_W:qx * TILE_W + img.shape[1]] += img
    return buf[MARGIN_Y:MARGIN_Y + height, MARGIN_X:MARGIN_X + width, :]


def prepare_entries(px, py, radius, rgbw, valid, *, width: int, height: int):
    """Clamp the radii, pack, pad and sort: (keys, pay1, pay2) sorted, the
    input of `cuda_splat.splat_tiles`."""
    n_tiles = tiles_for(width, height)[0] * tiles_for(width, height)[1]
    radius = torch.clamp(radius, MIN_RADIUS, MAX_RADIUS)
    key, pay1, pay2 = pack_entries(px, py, radius, rgbw, valid, width=width,
                                   height=height)
    return sort_entries(*pad_entries(key, pay1, pay2, n_tiles))


def splat_entries(px, py, radius, rgbw, valid, *, width: int, height: int,
                  backend: str = "auto"):
    """Rasterize M splat entries into an (H, W, 3) float framebuffer.

    radius is clamped to [MIN_RADIUS, MAX_RADIUS]; rgbw is the
    already-weighted colour in [0, 1] (apply exposure to the result, not
    the weights: channels are quantized to 10 bits). backend: "cuda" (the
    kernel; CUDA tensors only), "torch" (the plain version) or "auto" (the
    kernel on a CUDA tensor, the plain version on a CPU tensor; the JAX
    names "pallas" and "xla" are accepted)."""
    from spacetpu_torch.render import cuda_splat

    backend = {"pallas": "cuda", "xla": "torch"}.get(backend, backend)
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown splat backend {backend!r}")
    tx_n, ty_n = tiles_for(width, height)
    keys, pay1, pay2 = prepare_entries(px, py, radius, rgbw, valid,
                                       width=width, height=height)
    if backend == "torch":
        windows = cuda_splat.splat_tiles_plain(keys, pay1, pay2,
                                               n_tiles=tx_n * ty_n)
    else:
        windows = cuda_splat.splat_tiles(keys, pay1, pay2,
                                         n_tiles=tx_n * ty_n)
    return overlap_add(windows, width=width, height=height)


def _trail_stamp_entries(trail_history, trail_ages, colors, view, proj, *,
                         width: int, height: int, budget_per_body: int = 8):
    """Polyline trails: a fixed budget of stamps a body, spread at equal
    arc length along its PROJECTED trail (a screen-space lerp: the straight
    line a rasterizer draws), so a fast body leaves a continuous stroke.

    Returns (px, py, radius, rgbw, valid) flat entry tensors."""
    dtype = trail_history.dtype
    dev = trail_history.device
    t, n, _ = trail_history.shape
    order = torch.argsort(trail_ages, stable=True)  # newest..oldest
    hist = trail_history[order]
    ages = trail_ages[order]
    fade = torch.clamp(1.0 - ages, 0.0, 1.0) * 0.6  # (T,)

    px, py, _, _ = rasterizer.project(
        hist, view, proj, width=width, height=height,
        min_clip_size=torch.zeros((), dtype=dtype, device=dev),
        radii_clip=torch.zeros((t, n), dtype=dtype, device=dev))  # (T, N)
    # a segment draws when both endpoints are IN FRONT of the camera; an
    # endpoint merely outside the viewport still contributes its on-screen
    # stamps (each stamp is viewport-masked by pack_entries)
    hom = torch.cat([hist, torch.ones(hist.shape[:-1] + (1,), dtype=dtype,
                                      device=dev)], dim=-1)
    wc = ((hom @ view.T) @ proj.T)[..., 3]
    infront = wc > 1e-12  # (T, N)

    # segments: consecutive-age snapshot pairs, (T-1, N)
    x0, x1 = px[:-1], px[1:]
    y0, y1 = py[:-1], py[1:]
    seg_ok = infront[:-1] & infront[1:]
    pair_live = ((ages[:-1] <= 1.0) & (ages[1:] <= 1.0))[:, None]
    f0 = fade[:-1, None] * pair_live  # (T-1, 1)
    f1 = fade[1:, None] * pair_live
    seg_len = torch.hypot(x1 - x0, y1 - y0)
    # drawable arc length a segment (capped: one extreme off-screen streak
    # must not starve the rest of that body's stroke)
    len_eff = torch.clamp_max(
        torch.where(seg_ok & (pair_live > 0), seg_len, 0.0), 4.0 * width)
    cum = torch.cumsum(len_eff, dim=0)
    total_len = cum[-1]  # (N,)

    # B equal-arc stamps a body; the segment of each stamp by T-2 compares
    b = budget_per_body
    arc = ((torch.arange(b, dtype=dtype, device=dev) + 0.5) / b)[:, None] \
        * torch.clamp_min(total_len, 1e-6)[None, :]  # (B, N)
    seg_idx = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for k in range(t - 2):
        seg_idx = seg_idx + (arc > cum[k][None, :]).to(torch.int32)

    def select(per_seg):  # (T-1, N) -> (B, N) by seg_idx
        out = torch.zeros((b, n), dtype=dtype, device=dev)
        for k in range(t - 1):
            out = torch.where(seg_idx == k, per_seg[k][None], out)
        return out

    prev_cum = select(torch.cat([torch.zeros((1, n), dtype=dtype,
                                             device=dev), cum[:-1]], dim=0))
    len_sel = select(len_eff)
    tt = torch.clamp((arc - prev_cum) / torch.clamp_min(len_sel, 1e-6),
                     0.0, 1.0)
    sx = select(x0) * (1.0 - tt) + select(x1) * tt
    sy = select(y0) * (1.0 - tt) + select(y1) * tt
    f0b = select(f0.expand(t - 1, n))
    f1b = select(f1.expand(t - 1, n))

    # the stamp radius covers the spacing, so an under-budgeted stroke
    # thickens instead of beading; the weight normalizes the brightness a
    # unit of stroke length
    spacing = torch.clamp_min(total_len, 1.0)[None, :] / b
    radius = torch.clamp(0.75 * spacing, 1.0, MAX_RADIUS).expand(b, n)
    w = (f0b * (1.0 - tt) + f1b * tt) * torch.clamp_max(spacing, 1.0)
    ok = select(seg_ok.to(dtype)) > 0
    rgbw = colors[None].to(dtype).expand(b, n, 3) * w[..., None]
    return (sx.reshape(-1), sy.reshape(-1), radius.reshape(-1),
            rgbw.reshape(-1, 3), ok.reshape(-1))


def _group_entries(group, view, proj, *, width, height, min_clip_size):
    """PointGroup -> flat (px, py, radius, rgbw, valid) splat entries."""
    dtype = group.points.dtype
    px, py, pixel_radius, valid = rasterizer.project(
        group.points, view, proj, width=width, height=height,
        min_clip_size=min_clip_size, radii_clip=group.radii_clip.to(dtype))
    if group.fixed_pixel_radius is not None:
        pixel_radius = torch.where(group.fixed_pixel_radius > 0,
                                   group.fixed_pixel_radius, pixel_radius)
    rgbw = group.colors.to(dtype) * group.weights.to(dtype)[..., None]
    return px, py, pixel_radius, rgbw, valid


def scene_entries(trail_history, trail_ages, colors, radii_world, view, proj,
                  *, width: int, height: int, origin_shift=None,
                  min_clip_size=None, trail_subdiv: int = 2):
    """The projection: a frame's splat entries (px, py, radius, rgbw,
    valid), the trail stamps first, then one entry a body."""
    if min_clip_size is None:
        min_clip_size = MIN_CIRCLE_SIZE
    dtype = trail_history.dtype
    t = trail_history.shape[0]
    if origin_shift is not None:
        trail_history = trail_history - origin_shift[None, None, :]
    view = view.to(dtype)
    proj = proj.to(dtype)

    stamps = _trail_stamp_entries(
        trail_history, trail_ages, colors, view, proj, width=width,
        height=height, budget_per_body=max(2, trail_subdiv) * max(t - 1, 1))
    _, bodies_group = rasterizer.scene_point_groups(
        trail_history, trail_ages, colors, radii_world, proj,
        origin_shift=None, trail_subdiv=1, exposure=1.0)
    body = _group_entries(
        bodies_group, view, proj, width=width, height=height,
        min_clip_size=torch.as_tensor(min_clip_size, dtype=dtype,
                                      device=trail_history.device))
    return tuple(torch.cat([a, b]) for a, b in zip(stamps, body))


def render_scene_fast(trail_history, trail_ages, colors, radii_world, view,
                      proj, *, width: int, height: int, origin_shift=None,
                      min_clip_size=None, trail_subdiv: int = 2,
                      exposure=1.0, backend: str = "auto"):
    """The tile splatter in place of rasterizer.render_scene: the same
    scene (fading trails and sized bodies), with trails as polylines of
    trail_subdiv*(T-1) stamps a body (_trail_stamp_entries). Exposure is
    applied to the finished frame. Splat radii are continuous up to
    MAX_RADIUS px."""
    entries = scene_entries(
        trail_history, trail_ages, colors, radii_world, view, proj,
        width=width, height=height, origin_shift=origin_shift,
        min_clip_size=min_clip_size, trail_subdiv=trail_subdiv)
    frame = splat_entries(*entries, width=width, height=height,
                          backend=backend)
    return torch.clamp(frame * exposure, 0.0, 1.0)


def render_scene_auto(*args, **kw):
    """render_scene_fast on the card; the scatter path on the CPU (where
    the plain splat is slow and the scatter is not)."""
    if args[0].device.type == "cuda":
        return render_scene_fast(*args, **kw)
    kw.pop("backend", None)
    if kw.get("min_clip_size") is None:
        kw.pop("min_clip_size", None)
    return rasterizer.render_scene(*args, **kw)
