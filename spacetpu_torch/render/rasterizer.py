"""Point-splat rasterizer: scatter and convolve (PyTorch).

The counterpart of `spacetpu/render/rasterizer.py`, in plain PyTorch (the
JAX version reaches no Pallas kernel either):

1. project every point (bodies and trail history) with the camera's view and
   infinite-far projection (`project`);
2. scatter each point's weighted colour into one of a few radius-bucketed
   single-pixel canvases, with one `index_put_(accumulate=True)` for all
   points and buckets (bodies take 4 bilinear corner entries, trail points
   one nearest entry);
3. blur each bucket canvas with the separable falloff (1 - (t/r)^2)^2, as
   two 1-D passes of shifted adds, and sum the buckets.

Blending is additive. `render_ordered` composites few-body scenes back to
front with the radial profile as alpha, over the additive trails.

`fastsplat.render_scene_fast` is the path the card takes for additive
frames; this module is the CPU's path and its oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from spacetpu_torch.constants import MIN_CIRCLE_SIZE

#: splat radius buckets in pixels (bucket k's kernel covers _BUCKET_RADII[k])
_BUCKET_RADII = (1.0, 2.0, 4.0, 8.0)


def _falloff_kernel_1d(radius_px: float) -> np.ndarray:
    """1-D profile (1 - (t/r)^2)^2; the 2-D splat is the separable product
    f(x) f(y)."""
    r = int(np.ceil(radius_px))
    t = np.arange(-r, r + 1) / radius_px
    return (np.clip(1.0 - t * t, 0.0, 1.0) ** 2).astype(np.float32)


_KERNELS_1D = tuple(_falloff_kernel_1d(r) for r in _BUCKET_RADII)


@dataclasses.dataclass
class PointGroup:
    """A batch of world-space points sharing render options.

    points (M, 3); colors (M, 3); weights (M,) brightness; radii_clip (M,)
    clip-space sizes (e * world_radius). fixed_pixel_radius: where > 0,
    overrides the perspective pixel radius (hairline trails). antialias:
    bilinear 4-corner splat (4 scatter entries a point) or nearest (1)."""

    points: torch.Tensor
    colors: torch.Tensor
    weights: torch.Tensor
    radii_clip: torch.Tensor
    fixed_pixel_radius: torch.Tensor | None = None
    antialias: bool = True


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """x as a tensor of ref's dtype on ref's device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def project(points, view, proj, *, width: int, height: int, min_clip_size,
            radii_clip):
    """Project world-space points to pixel coordinates.

    Returns (px, py, pixel_radius, valid)."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    hom = torch.cat([points, ones], dim=-1)  # (..., 4)
    v = hom @ view.T
    c = v @ proj.T
    w = c[..., 3]
    valid = w > 1e-12
    w_safe = torch.where(valid, w, 1.0)
    ndc_x = c[..., 0] / w_safe
    ndc_y = c[..., 1] / w_safe
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height
    size_clip = torch.maximum(radii_clip, _like(min_clip_size, radii_clip))
    pixel_radius = size_clip * (height * 0.5) / w_safe
    on_screen = (valid & (px > -16) & (px < width + 16)
                 & (py > -16) & (py < height + 16))
    return px, py, pixel_radius, on_screen


def _bucket_of(pixel_radius):
    radii = _like(_BUCKET_RADII, pixel_radius)
    return torch.argmin(
        torch.abs(torch.log(torch.clamp_min(pixel_radius, 1e-3))[..., None]
                  - torch.log(radii)[None, :]), dim=-1)


def _group_entries(g: PointGroup, view, proj, *, width, height,
                   min_clip_size, dtype):
    """Scatter entries (bucket, y, x, rgb) for one group."""
    px, py, pixel_radius, valid = project(
        g.points, view, proj, width=width, height=height,
        min_clip_size=min_clip_size, radii_clip=g.radii_clip.to(dtype))
    if g.fixed_pixel_radius is not None:
        pixel_radius = torch.where(g.fixed_pixel_radius > 0,
                                   g.fixed_pixel_radius, pixel_radius)
    bucket = _bucket_of(pixel_radius)
    rgb = g.colors.to(dtype) * g.weights.to(dtype)[..., None]

    bs, ys, xs, cs = [], [], [], []

    def emit(xi, yi, w):
        ok = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        bs.append(torch.where(ok, bucket, 0))
        ys.append(torch.where(ok, yi, 0))
        xs.append(torch.where(ok, xi, 0))
        cs.append(rgb * (w * ok.to(dtype))[..., None])

    if g.antialias:
        x0 = torch.floor(px - 0.5)
        y0 = torch.floor(py - 0.5)
        fx = px - 0.5 - x0
        fy = py - 0.5 - y0
        x0 = x0.to(torch.int64)
        y0 = y0.to(torch.int64)
        emit(x0, y0, (1 - fx) * (1 - fy))
        emit(x0 + 1, y0, fx * (1 - fy))
        emit(x0, y0 + 1, (1 - fx) * fy)
        emit(x0 + 1, y0 + 1, fx * fy)
    else:
        emit(torch.round(px - 0.5).to(torch.int64),
             torch.round(py - 0.5).to(torch.int64), torch.ones_like(px))
    return bs, ys, xs, cs


def _blur_1d(img, k: torch.Tensor, dim: int):
    """'SAME' correlation of img with the odd 1-D kernel k along `dim`
    (zero padding), as a sum of shifted copies in tap order."""
    r = (k.shape[0] - 1) // 2
    n = img.shape[dim]
    pad = [0, 0] * (img.dim() - 1 - dim) + [r, r]
    padded = torch.nn.functional.pad(img, pad)
    out = torch.zeros_like(img)
    for i in range(k.shape[0]):
        out = out + k[i] * padded.narrow(dim, i, n)
    return out


def splat_groups(groups: Sequence[PointGroup], view, proj, *,
                 width: int, height: int, min_clip_size=MIN_CIRCLE_SIZE):
    """Rasterize point groups into an (H, W, 3) float framebuffer."""
    ref = groups[0].points
    dtype = ref.dtype
    view = view.to(dtype)
    proj = proj.to(dtype)
    min_clip = _like(min_clip_size, ref)

    bs, ys, xs, cs = [], [], [], []
    for g in groups:
        b, y, x, c = _group_entries(g, view, proj, width=width, height=height,
                                    min_clip_size=min_clip, dtype=dtype)
        bs += b
        ys += y
        xs += x
        cs += c

    canvases = torch.zeros((len(_BUCKET_RADII), height, width, 3),
                           dtype=dtype, device=ref.device)
    canvases.index_put_((torch.cat(bs), torch.cat(ys), torch.cat(xs)),
                        torch.cat(cs, dim=0), accumulate=True)

    frame = torch.zeros((height, width, 3), dtype=dtype, device=ref.device)
    for b, k1d in enumerate(_KERNELS_1D):
        k = torch.as_tensor(k1d, dtype=dtype, device=ref.device)
        img = _blur_1d(_blur_1d(canvases[b], k, 0), k, 1)
        frame = frame + img
    return torch.clamp(frame, 0.0, 1.0)


def splat(points, colors, weights, radii_clip, view, proj, *,
          width: int, height: int, min_clip_size=MIN_CIRCLE_SIZE,
          fixed_pixel_radius=None):
    """Single-group convenience wrapper around splat_groups."""
    return splat_groups(
        [PointGroup(points, colors, weights, radii_clip,
                    fixed_pixel_radius=fixed_pixel_radius)],
        view, proj, width=width, height=height, min_clip_size=min_clip_size)


def scene_point_groups(trail_history, trail_ages, colors, radii_world, proj,
                       *, origin_shift=None, trail_subdiv: int = 2,
                       exposure=1.0):
    """Build the (trails, bodies) PointGroups for a frame.

    Shared by the scatter renderer (render_scene) and the tile splatter
    (fastsplat.render_scene_fast)."""
    dtype = trail_history.dtype
    dev = trail_history.device
    t, n, _ = trail_history.shape
    if origin_shift is not None:
        trail_history = trail_history - origin_shift[None, None, :]
    colors = colors.to(dtype)

    e = proj[0, 0].to(dtype)  # 1/tan(fovy/2): the circle_vs size basis
    newest_age = torch.argmin(trail_ages)
    bodies = trail_history[newest_age]  # (N, 3) latest positions

    # --- trail points: every valid snapshot, alpha = (1 - age) * 0.6 ---
    fade = torch.clamp(1.0 - trail_ages, 0.0, 1.0) * 0.6  # (T,)
    order = torch.argsort(trail_ages, stable=True)  # newest..oldest
    hist_sorted = trail_history[order]  # (T, N, 3)
    fade_sorted = fade[order]
    segs_a = hist_sorted[:-1]
    segs_b = hist_sorted[1:]
    frac = torch.linspace(0.0, 1.0, trail_subdiv + 1, dtype=dtype,
                          device=dev)[:-1]
    interp = (segs_a[None] * (1.0 - frac[:, None, None, None])
              + segs_b[None] * frac[:, None, None, None])  # (S, T-1, N, 3)
    interp_fade = (fade_sorted[None, :-1] * (1.0 - frac[:, None])
                   + fade_sorted[None, 1:] * frac[:, None])  # (S, T-1)
    # a segment with a never-written endpoint would streak to the origin
    ages_sorted = trail_ages[order]
    pair_valid = (ages_sorted[:-1] <= 1.0) & (ages_sorted[1:] <= 1.0)
    interp_fade = interp_fade * pair_valid[None, :].to(dtype)

    trail_pts = interp.reshape(-1, 3)
    trail_w = interp_fade[..., None].expand(interp.shape[:-1]).reshape(-1)
    trail_cols = colors[None, None].expand(interp.shape[:-1] + (3,)
                                           ).reshape(-1, 3)

    exposure = _like(exposure, trail_history)
    trails_group = PointGroup(
        points=trail_pts, colors=trail_cols, weights=trail_w * exposure,
        radii_clip=torch.zeros_like(trail_w),
        fixed_pixel_radius=torch.ones_like(trail_w),  # hairline at any zoom
        antialias=False)
    bodies_group = PointGroup(
        points=bodies, colors=colors,
        weights=torch.full((n,), 1.0, dtype=dtype, device=dev) * exposure,
        radii_clip=e * radii_world.to(dtype), antialias=True)
    return trails_group, bodies_group


def render_scene(trail_history, trail_ages, colors, radii_world, view, proj,
                 *, width: int, height: int, origin_shift=None,
                 min_clip_size=MIN_CIRCLE_SIZE, trail_subdiv: int = 2,
                 exposure=1.0):
    """Render bodies and fading trails from a trail ring buffer.

    trail_history: (T, N, 3) snapshots; trail_ages: (T,) in [0, 1] with > 1
    meaning invalid (see trails.ages); colors (N, 3); radii_world (N,) in
    world units. origin_shift: optional (3,) position subtracted from
    everything first (the relative-position render mode). trail_subdiv:
    interpolated points per trail segment. exposure: global brightness
    multiplier (viewers scale it down with N)."""
    trails_group, bodies_group = scene_point_groups(
        trail_history, trail_ages, colors, radii_world, proj,
        origin_shift=origin_shift, trail_subdiv=trail_subdiv,
        exposure=exposure)
    return splat_groups([trails_group, bodies_group], view, proj,
                        width=width, height=height,
                        min_clip_size=min_clip_size)


def render_ordered(trail_history, trail_ages, colors, radii_world, view,
                   proj, *, width: int, height: int, origin_shift=None,
                   min_clip_size=MIN_CIRCLE_SIZE, trail_subdiv: int = 2,
                   exposure=1.0):
    """Depth-ordered alpha-over body rendering for few-body scenes.

    Bodies are composited back to front with the radial profile (1-d^2)^2
    as alpha, one dense (H, W) blend a body (a Python loop where the JAX
    version scans); the trails render additively underneath."""
    dtype = trail_history.dtype
    dev = trail_history.device
    n = trail_history.shape[1]
    if origin_shift is not None:
        trail_history = trail_history - origin_shift[None, None, :]
    colors = colors.to(dtype)

    # additive trails as the base layer (bodies weighted out: radius 0)
    base = render_scene(
        trail_history, trail_ages, colors,
        torch.zeros((n,), dtype=dtype, device=dev), view, proj, width=width,
        height=height, min_clip_size=0.0, trail_subdiv=trail_subdiv,
        exposure=exposure)

    e = proj[0, 0].to(dtype)
    bodies = trail_history[torch.argmin(trail_ages)]
    px, py, pixel_radius, valid = project(
        bodies, view.to(dtype), proj.to(dtype), width=width, height=height,
        min_clip_size=_like(min_clip_size, bodies),
        radii_clip=e * radii_world.to(dtype))
    # view-space depth for the painter's order (farthest first)
    hom = torch.cat([bodies, torch.ones((n, 1), dtype=dtype, device=dev)],
                    dim=-1)
    depth = -(hom @ view.to(dtype).T)[:, 2]
    order = torch.argsort(torch.where(valid, -depth, torch.inf), stable=True)

    ys = torch.arange(height, dtype=dtype, device=dev)[:, None]
    xs = torch.arange(width, dtype=dtype, device=dev)[None, :]
    r = torch.clamp_min(pixel_radius, 1.0)
    frame = base
    for i in order.tolist():
        d2 = ((xs - px[i]) ** 2 + (ys - py[i]) ** 2) / (r[i] * r[i])
        a = torch.clamp(1.0 - d2, 0.0, 1.0) ** 2 * valid[i].to(dtype)
        frame = frame * (1.0 - a[..., None]) + a[..., None] * colors[i]
    return torch.clamp(frame, 0.0, 1.0)


def to_u8_device(frame) -> torch.Tensor:
    """(H, W, 3) float framebuffer -> (H, W, 3) uint8 on its own device."""
    return torch.round(torch.clamp(frame, 0, 1) * 255).to(torch.uint8)


def to_u8(frame) -> np.ndarray:
    """Float framebuffer -> host uint8 (H, W, 3) (waits for the device)."""
    return to_u8_device(frame).cpu().numpy()
