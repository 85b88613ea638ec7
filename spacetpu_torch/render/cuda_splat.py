"""The tile splatter's windows through hand-written CUDA (``csrc/splat.cu``).

``splat_tiles`` replaces ``spacetpu/render/fastsplat.py:_splat_kernel`` as
``_splat_tiles_pallas`` launches it: from the entries sorted by tile key,
each tile's (WIN_H * 3, WIN_W) float32 window, the sum over the tile's
entries of the separable falloff p((y - wy) inv_r) rgb[ch] p((x - wx) inv_r),
p(d) = max(1 - d^2, 0)^2. As the TPU kernel walks fixed segments of SEGK
entries (`_build_segments`), the card's unit of work is a segment of at
most ``SEG`` entries of one tile: ``segment_table`` cuts each tile's
`searchsorted` range on the device, one block a segment splats into a
window in shared memory at a cost that follows each entry's nonzero
footprint, and a tile of several segments sums their partial windows in
segment order (``csrc/splat.cu`` says what bounds it and what the design
does about it). No single PyTorch call decodes, profiles and contracts the
entries.

A CPU tensor takes ``splat_tiles_plain``, the counterpart of the JAX
version's `_splat_tiles_xla`: each entry's (WIN_H, 3, WIN_W) patch,
`index_add_`-ed by tile. A CUDA tensor launches the kernels or raises;
nothing falls back. The wrapper reads nothing back to the host: the grid is
sized from the entry and tile counts.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build
from spacetpu_torch.render.fastsplat import (WIN_H, WIN_W, decode, profile,
                                             tile_starts)

#: Kernel launches since the last reset, by kernel name. The wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"splat_tiles": 0}

#: entries a chunk of the plain version (its temporaries are
#: chunk x WIN_H x 3 x WIN_W)
PLAIN_CHUNK = 1024

#: the most entries one block of the kernel walks (the header of
#: ``csrc/splat.cu`` says why)
SEG = 2048


def _lib() -> ctypes.CDLL:
    lib = _build.library("splat")
    if lib.spacetpu_splat_tiles.argtypes is None:
        lib.spacetpu_splat_tiles.argtypes = [
            *[ctypes.c_void_p] * 10, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.spacetpu_splat_tiles.restype = ctypes.c_int
    return lib


def _check(keys, pay1, pay2):
    for name, t in (("keys", keys), ("pay1", pay1), ("pay2", pay2)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.shape != keys.shape or t.device != keys.device:
            raise ValueError(f"{name} must match keys' shape and device")


def splat_tiles_plain(keys, pay1, pay2, *, n_tiles: int,
                      dtype=torch.float32, chunk: int = PLAIN_CHUNK):
    """The plain version of ``splat_tiles``: (T, WIN_H * 3, WIN_W) windows
    in `dtype`. The payloads are decoded in float32 as the kernel decodes
    them; the profiles and sums run in `dtype` (float64 gives the exact
    value of the kernel's function on the kernel's inputs). Entries with a
    key outside [0, T) are dropped."""
    _check(keys, pay1, pay2)
    out = torch.zeros((n_tiles + 1, WIN_H, 3, WIN_W), dtype=dtype,
                      device=keys.device)
    cols = torch.arange(WIN_W, dtype=dtype, device=keys.device)
    rows = torch.arange(WIN_H, dtype=dtype, device=keys.device)
    for i0 in range(0, keys.shape[0], chunk):
        wx, wy, inv_r, rgb = decode(pay1[i0:i0 + chunk], pay2[i0:i0 + chunk])
        wx, wy, inv_r = (v.to(dtype)[:, None] for v in (wx, wy, inv_r))
        rgb = torch.stack(rgb, dim=-1).to(dtype)  # (C, 3)
        f_x = profile((cols[None, :] - wx) * inv_r)  # (C, W)
        f_y = profile((rows[None, :] - wy) * inv_r)  # (C, H)
        patches = (f_y[:, :, None, None] * rgb[:, None, :, None]
                   * f_x[:, None, None, :])
        k = keys[i0:i0 + chunk].to(torch.int64)
        k = torch.where((k >= 0) & (k < n_tiles), k, n_tiles)
        out.index_add_(0, k, patches)
    return out[:n_tiles].reshape(n_tiles, WIN_H * 3, WIN_W)


def max_segments(n_entries: int, n_tiles: int, seg: int = SEG) -> int:
    """The most segments M entries on T tiles can make: a tile of c entries
    makes ceil(c / seg) <= c / seg + 1 of them, and only nonempty tiles
    make any."""
    return -(-n_entries // seg) + n_tiles


def max_partials(n_entries: int, n_tiles: int, seg: int = SEG) -> int:
    """The most partial windows: the segments of tiles with more than `seg`
    entries, of which there are fewer than M / seg."""
    per = -(-n_entries // seg)
    return per + min(n_tiles, per)


def segment_table(starts, n_tiles: int, n_entries: int, seg: int = SEG):
    """Each tile's entry range cut into segments of at most `seg` entries,
    in tile order and, within a tile, in entry order; built on the device
    of `starts` ((T + 1,) int64, `fastsplat.tile_starts`) without reading
    anything back. Returns a dict of int64 tensors:

    - ``tile``, ``lo``, ``hi``, ``slot``: (G,) with G = max_segments(M, T):
      segment b covers the entries [lo, hi) of tile `tile`; `tile` is T past
      the live segments (and lo = hi = 0 there); `slot` is -1 where the
      segment is its tile's only one, else the index of its partial window
      (a tile's partials are consecutive, in segment order);
    - ``nseg``, ``pfirst``: (T,) each tile's segment count and its first
      partial slot.

    Empty tiles and the sentinel entries (from starts[T]) make no segment.
    """
    counts = starts[1:] - starts[:-1]
    nseg = (counts + seg - 1) // seg
    last = torch.cumsum(nseg, 0)
    first = last - nseg
    b = torch.arange(max_segments(n_entries, n_tiles, seg),
                     device=starts.device)
    tile = torch.searchsorted(last, b, right=True)
    live = tile < n_tiles
    t = torch.clamp(tile, max=max(n_tiles - 1, 0))
    k = b - first[t]
    lo = starts[t] + k * seg
    hi = torch.minimum(lo + seg, starts[t + 1])
    pcount = torch.where(nseg > 1, nseg, 0)
    pfirst = torch.cumsum(pcount, 0) - pcount
    slot = torch.where(live & (nseg[t] > 1), pfirst[t] + k, -1)
    zero = torch.zeros_like(lo)
    return {"tile": tile, "lo": torch.where(live, lo, zero),
            "hi": torch.where(live, hi, zero), "slot": slot, "nseg": nseg,
            "pfirst": pfirst}


def splat_tiles(keys, pay1, pay2, *, n_tiles: int):
    """Sorted entries -> (T, WIN_H * 3, WIN_W) float32 tile windows.

    keys: (M,) int32 tile keys sorted ascending, T for the sentinel
    entries; pay1, pay2: (M,) int32 payloads in the same order (as
    `fastsplat.prepare_entries` gives them). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels."""
    _check(keys, pay1, pay2)
    if keys.device.type == "cpu":
        return splat_tiles_plain(keys, pay1, pay2, n_tiles=n_tiles)
    if keys.device.type != "cuda":
        raise ValueError(f"no splat kernel for device {keys.device}")
    keys, pay1, pay2 = (t.contiguous() for t in (keys, pay1, pay2))
    m = keys.shape[0]
    table = segment_table(tile_starts(keys, n_tiles), n_tiles, m)
    out = torch.empty((n_tiles, WIN_H * 3, WIN_W), dtype=torch.float32,
                      device=keys.device)
    partials = torch.empty((max_partials(m, n_tiles), WIN_H * 3, WIN_W),
                           dtype=torch.float32, device=keys.device)
    with torch.cuda.device(keys.device):
        rc = _lib().spacetpu_splat_tiles(
            pay1.data_ptr(), pay2.data_ptr(),
            *(table[k].data_ptr() for k in ("tile", "lo", "hi", "slot",
                                             "nseg", "pfirst")),
            out.data_ptr(), partials.data_ptr(), table["tile"].shape[0],
            n_tiles, torch.cuda.current_stream(keys.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splat_tiles launch failed: CUDA error {rc}")
    LAUNCHES["splat_tiles"] += 1
    return out
