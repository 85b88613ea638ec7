"""How closely the tile splat kernel (`spacetpu_torch.render.cuda_splat.
splat_tiles`) must match its float64 plain version, the inputs it is held
on, and the deliberately wrong versions the limit must refuse.

A window pixel is a sum of terms p(dy) rgb p(dx) >= 0, so the float64 value
of the same function on the same decoded inputs is also the size of what
float32 rounds. A float32 window is held pixel by pixel:

    |got - want| <= F32_TOL * (|want| + WINDOW_SHARE * max(window))

that is 1e-5 of the float64 value plus 1e-7 of the window's maximum (the
profile 1 - d^2 cancels near d = 1, where its terms are small against the
window's peak). The same idea as tests/pair_hold.py.

Shared by tests/test_torch_fastsplat.py, tests/test_torch_gpu.py and
chip_smoke.py. Imports neither JAX nor `spacetpu`.
"""

import math

import numpy as np
import torch

from spacetpu_torch.render import cuda_splat
from spacetpu_torch.render import fastsplat as fs

F32_TOL = 1e-5
WINDOW_SHARE = 1e-2


def rand_entries(m, w, h, seed=0, rad_range=(1.0, 8.0)):
    """tests/test_fastsplat.py's `_rand_entries`, as numpy arrays:
    (px, py, radius, rgbw, valid)."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-40, w + 40, m).astype(np.float32)
    py = rng.uniform(-40, h + 40, m).astype(np.float32)
    rad = rng.uniform(*rad_range, m).astype(np.float32)
    rgbw = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.1
    return px, py, rad, rgbw, valid


def hot_entries(m=5000):
    """tests/test_fastsplat.py's hot tile: m entries in one tile of 256x96."""
    rng = np.random.default_rng(1)
    px = rng.uniform(130, 140, m).astype(np.float32)
    py = rng.uniform(40, 44, m).astype(np.float32)
    rad = np.full((m,), 2.0, np.float32)
    rgbw = rng.uniform(0, 0.001, (m, 3)).astype(np.float32)
    valid = np.ones((m,), bool)
    return px, py, rad, rgbw, valid


def sorted_entries(entries, width, height, dev):
    """Numpy entries -> the kernel's inputs (keys, pay1, pay2) on `dev`, and
    the tile count."""
    px, py, rad, rgbw, valid = (torch.as_tensor(a, device=dev)
                                for a in entries)
    keys, pay1, pay2 = fs.prepare_entries(px, py, rad, rgbw, valid,
                                          width=width, height=height)
    tx, ty = fs.tiles_for(width, height)
    return keys, pay1, pay2, tx * ty


def hold_ratio(got, want) -> float:
    """max over pixels of |got - want| / (|want| + WINDOW_SHARE * max of the
    pixel's window); a pixel where that size is 0 counts 0 if got is 0 there
    and inf otherwise. `got` and `want` are (T, 96, 256); pass = ratio <=
    F32_TOL."""
    got, want = got.double(), want.double()
    winmax = want.abs().amax(dim=(1, 2), keepdim=True)
    size = want.abs() + WINDOW_SHARE * winmax
    diff = (got - want).abs()
    ratio = torch.where(size > 0, diff / torch.where(size > 0, size, 1.0),
                        torch.where(diff > 0, math.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def swapped_windows(keys, pay1, pay2, *, n_tiles, dtype=torch.float32,
                    chunk=cuda_splat.PLAIN_CHUNK):
    """A wrong version: the plain windows with the x and y profiles
    swapped, p((y - wx) inv_r) rgb p((x - wy) inv_r)."""
    out = torch.zeros((n_tiles + 1, fs.WIN_H, 3, fs.WIN_W), dtype=dtype,
                      device=keys.device)
    cols = torch.arange(fs.WIN_W, dtype=dtype, device=keys.device)
    rows = torch.arange(fs.WIN_H, dtype=dtype, device=keys.device)
    for i0 in range(0, keys.shape[0], chunk):
        wx, wy, inv_r, rgb = fs.decode(pay1[i0:i0 + chunk],
                                       pay2[i0:i0 + chunk])
        wx, wy, inv_r = (v.to(dtype)[:, None] for v in (wx, wy, inv_r))
        rgb = torch.stack(rgb, dim=-1).to(dtype)
        f_x = fs.profile((cols[None, :] - wy) * inv_r)
        f_y = fs.profile((rows[None, :] - wx) * inv_r)
        k = keys[i0:i0 + chunk].to(torch.int64)
        k = torch.where((k >= 0) & (k < n_tiles), k, n_tiles)
        out.index_add_(0, k, f_y[:, :, None, None] * rgb[:, None, :, None]
                       * f_x[:, None, None, :])
    return out[:n_tiles].reshape(n_tiles, fs.WIN_H * 3, fs.WIN_W)


def mutants(got, swapped) -> dict:
    """The four wrong versions of a (T, 96, 256) float32 result: windows not
    zeroed (another tile's window left in the buffer), tiles shifted by
    one, x and y profiles swapped (`swapped`, from `swapped_windows`), and a
    channel dropped."""
    dropped = got.clone().reshape(got.shape[0], fs.WIN_H, 3, fs.WIN_W)
    dropped[:, :, 2] = 0.0
    return {"not_zeroed": got + torch.roll(got, 1, dims=0),
            "shifted_tiles": torch.roll(got, 1, dims=0),
            "swapped_xy": swapped,
            "dropped_channel": dropped.reshape(got.shape)}


def hold(got, want, swapped=None) -> dict:
    """The hold of a float32 result against the float64 plain windows, and
    with `swapped` the ratios of the wrong versions, each of which must fail
    the limit."""
    row = {"finite": bool(torch.isfinite(got).all()),
           "max_abs_err": float((got.double() - want).abs().max())
           if got.numel() else 0.0,
           "hold_ratio": hold_ratio(got, want), "hold_tol": F32_TOL}
    row["ok"] = row["finite"] and row["hold_ratio"] <= F32_TOL
    if swapped is not None:
        row["mutants"] = {k: hold_ratio(v, want)
                          for k, v in mutants(got, swapped).items()}
        row["ok"] = row["ok"] and all(
            r > F32_TOL for r in row["mutants"].values())
    return row
