"""The port's tile splatter (`spacetpu_torch.render.fastsplat` and
`render.cuda_splat`) against the JAX package's `render.fastsplat`, on the
CPU: the packing value for value, the tile ranges, the plain splat against
`_splat_tiles_xla` and `_splat_tiles_pallas` in interpret mode (atol 1e-4,
tests/test_fastsplat.py:32), `overlap_add`, and a projected scene end to
end. The float32 limit of tests/splat_hold.py is checked here on the plain
version; the kernel itself is held on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.render import fastsplat as jfs
from spacetpu.render import rasterizer as jras
from spacetpu.render import trails as jtrails
from spacetpu.render.camera import Camera as JCamera
from spacetpu_torch.render import cuda_splat
from spacetpu_torch.render import fastsplat as fs
from spacetpu_torch.render import trails
from spacetpu_torch.render.camera import Camera
from tests import parity
from tests import splat_hold as sh
from tests.parity import one_torch_thread  # noqa: F401

W, H = 256, 96


def _pack_sort(px, py, rad, rgbw, valid, *, width, height, m_pad):
    n_tiles = jfs.tiles_for(width, height)[0] * jfs.tiles_for(width,
                                                              height)[1]
    key, p1, p2 = jfs.pack_entries(px, py, jnp.clip(rad, jfs.MIN_RADIUS,
                                                    jfs.MAX_RADIUS),
                                   rgbw, valid, width=width, height=height)
    pad = m_pad - key.shape[0]
    key = jnp.concatenate([key, jnp.full((pad,), n_tiles, jnp.uint32)])
    p1 = jnp.concatenate([p1, jnp.zeros((pad,), jnp.uint32)])
    p2 = jnp.concatenate([p2, jnp.zeros((pad,), jnp.uint32)])
    return jax.lax.sort((key, p1, p2), num_keys=1)


def _jax_sorted(entries, width, height):
    """The JAX package's packed, padded and sorted entries, as
    `splat_entries` makes them, with the tile count and the padded
    length."""
    tx, ty = jfs.tiles_for(width, height)
    m_pad = -(-len(entries[0]) // jfs.SEGK) * jfs.SEGK
    key, p1, p2 = parity.call(_pack_sort, *entries, width=width,
                              height=height, m_pad=m_pad)
    return key, p1, p2, tx * ty, m_pad


def _np(*arrays):
    return tuple(np.asarray(a).astype(np.int64) for a in arrays)


@pytest.mark.parametrize("case", ["rand", "hot", "edges"])
def test_pack_entries_match_jax_value_for_value(case):
    if case == "rand":
        entries = sh.rand_entries(3000, W, H)
    elif case == "hot":
        entries = sh.hot_entries()
    else:
        # centres on and just past the margins, radii and colours at their
        # clips, on a frame whose width is not a tile multiple
        px = np.asarray([-64.0, -63.97, 299.9, 300.0, 363.9, 364.0, 127.99,
                         128.0, 0.03125, 150.0], np.float32)
        py = np.asarray([-8.0, 0.0, 99.99, 107.9, 108.0, 15.99, 16.0,
                         -7.99, 50.0, 50.0], np.float32)
        rad = np.asarray([0.1, 1.0, 1.124, 1.125, 7.9, 8.0, 15.9, 20.0,
                          3.3, 2.0], np.float32)
        rgbw = np.asarray(np.linspace(-0.1, 1.1, 30).reshape(10, 3),
                          np.float32)
        valid = np.asarray([True] * 9 + [False])
        entries = (px, py, rad, rgbw, valid)
    w = 300 if case == "edges" else W
    h = 100 if case == "edges" else H
    jk, j1, j2 = _np(*jfs.pack_entries(*map(jnp.asarray, entries), width=w,
                                       height=h))
    tk, t1, t2 = fs.pack_entries(*map(torch.as_tensor, entries), width=w,
                                 height=h)
    assert tk.dtype == t1.dtype == t2.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(t1.numpy(), j1)
    np.testing.assert_array_equal(t2.numpy(), j2)


def test_sorted_entries_and_tile_starts_match_jax_segments():
    """The port's stable sort gives the JAX package's order, and its tile
    starts cover exactly the entries that `_build_segments` hands to each
    tile (empty segments aside)."""
    entries = sh.rand_entries(3000, W, H)
    jk, j1, j2, n_tiles, m_pad = _jax_sorted(entries, W, H)
    keys, p1, p2, t_n = sh.sorted_entries(entries, W, H, "cpu")
    assert t_n == n_tiles and keys.shape[0] == m_pad
    for mine, theirs in zip((keys, p1, p2), _np(jk, j1, j2)):
        np.testing.assert_array_equal(mine.numpy(), theirs)

    chunk, lo, hi, tile, _ = map(np.asarray,
                                 jfs._build_segments(jk, n_tiles, m_pad))
    jax_tile = np.full(m_pad, -1)
    for c, a, b, t in zip(chunk, lo, hi, tile):
        jax_tile[c * jfs.SEGK + a:c * jfs.SEGK + b] = t
    starts = fs.tile_starts(keys, n_tiles).numpy()
    assert starts.shape == (n_tiles + 1,) and starts[0] == 0
    port_tile = np.full(m_pad, n_tiles)
    for t in range(n_tiles):
        port_tile[starts[t]:starts[t + 1]] = t
    np.testing.assert_array_equal(port_tile, jax_tile)


@pytest.mark.parametrize("case", ["rand", "hot"])
def test_plain_splat_matches_jax_xla_and_pallas_interpret(case):
    entries = (sh.rand_entries(3000, W, H) if case == "rand"
               else sh.hot_entries())
    jk, j1, j2, n_tiles, m_pad = _jax_sorted(entries, W, H)
    keys, p1, p2, _ = sh.sorted_entries(entries, W, H, "cpu")
    mine = cuda_splat.splat_tiles_plain(keys, p1, p2,
                                        n_tiles=n_tiles).numpy()
    xla = np.asarray(jfs._splat_tiles_xla(jk, j1, j2, n_tiles=n_tiles,
                                          m_pad=m_pad))[:n_tiles]
    pallas = np.asarray(jfs._splat_tiles_pallas(
        jk, j1, j2, n_tiles=n_tiles, m_pad=m_pad, interpret=True))[:n_tiles]
    np.testing.assert_allclose(mine, xla, atol=1e-4)
    np.testing.assert_allclose(mine, pallas, atol=1e-4)
    # the wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(
        cuda_splat.splat_tiles(keys, p1, p2, n_tiles=n_tiles).numpy(), mine)
    assert cuda_splat.LAUNCHES["splat_tiles"] == 0


@pytest.mark.parametrize("case", ["rand", "hot"])
def test_splat_hold_passes_float32_and_refuses_wrong_versions(case):
    """tests/splat_hold.py's limit: the float32 plain version (the kernel's
    arithmetic in another order) passes it by far, the four wrong versions
    fail it."""
    entries = (sh.rand_entries(3000, W, H) if case == "rand"
               else sh.hot_entries())
    keys, p1, p2, n_tiles = sh.sorted_entries(entries, W, H, "cpu")
    got = cuda_splat.splat_tiles_plain(keys, p1, p2, n_tiles=n_tiles)
    want = cuda_splat.splat_tiles_plain(keys, p1, p2, n_tiles=n_tiles,
                                        dtype=torch.float64)
    row = sh.hold(got, want, sh.swapped_windows(keys, p1, p2,
                                                n_tiles=n_tiles))
    assert row["ok"], row
    assert row["hold_ratio"] < sh.F32_TOL / 5
    assert all(r > 10 * sh.F32_TOL for r in row["mutants"].values()), row


def test_overlap_add_matches_jax():
    w, h = 300, 100
    tx, ty = fs.tiles_for(w, h)
    rng = np.random.default_rng(4)
    windows = rng.uniform(size=(tx * ty, fs.WIN_H * 3, fs.WIN_W)
                          ).astype(np.float32)
    mine = fs.overlap_add(torch.as_tensor(windows), width=w, height=h)
    theirs = np.asarray(jfs.overlap_add(jnp.asarray(windows), width=w,
                                        height=h))
    assert mine.shape == (h, w, 3)
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-6)


def test_splat_entries_matches_jax_end_to_end():
    entries = sh.rand_entries(3000, W, H)
    mine = fs.splat_entries(*map(torch.as_tensor, entries), width=W,
                            height=H, backend="torch")
    theirs = jfs.splat_entries(*map(jnp.asarray, entries), width=W,
                               height=H, backend="xla")
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-4)
    with pytest.raises(ValueError, match="backend"):
        fs.splat_entries(*map(torch.as_tensor, entries), width=W, height=H,
                         backend="mosaic")


def _scene(n=32, t=4):
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    colors = rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32)
    radii = np.full((n,), 0.05, np.float32)
    snaps = [pos + 0.02 * k for k in range(t)]
    return pos, colors, radii, snaps


def _jax_entries(hist, ages, colors, radii, view, proj, *, width, height):
    """The first half of JAX's render_scene_fast: its splat entries."""
    t = hist.shape[0]
    stamps = jfs._trail_stamp_entries(
        hist, ages, colors, view, proj, width=width, height=height,
        budget_per_body=2 * (t - 1))
    _, bodies = jras.scene_point_groups(hist, ages, colors, radii, proj,
                                        trail_subdiv=1)
    body = jfs._group_entries(bodies, view, proj, width=width,
                              height=height,
                              min_clip_size=jnp.asarray(0.05, jnp.float32))
    return tuple(jnp.concatenate([a, b]) for a, b in zip(stamps, body))


def test_render_scene_fast_matches_jax_within_a_quantization_step():
    """n=32 on 192x128. The projection is a float32 matrix product whose
    summation order differs between XLA and torch, so an entry's position,
    radius or weight may differ in the last bits, and its payload may sit
    one quantization step over (1/16 px in x or y, 1/4 px of radius, 1/1023
    of a channel). The rule: the entries agree to 1e-5; keys agree; each
    payload field differs by at most one step; and the frames differ by at
    most the difference that the differing entries make alone (each
    rendered with both payloads by the port's plain splat), times the
    exposure, plus 1e-4."""
    w, h = 192, 128
    pos, colors, radii, snaps = _scene()
    cam = JCamera(w, h)
    cam.frame_scene(pos)
    view, proj = cam.view(), cam.projection()
    jtb = jtrails.make_trails(len(pos), t=4)
    tb = trails.make_trails(len(pos), t=4)
    for s in snaps:
        jtb = jtrails.push(jtb, jnp.asarray(s))
        tb = trails.push(tb, torch.as_tensor(s))
    jargs = (jtb.history, jtrails.ages(jtb), jnp.asarray(colors),
             jnp.asarray(radii), jnp.asarray(view), jnp.asarray(proj))
    targs = (tb.history, trails.ages(tb), torch.as_tensor(colors),
             torch.as_tensor(radii), torch.as_tensor(view),
             torch.as_tensor(proj))
    exposure = 0.7

    theirs_e = [np.asarray(a) for a in parity.call(
        _jax_entries, *jargs, width=w, height=h)]
    mine_e = fs.scene_entries(*targs, width=w, height=h)
    for a, b in zip(mine_e, theirs_e):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)

    jk, j1, j2 = _np(*jfs.pack_entries(
        *map(jnp.asarray, theirs_e[:2]),
        jnp.clip(jnp.asarray(theirs_e[2]), 1.0, fs.MAX_RADIUS),
        *map(jnp.asarray, theirs_e[3:]), width=w, height=h))
    tk, t1, t2 = (x.numpy().astype(np.int64) for x in fs.pack_entries(
        *mine_e[:2], torch.clamp(mine_e[2], 1.0, fs.MAX_RADIUS),
        *mine_e[3:], width=w, height=h))
    np.testing.assert_array_equal(tk, jk)
    for shift, mask in ((15, 0xFFF), (6, 0x1FF), (0, 0x3F)):
        assert np.abs((t1 >> shift & mask) - (j1 >> shift & mask)).max() <= 1
    for shift in (20, 10, 0):
        assert np.abs((t2 >> shift & 0x3FF) - (j2 >> shift & 0x3FF)
                      ).max() <= 1

    mine = fs.render_scene_fast(*targs, width=w, height=h,
                                exposure=exposure).numpy()
    theirs = np.asarray(jfs.render_scene_fast(*jargs, width=w, height=h,
                                              exposure=exposure,
                                              interpret=True))
    differ = (tk != jk) | (t1 != j1) | (t2 != j2)
    tx, ty = fs.tiles_for(w, h)

    def frame_of(k, p1, p2):
        sel = [torch.as_tensor(a[differ], dtype=torch.int32)
               for a in (k, p1, p2)]
        sel = fs.sort_entries(*fs.pad_entries(*sel, tx * ty))
        return fs.overlap_add(
            cuda_splat.splat_tiles_plain(*sel, n_tiles=tx * ty),
            width=w, height=h).numpy()

    allowance = exposure * np.abs(frame_of(tk, t1, t2)
                                  - frame_of(jk, j1, j2))
    assert (np.abs(mine - theirs) <= allowance + 1e-4).all()
    assert mine.max() > 0.1


def test_render_scene_auto_takes_the_scatter_path_on_the_cpu():
    w, h = 96, 64
    pos, colors, radii, snaps = _scene(n=8, t=3)
    cam = Camera(w, h)
    cam.frame_scene(pos)
    tb = trails.make_trails(len(pos), t=3)
    for s in snaps[:3]:
        tb = trails.push(tb, torch.as_tensor(s))
    args = (tb.history, trails.ages(tb), torch.as_tensor(colors),
            torch.as_tensor(radii), torch.as_tensor(cam.view()),
            torch.as_tensor(cam.projection()))
    from spacetpu_torch.render import rasterizer

    auto = fs.render_scene_auto(*args, width=w, height=h, exposure=0.5)
    scatter = rasterizer.render_scene(*args, width=w, height=h,
                                      exposure=0.5)
    np.testing.assert_array_equal(auto.numpy(), scatter.numpy())
