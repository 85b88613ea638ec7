"""The port's render stack against the JAX package's, on the CPU: the
camera (value for value), the trail ring, `project` (rtol 1e-6), the
scatter renderer and the ordered one, `to_u8`, `make_fused_frame`, the
terminal encoders (byte for byte) and the PNG writer."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.render import rasterizer as jras
from spacetpu.render import termgfx as jgfx
from spacetpu.render import trails as jtrails
from spacetpu.render.camera import Camera as JCamera
from spacetpu_torch.render import rasterizer, termgfx, trails
from spacetpu_torch.render.camera import Camera
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401


def _moves(cam):
    cam.frame_scene(np.random.default_rng(0).normal(size=(50, 3)))
    cam.pan(w=True, a=True)
    cam.zoom(zoom_in=True)
    cam.rotate(up=True, left=True, roll_ccw=True)
    cam.cycle_focus(5, nxt=True)
    cam.cycle_focus(5, toggle_relative=True)
    cam.track_focus(np.arange(15, dtype=np.float32).reshape(5, 3))
    cam.resize(300, 200)
    return cam


def test_camera_matches_jax_exactly():
    a, b = _moves(Camera(192, 128)), _moves(JCamera(192, 128))
    for f in ("eye", "target", "up"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.focus, a.relative_target) == (b.focus, b.relative_target)
    np.testing.assert_array_equal(a.view(), b.view())
    np.testing.assert_array_equal(a.projection(), b.projection())


def test_trail_ring_matches_jax():
    rng = np.random.default_rng(1)
    tb = trails.make_trails(4, t=3)
    jtb = jtrails.make_trails(4, t=3)
    np.testing.assert_array_equal(trails.ages(tb).numpy(),
                                  np.asarray(jtrails.ages(jtb)))
    for _ in range(5):
        snap = rng.normal(size=(4, 3)).astype(np.float32)
        tb = trails.push(tb, torch.as_tensor(snap))
        jtb = jtrails.push(jtb, jnp.asarray(snap))
        np.testing.assert_array_equal(tb.history.numpy(),
                                      np.asarray(jtb.history))
        assert (tb.head, tb.count) == (int(jtb.head), int(jtb.count))
        np.testing.assert_allclose(trails.ages(tb).numpy(),
                                   np.asarray(jtrails.ages(jtb)), rtol=1e-7)
        np.testing.assert_array_equal(trails.latest(tb).numpy(), snap)
    tb = trails.clear(tb)
    assert (tb.head, tb.count) == (0, 0) and not tb.history.any()


def _frame_args(n=24, t=4, seed=2, w=96, h=64):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    cam = JCamera(w, h)
    cam.frame_scene(pos)
    hist = np.zeros((t, n, 3), np.float32)
    for k in range(t - 1):  # one slot never written: the first frames
        hist[k] = pos + 0.05 * k
    ages = np.asarray([2.0 / 3.0, 1.0 / 3.0, 0.0, 2.0][:t], np.float32)
    colors = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.01, 0.3, n).astype(np.float32)
    return (hist, ages, colors, radii, cam.view(), cam.projection())


def test_project_matches_jax():
    hist, _, _, radii, view, proj = _frame_args()
    kw = dict(width=96, height=64)
    mine = rasterizer.project(
        torch.as_tensor(hist[0]), torch.as_tensor(view),
        torch.as_tensor(proj), min_clip_size=0.05,
        radii_clip=torch.as_tensor(radii), **kw)
    theirs = parity.call(
        lambda p, v, q, r: jras.project(p, v, q, min_clip_size=0.05,
                                        radii_clip=r, **kw),
        hist[0], view, proj, radii)
    for a, b in zip(mine[:3], theirs[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_array_equal(mine[3].numpy(), np.asarray(theirs[3]))


@pytest.mark.parametrize("fn", ["render_scene", "render_ordered"])
def test_renderers_match_jax(fn):
    """The scatter renderer and the ordered one on a partly filled trail
    ring (a never-written slot, age 2), float32: the scatter sums in
    another order than XLA's, so atol 1e-5 of frames in [0, 1]."""
    args = _frame_args()
    kw = dict(width=96, height=64, exposure=0.8)
    mine = getattr(rasterizer, fn)(*map(torch.as_tensor, args), **kw)
    theirs = getattr(jras, fn)(*map(jnp.asarray, args), **kw)
    assert mine.shape == (64, 96, 3)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)
    assert mine.max() > 0.05


def test_to_u8_matches_jax():
    frame = np.linspace(-0.2, 1.2, 4 * 5 * 3).reshape(4, 5, 3)
    frame[0, 0, 0] = 0.5 / 255  # round half to even, as jnp.round
    frame = frame.astype(np.float32)
    mine = rasterizer.to_u8(torch.as_tensor(frame))
    assert mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, jras.to_u8(jnp.asarray(frame)))


def test_fused_frame_matches_jax():
    """make_fused_frame at n=16: k steps, a trail push and a frame on each
    side from the same numpy inputs; the frames agree to 1e-4 (float32
    trajectories in another summation order)."""
    from spacetpu import make_simulation as jmake
    from spacetpu.render.fused import make_fused_frame as jfused
    from spacetpu_torch import make_simulation
    from spacetpu_torch.render.fused import make_fused_frame
    from spacetpu_torch.state import make_state

    n, w, h = 16, 64, 48
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(n, 3))
    vel = 0.1 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    colors = rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32)
    radii = np.full((n,), 0.05, np.float32)
    cam = JCamera(w, h)
    cam.frame_scene(pos)
    kw = dict(algorithm="direct", softening="plummer", eps=1e-2, g=1.0)
    fkw = dict(width=w, height=h, steps_per_frame=2, exposure=0.9)

    from spacetpu.state import make_state as jmake_state

    jsim = jmake(n, backend="xla", **kw)
    jinit, jframe = jfused(jsim, **fkw)
    jf = jinit(jmake_state(pos, vel, mass, dtype=jnp.float32), t=4)
    sim = make_simulation(n, device="cpu", **kw)
    init, frame = make_fused_frame(sim, **fkw)
    tf = init(make_state(pos, vel, mass, device="cpu"), t=4)
    view, proj = cam.view(), cam.projection()
    for _ in range(2):
        jf, jfb = jframe(jf, 1e-2, jnp.asarray(colors), jnp.asarray(radii),
                         jnp.asarray(view), jnp.asarray(proj))
        tf, tfb = frame(tf, 1e-2, torch.as_tensor(colors),
                        torch.as_tensor(radii), torch.as_tensor(view),
                        torch.as_tensor(proj))
    np.testing.assert_allclose(tf.sim_state.pos.numpy(),
                               np.asarray(jf.sim_state.pos), rtol=1e-5,
                               atol=1e-6)
    assert tf.trail_buf.count == int(jf.trail_buf.count) == 3
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=1e-4)
    assert tfb.max() > 0.05


def _rgb(h=7, w=10, seed=6):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    rgb[:2] = 0  # a black band: sixel skips palette index 0
    return rgb


@pytest.mark.parametrize("protocol", ["ansi", "kitty", "sixel"])
def test_termgfx_encoders_match_jax_byte_for_byte(protocol):
    for rgb in (_rgb(), _rgb(12, 5, 7)):
        assert (termgfx.encode_frame(rgb, protocol)
                == jgfx.encode_frame(rgb, protocol))
    assert termgfx.PROTOCOLS == jgfx.PROTOCOLS


def _png_pixels(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    at, chunks = 8, {}
    while at < len(data):
        size = struct.unpack(">I", data[at:at + 4])[0]
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + size]
        crc = struct.unpack(">I", data[at + 8 + size:at + 12 + size])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        at += size + 12
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                         chunks[b"IHDR"])
    assert (depth, ctype, comp, filt, lace) == (8, 2, 0, 0, 0)
    assert chunks[b"IEND"] == b""
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_round_trips_through_zlib():
    import base64

    rgb = _rgb(9, 13, 8)
    np.testing.assert_array_equal(_png_pixels(termgfx.encode_png(rgb)), rgb)
    # the iTerm2 escape carries the same PNG (the JAX package's goes
    # through PIL, so its bytes differ; its pixels do not)
    esc = termgfx.iterm2_frame(rgb)
    head, _, rest = esc.partition(b":")
    assert head.startswith(b"\x1b]1337;File=inline=1;size=")
    np.testing.assert_array_equal(
        _png_pixels(base64.standard_b64decode(rest[:-1])), rgb)
    with pytest.raises(ValueError):
        termgfx.encode_png(rgb[..., :2])
