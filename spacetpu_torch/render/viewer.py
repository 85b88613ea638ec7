"""Host-side frontends consuming framebuffers rendered on the card.

The counterpart of `spacetpu/render/viewer.py`:

- `OfflineViewer`: renders frames to PNG files (written by
  `termgfx.encode_png`, zlib and struct only) and, with PIL, an animated
  GIF;
- `TerminalViewer`: an interactive terminal viewer with the reference's key
  bindings: WASD pan, arrows/Home/PageUp rotate, +/- zoom, f/g/h focus
  cycle, j relative-target toggle, space trail clear, l/o live dt, q quit.

Both share `FrameSource`: exchange sample -> trail push -> camera track ->
render -> readback. The info panel shows the rolling tick-rate average,
simulated time, sim time per wall second, time per tick and the focused
body's name.

A frame's device work is issued under `engine.DEVICE_LOCK`; its readback
waits under `engine.TRANSFER_LOCK`, outside `DEVICE_LOCK`, as a snapshot's
does, so that several consumers may render and sample at once (the JAX
version reads back under `DEVICE_LOCK` alone, which is safe with one
consumer only).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from spacetpu_torch import constants
from spacetpu_torch.engine import (DEVICE_LOCK, TRANSFER_LOCK, Readback,
                                   SimEngine)
from spacetpu_torch.render import fastsplat, rasterizer, termgfx, trails
from spacetpu_torch.render.camera import Camera
from spacetpu_torch.state import Scene
from spacetpu_torch.utils.metrics import TickRateTracker, compute_elapsed_time


@dataclasses.dataclass
class KeyState:
    """One frame's worth of key events."""

    w: bool = False
    a: bool = False
    s: bool = False
    d: bool = False
    up: bool = False
    down: bool = False
    left: bool = False
    right: bool = False
    home: bool = False
    pgup: bool = False
    plus: bool = False
    minus: bool = False
    f: bool = False
    g: bool = False
    h: bool = False
    j: bool = False
    space: bool = False
    o: bool = False
    l: bool = False  # noqa: E741 - the key's name
    quit: bool = False


class FrameSource:
    """Pulls snapshots from a SimEngine and renders framebuffers on the
    engine's device."""

    def __init__(self, engine: SimEngine, scene: Scene, *,
                 width: int = 960, height: int = 540, auto_frame: bool = True,
                 trail_length: int = constants.TRAIL_MAX_LENGTH,
                 blend: str = "auto"):
        if blend not in ("auto", "ordered", "additive"):
            raise ValueError(f"unknown blend mode {blend!r}")
        self.engine = engine
        self.scene = scene
        self.width = width
        self.height = height
        self.device = engine.sim.device
        self.camera = Camera(width, height)
        if auto_frame:
            self.camera.frame_scene(scene.pos)
        self.trails = trails.make_trails(scene.n, t=trail_length,
                                         device=self.device)
        self.colors = torch.as_tensor(scene.colors, dtype=torch.float32,
                                      device=self.device)
        self.radii = torch.as_tensor(scene.radii, dtype=torch.float32,
                                     device=self.device)
        self.info = InfoPanel()
        #: the frontend that drives this source (`main` sets it)
        self.viewer = None
        # depth-ordered alpha-over for few-body scenes (opaque planets);
        # additive glow splatting for clouds
        self.blend = ("ordered" if scene.n <= 128 else "additive"
                      ) if blend == "auto" else blend

    def apply_keys(self, k: KeyState):
        cam = self.camera
        cam.pan(w=k.w, a=k.a, s=k.s, d=k.d)
        cam.zoom(zoom_in=k.plus, zoom_out=k.minus)
        cam.rotate(up=k.up, down=k.down, left=k.left, right=k.right,
                   roll_ccw=k.home, roll_cw=k.pgup)
        cam.cycle_focus(self.scene.n, prev=k.f, nxt=k.g, clear=k.h,
                        toggle_relative=k.j)
        if k.space:
            with DEVICE_LOCK:
                self.trails = trails.clear(self.trails)
        if k.l:
            self.engine.exchange.set_delta(self.engine.exchange.delta() * 0.9)
        if k.o:
            self.engine.exchange.set_delta(self.engine.exchange.delta() * 1.1)

    def render(self, snapshot: np.ndarray) -> torch.Tensor:
        """Push `snapshot` into the trails and render: the (H, W, 3) float
        framebuffer on the device (issued, not waited for). Call under
        DEVICE_LOCK."""
        self.trails = trails.push(self.trails, torch.from_numpy(snapshot))
        shift = None
        if self.camera.relative_target is not None:
            shift = torch.as_tensor(
                snapshot[self.camera.relative_target % len(snapshot)],
                device=self.device)
        render_fn = (rasterizer.render_ordered if self.blend == "ordered"
                     else fastsplat.render_scene_auto)
        return render_fn(
            self.trails.history, trails.ages(self.trails), self.colors,
            self.radii,
            torch.as_tensor(self.camera.view(), device=self.device),
            torch.as_tensor(self.camera.projection(), device=self.device),
            width=self.width, height=self.height, origin_shift=shift,
            # keep dense clouds from saturating to white
            exposure=min(1.0, 5000.0 / max(self.scene.n, 1)))

    def frame(self) -> np.ndarray:
        """One UI tick: sample -> trails -> camera -> render -> readback.
        Returns a host (H, W, 3) uint8 frame."""
        self.engine.check_health()  # surface a dead sim thread at once
        snapshot = self.engine.exchange.sample()
        self.camera.track_focus(snapshot)
        with DEVICE_LOCK:
            readback = Readback(rasterizer.to_u8_device(self.render(snapshot)))
        with TRANSFER_LOCK:
            return readback.wait()[0]

    def info_lines(self) -> list[str]:
        return self.info.lines(
            self.engine.exchange.current_ticks(),
            self.engine.exchange.delta(),
            self.camera.focus,
            self.scene.names,
        )


class InfoPanel:
    """The info side panel as text lines."""

    def __init__(self):
        self.tracker = TickRateTracker(30)

    def lines(self, tick: int, delta: float, focus: Optional[int],
              names: list[str]) -> list[str]:
        avg = self.tracker.update(tick)
        out = [
            f"Current time: {compute_elapsed_time(tick, delta)}",
            f"Simulated time per second: {compute_elapsed_time(avg, delta)}",
            f"Current time per tick: {compute_elapsed_time(1.0, delta)}",
        ]
        if focus is not None and 0 <= focus < len(names):
            out.append(f"Focused object: {names[focus]}")
        return out


class OfflineViewer:
    """Render N frames to PNGs (and optionally a GIF). `frame_seconds` and
    `png_seconds` hold each frame's host time: the frame (sample, render
    and readback) and the PNG encode and write; `ticks` the engine's tick
    count after each frame."""

    def __init__(self, source: FrameSource, out_dir: str = "frames"):
        self.source = source
        self.out_dir = out_dir
        self.frame_seconds: list[float] = []
        self.png_seconds: list[float] = []
        self.ticks: list[int] = []

    def run(self, n_frames: int, *, every_ticks: Optional[int] = None,
            gif: Optional[str] = None, frame_delay_s: float = 0.0):
        if gif:
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError(
                    "--gif needs the PIL package (pillow), which is not "
                    "installed; drop --gif to write the PNG frames only"
                ) from e
        os.makedirs(self.out_dir, exist_ok=True)
        frames = []
        for i in range(n_frames):
            t0 = time.perf_counter()
            rgb = self.source.frame()
            t1 = time.perf_counter()
            with open(os.path.join(self.out_dir, f"frame_{i:05d}.png"),
                      "wb") as f:
                f.write(termgfx.encode_png(rgb))
            self.frame_seconds.append(t1 - t0)
            self.png_seconds.append(time.perf_counter() - t1)
            self.ticks.append(self.source.engine.exchange.current_ticks())
            if gif:
                frames.append(rgb)
            if (i + 1) % 60 == 0:
                # console heartbeat every 60 frames
                print(" | ".join(self.source.info_lines()), flush=True)
            if frame_delay_s:
                time.sleep(frame_delay_s)
        if gif and frames:
            images = [Image.fromarray(f) for f in frames]
            images[0].save(gif, save_all=True, append_images=images[1:],
                           duration=50, loop=0)
        return frames


class TerminalViewer:
    """Interactive terminal frontend with the reference's key bindings.

    Renders real pixels through the kitty graphics protocol, iTerm2 inline
    images, or sixel when the terminal supports one (detected from the
    environment, or --term-graphics), and truecolor ANSI half-blocks
    anywhere else."""

    KEYMAP = {
        "w": "w", "a": "a", "s": "s", "d": "d",
        "+": "plus", "-": "minus",
        "f": "f", "g": "g", "h": "h", "j": "j", " ": "space",
        "o": "o", "l": "l", "q": "quit",
        "\x1b[A": "up", "\x1b[B": "down", "\x1b[D": "left", "\x1b[C": "right",
        "\x1b[H": "home", "\x1b[5~": "pgup",
    }

    def __init__(self, source: FrameSource, fps: float = 20.0,
                 graphics: str = "auto"):
        self.source = source
        self.fps = fps
        if graphics not in termgfx.PROTOCOLS:
            raise ValueError(f"graphics must be one of {termgfx.PROTOCOLS}")
        self.graphics = (termgfx.detect_protocol() if graphics == "auto"
                         else graphics)

    def _read_keys(self) -> KeyState:
        """Non-blocking drain of stdin escape sequences."""
        import select

        k = KeyState()
        buf = ""
        while select.select([sys.stdin], [], [], 0)[0]:
            buf += os.read(sys.stdin.fileno(), 64).decode(errors="ignore")
        i = 0
        while i < len(buf):
            for seq, attr in self.KEYMAP.items():
                if buf.startswith(seq, i):
                    setattr(k, attr, True)
                    i += len(seq)
                    break
            else:
                i += 1
        return k

    def _fit_to_terminal(self):
        """Resize the framebuffer to the terminal. Half-blocks give 2 pixel
        rows a text row (one row kept for the info line); the pixel
        protocols use the TTY's pixel size where it reports one."""
        import shutil

        cols, rows = shutil.get_terminal_size()
        if self.graphics == "ansi":
            w = max(32, cols)
            h = max(32, (rows - 2) * 2)
        else:
            px = termgfx.terminal_pixel_size()
            if px is not None:
                cell_h = max(1, px[1] // max(rows, 1))
                w, h = px[0], max(32, px[1] - 2 * cell_h)
            else:
                # no pixel report: assume ~10x20 px cells
                w, h = cols * 10, max(32, (rows - 2) * 20)
            if self.graphics == "sixel":  # chatty protocol: cap resolution
                w, h = min(w, 640), min(h, 400)
        w -= w % 2
        h -= h % 2
        if (w, h) != (self.source.width, self.source.height):
            self.source.width = w
            self.source.height = h
            self.source.camera.resize(w, h)

    def run(self, max_frames: Optional[int] = None):
        import termios
        import tty

        if not sys.stdin.isatty():
            raise SystemExit(
                "terminal frontend needs an interactive TTY; use "
                "--frontend offline (PNG/GIF) or --frontend none (headless)")
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            sys.stdout.write("\x1b[2J")  # clear
            frame_i = 0
            while max_frames is None or frame_i < max_frames:
                t0 = time.monotonic()
                if frame_i % 30 == 0:
                    self._fit_to_terminal()
                keys = self._read_keys()
                if keys.quit:
                    break
                self.source.apply_keys(keys)
                frame = termgfx.encode_frame(self.source.frame(),
                                             self.graphics)
                info = " | ".join(self.source.info_lines())
                if self.graphics == "ansi":
                    buf = (b"\x1b[H" + frame + b"\x1b[0m" + info.encode()
                           + b"\x1b[K\n")
                else:
                    # pixel frame from the top-left, info on the last row
                    buf = (b"\x1b[H" + frame + b"\x1b[999;1H\x1b[0m"
                           + info.encode() + b"\x1b[K")
                sys.stdout.buffer.write(buf)
                sys.stdout.flush()
                frame_i += 1
                dt = 1.0 / self.fps - (time.monotonic() - t0)
                if dt > 0:
                    time.sleep(dt)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            sys.stdout.write("\x1b[0m\n")
