"""Native windowed frontend (SDL via pygame).

The counterpart of `spacetpu/render/window.py`: a resizable SDL window whose
framebuffer is the rendered frame (FrameSource), with the reference's
interaction model:

- held keys pan/zoom/rotate continuously: WASD pan, +/- zoom,
  arrows/Home/PageUp rotate;
- edge-triggered keys fire once a press: f/g/h focus cycle, j
  relative-target toggle, space trail clear, l/o live dt;
- an info line overlays the frame;
- a window resize re-sizes the render target;
- the frame loop is capped at `fps`.

pygame is imported when a window is opened, and its absence raises an
ImportError that names --frontend window. Headless environments run it
under SDL's "dummy" video driver.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from spacetpu_torch.render.viewer import FrameSource, KeyState


def _import_pygame():
    # Quiet the community banner before the first import.
    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    if (not os.environ.get("DISPLAY")
            and not os.environ.get("WAYLAND_DISPLAY")
            and not os.environ.get("SDL_VIDEODRIVER")):
        # No X/Wayland: fall back to the dummy driver instead of dying in
        # SDL_Init (the window is then invisible but the loop still runs —
        # useful for tests and remote hosts; real displays unaffected).
        os.environ["SDL_VIDEODRIVER"] = "dummy"
    try:
        import pygame
    except ImportError as e:
        raise ImportError(
            "--frontend window needs the pygame package, which is not "
            "installed; use --frontend offline or --frontend terminal"
        ) from e
    return pygame


class WindowViewer:
    """Interactive SDL window consuming FrameSource framebuffers."""

    #: held keys -> KeyState attrs (continuous while pressed)
    HELD = {
        "w": "w", "a": "a", "s": "s", "d": "d",
        "up": "up", "down": "down", "left": "left", "right": "right",
        "home": "home", "pageup": "pgup",
        "+": "plus", "=": "plus", "-": "minus",
        "keypad +": "plus", "keypad -": "minus",
    }
    #: edge-triggered keys -> KeyState attrs (once per press)
    EDGE = {
        "f": "f", "g": "g", "h": "h", "j": "j", "space": "space",
        "o": "o", "l": "l", "q": "quit", "escape": "quit",
    }

    def __init__(self, source: FrameSource, fps: float = 60.0,
                 title: str = "spacetpu_torch"):
        self.source = source
        self.fps = fps
        pg = self._pg = _import_pygame()
        pg.display.init()
        pg.font.init()
        self._screen = pg.display.set_mode(
            (source.width, source.height), pg.RESIZABLE
        )
        pg.display.set_caption(title)
        self._font = pg.font.Font(None, 20)
        self._held_map = {pg.key.key_code(k): a for k, a in self.HELD.items()}
        self._edge_map = {pg.key.key_code(k): a for k, a in self.EDGE.items()}

    def _poll_keys(self) -> KeyState:
        """One frame's KeyState: drained KEYDOWN edges + current held set
        (the KeyboardState + KeyTrigger split of event_loop.rs:25-86)."""
        pg = self._pg
        k = KeyState()
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                k.quit = True
            elif ev.type == pg.KEYDOWN:
                attr = self._edge_map.get(ev.key)
                if attr:
                    setattr(k, attr, True)
            elif ev.type == pg.VIDEORESIZE:
                w = max(32, ev.w - ev.w % 2)
                h = max(32, ev.h - ev.h % 2)
                self.source.width = w
                self.source.height = h
                self.source.camera.resize(w, h)
        pressed = pg.key.get_pressed()
        for code, attr in self._held_map.items():
            if code >= 0 and pressed[code]:
                setattr(k, attr, True)
        return k

    def _blit(self, frame: np.ndarray, info: str):
        pg = self._pg
        # surfarray wants (W, H, 3); the framebuffer is (H, W, 3)
        surf = pg.surfarray.make_surface(frame.swapaxes(0, 1))
        if surf.get_size() != self._screen.get_size():
            self._screen = pg.display.set_mode(surf.get_size(), pg.RESIZABLE)
        self._screen.blit(surf, (0, 0))
        text = self._font.render(info, True, (235, 235, 235))
        self._screen.blit(text, (8, self._screen.get_height() - 24))
        pg.display.flip()

    def run(self, max_frames: Optional[int] = None):
        frame_i = 0
        try:
            while max_frames is None or frame_i < max_frames:
                t0 = time.monotonic()
                keys = self._poll_keys()
                if keys.quit:
                    break
                self.source.apply_keys(keys)
                frame = self.source.frame()
                self._blit(frame, " | ".join(self.source.info_lines()))
                if (frame_i + 1) % 60 == 0:
                    # console heartbeat every 60 frames (event_loop.rs:289)
                    print(" | ".join(self.source.info_lines()), flush=True)
                frame_i += 1
                dt = 1.0 / self.fps - (time.monotonic() - t0)
                if dt > 0:
                    time.sleep(dt)
        finally:
            self._pg.display.quit()
        return frame_i
