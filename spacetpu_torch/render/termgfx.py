"""Terminal graphics encoders for the interactive frontend (numpy).

The port's own copy of `spacetpu/render/termgfx.py`: each protocol encodes
the (H, W, 3) uint8 framebuffer with vectorized numpy.

- **kitty** graphics protocol: raw 24-bit RGB, zlib-compressed, base64,
  4 KB chunks.
- **iTerm2** inline images: one base64 PNG, written by `encode_png` below
  (zlib and struct only), so the port needs no imaging package.
- **sixel**: 64-color fixed-palette encoder, vectorized over bands.
- **ANSI half-blocks**: the fallback, 2 pixels per character cell via the
  upper-half-block glyph with truecolor fg/bg, assembled as one
  fixed-stride uint8 array.

`detect_protocol()` sniffs the environment; the viewer exposes
--term-graphics to override.
"""

from __future__ import annotations

import base64
import os
import struct
import zlib

import numpy as np

PROTOCOLS = ("auto", "kitty", "iterm2", "sixel", "ansi")


def detect_protocol() -> str:
    term = os.environ.get("TERM", "")
    if "kitty" in term or "ghostty" in term or os.environ.get("KITTY_WINDOW_ID"):
        return "kitty"
    prog = os.environ.get("TERM_PROGRAM", "")
    if prog in ("iTerm.app", "WezTerm", "vscode") or os.environ.get("ITERM_SESSION_ID"):
        return "iterm2"
    if "sixel" in term or term in ("mlterm", "foot", "yaft-256color"):
        return "sixel"
    return "ansi"


# --- ANSI half-blocks (vectorized) ------------------------------------------

#: per-cell template: fg SGR (19 B) + bg SGR (19 B) + UTF-8 upper half block
_CELL = np.frombuffer(
    b"\x1b[38;2;RRR;GGG;BBBm\x1b[48;2;RRR;GGG;BBBm\xe2\x96\x80", np.uint8
)
_DIGIT_OFFSETS = np.asarray(
    [7, 8, 9, 11, 12, 13, 15, 16, 17, 26, 27, 28, 30, 31, 32, 34, 35, 36]
)
_NL = np.frombuffer(b"\x1b[0m\n", np.uint8)


def _digits3(v: np.ndarray) -> np.ndarray:
    """uint8 values -> (..., 3) ASCII digit bytes, zero padded."""
    v = v.astype(np.uint16)
    return np.stack(
        [v // 100 + 48, (v // 10) % 10 + 48, v % 10 + 48], axis=-1
    ).astype(np.uint8)


def ansi_halfblocks(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> truecolor half-block escape buffer (bytes).

    Each text row shows two pixel rows (fg = top pixel via the upper half
    block, bg = bottom pixel). Rows end with SGR reset + newline."""
    h = rgb.shape[0] - (rgb.shape[0] % 2)
    w = rgb.shape[1]
    top = rgb[0:h:2]  # (R, W, 3)
    bot = rgb[1:h:2]
    rows = h // 2
    cells = np.broadcast_to(_CELL, (rows, w, len(_CELL))).copy()
    comps = np.concatenate([top, bot], axis=-1)  # (R, W, 6) r1 g1 b1 r2 g2 b2
    cells[:, :, _DIGIT_OFFSETS] = _digits3(comps).reshape(rows, w, 18)
    body = cells.reshape(rows, w * len(_CELL))
    out = np.empty((rows, body.shape[1] + len(_NL)), np.uint8)
    out[:, : body.shape[1]] = body
    out[:, body.shape[1]:] = _NL
    return out.tobytes()


# --- kitty graphics protocol -------------------------------------------------

def kitty_frame(rgb: np.ndarray, *, image_id: int = 77) -> bytes:
    """One full-frame transmission+display, replacing the previous image.

    f=24 raw RGB, o=z zlib, q=2 (no responses), chunked at 4 KB. Reusing
    one image id with a=T makes each frame replace the last in place."""
    h, w = rgb.shape[:2]
    payload = base64.standard_b64encode(
        zlib.compress(np.ascontiguousarray(rgb).tobytes(), 1)
    )
    parts = []
    first = True
    step = 4096
    for off in range(0, len(payload), step):
        chunk = payload[off:off + step]
        more = 1 if off + step < len(payload) else 0
        if first:
            head = (f"\x1b_Gf=24,o=z,a=T,t=d,q=2,i={image_id},"
                    f"s={w},v={h},m={more};").encode()
            first = False
        else:
            head = f"\x1b_Gm={more};".encode()
        parts.append(head + chunk + b"\x1b\\")
    return b"".join(parts)


# --- iTerm2 inline images ----------------------------------------------------

def encode_png(rgb: np.ndarray, *, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG file bytes: 8-bit truecolor, no interlace,
    every row with filter 0, one zlib stream at compression `level`."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {rgb.shape}")
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def iterm2_frame(rgb: np.ndarray) -> bytes:
    """OSC 1337 inline PNG (one escape per frame)."""
    payload = base64.standard_b64encode(encode_png(rgb))
    return (b"\x1b]1337;File=inline=1;size=%d:" % len(payload)
            + payload + b"\x07")


# --- sixel -------------------------------------------------------------------

#: 4 levels per channel -> 64-color palette, scaled to sixel's 0-100 range
_SIX_LEVELS = np.asarray([0, 85, 170, 255], np.uint8)


def sixel_frame(rgb: np.ndarray) -> bytes:
    """64-color sixel image (vectorized over 6-row bands and colors)."""
    h, w = rgb.shape[:2]
    q = np.minimum((rgb.astype(np.uint16) + 42) // 85, 3)  # (H, W, 3) 0..3
    idx = (q[..., 0] * 16 + q[..., 1] * 4 + q[..., 2]).astype(np.uint8)
    pad = (-h) % 6
    if pad:
        idx = np.concatenate(
            [idx, np.zeros((pad, w), np.uint8)], axis=0
        )
    bands = idx.reshape(-1, 6, w)  # (B, 6, W)
    weights = (1 << np.arange(6, dtype=np.uint8))[None, :, None]

    out = [b"\x1bPq\"1;1;%d;%d" % (w, h)]
    used = np.unique(idx)
    for c in used:
        r, g, b = c >> 4, (c >> 2) & 3, c & 3
        pct = (_SIX_LEVELS.astype(np.uint32) * 100 + 127) // 255
        out.append(b"#%d;2;%d;%d;%d" % (c, pct[r], pct[g], pct[b]))
    chars_all = []
    for bi in range(bands.shape[0]):
        band = bands[bi]
        present = np.unique(band)
        line = []
        for c in present:
            if c == 0:
                # palette index 0 is pure black: skip it (space stays at
                # the terminal background, which the viewer clears to
                # black) — glow frames are mostly black, so this is the
                # difference between ~1 and ~60 color passes per band
                continue
            mask = (band == c).astype(np.uint8)  # (6, W)
            codes = (mask * weights[0]).sum(0).astype(np.uint8) + 63
            line.append(b"#%d" % c + codes.tobytes() + b"$")
        chars_all.append(b"".join(line) + b"-")
    out.append(b"".join(chars_all))
    out.append(b"\x1b\\")
    return b"".join(out)


def encode_frame(rgb: np.ndarray, protocol: str) -> bytes:
    if protocol == "kitty":
        return kitty_frame(rgb)
    if protocol == "iterm2":
        return iterm2_frame(rgb)
    if protocol == "sixel":
        return sixel_frame(rgb)
    return ansi_halfblocks(rgb)


def terminal_pixel_size() -> "tuple[int, int] | None":
    """(width_px, height_px) of the terminal, if the TTY reports it."""
    try:
        import fcntl
        import struct
        import sys
        import termios

        buf = fcntl.ioctl(sys.stdout.fileno(), termios.TIOCGWINSZ,
                          b"\x00" * 8)
        rows, cols, xpix, ypix = struct.unpack("HHHH", buf)
        if xpix > 0 and ypix > 0:
            return int(xpix), int(ypix)
    except Exception:
        pass
    return None
