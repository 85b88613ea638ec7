"""Camera: view/projection matrices and interactive movement (numpy).

The port's own copy of `spacetpu/render/camera.py`, value for value: a
right-handed look-at view, the infinite-far-plane projection with the
epsilon trick, WASD panning in view space, 10%-of-distance zoom steps,
arrow/Home/PageUp rotations about the up and perpendicular axes, and focus
cycling with the relative-target toggle (the reference's `camera.rs`).

The camera is small host-side numpy state that changes only on user input;
the renderer takes its matrices as tensors on the card.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (row-major, post-multiplies column
    vectors), matching cgmath::Matrix4::look_at_rh."""
    f = _normalize(np.asarray(target, np.float64) - np.asarray(eye, np.float64))
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def infinite_projection(fovy: float, aspect: float, epsilon: float = 3e-7):
    """The reference's infinite-far-plane perspective (camera.rs:86-99):
    e = 1/tan(fovy/2); z entries use the epsilon trick so the far plane sits
    at infinity without depth precision collapse. NOTE the reference scales
    *y* by e*aspect (and x by e), i.e. aspect correction on the y axis."""
    e = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = e
    m[1, 1] = e * aspect
    m[2, 2] = epsilon - 1.0
    m[2, 3] = (epsilon - 2.0) * 1e-10
    m[3, 2] = -1.0
    return m


def _axis_angle(axis, angle):
    """Rotation matrix about a unit axis (cgmath::Matrix3::from_axis_angle)."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    t = 1 - c
    return np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ]
    )


class Camera:
    """Interactive camera with the reference's movement model."""

    PAN_STEP = 0.1  # camera.rs:142 LOOK_REL
    ROT_STEP = 0.02  # camera.rs:234-283 Rad(0.02)
    ZOOM_FRAC = 10.0  # camera.rs:213 look_mag / 10

    def __init__(self, width: int, height: int, fovy_deg: float = 45.0):
        self.eye = np.array([0.0, 0.0, 2.0])
        self.target = np.array([0.0, 0.0, 0.0])
        self.up = np.array([0.0, 1.0, 0.0])
        self.fovy = np.radians(fovy_deg)
        self.aspect = width / height
        self.focus: int | None = None
        self.relative_target: int | None = None

    # --- matrices ---
    def view(self) -> np.ndarray:
        return look_at_rh(self.eye, self.target, self.up)

    def projection(self) -> np.ndarray:
        return infinite_projection(self.fovy, self.aspect)

    def resize(self, width: int, height: int):
        self.aspect = width / height

    # --- movement (camera.rs:137-163) ---
    def pan(self, w=False, a=False, s=False, d=False):
        look_dir = _normalize(self.target - self.eye)
        look_lr = np.cross(self.up, look_dir)
        rel = np.zeros(3)
        if a:
            rel += look_lr * self.PAN_STEP
        if d:
            rel -= look_lr * self.PAN_STEP
        if w:
            rel += self.up * self.PAN_STEP
        if s:
            rel -= self.up * self.PAN_STEP
        self.target = self.target + rel
        self.eye = self.eye + rel

    # --- zoom (camera.rs:207-227) ---
    def zoom(self, zoom_in=False, zoom_out=False):
        look = self.target - self.eye
        look_dir = _normalize(look)
        step = np.linalg.norm(look) / self.ZOOM_FRAC
        if zoom_in:
            self.eye = self.eye + look_dir * step
        if zoom_out:
            self.eye = self.eye - look_dir * step

    # --- rotation (camera.rs:229-288) ---
    def rotate(self, up=False, down=False, left=False, right=False,
               roll_ccw=False, roll_cw=False):
        if roll_ccw or roll_cw:
            look_dir = _normalize(self.target - self.eye)
            ang = self.ROT_STEP if roll_ccw else -self.ROT_STEP
            self.up = _axis_angle(look_dir, ang) @ self.up
        if up or down:
            look = self.target - self.eye
            look_perp = np.cross(_normalize(look), self.up)
            ang = self.ROT_STEP if up else -self.ROT_STEP
            rot = _axis_angle(look_perp, ang)
            self.eye = self.target + rot @ (-look)
            self.up = rot @ self.up
        if left or right:
            look = self.target - self.eye
            ang = -self.ROT_STEP if left else self.ROT_STEP
            rot = _axis_angle(self.up, ang)
            self.eye = self.target + rot @ (-look)

    def frame_scene(self, positions: np.ndarray, fill: float = 0.7,
                    quantile: float = 0.995):
        """Place the camera so the scene's visible mass fills the frame
        (new — the reference starts at eye=(0,0,2) regardless of scene
        extent, camera.rs:44, leaving e.g. fixed_cloud mostly
        off-screen). Frames to the `quantile` body radius rather than the
        max: heavy-tailed scenes (a Plummer halo is unbounded) would
        otherwise zoom out to their single farthest straggler and render
        the cluster as one dot."""
        center = positions.mean(axis=0)
        r = np.linalg.norm(positions - center, axis=-1)
        radius = float(np.quantile(r, quantile)) if len(r) > 1 else float(r[0])
        radius = max(radius, 1e-6)
        # The projection scales y by e*aspect (camera.rs convention), so the
        # vertical half-FOV tangent is tan(fovy/2)/aspect: for aspect > 1
        # the height is the limiting direction and the distance must grow
        # with it.
        dist = radius * max(1.0, self.aspect) / (fill * np.tan(self.fovy / 2.0))
        self.target = center.astype(np.float64)
        self.eye = self.target + np.array([0.0, 0.0, dist])
        self.up = np.array([0.0, 1.0, 0.0])

    # --- focus cycling (camera.rs:169-205) ---
    def cycle_focus(self, n_objects: int, *, prev=False, nxt=False,
                    clear=False, toggle_relative=False):
        if prev:
            self.focus = int(((self.focus if self.focus is not None else 1) - 1)
                             % n_objects)
        if nxt:
            self.focus = int(((self.focus if self.focus is not None else -1) + 1)
                             % n_objects)
        if clear:
            self.focus = None
        if toggle_relative:
            if self.relative_target is not None:
                self.relative_target = None
            else:
                self.relative_target = self.focus

    def track_focus(self, positions: np.ndarray):
        """Re-center the view on the focused body, preserving the eye offset
        (camera.rs:187-204). In relative mode the target is the focused
        body's position relative to the relative_target body."""
        if self.focus is None:
            return
        pos = positions[self.focus % len(positions)].astype(np.float64)
        if self.relative_target is not None:
            pos = pos - positions[self.relative_target % len(positions)]
        rel = self.eye - self.target
        self.target = pos
        self.eye = pos + rel
