"""Additional viz drawables: Cuboid, Lines, Label, TargetDisplay, Mesh.

Rebuild of the reference drawable set (ref: ouster_viz/include/ouster/
point_viz.h:1055-1779) for the offscreen renderer: each drawable
rasterizes itself into the PointViz frame through the shared camera.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .core import PointViz


def _project(viz: PointViz, pts: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    V = viz.camera.view_matrix()
    f = 0.5 * viz.height / math.tan(math.radians(viz.camera.fov) / 2)
    cam = pts @ V[:3, :3].T + V[:3, 3]
    z = -cam[:, 2]
    vis = z > 0.1
    x = np.where(vis, (cam[:, 0] / np.maximum(z, 1e-9)) * f + viz.width / 2,
                 -1)
    y = np.where(vis, viz.height / 2
                 - (cam[:, 1] / np.maximum(z, 1e-9)) * f, -1)
    return x, y, vis


def _draw_segment(frame: np.ndarray, x0, y0, x1, y1, color) -> None:
    h, w = frame.shape[:2]
    # Liang-Barsky clip to the viewport first: segments projecting far
    # off-screen would otherwise allocate O(projected length) samples
    # (near-clip geometry can project to millions of pixels)
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, w - 1 - x0), (-dy, y0),
                 (dy, h - 1 - y0)):
        if p == 0:
            if q < 0:
                return  # parallel and fully outside
            continue
        r = q / p
        if p < 0:
            if r > t1:
                return
            t0 = max(t0, r)
        else:
            if r < t0:
                return
            t1 = min(t1, r)
    cx0, cy0 = x0 + t0 * dx, y0 + t0 * dy
    cx1, cy1 = x0 + t1 * dx, y0 + t1 * dy
    n = int(max(abs(cx1 - cx0), abs(cy1 - cy0), 1)) + 1
    xs = np.linspace(cx0, cx1, n).astype(int)
    ys = np.linspace(cy0, cy1, n).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    frame[ys[ok], xs[ok]] = color


@dataclass
class Lines:
    """Line segments (ref: point_viz.h:1702): points (N, 2, 3)."""

    segments: np.ndarray
    color: Tuple[int, int, int] = (255, 255, 0)

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        segs = self.segments.reshape(-1, 2, 3)
        x, y, vis = _project(viz, segs.reshape(-1, 3))
        x, y = x.reshape(-1, 2), y.reshape(-1, 2)
        vis = vis.reshape(-1, 2).all(axis=1)
        for i in np.flatnonzero(vis):
            _draw_segment(frame, x[i, 0], y[i, 0], x[i, 1], y[i, 1],
                          self.color)


@dataclass
class Cuboid:
    """Wireframe box (ref: point_viz.h:1634): pose 4x4 maps the unit cube
    [-0.5, 0.5]^3."""

    pose: np.ndarray
    color: Tuple[int, int, int] = (255, 0, 0)

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        c = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                      for z in (-0.5, 0.5)])
        corners = c @ self.pose[:3, :3].T + self.pose[:3, 3]
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                 (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        segs = np.stack([corners[list(e)] for e in edges])
        Lines(segs, self.color).draw(viz, frame)


_FONT = {
    # minimal 3x5 bitmap font for labels (digits + a few letters)
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    "-": ["000", "000", "111", "000", "000"],
    " ": ["000", "000", "000", "000", "000"],
    "m": ["000", "000", "111", "111", "101"],
    "s": ["011", "100", "010", "001", "110"],
}


@dataclass
class Label:
    """2D/3D text label (ref: point_viz.h:1779)."""

    text: str
    position: np.ndarray  # (3,) world or (2,) screen-fraction
    color: Tuple[int, int, int] = (255, 255, 255)
    scale: int = 2

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        pos = np.asarray(self.position, dtype=np.float64)
        if pos.size == 3:
            x, y, vis = _project(viz, pos.reshape(1, 3))
            if not vis[0]:
                return
            px, py = int(x[0]), int(y[0])
        else:
            px = int(pos[0] * viz.width)
            py = int(pos[1] * viz.height)
        h, w = frame.shape[:2]
        cx = px
        for ch in self.text:
            glyph = _FONT.get(ch.lower())
            if glyph is None:
                cx += 4 * self.scale
                continue
            for gy, row in enumerate(glyph):
                for gx, bit in enumerate(row):
                    if bit == "1":
                        y0 = py + gy * self.scale
                        x0 = cx + gx * self.scale
                        frame[max(0, min(y0, h - self.scale)):
                              max(0, min(y0 + self.scale, h)),
                              max(0, min(x0, w - self.scale)):
                              max(0, min(x0 + self.scale, w))] = self.color
            cx += 4 * self.scale


@dataclass
class TargetDisplay:
    """Distance rings + grid on the ground plane
    (ref: point_viz.h:1055)."""

    ring_size_m: float = 10.0
    rings: int = 5
    color: Tuple[int, int, int] = (60, 60, 60)

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        theta = np.linspace(0, 2 * np.pi, 90)
        for k in range(1, self.rings + 1):
            r = k * self.ring_size_m
            pts = np.stack([r * np.cos(theta), r * np.sin(theta),
                            np.zeros_like(theta)], axis=1)
            segs = np.stack([pts[:-1], pts[1:]], axis=1)
            Lines(segs, self.color).draw(viz, frame)


@dataclass
class Mesh:
    """Triangle-mesh wireframe (ref: point_viz.h:1534)."""

    triangles: np.ndarray  # (M, 3, 3)
    color: Tuple[int, int, int] = (0, 160, 255)

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        t = self.triangles.reshape(-1, 3, 3)
        segs = np.concatenate([
            np.stack([t[:, 0], t[:, 1]], axis=1),
            np.stack([t[:, 1], t[:, 2]], axis=1),
            np.stack([t[:, 2], t[:, 0]], axis=1)], axis=0)
        Lines(segs, self.color).draw(viz, frame)


def render_with_drawables(viz: PointViz, drawables: Sequence) -> np.ndarray:
    """Render the viz clouds then overlay vector drawables."""
    frame = viz.render().copy()
    for d in drawables:
        d.draw(viz, frame)
    return frame


class Image:
    """2D screen-space image panel (ref: point_viz.h:1330 Image;
    _viz.cpp:922-1010 set_image/set_position/set_hshift/set_palette).

    Holds a mono ([0,1] keys, palette-colored) or RGB float image and a
    normalized-device position (x_min..x_max, y_min..y_max in [-1, 1],
    y up). ``draw`` blits it into the frame; PointViz.add also accepts
    it directly.
    """

    def __init__(self):
        self._img: Optional[np.ndarray] = None
        self._palette: Optional[str] = None
        self._pos = (-1.0, 1.0, 0.0, 1.0)
        self._hshift = 0.0

    def set_image(self, image: np.ndarray) -> None:
        """Mono (H, W) in [0, 1] or RGB/RGBA (H, W, 3|4) float."""
        self._img = np.asarray(image, dtype=np.float32)

    def set_position(self, x_min: float, x_max: float, y_min: float,
                     y_max: float) -> None:
        self._pos = (float(x_min), float(x_max), float(y_min),
                     float(y_max))

    def set_hshift(self, hshift: float) -> None:
        """Extra horizontal shift in NDC applied after aspect scaling
        (ref: _viz.cpp:999)."""
        self._hshift = float(hshift)

    def set_palette(self, palette) -> None:
        """Palette name (or (N, 3) float array registered ad hoc) used
        for mono images."""
        self._palette = palette

    def clear_palette(self) -> None:
        self._palette = None

    def _rgb(self) -> Optional[np.ndarray]:
        if self._img is None:
            return None
        img = self._img
        if img.ndim == 2:
            key = np.clip(img, 0.0, 1.0)
            if isinstance(self._palette, np.ndarray):
                idx = np.clip((key * (len(self._palette) - 1)).astype(int),
                              0, len(self._palette) - 1)
                return (self._palette[idx] * 255).astype(np.uint8)
            from .core import colorize

            return colorize(key.astype(np.float32),
                            self._palette or "grey")
        rgb = img[..., :3]
        return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)

    def draw(self, viz: PointViz, frame: np.ndarray) -> None:
        rgb = self._rgb()
        if rgb is None:
            return
        H, W = frame.shape[:2]
        x0, x1, y0, y1 = self._pos
        # NDC (y up) -> pixel rows (y down)
        px0 = int((x0 + self._hshift + 1.0) / 2.0 * W)
        px1 = int((x1 + self._hshift + 1.0) / 2.0 * W)
        py0 = int((1.0 - y1) / 2.0 * H)
        py1 = int((1.0 - y0) / 2.0 * H)
        px0, px1 = np.clip([px0, px1], 0, W)
        py0, py1 = np.clip([py0, py1], 0, H)
        if px1 <= px0 or py1 <= py0:
            return
        ys = np.linspace(0, rgb.shape[0] - 1, py1 - py0).astype(int)
        xs = np.linspace(0, rgb.shape[1] - 1, px1 - px0).astype(int)
        frame[py0:py1, px0:px1] = rgb[ys][:, xs]


class AxisWithLabel:
    """Coordinate axes with an optional text label, addable to a viz
    (ref: sdk/viz/util.py:85 AxisWithLabel)."""

    def __init__(self, point_viz: PointViz, *,
                 pose: Optional[np.ndarray] = None, label: str = "",
                 length: float = 1.0, thickness: int = 3,
                 label_scale: float = 1.0, enabled: bool = True):
        self._viz = point_viz
        self._pose = np.eye(4) if pose is None else np.asarray(pose)
        self._label_text = label
        o = self._pose[:3, 3]
        R = self._pose[:3, :3]
        segs = np.stack([np.stack([o, o + R[:, k] * length])
                         for k in range(3)])
        self._axes = [
            Lines(segs[0:1], (255, 0, 0)),
            Lines(segs[1:2], (0, 255, 0)),
            Lines(segs[2:3], (0, 0, 255)),
        ]
        self._label = Label(label, tuple(o)) if label else None
        self._enabled = False
        if enabled:
            self.enable()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        if not self._enabled:
            for a in self._axes:
                self._viz.add(a)
            if self._label is not None:
                self._viz.add(self._label)
            self._enabled = True

    def disable(self) -> None:
        if self._enabled:
            for a in self._axes:
                self._viz.remove(a)
            if self._label is not None:
                self._viz.remove(self._label)
            self._enabled = False

    def toggle(self) -> bool:
        (self.disable if self._enabled else self.enable)()
        return self._enabled

    def update(self, pose: np.ndarray, label: Optional[str] = None
               ) -> None:
        was = self._enabled
        self.disable()
        self.__init__(self._viz, pose=pose,
                      label=self._label_text if label is None else label,
                      enabled=was)
