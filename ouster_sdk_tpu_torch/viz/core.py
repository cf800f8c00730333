"""Point-cloud & range-image visualization (offscreen software renderer).

Rebuild of the reference viz layer (ref: ouster_viz/src/point_viz.cpp,
python/src/ouster/sdk/viz/core.py:63,1180). The reference renders through
GLFW/OpenGL with the XYZ projection done in the vertex shader; this
environment is headless, so the renderer here is a vectorized numpy
rasterizer (perspective camera + z-buffered point splatting) with the same
conceptual pieces: Camera (orbit/fov/dolly), Cloud/Image drawables,
colormaps, AutoExposure-driven image panels, and a SimpleViz playback loop
that writes PNG snapshots. The device pipeline can feed it directly
(range image + LUT, exactly like the reference's GPU path,
ref: ouster_viz/src/common.h:221-260).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field as dc_field
from enum import IntEnum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..ops.destagger import destagger
from ..ops.image_processing import AutoExposure
from ..ops.xyzlut import make_xyz_lut


# -- colormaps (ref: ouster_viz/src/colormaps.h) ---------------------------

def _make_viridis() -> np.ndarray:
    anchors = np.array([
        [0.267, 0.005, 0.329], [0.283, 0.141, 0.458], [0.254, 0.265, 0.530],
        [0.207, 0.372, 0.553], [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
        [0.135, 0.659, 0.518], [0.267, 0.749, 0.441], [0.478, 0.821, 0.318],
        [0.741, 0.873, 0.150], [0.993, 0.906, 0.144]])
    x = np.linspace(0, 1, len(anchors))
    xi = np.linspace(0, 1, 256)
    return np.stack([np.interp(xi, x, anchors[:, c]) for c in range(3)],
                    axis=1)


def _make_turbo() -> np.ndarray:
    anchors = np.array([
        [0.190, 0.072, 0.232], [0.275, 0.408, 0.860], [0.212, 0.718, 0.946],
        [0.098, 0.940, 0.708], [0.437, 0.998, 0.365], [0.796, 0.910, 0.178],
        [0.988, 0.652, 0.211], [0.897, 0.286, 0.075], [0.480, 0.016, 0.011]])
    x = np.linspace(0, 1, len(anchors))
    xi = np.linspace(0, 1, 256)
    return np.stack([np.interp(xi, x, anchors[:, c]) for c in range(3)],
                    axis=1)


def _make_magma() -> np.ndarray:
    anchors = np.array([
        [0.001, 0.000, 0.014], [0.113, 0.065, 0.277], [0.317, 0.072, 0.485],
        [0.513, 0.148, 0.508], [0.716, 0.215, 0.475], [0.904, 0.320, 0.388],
        [0.988, 0.510, 0.383], [0.997, 0.718, 0.488], [0.987, 0.991, 0.750]])
    x = np.linspace(0, 1, len(anchors))
    xi = np.linspace(0, 1, 256)
    return np.stack([np.interp(xi, x, anchors[:, c]) for c in range(3)],
                    axis=1)


def _make_rainbow() -> np.ndarray:
    """HSV sweep 0..~325 deg (ref: model.py Palettes rainbow)."""
    import colorsys

    return np.array([colorsys.hsv_to_rgb(i * (230 / 255) / 256, 1.0, 1.0)
                     for i in range(256)])


def _make_spezia() -> np.ndarray:
    """'Ouster Colors' style: deep blue -> teal -> sand (analytic stand-in
    for colormaps.h spezia)."""
    anchors = np.array([
        [0.040, 0.050, 0.350], [0.100, 0.280, 0.560], [0.130, 0.480, 0.620],
        [0.290, 0.650, 0.580], [0.590, 0.750, 0.480], [0.850, 0.800, 0.470],
        [0.980, 0.870, 0.600]])
    x = np.linspace(0, 1, len(anchors))
    xi = np.linspace(0, 1, 256)
    return np.stack([np.interp(xi, x, anchors[:, c]) for c in range(3)],
                    axis=1)


def _make_calref() -> np.ndarray:
    """Calibrated-reflectivity palette: diffuse half greyscale, retro half
    colorful (ref: colormaps.h calref semantics)."""
    cm = np.zeros((256, 3))
    cm[:128] = np.repeat(np.linspace(0.0, 0.85, 128)[:, None], 3, axis=1)
    t = np.linspace(0, 1, 128)
    cm[128:, 0] = 1.0
    cm[128:, 1] = 1.0 - 0.8 * t
    cm[128:, 2] = 0.1
    return cm


COLORMAPS: Dict[str, np.ndarray] = {
    "viridis": _make_viridis(),
    "turbo": _make_turbo(),
    "grey": np.repeat(np.linspace(0, 1, 256)[:, None], 3, axis=1),
    "magma": _make_magma(),
    "rainbow": _make_rainbow(),
    "spezia": _make_spezia(),
    "calref": _make_calref(),
}

# cloud palette cycle order (ref: model.py:113 Palettes)
CLOUD_PALETTE_ORDER = ["calref", "spezia", "grey", "viridis", "magma",
                       "rainbow"]


def colorize(key: np.ndarray, palette: str = "viridis") -> np.ndarray:
    """Map [0,1] keys to RGB u8."""
    cm = COLORMAPS[palette]
    idx = np.clip((key * 255).astype(np.int32), 0, 255)
    return (cm[idx] * 255).astype(np.uint8)


@dataclass
class Camera:
    """Orbit camera (ref: ouster_viz/src/camera.cpp:269)."""

    yaw: float = 140.0       # degrees
    pitch: float = -35.0
    distance: float = 40.0   # dolly
    target: np.ndarray = dc_field(default_factory=lambda: np.zeros(3))
    fov: float = 60.0        # degrees

    def view_matrix(self) -> np.ndarray:
        cy, sy = math.cos(math.radians(self.yaw)), \
            math.sin(math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), \
            math.sin(math.radians(self.pitch))
        # camera position on the orbit sphere
        eye = self.target + self.distance * np.array(
            [cp * cy, cp * sy, -sp])
        fwd = self.target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        nr = np.linalg.norm(right)
        right = right / (nr if nr > 1e-9 else 1.0)
        up = np.cross(right, fwd)
        V = np.eye(4)
        V[0, :3], V[1, :3], V[2, :3] = right, up, -fwd
        V[:3, 3] = -V[:3, :3] @ eye
        return V

    def dolly(self, amount: float) -> None:
        self.distance = float(np.clip(self.distance * (0.95 ** amount),
                                      1.0, 1000.0))

    def orbit(self, dyaw: float, dpitch: float) -> None:
        self.yaw = (self.yaw + dyaw) % 360.0
        self.pitch = float(np.clip(self.pitch + dpitch, -89.0, 89.0))


class Cloud:
    """Point cloud drawable (ref: point_viz.h:1098): either xyz directly or
    range + LUT like the reference's GPU path."""

    def __init__(self, xyz: np.ndarray, key: Optional[np.ndarray] = None,
                 palette: str = "viridis", point_size: int = 1,
                 pose: Optional[np.ndarray] = None):
        self.xyz = xyz.reshape(-1, 3)
        self.key = None if key is None else key.reshape(-1)
        self.palette = palette
        self.point_size = point_size
        self.pose = np.eye(4) if pose is None else pose
        # set by from_range for the GL backend's in-shader projection
        self.range_image: Optional[np.ndarray] = None
        self.lut_dir: Optional[np.ndarray] = None
        self.lut_offset: Optional[np.ndarray] = None
        self.column_poses: Optional[np.ndarray] = None

    @classmethod
    def from_range(cls, range_image: np.ndarray, lut,
                   key: Optional[np.ndarray] = None,
                   palette: str = "viridis", point_size: int = 1,
                   pose: Optional[np.ndarray] = None,
                   column_poses: Optional[np.ndarray] = None) -> "Cloud":
        """Cloud defined by a range image + XYZ LUT, the reference GPU
        path (ref: point_viz.h:1098 Cloud::set_range, common.h:221-260):
        the GL backend uploads range/dir/offset and projects per vertex;
        the software path precomputes xyz here. `column_poses` (W, 4, 4)
        dewarps per column like the reference's pose texture."""
        rng = np.asarray(range_image, dtype=np.float64)
        h, w = rng.shape
        xyz = np.where((rng > 0)[..., None],
                       rng[..., None] * lut.direction + lut.offset, 0.0)
        # reference transform order col_pose . model . lut
        # (common.h:246-267: local = model*lut, position = car_pose*local)
        # is baked into the software xyz; the GL path reproduces it in
        # the shader from the stored model/column_poses instead.
        model = np.eye(4) if pose is None else np.asarray(pose,
                                                          np.float64)
        xyz = xyz @ model[:3, :3].T + model[:3, 3]
        if column_poses is not None:
            cp = np.asarray(column_poses, dtype=np.float64).reshape(
                w, 4, 4)
            xyz = np.einsum("wij,hwj->hwi", cp[:, :3, :3], xyz) \
                + cp[None, :, :3, 3]
        c = cls(xyz.reshape(-1, 3), key=key, palette=palette,
                point_size=point_size, pose=None)
        c.gl_model = model
        c.range_image = rng
        c.lut_dir = np.asarray(lut.direction, dtype=np.float64)
        c.lut_offset = np.asarray(lut.offset, dtype=np.float64)
        c.column_poses = (None if column_poses is None else
                          np.asarray(column_poses,
                                     dtype=np.float64).reshape(w, 4, 4))
        return c


class PointViz:
    """Offscreen renderer (API shape follows point_viz.h:207)."""

    def __init__(self, name: str = "ouster-viz", width: int = 1024,
                 height: int = 768, backend: str = "software"):
        self.name = name
        self.width = width
        self.height = height
        #: "software" (numpy rasterizer) or "gl" (real OpenGL via
        #: surfaceless EGL; see viz/gl.py)
        self.backend = backend
        self._gl_renderer = None
        self.camera = Camera()
        self._clouds: List[Cloud] = []
        self._images: List[Tuple[np.ndarray, float, float]] = []
        # generic drawables with a draw(viz, frame) method (Lines,
        # Cuboid, Label, Image, Mesh, ...; ref: point_viz.h add/remove)
        self._drawables: List = []
        self._key_handlers: List = []
        self._mouse_handlers: List = []
        self._scroll_handlers: List = []
        self._fb_handlers: List = []

    def add(self, drawable) -> None:
        if isinstance(drawable, Cloud):
            self._clouds.append(drawable)
        else:
            self._drawables.append(drawable)

    def remove(self, drawable) -> bool:
        for coll in (self._clouds, self._drawables):
            if drawable in coll:
                coll.remove(drawable)
                return True
        return False

    def clear(self) -> None:
        self._clouds.clear()
        self._images.clear()
        self._drawables.clear()

    def add_image_panel(self, rgb: np.ndarray) -> None:
        self._images.append((rgb, 0.0, 0.0))

    def render(self, backend: Optional[str] = None) -> np.ndarray:
        """Rasterize to (H, W, 3) u8 with the software rasterizer, or
        on a real OpenGL context when backend (or self.backend) is
        "gl" (ref: point_viz.h:207 PointViz — the reference always
        renders through GL; here GL is the accelerated option and
        numpy the dependency-free default)."""
        if (backend or self.backend) == "gl":
            from . import gl as _gl

            if self._gl_renderer is None or \
                    (self._gl_renderer.ctx.width,
                     self._gl_renderer.ctx.height) != (self.width,
                                                       self.height):
                if self._gl_renderer is not None:
                    self._gl_renderer.close()
                self._gl_renderer = _gl.GLRenderer(self.width,
                                                   self.height)
            return self._gl_renderer.render(self)
        H, W = self.height, self.width
        frame = np.zeros((H, W, 3), dtype=np.uint8)
        zbuf = np.full((H, W), np.inf, dtype=np.float32)

        V = self.camera.view_matrix()
        f = 0.5 * H / math.tan(math.radians(self.camera.fov) / 2)

        for cloud in self._clouds:
            pts = cloud.xyz @ cloud.pose[:3, :3].T + cloud.pose[:3, 3]
            cam = pts @ V[:3, :3].T + V[:3, 3]
            z = -cam[:, 2]
            vis = z > 0.1
            x = (cam[:, 0] / z) * f + W / 2
            y = H / 2 - (cam[:, 1] / z) * f
            vis &= (x >= 0) & (x < W - 1) & (y >= 0) & (y < H - 1)
            xi = x[vis].astype(np.int32)
            yi = y[vis].astype(np.int32)
            zi = z[vis].astype(np.float32)

            if cloud.key is not None:
                colors = colorize(np.clip(cloud.key[vis], 0, 1),
                                  cloud.palette)
            else:
                colors = np.full((vis.sum(), 3), 200, dtype=np.uint8)

            # z-buffered splat: sort far-to-near so near wins on overwrite
            order = np.argsort(-zi)
            xi, yi, zi, colors = xi[order], yi[order], zi[order], \
                colors[order]
            for dy in range(cloud.point_size):
                for dx in range(cloud.point_size):
                    yy = np.clip(yi + dy, 0, H - 1)
                    xx = np.clip(xi + dx, 0, W - 1)
                    closer = zi < zbuf[yy, xx]
                    frame[yy[closer], xx[closer]] = colors[closer]
                    zbuf[yy[closer], xx[closer]] = zi[closer]

        # generic drawables (vector overlays + positioned Image panels)
        for d in self._drawables:
            d.draw(self, frame)

        # stack 2D panels at the top
        y_off = 0
        for rgb, _, _ in self._images:
            ph, pw = rgb.shape[:2]
            scale = W / pw
            target_h = max(int(ph * scale) // 2, 1)
            ys = (np.linspace(0, ph - 1, target_h)).astype(int)
            xs = (np.linspace(0, pw - 1, W)).astype(int)
            panel = rgb[ys][:, xs]
            if y_off + target_h <= H:
                frame[y_off:y_off + target_h] = panel
                y_off += target_h

        for h in self._fb_handlers:
            h(frame, W, H)
        return frame

    def save_png(self, path: str, frame: Optional[np.ndarray] = None
                 ) -> None:
        from ..utils import png as png_codec

        frame = self.render() if frame is None else frame
        data = png_codec.encode(frame, png_codec.COLOR_RGB, 8)
        with open(path, "wb") as f:
            f.write(data)

    # -- event-handler registry (ref: point_viz.h:~600-745) ---------------
    # Headless: handlers are invoked by tests / embedding front-ends via
    # the dispatch_* methods; frame-buffer handlers fire on every render.
    def push_key_handler(self, handler) -> None:
        self._key_handlers.append(handler)

    def push_mouse_button_handler(self, handler) -> None:
        self._mouse_handlers.append(handler)

    def push_scroll_handler(self, handler) -> None:
        self._scroll_handlers.append(handler)

    def push_frame_buffer_handler(self, handler) -> None:
        self._fb_handlers.append(handler)

    def pop_frame_buffer_handler(self) -> None:
        if self._fb_handlers:
            self._fb_handlers.pop()

    def window_context(self) -> "WindowCtx":
        return WindowCtx(viewport_width=self.width,
                         viewport_height=self.height,
                         window_width=self.width,
                         window_height=self.height)

    def dispatch_key(self, key: int, mods: int = 0) -> bool:
        ctx = self.window_context()
        for h in reversed(self._key_handlers):
            if not h(ctx, key, mods):
                return False
        return True

    def dispatch_mouse_button(self, button, event, mods: int = 0) -> bool:
        ctx = self.window_context()
        for h in reversed(self._mouse_handlers):
            if not h(ctx, button, event, mods):
                return False
        return True

    def dispatch_scroll(self, x: float, y: float) -> bool:
        ctx = self.window_context()
        for h in reversed(self._scroll_handlers):
            if not h(ctx, x, y):
                return False
        return True


class Selection2d:
    """2D AOI selection on an image panel (ref: model.py:194 Selection2d):
    a destaggered-image rectangle, its staggered mask, and point stats."""

    def __init__(self, p1: Tuple[int, int], p2: Tuple[int, int],
                 sensor_index: int, image_index: int, info: SensorInfo):
        self.p1 = (min(p1[0], p2[0]), min(p1[1], p2[1]))
        self.p2 = (max(p1[0], p2[0]), max(p1[1], p2[1]))
        self.sensor_index = sensor_index
        self.image_index = image_index
        self._info = info
        self.finalized = False

    def finalize(self) -> None:
        self.finalized = True

    def mask(self, h: int, w: int) -> np.ndarray:
        """Staggered-frame boolean mask of the selected rectangle (the
        rectangle is drawn on the destaggered panel)."""
        m = np.zeros((h, w), dtype=bool)
        (r0, c0), (r1, c1) = self.p1, self.p2
        m[r0:r1 + 1, c0:c1 + 1] = True
        from ..ops.destagger import stagger

        return stagger(self._info, m)

    def stats(self, scan: LidarScan) -> Dict[str, float]:
        """Range/field statistics of the selected pixels."""
        m = self.mask(scan.h, scan.w)
        rng = scan.field(ChanField.RANGE)
        sel = rng[m & (rng > 0)]
        out = {"num_points": int(sel.size),
               "mean_range_m": float(sel.mean() * 1e-3) if sel.size else 0.0,
               "min_range_m": float(sel.min() * 1e-3) if sel.size else 0.0,
               "max_range_m": float(sel.max() * 1e-3) if sel.size else 0.0}
        return out


def _imu_subplot(scan: LidarScan, width: int, height: int = 120
                 ) -> Optional[np.ndarray]:
    """Render accel/gyro time series into an RGB strip
    (ref: viz/core.py IMU subplot)."""
    if not (scan.has_field(ChanField.IMU_ACC)
            and scan.has_field(ChanField.IMU_GYRO)):
        return None
    acc = np.asarray(scan.field(ChanField.IMU_ACC), np.float64)
    gyro = np.asarray(scan.field(ChanField.IMU_GYRO), np.float64)
    if acc.size == 0:
        return None
    panel = np.full((height, width, 3), 16, dtype=np.uint8)
    half = height // 2
    colors = [(255, 80, 80), (80, 255, 80), (100, 140, 255)]

    def plot(series, y0, h):
        n = series.shape[0]
        if n < 2:
            return
        lo = series.min()
        span = max(series.max() - lo, 1e-9)
        xs = np.linspace(0, width - 1, n).astype(int)
        for axis in range(3):
            ys = y0 + h - 1 - ((series[:, axis] - lo) / span *
                               (h - 1)).astype(int)
            for i in range(n - 1):
                x0, x1 = xs[i], xs[i + 1]
                steps = max(x1 - x0, 1)
                xi = np.linspace(x0, x1, steps + 1).astype(int)
                yi = np.linspace(ys[i], ys[i + 1], steps + 1).astype(int)
                panel[np.clip(yi, y0, y0 + h - 1), np.clip(xi, 0, width - 1)
                      ] = colors[axis]

    plot(acc, 0, half)
    plot(gyro, half, height - half)
    panel[half - 1:half + 1, :] = 60  # divider
    return panel


class LidarScanViz:
    """Per-scan panels + cloud with view-mode/palette cycling, 2D AOI
    selection and an IMU subplot (ref: sdk/viz/core.py:63,
    sdk/viz/model.py:113,194)."""

    def __init__(self, infos: Sequence[SensorInfo],
                 viz: Optional[PointViz] = None):
        from .view_mode import default_cloud_modes, default_image_modes

        self.infos = list(infos)
        self.viz = viz or PointViz()
        self._luts = [make_xyz_lut(i) for i in self.infos]
        self.cloud_modes = [default_cloud_modes(i) for i in self.infos]
        self.image_modes = [default_image_modes(i) for i in self.infos]
        self._cloud_mode_ind = 0
        self._img_mode_ind = [0, 1]  # two panels, like the reference
        self._palette_ind = 0
        self._scans: List[Optional[LidarScan]] = []
        self.selections: List[Selection2d] = []
        self.show_imu = True

    # -- mode / palette cycling (ref: model.py cycle_* ) -------------------
    @property
    def cloud_mode(self):
        return self.cloud_modes[0][self._cloud_mode_ind]

    @property
    def cloud_palette(self) -> str:
        return CLOUD_PALETTE_ORDER[self._palette_ind]

    def cycle_cloud_mode(self, direction: int = 1) -> str:
        n = len(self.cloud_modes[0])
        self._cloud_mode_ind = (self._cloud_mode_ind + direction) % n
        return self.cloud_mode.name

    def cycle_img_mode(self, panel: int, direction: int = 1) -> str:
        n = len(self.image_modes[0])
        self._img_mode_ind[panel] = \
            (self._img_mode_ind[panel] + direction) % n
        return self.image_modes[0][self._img_mode_ind[panel]].name

    def cycle_cloud_palette(self, direction: int = 1) -> str:
        self._palette_ind = (self._palette_ind + direction) % \
            len(CLOUD_PALETTE_ORDER)
        return self.cloud_palette

    # -- AOI (ref: model.py:194) -------------------------------------------
    def select_aoi(self, p1: Tuple[int, int], p2: Tuple[int, int],
                   sensor_index: int = 0, image_index: int = 0
                   ) -> Selection2d:
        sel = Selection2d(p1, p2, sensor_index, image_index,
                          self.infos[sensor_index])
        self.selections.append(sel)
        return sel

    def clear_selections(self) -> None:
        self.selections.clear()

    def update(self, scans: Sequence[Optional[LidarScan]]) -> None:
        self._scans = list(scans)
        self.viz.clear()
        for idx, scan in enumerate(scans):
            if scan is None:
                continue
            info = self.infos[idx]
            rng = scan.field(ChanField.RANGE)
            xyz = self._luts[idx](rng)
            valid = rng > 0
            # apply per-column scan poses so SLAM-posed scans render in
            # the world frame (ref: _viz.cpp Cloud column poses)
            if not np.allclose(scan.pose, np.eye(4)):
                from ..utils.pose_util import dewarp as _dewarp

                xyz = _dewarp(xyz, scan.pose)

            mode = self.cloud_modes[idx][self._cloud_mode_ind]
            if not mode.enabled(scan):
                mode = self.cloud_modes[idx][1]  # RANGE fallback
            key = mode.prepare(scan)
            aoi = np.zeros_like(valid)
            for sel in self.selections:
                if sel.sensor_index == idx:
                    aoi |= sel.mask(scan.h, scan.w)
            cloud = Cloud(xyz[valid], key[valid],
                          palette=self.cloud_palette)
            self.viz.add(cloud)
            if aoi.any():  # highlight selected points on top
                hl = Cloud(xyz[valid & aoi],
                           np.ones(int((valid & aoi).sum())),
                           palette="turbo", point_size=2)
                self.viz.add(hl)

            # 2D panels with per-panel modes + AOI rectangles
            for panel, mode_ind in enumerate(self._img_mode_ind):
                imode = self.image_modes[idx][mode_ind]
                if not imode.enabled(scan):
                    continue
                img = destagger(info, imode.prepare(scan))
                rgb = colorize(img, "grey").copy()
                for sel in self.selections:
                    if sel.sensor_index == idx and \
                            sel.image_index == panel:
                        (r0, c0), (r1, c1) = sel.p1, sel.p2
                        rgb[r0:r1 + 1, [c0, c1]] = (255, 40, 40)
                        rgb[[r0, r1], c0:c1 + 1] = (255, 40, 40)
                self.viz.add_image_panel(rgb)

            if self.show_imu:
                imu = _imu_subplot(scan, self.viz.width)
                if imu is not None:
                    self.viz.add_image_panel(imu)

    def draw(self) -> np.ndarray:
        return self.viz.render()


class _Seekable:
    """Wrap an iterable with a bounded back-buffer so playback can seek
    by absolute index (ref: sdk/viz/core.py:1031 _Seekable — same
    invariant: (read_ind - len(cache)) < next_ind <= read_ind + 1)."""

    def __init__(self, it: Iterable, maxlen: int = 50):
        from collections import deque

        self._it = iter(it)
        self._cache: "deque" = deque(maxlen=maxlen)
        self._maxlen = maxlen
        self._read_ind = -1   # last index read from the source
        self._next_ind = 0    # index returned by the next __next__

    @property
    def next_ind(self) -> int:
        return self._next_ind

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_ind <= self._read_ind:
            val = self._cache[self._next_ind - self._read_ind - 1]
        else:
            val = next(self._it)
            self._read_ind += 1
            self._cache.append(val)
        self._next_ind += 1
        return val

    def seek(self, ind: int) -> bool:
        """Position so the next __next__ returns index `ind`. Seeking
        forward past the read head consumes the source up to `ind`
        (reference semantics); False when `ind` was evicted from the
        bounded back-cache or the source ends first."""
        while ind > self._read_ind + 1:
            try:
                val = next(self._it)
            except StopIteration:
                return False
            self._read_ind += 1
            # skipped-over items enter the back-cache like read ones,
            # so seeking back across a forward seek still works
            self._cache.append(val)
        if ind <= self._read_ind - len(self._cache):
            return False
        self._next_ind = max(ind, 0)
        return True

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close:
            close()


class LiveConsumer:
    """Consume a live iterator on a worker thread through a depth-1
    queue, dropping (and counting) frames the consumer can't keep up
    with (ref: sdk/viz/core.py:1130 LiveConsumer)."""

    def __init__(self, iterable, should_count_dropped_frame=lambda: True):
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(1)
        self._stopped = threading.Event()
        self._should_count = should_count_dropped_frame
        self.dropped = 0

        def run():
            for item in iterable:
                if self._stopped.is_set():
                    break
                try:
                    self._queue.put_nowait(item)
                except queue.Full:
                    if self._should_count():
                        self.dropped += 1
            self._stopped.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        import queue

        while True:
            try:
                yield self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._stopped.is_set():
                    return

    def stop(self) -> None:
        self._stopped.set()


class SimpleViz:
    """Playback loop (ref: sdk/viz/core.py:1180). Headless: renders every
    `snapshot_every` scans to PNG when snapshot_path is set. Accumulators
    (key frames / trajectory / global map, ref: viz/accumulators.py and
    the CLI --accum-*/--map flags) overlay onto the cloud when enabled.

    Playback semantics follow the reference: `rate` paces wall-clock
    replay (0 = as fast as possible), `pause_at` pauses on a scan index,
    pause()/resume()/toggle_pause and step/seek work from another thread
    or through the key bindings (SPACE pause, . / , step, > / < rate)."""

    _playback_rates = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 0.0)

    def __init__(self, infos: Sequence[SensorInfo],
                 snapshot_path: Optional[str] = None,
                 snapshot_every: int = 10,
                 accum_num: int = 0,
                 accum_every: int = 0,
                 accum_every_m: float = 0.0,
                 map_enabled: bool = False,
                 map_ratio: float = 1.0,
                 map_size: int = 1_500_000,
                 rate: Optional[float] = None,
                 pause_at: int = -1,
                 buflen: int = 50,
                 auto_resume: bool = False,
                 backend: str = "software"):
        from .accumulators import (MapAccumulator, ScansAccumulator,
                                   TracksAccumulator)

        self.scan_viz = LidarScanViz(infos,
                                     viz=PointViz(backend=backend))
        self.snapshot_path = snapshot_path
        self.snapshot_every = max(snapshot_every, 1)
        self._infos = list(infos)
        self.accum = None
        self.tracks = None
        self.map = None
        if accum_num > 0 or accum_every > 0 or accum_every_m > 0:
            self.accum = ScansAccumulator(
                infos,
                accum_max_num=accum_num if accum_num > 0 else 100,
                accum_min_dist_meters=accum_every_m,
                accum_min_dist_num=accum_every)
            self.tracks = TracksAccumulator()
        if map_enabled or map_ratio != 1.0:
            self.map = MapAccumulator(infos, map_ratio=map_ratio,
                                      map_size=map_size)

        import threading

        if rate is not None and rate not in self._playback_rates:
            raise ValueError(
                f"rate must be one of {self._playback_rates}")
        # default: free-run — headless batch jobs must not sleep between
        # scans; pass an explicit rate for wall-clock pacing
        self._rate = 0.0 if rate is None else rate
        self._pause_at = pause_at
        self._buflen = buflen
        self._paused = False
        self._step = 0
        self._seek_to: Optional[int] = None
        self._auto_resume = auto_resume
        self._cv = threading.Condition()
        self._install_key_bindings()

    # -- playback controls (ref: sdk/viz/core.py:1330-1420) ---------------
    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def rate(self) -> float:
        return self._rate

    def pause(self) -> None:
        with self._cv:
            self._paused = True
            self._cv.notify()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify()

    def toggle_pause(self) -> None:
        with self._cv:
            self._paused = not self._paused
            self._cv.notify()

    def seek_relative(self, n_frames: int) -> None:
        """Step forward/backward; pauses playback
        (ref: core.py:1380 seek_relative)."""
        with self._cv:
            self._paused = True
            self._step += n_frames
            self._cv.notify()

    def seek(self, ind: int) -> None:
        with self._cv:
            self._seek_to = ind
            self._cv.notify()

    def modify_rate(self, amount: int) -> float:
        """Cycle through the reference playback rates
        (ref: core.py:1388 modify_rate)."""
        with self._cv:
            i = self._playback_rates.index(self._rate)
            i = int(np.clip(i + amount, 0,
                            len(self._playback_rates) - 1))
            self._rate = self._playback_rates[i]
        return self._rate

    def _install_key_bindings(self) -> None:
        def handle(ctx, key: int, mods: int) -> bool:
            if key == ord(" "):
                self.toggle_pause()
            elif key == ord("."):
                self.seek_relative(1)
            elif key == ord(","):
                self.seek_relative(-1)
            elif key == ord(">"):
                self.modify_rate(1)
            elif key == ord("<"):
                self.modify_rate(-1)
            return True

        self.scan_viz.viz.push_key_handler(handle)

    def _consume(self, scans, n: int) -> None:
        self.scan_viz.update(scans)
        if self.accum is not None:
            self.accum.accept(scans)
            self.tracks.accept(scans)
        if self.map is not None:
            self.map.accept(scans)
        if self.snapshot_path and n % self.snapshot_every == 0:
            self._overlay_accumulators()
            stem, ext = os.path.splitext(self.snapshot_path)
            path = f"{stem}_{n:04d}{ext or '.png'}"
            self.scan_viz.viz.save_png(path)

    def run(self, scan_sets: Iterable, live: bool = False) -> int:
        """Drive the playback loop over scan sets. `live` wraps the
        source in a LiveConsumer (drop-when-slow, no seeking)."""
        import time as _time

        if live:
            src: Iterable = LiveConsumer(scan_sets)
            seekable = None
        else:
            seekable = _Seekable(scan_sets, maxlen=self._buflen)
            src = seekable

        n = 0
        last_wall = None
        it = iter(src)
        while True:
            # honor pause/step/seek before pulling the next set
            with self._cv:
                while self._paused and not self._step and \
                        self._seek_to is None:
                    self._cv.wait(timeout=0.1)
                step, self._step = self._step, 0
                seek_to, self._seek_to = self._seek_to, None
            if seekable is not None:
                if seek_to is not None:
                    seekable.seek(seek_to)
                elif step:
                    seekable.seek(max(seekable.next_ind - 1 + step, 0))
            try:
                ls_set = next(it)
            except StopIteration:
                break
            scans = list(ls_set)
            self._consume(scans, n)
            n += 1
            if n - 1 == self._pause_at:
                self.pause()
                if self._auto_resume:
                    # headless CLI semantics: a pause point becomes a
                    # guaranteed snapshot, then playback continues
                    if self.snapshot_path:
                        self._overlay_accumulators()
                        stem, ext = os.path.splitext(self.snapshot_path)
                        self.scan_viz.viz.save_png(
                            f"{stem}_pause_{n - 1:04d}{ext or '.png'}")
                    self.resume()
            # wall-clock pacing from scan timestamps (ref: core.py run
            # loop; 0 = free-run)
            if self._rate > 0 and not live:
                anchor = next((s for s in scans if s is not None), None)
                period = 0.1
                if anchor is not None and \
                        anchor.sensor_info is not None:
                    fps = getattr(anchor.sensor_info.format, "fps", 0) \
                        or 10
                    period = 1.0 / fps
                now = _time.monotonic()
                if last_wall is not None:
                    sleep = period / self._rate - (now - last_wall)
                    if sleep > 0:
                        _time.sleep(sleep)
                last_wall = _time.monotonic()
        if seekable is not None:
            seekable.close()
        return n

    def _overlay_accumulators(self) -> None:
        viz = self.scan_viz.viz
        if self.map is not None:
            pts = self.map.points()
            if pts.shape[0]:
                viz.add(Cloud(pts, np.full(pts.shape[0], 0.55),
                              palette="grey"))
        if self.accum is not None:
            pts = self.accum.points()
            if pts.shape[0]:
                viz.add(Cloud(pts, np.full(pts.shape[0], 0.75),
                              palette="viridis"))
            tr = self.tracks.points()
            if tr.shape[0]:
                viz.add(Cloud(tr, np.full(tr.shape[0], 1.0),
                              palette="turbo", point_size=3))


def ls_show(scan_or_scans, info: Optional[SensorInfo] = None,
            path: str = "scan.png") -> str:
    """One-liner snapshot of a scan (ref: viz/core.py:1722 ls_show)."""
    scans = scan_or_scans if isinstance(scan_or_scans, (list, tuple)) \
        else [scan_or_scans]
    infos = [info or s.sensor_info for s in scans]
    lsv = LidarScanViz(infos)
    lsv.update(scans)
    lsv.viz.save_png(path)
    return path


# ---------------------------------------------------------------------------
# Reference API compatibility surface (ref: _viz.cpp enums/structs,
# sdk/viz/util.py helpers, sdk/viz/core.py ImuVisualizationConfig)
# ---------------------------------------------------------------------------

class PointVizNotRunningError(RuntimeError):
    """Raised by operations that need a live render loop
    (ref: _viz.cpp PointVizNotRunningError)."""


class MouseButton(IntEnum):
    """(ref: _viz.cpp:109-122; GLFW button numbering)"""

    MOUSE_BUTTON_1 = 0
    MOUSE_BUTTON_2 = 1
    MOUSE_BUTTON_3 = 2
    MOUSE_BUTTON_4 = 3
    MOUSE_BUTTON_5 = 4
    MOUSE_BUTTON_6 = 5
    MOUSE_BUTTON_7 = 6
    MOUSE_BUTTON_8 = 7
    MOUSE_BUTTON_LAST = 7
    MOUSE_BUTTON_LEFT = 0
    MOUSE_BUTTON_RIGHT = 1
    MOUSE_BUTTON_MIDDLE = 2


class MouseButtonEvent(IntEnum):
    """(ref: _viz.cpp:124-128)"""

    MOUSE_BUTTON_RELEASED = 0
    MOUSE_BUTTON_PRESSED = 1


class EventModifierKeys(IntEnum):
    """(ref: _viz.cpp:130-137; GLFW modifier bits)"""

    MOD_NONE = 0
    MOD_SHIFT = 1
    MOD_CONTROL = 2
    MOD_ALT = 4
    MOD_SUPER = 8


@dataclass
class WindowCtx:
    """Window/viewport state passed to event handlers
    (ref: point_viz.h:757-765 WindowCtx)."""

    lbutton_down: bool = False
    mbutton_down: bool = False
    mouse_x: float = 0.0
    mouse_y: float = 0.0
    viewport_width: int = 0
    viewport_height: int = 0
    window_width: int = 0
    window_height: int = 0

    def aspect_ratio(self) -> float:
        """window_width / window_height (ref: point_viz.cpp:1250)."""
        return (self.window_width / self.window_height
                if self.window_height else 1.0)

    def normalized_coordinates(self, x: float, y: float):
        """Window pixels -> 2D NDC, y in (-1, 1)
        (ref: point_viz.cpp:1255-1260)."""
        w = self.window_width or 1
        h = self.window_height or 1
        return ((2.0 / w * x - 1.0) * self.aspect_ratio(),
                2.0 * (1.0 - y / h) - 1.0)


# simple geometry aliases (ref: _viz.cpp Vertex/Vec3f for Mesh input)
Vec3f = tuple
Vertex = tuple


class ImuVisualizationConfig:
    """IMU subplot options (ref: sdk/viz/core.py:43-60)."""

    imu_plot_width_pixels = 1000
    imu_plot_height_pixels = 28
    downsample_factor = 2
    field_colors = {
        "IMU_ACC": (1.0, 0.0, 0.0, 1.0),
        "IMU_GYRO": (1.0, 1.0, 1.0, 1.0),
    }

    def __init__(self, options: str = "only_gyro") -> None:
        if options == "only_gyro":
            self._fields = ["IMU_GYRO"]
        elif options == "only_acc":
            self._fields = ["IMU_ACC"]
        elif options == "all":
            self._fields = ["IMU_ACC", "IMU_GYRO"]
        else:
            raise ValueError(f"unknown imu viz option: {options}")

    @property
    def fields(self):
        return list(self._fields)


def push_point_viz_handler(viz: "PointViz", arg, handler) -> None:
    """Key handler with weakly-referenced extra context — avoids the
    reference cycle of capturing self (ref: sdk/viz/util.py:28-52)."""
    import weakref

    weakarg = weakref.ref(arg)

    def handle_keys(ctx, key: int, mods: int) -> bool:
        obj = weakarg()
        if obj is not None:
            return handler(obj, ctx, key, mods)
        return True

    viz.push_key_handler(handle_keys)


def add_default_controls(viz: "PointViz", mx=None) -> None:
    """Install the reference default camera key bindings
    (ref: point_viz.cpp:239 add_default_controls): arrows orbit,
    =/- dolly, 0 resets."""

    def handle(ctx, key: int, mods: int) -> bool:
        cam = viz.camera
        if key == ord("="):
            cam.dolly(1)
        elif key == ord("-"):
            cam.dolly(-1)
        elif key == ord("0"):
            viz.camera = Camera()
        elif key == 262:    # right arrow
            cam.orbit(-5.0, 0.0)
        elif key == 263:    # left arrow
            cam.orbit(5.0, 0.0)
        elif key == 264:    # down arrow
            cam.orbit(0.0, -5.0)
        elif key == 265:    # up arrow
            cam.orbit(0.0, 5.0)
        return True

    viz.push_key_handler(handle)


# palette arrays under the reference export names
# (ref: _viz.cpp calref_palette/spezia_palette/... bindings)
calref_palette = COLORMAPS["calref"]
spezia_palette = COLORMAPS["spezia"]
grey_palette = COLORMAPS["grey"]
viridis_palette = COLORMAPS["viridis"]
magma_palette = COLORMAPS["magma"]
