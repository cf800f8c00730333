"""Render a PLY/PCD map to a top-down PNG (ref: python/src/ouster/sdk/
mapping/ply_to_png.py)."""

from __future__ import annotations

import numpy as np


def ply_to_png(cloud_path: str, png_path: str, *, resolution_m: float = 0.1,
               max_size_px: int = 4096) -> str:
    """Orthographic top-down render of a point cloud, colored by height."""
    from ..io.cloud_io import read_pointcloud
    from ..utils import png as P
    from ..viz.core import colorize

    pts, _ = read_pointcloud(cloud_path)
    if pts.shape[0] == 0:
        raise ValueError("empty cloud")
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    span = np.maximum(maxs[:2] - mins[:2], resolution_m)
    res = max(float(span.max()) / max_size_px, resolution_m)
    w = int(span[0] / res) + 1
    h = int(span[1] / res) + 1

    xi = ((pts[:, 0] - mins[0]) / res).astype(int).clip(0, w - 1)
    yi = ((pts[:, 1] - mins[1]) / res).astype(int).clip(0, h - 1)
    z = pts[:, 2]
    zn = (z - z.min()) / max(z.max() - z.min(), 1e-9)

    # max-height per cell
    img = np.zeros((h, w), dtype=np.float32)
    np.maximum.at(img, (yi, xi), zn.astype(np.float32) + 0.05)
    rgb = colorize(np.clip(img, 0, 1), "turbo")
    rgb[img == 0] = 0
    data = P.encode(rgb[::-1], P.COLOR_RGB, 8)
    with open(png_path, "wb") as f:
        f.write(data)
    return png_path
