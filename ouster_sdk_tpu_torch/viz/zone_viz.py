"""Zone-monitor visualization (headless).

Rebuild of the reference's zone voxel mesh rendering (ref:
ouster_viz/src/zone_monitor_voxel_mesh.cpp — zones render as translucent
meshes over the cloud, triggered zones recolored per zone id;
sdk/viz/model.py triggered_live_zone_color). Headless: zone triangle
meshes draw as wireframes over the scan cloud; triggered zones highlight
and occupied points render enlarged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.constants import ChanField
from ..ops.xyzlut import make_xyz_lut
from ..zone.zone import Zone, ZoneSet
from .core import Cloud, PointViz
from .drawables import Label, Lines, render_with_drawables

# per-zone-id colors, cycling a small palette like the reference's
# triggered_live_zone_color (palette[(zone_id * 20) % len])
_ZONE_COLORS = [(255, 80, 80), (80, 220, 80), (90, 140, 255),
                (255, 210, 60), (230, 110, 255), (90, 230, 230)]


def zone_color(zone_id: int):
    return _ZONE_COLORS[zone_id % len(_ZONE_COLORS)]


def zone_wireframe(zone: Zone, color=None) -> Lines:
    """Triangle-edge wireframe of a zone mesh ((N, 3, 3) triangles)."""
    tris = np.asarray(zone.triangles, np.float64)
    edges = np.concatenate([
        np.stack([tris[:, 0], tris[:, 1]], axis=1),
        np.stack([tris[:, 1], tris[:, 2]], axis=1),
        np.stack([tris[:, 2], tris[:, 0]], axis=1)])
    return Lines(edges, color or zone_color(zone.id))


def render_zone_scene(zone_set: ZoneSet, info, scan=None,
                      triggered: Optional[Dict[int, int]] = None,
                      width: int = 1024, height: int = 768) -> np.ndarray:
    """Render the scan cloud with zone wireframes; triggered zones label
    their occupancy counts. Returns the (H, W, 3) frame."""
    triggered = triggered or {}
    viz = PointViz(width=width, height=height)
    drawables: List = []
    centers = []
    for zid, zone in zone_set.zones.items():
        color = zone_color(zid)
        if zid not in triggered:
            color = tuple(int(c * 0.45) for c in color)
        drawables.append(zone_wireframe(zone, color))
        c = np.asarray(zone.triangles, np.float64).reshape(-1, 3).mean(0)
        centers.append(c)
        if zid in triggered:
            drawables.append(Label(
                f"{zid} {triggered[zid]}", c,
                color=color))
    if scan is not None:
        rng = scan.field(ChanField.RANGE)
        xyz = make_xyz_lut(info)(rng)
        valid = rng > 0
        viz.add(Cloud(xyz[valid], np.clip(
            rng[valid] * 2e-5, 0, 1), palette="grey"))
    if centers:
        viz.camera.target = np.mean(centers, axis=0)
        span = float(np.abs(np.array(centers)
                            - viz.camera.target).max()) + 5.0
        viz.camera.distance = max(span * 3.0, 10.0)
    return render_with_drawables(viz, drawables)


def save_zone_snapshot(zone_set: ZoneSet, info, scan, triggered,
                       path: str) -> str:
    from ..utils import png as png_codec

    frame = render_zone_scene(zone_set, info, scan, triggered)
    with open(path, "wb") as f:
        f.write(png_codec.encode(frame, png_codec.COLOR_RGB, 8))
    return path


def precompute_voxel_vertices(info) -> np.ndarray:
    """Per-pixel unit beam directions + offsets: the reusable vertex
    lookup table for voxel-style zone meshes (ref: _viz.cpp:1133
    precompute_voxel_vertices / zone_monitor_voxel_mesh.cpp
    VertexLookupTable). Returns (2, H, W, 3): [unit directions,
    beam origins in meters]."""
    from ..ops.xyzlut import make_xyz_lut

    lut = make_xyz_lut(info)
    dirs = lut.direction
    mags = np.linalg.norm(dirs, axis=-1, keepdims=True)
    unit = dirs / np.maximum(mags, 1e-30)
    return np.stack([unit, lut.offset])


def voxel_style_mesh_from_zone_image_pair(zrb, sensor_info,
                                          voxel_vertices=None):
    """Build a wireframe Mesh of a zone's near/far range-image bounds
    (ref: zone_monitor_voxel_mesh.cpp:355
    voxel_style_mesh_from_zone_image_pair): for every active pixel, the
    near-face and far-face sample points become quad diagonals, stitched
    into triangles along the image grid; edges connect near to far at
    the zone silhouette."""
    from .drawables import Mesh

    if voxel_vertices is None:
        voxel_vertices = precompute_voxel_vertices(sensor_info)
    unit, offset = voxel_vertices
    near = np.asarray(zrb.near_range_mm, dtype=np.float64) * 1e-3
    far = np.asarray(zrb.far_range_mm, dtype=np.float64) * 1e-3
    active = far > near

    tris = []
    h, w = near.shape
    for img in (near, far):
        pts = offset + unit * img[..., None]
        # quads between horizontally/vertically adjacent active pixels
        a = active[:-1, :-1] & active[:-1, 1:] & active[1:, :-1] \
            & active[1:, 1:]
        if not a.any():
            continue
        p00 = pts[:-1, :-1][a]
        p01 = pts[:-1, 1:][a]
        p10 = pts[1:, :-1][a]
        p11 = pts[1:, 1:][a]
        tris.append(np.stack([p00, p01, p11], axis=1))
        tris.append(np.stack([p00, p11, p10], axis=1))
    # near<->far stitching at silhouette pixels (boundary of the mask)
    import scipy.ndimage as ndi

    edge_px = active & ~ndi.binary_erosion(active)
    if edge_px.any():
        pn = (offset + unit * near[..., None])[edge_px]
        pf = (offset + unit * far[..., None])[edge_px]
        # degenerate triangles render as near-far edges in the
        # wireframe rasterizer
        tris.append(np.stack([pn, pf, pf], axis=1))
    triangles = np.concatenate(tris) if tris else np.zeros((0, 3, 3))
    return Mesh(triangles)
