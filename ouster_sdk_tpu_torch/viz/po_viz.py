"""Pose-optimizer visualization (headless).

Rebuild of the reference pose-optimizer viewer (ref: python/src/ouster/
cli/plugins/source_po_viz.py — an interactive GL editor showing the
trajectory, constraint markers and the optimized result). Headless
equivalent: render before/after trajectories plus constraint markers into
PNG snapshots (top-down and orbit views) via the offscreen PointViz.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .core import Camera, Cloud, PointViz
from .drawables import Cuboid, Label, Lines, render_with_drawables


def _traj_segments(positions: np.ndarray) -> np.ndarray:
    if positions.shape[0] < 2:
        return np.zeros((0, 2, 3))
    return np.stack([positions[:-1], positions[1:]], axis=1)


def render_po_viz(nodes_before: Sequence, nodes_after: Sequence,
                  constraints: Sequence = (), *,
                  width: int = 1024, height: int = 768,
                  top_down: bool = False) -> np.ndarray:
    """Render before (grey) / after (green) trajectories + constraint
    markers (yellow = pose-to-pose links, red cubes = absolute poses)."""
    before = np.array([n.pose[:3, 3] for n in nodes_before]).reshape(-1, 3)
    after = np.array([n.pose[:3, 3] for n in nodes_after]).reshape(-1, 3)
    center = after.mean(axis=0) if after.size else np.zeros(3)
    span = float(np.abs(after - center).max()) if after.size else 10.0

    viz = PointViz(width=width, height=height)
    viz.camera = Camera(target=center,
                        distance=max(span * 3.0, 10.0),
                        pitch=-89.0 if top_down else -40.0,
                        yaw=0.0 if top_down else 140.0)
    viz.add(Cloud(before, np.full(len(before), 0.35), palette="grey",
                  point_size=2))
    viz.add(Cloud(after, np.full(len(after), 0.8), palette="viridis",
                  point_size=2))

    drawables: List = [
        Lines(_traj_segments(before), color=(120, 120, 120)),
        Lines(_traj_segments(after), color=(60, 220, 60)),
    ]
    ts_to_after = {n.ts: n for n in nodes_after}
    for c in constraints:
        kind = type(c).__name__
        if kind == "AbsolutePoseConstraint":
            pose = np.eye(4)
            pose[:3, :3] *= max(span * 0.04, 0.2)
            pose[:3, 3] = c.target_pose[:3, 3]
            drawables.append(Cuboid(pose, color=(255, 60, 60)))
        elif kind == "PoseToPoseConstraint":
            a = ts_to_after.get(c.ts1)
            b = ts_to_after.get(c.ts2)
            if a is not None and b is not None:
                drawables.append(Lines(
                    np.array([[a.pose[:3, 3], b.pose[:3, 3]]]),
                    color=(255, 255, 0)))
    drawables.append(Label("pose_optimizer: grey=input green=optimized",
                           np.array([0.01, 0.01])))
    return render_with_drawables(viz, drawables)


def export_po_html(nodes_before: Sequence, nodes_after: Sequence,
                   constraints: Sequence = (),
                   path: str = "po_viz.html") -> str:
    """Interactive WebGL view of the pose graph: grey input trajectory,
    green optimized trajectory, yellow pose-to-pose constraint links,
    red absolute-pose markers (headless stand-in for the reference's
    interactive editor, ref: cli/plugins/source_po_viz.py)."""
    from .html import export_html

    before = np.array([n.pose[:3, 3]
                       for n in nodes_before]).reshape(-1, 3)
    after = np.array([n.pose[:3, 3] for n in nodes_after]).reshape(-1, 3)
    pts = np.concatenate([before, after])
    key = np.concatenate([np.full(len(before), 0.2),
                          np.full(len(after), 0.9)])

    segs: List[np.ndarray] = []
    cols: List = []

    def add_traj(p, color):
        if p.shape[0] >= 2:
            segs.append(np.stack([p[:-1], p[1:]], axis=1))
            cols.append(np.tile(color, (p.shape[0] - 1, 1)))

    add_traj(before, (120, 120, 120))
    add_traj(after, (60, 220, 60))
    ts_to_after = {n.ts: n for n in nodes_after}
    extra_segs = []
    extra_cols = []
    for c in constraints:
        kind = type(c).__name__
        if kind == "PoseToPoseConstraint":
            a = ts_to_after.get(c.ts1)
            b = ts_to_after.get(c.ts2)
            if a is not None and b is not None:
                extra_segs.append(np.array([[a.pose[:3, 3],
                                             b.pose[:3, 3]]]))
                extra_cols.append(np.array([[255, 255, 0]]))
        elif kind == "AbsolutePoseConstraint":
            t = c.target_pose[:3, 3]
            d = 0.3
            for axis in range(3):
                e = np.zeros(3)
                e[axis] = d
                extra_segs.append(np.array([[t - e, t + e]]))
                extra_cols.append(np.array([[255, 60, 60]]))
    segs.extend(extra_segs)
    cols.extend(extra_cols)
    lines = np.concatenate(segs) if segs else None
    line_colors = np.concatenate(cols) if cols else None
    return export_html(path, pts, key, palette="viridis",
                       point_size=4.0,
                       title="pose_optimizer: grey=input green=optimized",
                       lines=lines, line_colors=line_colors)


def save_po_viz_snapshots(nodes_before, nodes_after, constraints,
                          path: str) -> List[str]:
    """Write orbit + top-down PNG snapshots; returns the paths."""
    from ..utils import png as png_codec

    stem, ext = os.path.splitext(path)
    ext = ext or ".png"
    out = []
    for tag, top in (("orbit", False), ("top", True)):
        frame = render_po_viz(nodes_before, nodes_after, constraints,
                              top_down=top)
        p = f"{stem}_{tag}{ext}"
        with open(p, "wb") as f:
            f.write(png_codec.encode(frame, png_codec.COLOR_RGB, 8))
        out.append(p)
    return out
