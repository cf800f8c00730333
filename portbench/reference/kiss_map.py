"""The map side of KISS-ICP in plain float64 Python and numpy, written from
KISS-ICP (Vizzo et al., "KISS-ICP", RA-L 2023) and its Preprocessing.cpp,
VoxelUtils.cpp, Threshold.cpp and VoxelHashMap.cpp:

  - crop: the points whose norm lies strictly between min and max range;
  - downsample: the first point of each voxel, in the frame's order;
  - the adaptive threshold: sigma = sqrt(sse / n), starting from the
    initial threshold's square and one sample, each registration adding
    its model error |t| + 2 max_range sin(theta / 2) where that exceeds
    the least motion;
  - the map: a voxel holds at most `max_points` points; a point enters
    its voxel unless the voxel is full or holds a point nearer than
    sqrt(voxel^2 / max_points); a voxel goes once its first point lies
    `max_distance` or farther from the sensor's position.

A voxel is keyed by the floor of its points over the voxel's edge.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

Voxels = Dict[Tuple[int, int, int], List[List[float]]]


def crop(points: np.ndarray, min_range: float, max_range: float
         ) -> np.ndarray:
    d = np.linalg.norm(points, axis=1)
    return points[(d > min_range) & (d < max_range)]


def downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """The first point of each voxel of edge `voxel`, in order."""
    if len(points) == 0:
        return points.reshape(0, 3)
    keys = np.floor(points / voxel).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(first)]


def threshold(history: Sequence[Tuple[np.ndarray, np.ndarray]],
              initial: float, min_motion: float, max_range: float) -> float:
    """sigma after the registrations `history`, each (initial guess,
    registered pose)."""
    sse, n = initial * initial, 1
    for guess, pose in history:
        dev = np.linalg.inv(guess) @ pose
        cos = min(max((np.trace(dev[:3, :3]) - 1.0) / 2.0, -1.0), 1.0)
        error = float(np.linalg.norm(dev[:3, 3])) \
            + 2.0 * max_range * math.sin(math.acos(cos) / 2.0)
        if error > min_motion:
            sse += error * error
            n += 1
    return math.sqrt(sse / n)


def voxels_of(counts: np.ndarray, points: np.ndarray, voxel: float
              ) -> Tuple[Voxels, int]:
    """(voxels, how many voxels hold a point of another voxel) of a map
    given as each voxel's point count and its points, in order."""
    out: Voxels = {}
    wrong = 0
    keys = np.floor(points / voxel).astype(np.int64).tolist()
    pts = points.tolist()
    at = 0
    for c in counts.tolist():
        key = tuple(keys[at])
        if key in out or any(tuple(k) != key for k in keys[at:at + c]):
            wrong += 1
        else:
            out[key] = pts[at:at + c]
        at += c
    return out, wrong


def update(voxels: Voxels, points: np.ndarray, pose: np.ndarray,
           voxel: float, max_points: int, max_distance: float) -> Voxels:
    """The map after VoxelHashMap::Update(points, pose): a new dict, the
    given one left as it was."""
    out = {k: list(v) for k, v in voxels.items()}
    world = points @ pose[:3, :3].T + pose[:3, 3]
    res = math.sqrt(voxel * voxel / max_points)
    for p in world.tolist():
        key = (math.floor(p[0] / voxel), math.floor(p[1] / voxel),
               math.floor(p[2] / voxel))
        pts = out.get(key)
        if pts is None:
            out[key] = [p]
        elif len(pts) < max_points and all(math.dist(q, p) >= res
                                           for q in pts):
            pts.append(p)
    origin = pose[:3, 3].tolist()
    for key in [k for k, v in out.items()
                if math.dist(v[0], origin) >= max_distance]:
        del out[key]
    return out


def difference(got: Voxels, want: Voxels) -> Tuple[int, float]:
    """(voxels in one map and not the other, or holding another number
    of points; the largest distance between a voxel's point and the same
    point of the other map, m)."""
    wrong, worst = len(got.keys() ^ want.keys()), 0.0
    for key in got.keys() & want.keys():
        a, b = got[key], want[key]
        if len(a) != len(b):
            wrong += 1
            continue
        worst = max(worst, max(math.dist(p, q) for p, q in zip(a, b)))
    return wrong, worst
