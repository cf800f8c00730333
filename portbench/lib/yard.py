"""A drive through a yard, ray-cast from the sensor's pose at each column's
own time, so the scans carry the motion of the sweep (a frozen copy of the
smoke run's yard, in numpy alone): ground, nine buildings and a fence,
parked cars, poles and trees, surfaces 5-80 m away. The vehicle speeds up
evenly from rest to `speed` m a frame over `ramp` frames and holds it, on
an arc that turns `yaw_deg` a frame at that speed.

The geometry is the same for every seed, so the ray cast (0.5 s a frame on
one core) is cached by configuration and mix; the seed draws the range
noise, the dropouts, the second returns and the reflectivity.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.lib import synth
from portbench.reference.lut import Lut

HEIGHT = 1.8                       # the sensor above the ground, m
MAX_M = 90.0                       # no return beyond
BUILDINGS = (                      # (x0, x1, y0, y1, height)
    (10.0, 30.0, 14.0, 26.0, 8.0), (35.0, 60.0, -22.0, -9.0, 10.0),
    (-30.0, -12.0, -16.0, 6.0, 6.0), (46.0, 56.0, 22.0, 45.0, 12.0),
    (0.0, 16.0, -28.0, -16.0, 5.0), (68.0, 76.0, -4.0, 16.0, 15.0),
    (-8.0, 4.0, 12.0, 20.0, 7.0), (20.0, 32.0, -30.0, -18.0, 9.0),
    (-20.0, 80.0, -12.5, -12.2, 2.0))


def _parked_cars(seed: int = 11):
    rng = np.random.default_rng(seed)
    cars = []
    for y0, x in [(-5.0, x) for x in np.arange(-20.0, 70.0, 6.5)] + \
            [(9.5, x) for x in np.arange(-20.0, 40.0, 7.0)]:
        if rng.random() < 0.75:
            x0 = x + rng.uniform(-1.0, 1.0)
            cars.append((x0, x0 + 4.5, y0, y0 + 1.8, 1.5))
    return tuple(cars)


BOXES = BUILDINGS + _parked_cars()
POLES = tuple((x, -7.0, 0.2, 6.0) for x in range(-10, 75, 10)) + \
    tuple((x + 5.0, 12.0, 0.3, 4.0) for x in range(-10, 45, 8))   # x, y, r, h


def poses(t: np.ndarray, drive: dict) -> np.ndarray:
    """World poses (len(t), 4, 4) of the sensor at times t, in frames."""
    speed, ramp = drive["speed_m"], drive["ramp_frames"]
    k = np.deg2rad(drive["yaw_deg"]) / speed          # turn a metre
    t = np.asarray(t, np.float64)
    dist = speed * np.where(t < ramp, t * t / (2 * max(ramp, 1)),
                            t - ramp / 2)
    phi = k * dist
    P = np.tile(np.eye(4), (len(t), 1, 1))
    P[:, 0, 0] = P[:, 1, 1] = np.cos(phi)
    P[:, 1, 0], P[:, 0, 1] = np.sin(phi), -np.sin(phi)
    P[:, 0, 3] = np.sin(phi) / k
    P[:, 1, 3] = (1 - np.cos(phi)) / k
    P[:, 2, 3] = HEIGHT
    return P


def _wrap(a: np.ndarray) -> np.ndarray:
    return (a + np.pi) % (2 * np.pi) - np.pi


def _seen(o: np.ndarray, u: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Which rectangles (k, 4: x0, x1, y0, y1) a bundle of rays (origins o,
    unit directions u, (..., 3)) can reach in the xy plane, conservatively."""
    c = o[..., :2].reshape(-1, 2).mean(axis=0)
    spread = np.linalg.norm(o[..., :2].reshape(-1, 2) - c, axis=1).max()
    uh = u[..., :2].reshape(-1, 2)
    if np.linalg.norm(uh, axis=1).min() < 0.1:      # steep rays: no cull
        return np.ones(len(rects), bool)
    az = np.arctan2(uh[:, 1], uh[:, 0])
    mid = np.arctan2(np.sin(az).mean(), np.cos(az).mean())
    rel = _wrap(az - mid)
    lo, hi = rel.min(), rel.max()
    cx = np.stack([rects[:, 0], rects[:, 1], rects[:, 0], rects[:, 1]], 1)
    cy = np.stack([rects[:, 2], rects[:, 2], rects[:, 3], rects[:, 3]], 1)
    ang = _wrap(np.arctan2(cy - c[1], cx - c[0]) - mid)
    dx = np.maximum(np.maximum(rects[:, 0] - c[0], c[0] - rects[:, 1]), 0)
    dy = np.maximum(np.maximum(rects[:, 2] - c[1], c[1] - rects[:, 3]), 0)
    dist = np.hypot(dx, dy)
    near = dist <= 2 * spread + 1e-6
    margin = np.arcsin(np.minimum(1.0, spread / np.maximum(dist, 1e-9)))
    behind = ang.max(axis=1) - ang.min(axis=1) > np.pi   # straddles +-pi
    return near | behind | ((ang.min(axis=1) - margin <= hi)
                            & (ang.max(axis=1) + margin >= lo))


def ray_cast(o: np.ndarray, u: np.ndarray, cols: int = 64) -> np.ndarray:
    """Distance along unit rays u from origins o (both (h, w, 3), world) to
    the first surface, inf where none lies within MAX_M."""
    boxes = np.asarray(BOXES)
    poles = np.asarray(POLES)
    x, y, r = poles[:, 0], poles[:, 1], poles[:, 2]
    pole_rects = np.stack([x - r, x + r, y - r, y + r], 1)
    out = np.empty(u.shape[:-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(0, u.shape[1], cols):
            ob, ub = o[:, k:k + cols], u[:, k:k + cols]
            t = np.full(ub.shape[:-1], np.inf)
            tg = -ob[..., 2] / ub[..., 2]
            t = np.where((ub[..., 2] < 0) & (tg > 0), tg, t)
            bx = boxes[_seen(ob, ub, boxes[:, :4])]
            if len(bx):                              # slabs, all at once
                lo = np.stack([bx[:, 0], bx[:, 2], 0 * bx[:, 0]], -1)
                hi = np.stack([bx[:, 1], bx[:, 3], bx[:, 4]], -1)
                inv = 1.0 / ub[..., None, :]
                ta = (lo - ob[..., None, :]) * inv
                tb = (hi - ob[..., None, :]) * inv
                tn = np.nanmax(np.minimum(ta, tb), axis=-1)
                tf = np.nanmin(np.maximum(ta, tb), axis=-1)
                tn = np.where((tn <= tf) & (tn > 0.05), tn, np.inf)
                t = np.minimum(t, tn.min(axis=-1))
            for cx, cy, r, hgt in poles[_seen(ob, ub, pole_rects)]:
                dx, dy = ob[..., 0] - cx, ob[..., 1] - cy
                a = ub[..., 0] ** 2 + ub[..., 1] ** 2
                b = 2 * (dx * ub[..., 0] + dy * ub[..., 1])
                c = dx * dx + dy * dy - r * r
                disc = b * b - 4 * a * c
                tc = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
                z = ob[..., 2] + tc * ub[..., 2]
                hit = (disc > 0) & (tc > 0.05) & (z >= 0) & (z <= hgt)
                t = np.where(hit, np.minimum(t, tc), t)
            out[:, k:k + cols] = t
    return np.where(out < MAX_M, out, np.inf)


def distances(metadata: dict, drive: dict, n_frames: int) -> np.ndarray:
    """(n_frames, h, w) float32 metres from each pixel's beam origin to the
    yard, inf where nothing is hit: every column cast from its own pose."""
    lut = Lut(metadata)
    origin, step = lut.rays()                 # sensor frame, m and m/mm
    unit = np.linalg.norm(step, axis=-1, keepdims=True)
    u_s = step / unit
    w = origin.shape[1]
    out = np.empty((n_frames,) + origin.shape[:2], np.float32)
    for k in range(n_frames):
        P = poses(k + np.arange(w) / w, drive)   # a pose a column
        R, p = P[:, :3, :3], P[:, :3, 3]
        o = np.einsum("wij,hwj->hwi", R, origin) + p[None]
        u = np.einsum("wij,hwj->hwi", R, u_s)
        out[k] = ray_cast(o, u)
    return out


def cached_distances(path: str, metadata: dict, drive: dict,
                     n_frames: int) -> np.ndarray:
    """distances(), kept at `path` (a fixed path a configuration and mix)
    once made."""
    if os.path.exists(path):
        d = np.load(path)
        if d.shape[0] == n_frames:
            return d
    d = distances(metadata, drive, n_frames)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path + ".partial.npy", d)
    os.replace(path + ".partial.npy", path)
    return d


def truth(drive: dict, n_frames: int, w: int) -> np.ndarray:
    """The world pose of each frame's middle column, (n_frames, 4, 4): the
    pose the SLAM engine registers a frame at."""
    return poses(np.arange(n_frames) + ((w - 1) // 2) / w, drive)


def frame(sensor, dist_m: np.ndarray, data: dict, seed: int, index: int
          ) -> dict:
    """Frame `index` of the drive as synth.random_frame gives frames:
    ranges with `noise_mm` noise and `dropout_share` dropouts, second
    returns 400-600 mm behind on `second_share` of the valid pixels,
    random reflectivity, every column valid."""
    rng = synth.frame_rng(seed, index)
    unit_mm = 1000.0
    d = dist_m.astype(np.float64)
    r_mm = np.where(np.isfinite(d), d * unit_mm
                    + rng.normal(0.0, data["noise_mm"], d.shape), 0.0)
    r_mm[rng.random(d.shape) < data["dropout_share"]] = 0
    r1 = np.clip(np.round(r_mm), 0, (1 << 19) - 1).astype(np.uint32)
    fields = {"RANGE": r1}
    if sensor.dual:
        r2 = r1 + rng.integers(400, 600, r1.shape).astype(np.uint32)
        r2[(r1 == 0) | (rng.random(r1.shape) >= data["second_share"])] = 0
        fields["RANGE2"] = np.minimum(r2, (1 << 19) - 1)
    fields["REFLECTIVITY"] = rng.integers(0, 256, r1.shape, dtype=np.uint32)
    col_ts, pkt_ts = synth.frame_times(sensor, index)
    return {"fields": fields, "status": np.ones(sensor.w, np.uint16),
            "col_ts": col_ts, "pkt_ts": pkt_ts, "frame_id": index + 1}
