"""Zone monitoring: mesh -> range-image bounds LUT + occupancy on the device.

The reference zone pipeline (ref: ouster_client/src/zone_monitor.cpp:527,
zone_lut.h:22, zone_render_mini.cpp): each zone mesh is rendered into
per-pixel [near, far] range bounds along the beam directions (ray casting
once per config change, numpy); live occupancy is then an elementwise
check of the range image against the bounds, `(near <= r) & (r <= far)`
summed per zone (zone_occupancy_device, plain PyTorch on the tensors'
device; zone_occupancy on the host).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.types import SensorInfo
from .zone import Zone, ZoneMode, ZoneSet
from .zrb import Zrb


# f32 machine epsilon: the reference's intersection tolerances are
# float (triangle.cpp:27), kept here even though the math runs in f64
_EPS = float(np.finfo(np.float32).eps)


def ray_triangle_intersect(origins: np.ndarray, dirs: np.ndarray,
                           tris: np.ndarray) -> np.ndarray:
    """Batched Möller-Trumbore (ref: triangle.cpp:26-61
    Triangle::intersect + mesh.cpp:287-296 intersection_distances).

    origins/dirs: (N, 3); tris: (M, 3, 3). Returns (N, M) ray parameters
    t (inf where no positive hit). Boundary tolerances match the
    reference: u/v/(u+v) accepted within f32 epsilon of [0, 1], parallel
    cutoff |det| < f32 epsilon, hits filtered to t > 0.
    """
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    out = np.full((origins.shape[0], tris.shape[0]), np.inf)

    # chunk over triangles to bound memory
    chunk = max(1, int(4e6 // max(origins.shape[0], 1)))
    for s in range(0, tris.shape[0], chunk):
        e1c, e2c, v0c = e1[s:s + chunk], e2[s:s + chunk], v0[s:s + chunk]
        p = np.cross(dirs[:, None, :], e2c[None])          # (N, M, 3)
        det = np.einsum("mc,nmc->nm", e1c, p)
        ok = np.abs(det) >= _EPS
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = origins[:, None, :] - v0c[None]
        u = np.einsum("nmc,nmc->nm", tvec, p) * inv
        q = np.cross(tvec, e1c[None])
        v = np.einsum("nc,nmc->nm", dirs, q) * inv
        t = np.einsum("mc,nmc->nm", e2c, q) * inv
        hit = ok & (u >= -_EPS) & (u <= 1 + _EPS) & (v >= -_EPS) \
            & (u + v <= 1 + _EPS) & (t > 0)
        out[:, s:s + chunk] = np.where(hit, t, np.inf)
    return out


def closest_and_farthest_intersections(
        origins: np.ndarray, dirs: np.ndarray,
        tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-ray (near, far, n_hits) over all positive intersections
    (ref: mesh.cpp:270-285 Mesh::closest_and_farthest_intersections):
    >= 2 hits -> (min, max); exactly 1 hit -> (0, hit) — the ray starts
    inside or the mesh is open; 0 hits -> (0, 0)."""
    t = ray_triangle_intersect(origins, dirs, tris)
    finite = np.isfinite(t)
    n = finite.sum(axis=1)
    near = np.where(n > 0, np.min(t, axis=1), 0.0)
    far = np.where(
        n > 0, np.max(np.where(finite, t, -np.inf), axis=1), 0.0)
    near = np.where(n == 1, 0.0, near)
    return near, far, n


def render_zone_to_zrb(stl, config) -> Tuple[Zrb, int]:
    """Core zone render: cast every beam of the BeamConfig through the
    STL mesh and build the Zrb (ref: zone.cpp:63-127 Zone::render).
    Returns (zrb, pixels_with_intersections)."""
    import hashlib

    from .zone import CoordinateFrame

    tris = stl.to_mesh()
    lut = (config.lut
           if stl.coordinate_frame == CoordinateFrame.BODY
           else config.lut_no_sensor_to_body_transform)
    # LUT direction magnitude is range_unit (0.001): x1000 gives unit
    # beams so t is in meters (ref: zone.cpp:96-98 direction * 1000.f)
    dirs = lut.direction.reshape(-1, 3) * 1000.0
    origins = lut.offset.reshape(-1, 3)

    near, far, n = closest_and_farthest_intersections(origins, dirs, tris)
    near_mm = np.round(near * 1000.0)
    far_mm = np.round(far * 1000.0)
    if near_mm.max(initial=0) > 0xFFFFFFFF or \
            far_mm.max(initial=0) > 0xFFFFFFFF:
        raise ValueError("Zone::render: range overflow")

    zrb = Zrb(config.n_rows, config.n_cols, config.m_per_zmbin,
              serial_number=config.serial_number,
              stl_hash=hashlib.sha256(stl._data).digest(),
              beam_to_lidar=config.beam_to_lidar_transform,
              lidar_to_sensor=config.lidar_to_sensor_transform,
              sensor_to_body=config.sensor_to_body_transform)
    shape = (config.n_rows, config.n_cols)
    zrb.near_range_mm = near_mm.astype(np.uint32).reshape(shape)
    zrb.far_range_mm = far_mm.astype(np.uint32).reshape(shape)
    return zrb, int((n > 0).sum())


def render_zone_bounds(zone: Zone, info: SensorInfo,
                       m_per_zmbin: Optional[float] = None,
                       sensor_to_body: Optional[np.ndarray] = None) -> Zrb:
    """Render a zone mesh to per-pixel near/far bounds using the
    sensor's own geometry (ref: zone_render_mini.cpp). Convenience
    wrapper over Zone.render/BeamConfig."""
    from .zone import BeamConfig

    config = BeamConfig.from_sensor_info(
        info, sensor_to_body_transform=sensor_to_body,
        m_per_zmbin=m_per_zmbin)
    zone.render(config)
    return zone.zrb


def zone_occupancy(range_img: np.ndarray, zrb: Zrb,
                   min_range_mm: int = 0) -> Tuple[int, np.ndarray]:
    """Host check: points inside the zone bounds
    (ref: zone_monitor.cpp occupancy counting). Returns (count, mask)."""
    r = range_img.astype(np.uint32)
    inside = (r > 0) & (r >= np.maximum(zrb.near_range_mm, min_range_mm)) \
        & (r <= zrb.far_range_mm) & (zrb.far_range_mm > 0)
    return int(inside.sum()), inside


def _u32_values(a, device: torch.device) -> torch.Tensor:
    """`a` (numpy or a tensor) as its uint32 values in int64 on `device`:
    torch has no uint32 comparisons on the CPU, and int64 keeps a bound of
    2**32 - 1 unsigned. Numpy crosses to the device as 32-bit words."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint32:
            a = a.view(torch.int32)
        return a.to(device).to(torch.int64) & 0xFFFFFFFF
    w = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    return torch.from_numpy(w.view(np.int32)).to(device).to(torch.int64) \
        & 0xFFFFFFFF


def zone_occupancy_device(range_img, near_mm, far_mm,
                          device=None) -> torch.Tensor:
    """Device check: elementwise bounds test + per-zone reduction, the
    counterpart of the JAX package's zone_occupancy_jax (a jnp program; no
    Pallas kernel stands behind it).

    range_img: (H, W) and near/far: (Z, H, W), uint32 values (numpy arrays
    or tensors). Returns the (Z,) int32 occupancy counts on `device`: the
    one named, else that of the first tensor argument, else CUDA (raises
    without a GPU)."""
    from ..ops.pose import _device_of

    dev = _device_of(device, range_img, near_mm, far_mm)
    r = _u32_values(range_img, dev)[None]
    near, far = _u32_values(near_mm, dev), _u32_values(far_mm, dev)
    inside = (r > 0) & (r >= near) & (r <= far) & (far > 0)
    return inside.sum(dim=(1, 2), dtype=torch.int32)


MAX_ACTIVE_ZONES = 16
MAX_AVAILABLE_ZONES = 128


class EmulatedZoneMon:
    """Off-sensor zone-monitor emulation: per-frame occupancy /
    occlusion / invalid counts, trigger hysteresis (frame_count
    consecutive frames before alerting), per-pixel ZONE_MASK bits for
    live zones, and ZoneState records identical to the sensor's zone
    packets (ref: sdk/zone_monitor/zone_common.py:14 EmulatedZoneMon)."""

    def __init__(self, zone_set: ZoneSet,
                 info: Optional[SensorInfo] = None,
                 zrbs: Optional[Dict[int, Zrb]] = None,
                 m_per_zmbin: float = 0.004):
        if not zone_set.zones:
            raise ValueError("ZoneSet must have at least one zone defined")
        self.zone_set = zone_set
        self.zones = dict(zone_set.zones)
        if zrbs is not None:
            self.rendered_zones = zrbs
        elif all(z.zrb is not None for z in self.zones.values()):
            # reference-style use: pre-rendered ZRBs travel on the zones
            # (ref: zone_common.py:37-40)
            self.rendered_zones = {
                zid: z.zrb for zid, z in self.zones.items()}
        elif info is not None:
            self.rendered_zones = {
                zid: render_zone_bounds(
                    z, info, m_per_zmbin,
                    sensor_to_body=zone_set.sensor_to_body_transform)
                for zid, z in self.zones.items()}
        else:
            raise ValueError(
                "EmulatedZoneMon: all zones in ZoneSet must have a valid "
                "ZRB")
        #: legacy alias kept for earlier-round callers
        self.rendered = self.rendered_zones
        self.live_zones: List[int] = zone_set.live_ids
        self.zone_triggers = [0] * MAX_AVAILABLE_ZONES
        self.zone_alerts = [0] * MAX_AVAILABLE_ZONES
        self.triggered_zone_ids: List[int] = []
        self.zone_counts: Dict[int, int] = {}
        self.occlusion_counts: Dict[int, int] = {}
        self.invalid_counts: Dict[int, int] = {}
        self.zone_mins: Dict[int, int] = {}
        self.zone_maxes: Dict[int, int] = {}
        self.zone_avgs: Dict[int, int] = {}
        #: frame counter surfaced by the reference (zone_common.py:36;
        #: initialized and never advanced there — kept live here)
        self.update_count = 0
        #: verbose trigger logging toggle (ref: zone_common.py:41)
        self.debug = False
        self.max_counts: Dict[int, int] = {
            zid: int(np.count_nonzero(zrb.near_range_mm < zrb.far_range_mm))
            for zid, zrb in self.rendered_zones.items()}

    def set_live_zones(self, live_zones: List[int]) -> None:
        # reset hysteresis for zones leaving the live set, else a
        # previously-triggered zone stays in triggered_zone_ids forever
        for zid in self.live_zones:
            if zid not in live_zones:
                self.zone_triggers[zid] = 0
                self.zone_alerts[zid] = 0
        self.triggered_zone_ids = [
            z for z in self.triggered_zone_ids if z in live_zones]
        self.live_zones = list(live_zones)

    def calc_triggers(self, range_field: np.ndarray,
                      bitmask_field: Optional[np.ndarray] = None) -> None:
        """One frame update: counts + hysteresis; sets bit (1 << live
        index) in bitmask_field for pixels inside each live zone."""
        self.update_count += 1
        for zid, zone in self.zones.items():
            if zid not in self.live_zones:
                continue
            zrb = self.rendered_zones[zid]
            # pure ZRB bounds test — no min/max-range clamp, exactly
            # like the reference (zone_common.py:59-62 trigger_mask)
            inside = (range_field > 0) & \
                (zrb.near_range_mm <= range_field) & \
                (range_field <= zrb.far_range_mm)
            self.zone_counts[zid] = int(np.count_nonzero(inside))
            self.invalid_counts[zid] = int(np.count_nonzero(
                (range_field == 0) & (zrb.near_range_mm > 0)))
            self.occlusion_counts[zid] = int(np.count_nonzero(
                (range_field > 0) & (range_field <= zrb.near_range_mm)))
            pts = range_field[inside]
            self.zone_avgs[zid] = int(pts.mean()) if pts.size else 0
            self.zone_mins[zid] = int(pts.min()) if pts.size else 0
            self.zone_maxes[zid] = int(pts.max()) if pts.size else 0
            if bitmask_field is not None:
                bitmask_field[inside] |= np.array(
                    1 << self.live_zones.index(zid),
                    dtype=bitmask_field.dtype)
            occupied = self.zone_counts[zid] >= zone.min_points
            if (occupied and zone.mode == ZoneMode.OCCUPANCY) or \
                    (not occupied and zone.mode == ZoneMode.VACANCY):
                self.zone_triggers[zid] += 1
            else:
                self.zone_triggers[zid] = 0
            if self.zone_triggers[zid] >= zone.frame_count:
                self.zone_alerts[zid] += 1
            else:
                self.zone_alerts[zid] = 0
        self.triggered_zone_ids = [
            zid for zid, alerts in enumerate(self.zone_alerts) if alerts > 0]

    def get_packet(self) -> np.recarray:
        """(16,) ZoneState records, inactive slots id=255
        (ref: zone_common.py get_packet)."""
        from ..core.field import ZONE_STATE_DTYPE

        zmu = np.zeros((MAX_ACTIVE_ZONES,), dtype=ZONE_STATE_DTYPE)
        for k in range(MAX_ACTIVE_ZONES):
            if k < len(self.live_zones):
                zid = self.live_zones[k]
                rec = zmu[k]
                rec["live"] = 1
                rec["id"] = zid
                rec["count"] = self.zone_counts.get(zid, 0)
                rec["occlusion_count"] = self.occlusion_counts.get(zid, 0)
                rec["invalid_count"] = self.invalid_counts.get(zid, 0)
                rec["max_count"] = self.max_counts.get(zid, 0)
                rec["trigger_status"] = self.zone_alerts[zid] > 0
                rec["trigger_type"] = self.zones[zid].mode.value
                rec["triggered_frames"] = self.zone_alerts[zid]
                rec["min_range"] = self.zone_mins.get(zid, 0)
                rec["max_range"] = self.zone_maxes.get(zid, 0)
                rec["mean_range"] = self.zone_avgs.get(zid, 0)
            else:
                zmu[k]["id"] = 255
        return zmu.view(np.recarray)


class ZoneMonitor:
    """Evaluate a ZoneSet against incoming scans
    (ref: zone_monitor.cpp:527)."""

    def __init__(self, zone_set: ZoneSet, info: SensorInfo,
                 m_per_zmbin: float = 0.004):
        self.zone_set = zone_set
        self.info = info
        self.zrbs: Dict[int, Zrb] = {
            zid: render_zone_bounds(
                z, info, m_per_zmbin,
                sensor_to_body=zone_set.sensor_to_body_transform)
            for zid, z in zone_set.zones.items()}

    def check_scan(self, scan) -> Dict[int, int]:
        """Per-zone occupancy counts for a LidarScan."""
        from ..core.constants import ChanField

        rng = scan.field(ChanField.RANGE)
        out: Dict[int, int] = {}
        for zid, z in self.zone_set.zones.items():
            zrb = self.zrbs[zid]
            count, _ = zone_occupancy(
                rng, zrb, min_range_mm=int(z.min_range_m * 1000))
            out[zid] = count
        return out


class ZoneState:
    """Per-zone occupancy statistics record view
    (ref: zone_state.h; python binding zone_monitor.cpp:49-64). Wraps
    one ZONE_STATE_DTYPE element (the wire record parsed from zone
    packets) with attribute access."""

    _FIELDS = ("live", "id", "error_flags", "trigger_type",
               "trigger_status", "triggered_frames", "count",
               "occlusion_count", "invalid_count", "max_count",
               "min_range", "max_range", "mean_range")

    def __init__(self, record=None, **kwargs):
        from ..core.field import ZONE_STATE_DTYPE

        if record is None:
            record = np.zeros((), dtype=ZONE_STATE_DTYPE)
        self._rec = np.asarray(record).reshape(())
        for k, v in kwargs.items():
            setattr(self, k, v)

    @staticmethod
    def dtype() -> np.dtype:
        from ..core.field import ZONE_STATE_DTYPE

        return ZONE_STATE_DTYPE

    def __getattr__(self, name):
        if name in ZoneState._FIELDS:
            return self._rec[name][()]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in ZoneState._FIELDS:
            self._rec[name] = value
        else:
            object.__setattr__(self, name, value)

    def __repr__(self) -> str:
        vals = ", ".join(f"{k}={getattr(self, k)}"
                         for k in ZoneState._FIELDS)
        return f"ZoneState({vals})"
