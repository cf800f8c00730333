"""Zone / ZoneSet configuration model + STL mesh loading.

The reference zone config (ref: ouster_client/include/ouster/
zone.h:24, zone_monitor.h:42, stl.h, mesh.h): a Zone is a triangle-mesh
volume with a mode and filter parameters; a ZoneSet is pushed to the sensor
as a zip of config json + STL meshes (ref: sensor_http.h:401-461).
A numpy copy of the JAX package's zone/zone.py: zips, hashes and rendered
bounds are byte-identical; rendering takes this package's make_xyz_lut.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import struct
import zipfile
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class ZoneMode(Enum):
    """(ref: zone.h:36-42: NONE=0, OCCUPANCY=1, VACANCY=2)"""

    NONE = 0
    OCCUPANCY = 1
    VACANCY = 2


class ZoneError(ValueError, RuntimeError):
    """Zone/ZoneSet validation failure.

    Dual-typed: the reference's C++ invariant checks surface in Python
    as RuntimeError (ref: python/tests/test_zone_monitor.py:424-485
    pytest.raises(RuntimeError)), while this package's earlier tests
    match ValueError — both catch this.
    """


def load_stl(data_or_path) -> np.ndarray:
    """Load a binary or ASCII STL into (n_tris, 3, 3) float64 vertices
    (ref: ouster_client stl.cpp, mesh.cpp load_from_stl_stream:218-235).

    Format sniff follows the reference: the first line is lowercased and
    the file is ASCII iff it contains "solid"; otherwise binary.
    """
    if isinstance(data_or_path, (bytes, bytearray)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()

    # sniff on the first NON-BLANK line, like read_stl_ascii_line
    first_line = b""
    for ln in data.split(b"\n"):
        if ln.strip():
            first_line = ln.lower()
            break
    if not first_line:
        raise ValueError("STL file too short.")
    if b"solid" in first_line:
        return _load_stl_ascii(data)

    if len(data) < 84:
        raise ValueError("not an STL file")
    n = struct.unpack_from("<I", data, 80)[0]
    if len(data) < 84 + n * 50:
        raise ValueError("truncated binary STL")
    rec = np.frombuffer(data, dtype=np.dtype([
        ("normal", "<f4", (3,)), ("v", "<f4", (3, 3)),
        ("attr", "<u2")]), count=n, offset=84)
    return rec["v"].astype(np.float64)


_VERTEX_RE = re.compile(
    r"^\s*vertex\s+(-?[0-9.]+(?:[eE][+-]\d+)?)"
    r"\s+(-?[0-9.]+(?:[eE][+-]\d+)?)"
    r"\s+(-?[0-9.]+(?:[eE][+-]\d+)?)")


def _load_stl_ascii(data: bytes) -> np.ndarray:
    """Strict ASCII STL grammar, mirroring the reference parser
    (ref: mesh.cpp load_from_stl_ascii / load_from_stl_ascii_facet):
    solid header; facets of 'outer loop', 3x vertex, 'endloop',
    'endfacet'; terminated by 'endsolid'. Blank lines skipped."""
    lines = [ln for ln in data.decode(errors="replace").splitlines()
             if ln.strip()]
    it = iter(lines)

    def next_line(err: str) -> str:
        try:
            return next(it)
        except StopIteration:
            raise ValueError(err) from None

    if not re.search(r"^\s*solid\b", next_line(
            "STL parse: failed to find 'solid' header")):
        raise ValueError("STL parse: failed to find 'solid' header")

    verts: List[List[float]] = []
    for line in it:
        if re.search(r"^\s*endsolid\b", line):
            arr = np.asarray(verts, dtype=np.float64)
            return arr.reshape(-1, 3, 3)
        if not re.search(r"^\s*facet\b", line):
            raise ValueError(
                "STL parse: unexpected line outside of a facet: " + line)
        if not re.search(r"^\s*outer\s+loop",
                         next_line("STL parse: expected 'outer loop'")):
            raise ValueError("STL parse: expected 'outer loop'")
        for _ in range(3):
            m = _VERTEX_RE.search(
                next_line("STL parse: expected 'vertex'"))
            if not m:
                raise ValueError("STL parse: expected 'vertex'")
            verts.append([float(m.group(1)), float(m.group(2)),
                          float(m.group(3))])
        if not re.search(r"^\s*endloop",
                         next_line("STL parse: expected 'endloop'")):
            raise ValueError("STL parse: expected 'endloop'")
        if not re.search(r"^\s*endfacet",
                         next_line("STL parse: expected 'endfacet'")):
            raise ValueError("STL parse: expected 'endfacet'")
    raise ValueError(
        "STL parse: file ended unexpectedly without 'endsolid'")


def save_stl(path_or_buf, triangles: np.ndarray) -> Optional[bytes]:
    """Write binary STL."""
    tris = np.asarray(triangles, dtype=np.float32).reshape(-1, 3, 3)
    rec = np.zeros(len(tris), dtype=np.dtype([
        ("normal", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]))
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    mag = np.linalg.norm(n, axis=1, keepdims=True)
    rec["normal"] = np.where(mag > 0, n / np.maximum(mag, 1e-30), 0)
    rec["v"] = tris
    blob = b"\x00" * 80 + struct.pack("<I", len(tris)) + rec.tobytes()
    if isinstance(path_or_buf, str):
        with open(path_or_buf, "wb") as f:
            f.write(blob)
        return None
    return blob


@dataclass
class Zone:
    """(ref: zone.h:24; default-constructible like client.pyi:1843)"""

    id: int = 0
    name: str = ""
    mode: ZoneMode = ZoneMode.OCCUPANCY
    triangles: np.ndarray = dc_field(
        default_factory=lambda: np.zeros((0, 3, 3)))
    min_points: int = 1
    frame_count: int = 1   # consecutive triggered frames before alerting
    min_range_m: float = 0.0
    max_range_m: float = 200.0
    #: source mesh handle; when set its triangles/coordinate frame drive
    #: render() (ref: zone.h stl member)
    stl: Optional["Stl"] = None
    #: rendered near/far bounds, populated by render() (ref: zone.h zrb)
    zrb: Optional["Zrb"] = None

    @property
    def point_count(self) -> int:
        """Reference name for the occupancy point threshold
        (ref: zone.h point_count == our min_points)."""
        return self.min_points

    @point_count.setter
    def point_count(self, v: int) -> None:
        self.min_points = int(v)

    @property
    def label(self) -> str:
        """Reference name for the zone's display label
        (ref: zone_monitor.cpp metadata "label" key == our name)."""
        return self.name

    @label.setter
    def label(self, v: str) -> None:
        self.name = str(v)

    def mesh_hash(self) -> bytes:
        """Identity hash of the zone's effective mesh: the attached
        STL's triangles when present, else the raw triangles array.
        Keeps a freshly-authored zone (mesh only on .stl) equal to its
        zip round-trip (mesh mirrored into .triangles)."""
        tris = self.triangles
        if self.stl is not None:
            tris = self.stl.to_mesh()
        return hashlib.sha256(
            np.ascontiguousarray(tris,
                                 dtype=np.float32).tobytes()).digest()

    def _ensure_stl(self) -> None:
        """Materialize an Stl handle from raw triangles so
        serialization/render can treat every zone uniformly."""
        if self.stl is None and self.triangles is not None \
                and self.triangles.size:
            self.stl = Stl(save_stl(None, self.triangles),
                           coordinate_frame=CoordinateFrame.BODY)

    def check_invariants(self) -> None:
        """(ref: zone.cpp:17-46 Zone::check_invariants)"""
        if self.min_points == 0:
            raise ZoneError("Zone: point_count must be in [1, 262143]")
        if self.frame_count == 0:
            raise ZoneError("Zone: frame_count must be in [1, 65535]")
        has_tris = self.triangles is not None and self.triangles.size > 0
        if self.stl is None and self.zrb is None and not has_tris:
            raise ZoneError("Zone: must have either STL or ZRB")
        if self.mode not in (ZoneMode.OCCUPANCY, ZoneMode.VACANCY):
            raise ZoneError("Zone: mode must be OCCUPANCY or VACANCY")
        if self.stl is not None:
            if not self.stl._data:
                raise ZoneError("Zone: STL blob cannot be empty")
            if self.stl.coordinate_frame == CoordinateFrame.NONE:
                raise ZoneError(
                    "Zone: STL coordinate frame must be BODY or SENSOR")
        if self.zrb is not None:
            if int((self.zrb.far_range_mm != 0).sum()) < self.min_points:
                raise ZoneError(
                    "Zone: ZRB far range image has fewer nonzero pixels "
                    "than point_count")

    def render(self, beam_config: "BeamConfig") -> bool:
        """Ray-cast the zone mesh into per-pixel near/far bounds,
        stored in self.zrb (ref: zone.cpp:63-127 Zone::render).
        Returns True iff any beam intersected the mesh."""
        from .monitor import render_zone_to_zrb

        self.check_invariants()
        stl = self.stl
        if stl is None:
            if self.triangles is None or self.triangles.size == 0:
                return False
            blob = save_stl(None, self.triangles)
            stl = Stl(blob, coordinate_frame=CoordinateFrame.BODY)
        tris = stl.to_mesh()
        if tris.shape[0] == 0:
            return False
        zrb, n_hit = render_zone_to_zrb(stl, beam_config)
        self.zrb = zrb  # assigned even when nothing intersects (zone.cpp:75)
        if 0 < n_hit < self.min_points:
            raise ZoneError(
                f"Zone: area of rendered zone ({n_hit}) is smaller than "
                f"point_count ({self.min_points}) specified in zone.")
        return n_hit > 0

    @classmethod
    def box(cls, zone_id: int, center, size, name: str = "") -> "Zone":
        """Axis-aligned box helper for tests/config authoring."""
        c = np.asarray(center, dtype=np.float64)
        s = np.asarray(size, dtype=np.float64) / 2
        corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                            for sy in (-1, 1) for sz in (-1, 1)])
        v = c + corners * s
        faces = [
            (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
            (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
            (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),
        ]
        tris = np.stack([v[list(f)] for f in faces])
        return cls(zone_id, name=name or f"box{zone_id}", triangles=tris)


class ZoneSetOutputFilter(Enum):
    """What a serialized zone set carries
    (ref: client.pyi:1854 ZoneSetOutputFilter STL/ZRB/STL_AND_ZRB)."""

    STL = 1
    ZRB = 2
    STL_AND_ZRB = 3


class ZoneSet:
    """Zone-monitor configuration: zones keyed by id, a power-on live
    set, and the body-frame extrinsics; serialized as the sensor-facing
    zip of metadata.json + per-zone STL/ZRB entries
    (ref: zone_monitor.h:42, zone_monitor.cpp:216-527).
    """

    def __init__(self, zones=None,
                 power_on_live_ids: Optional[List[int]] = None,
                 sensor_to_body_transform: Optional[np.ndarray] = None,
                 label: str = ""):
        from .zrb import DEFAULT_M_PER_ZMBIN

        self.m_per_zmbin = DEFAULT_M_PER_ZMBIN
        self.zones: Dict[int, Zone] = {}
        if isinstance(zones, (str, bytes, bytearray)):
            # ZoneSet(path) / ZoneSet(zip_bytes) (ref: client.pyi:1866)
            src = ZoneSet.from_zip(zones if isinstance(zones, str)
                                   else bytes(zones))
            self.zones = src.zones
            self.power_on_live_ids = src.power_on_live_ids
            self.sensor_to_body_transform = src.sensor_to_body_transform
            self.label = src.label
            return
        if isinstance(zones, dict):
            self.zones = {int(k): v for k, v in zones.items()}
        elif zones:
            for z in zones:
                self.zones[int(z.id)] = z
        self.power_on_live_ids = (None if power_on_live_ids is None
                                  else list(power_on_live_ids))
        self.sensor_to_body_transform = sensor_to_body_transform
        self.label = label

    # -------------------------------------------------------------- views
    @property
    def live_ids(self) -> List[int]:
        """power_on_live_ids, defaulting to every configured zone."""
        if self.power_on_live_ids is not None:
            return list(self.power_on_live_ids)
        return sorted(self.zones)

    def hash(self) -> bytes:
        h = hashlib.sha256()
        for zid in sorted(self.zones):
            z = self.zones[zid]
            h.update(struct.pack("<IB", zid, z.mode.value))
            h.update(z.mesh_hash())
        return h.digest()

    def __eq__(self, other: object) -> bool:
        """(ref: zone_monitor.cpp operator== — zones, live ids, s2b).
        Comparing against a non-ZoneSet raises TypeError, matching the
        reference binding (python/tests/test_zone_monitor.py:487-497
        'comparing to None currently raises TypeError')."""
        if not isinstance(other, ZoneSet):
            raise TypeError(
                "ZoneSet.__eq__: cannot compare ZoneSet with "
                f"{type(other).__name__}")
        if set(self.zones) != set(other.zones):
            return False
        for zid, z in self.zones.items():
            o = other.zones[zid]
            if (z.mode != o.mode or z.min_points != o.min_points
                    or z.frame_count != o.frame_count
                    or z.mesh_hash() != o.mesh_hash()):
                return False
        a = (np.eye(4) if self.sensor_to_body_transform is None
             else self.sensor_to_body_transform)
        b = (np.eye(4) if other.sensor_to_body_transform is None
             else other.sensor_to_body_transform)
        return (self.live_ids == other.live_ids
                and np.array_equal(a, b))

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    # --------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """(ref: zone_monitor.cpp:297-335 ZoneSet::check_invariants +
        the metadata JSON-schema domain checks that precede it)"""
        if self.sensor_to_body_transform is None or \
                not np.asarray(self.sensor_to_body_transform).any():
            raise ZoneError(
                "ZoneSet: sensor_to_body_transform must be set.")
        # zone ids and live ids are schema-bounded to [0, 127]; the
        # error texts replicate the reference's json-schema validator
        # (ref: python/tests/test_zone_monitor.py:456-485)
        for zid in sorted(self.zones):
            if not 0 <= int(zid) <= 127:
                raise ZoneError(
                    f'Additional property "{zid}" found but was '
                    "invalid.")
        for lid in (self.power_on_live_ids or []):
            if int(lid) > 127:
                raise ZoneError(f"{lid} exceeds maximum of 127")
            if int(lid) < 0:
                raise ZoneError(f"{lid} is below minimum of 0")
        first_shape = None
        for zid in sorted(self.zones):
            zone = self.zones[zid]
            zone._ensure_stl()
            try:
                zone.check_invariants()
            except Exception as exc:
                raise ZoneError(
                    f"ZoneSet: Zone {zid} failed invariant check: "
                    f"{exc}") from exc
            if zone.stl is None and zone.zrb is None:
                raise ZoneError(
                    "ZoneSet: all Zones must have either an STL or ZRB "
                    "file.")
            if zone.zrb is not None:
                shape = zone.zrb.near_range_mm.shape
                if first_shape is None:
                    first_shape = shape
                elif shape != first_shape:
                    raise ZoneError(
                        "ZoneSet: all ZRBs must have the same "
                        "resolution.")

    # ------------------------------------------------------------- render
    def render(self, sensor_info) -> None:
        """Render every STL zone into its ZRB against the sensor's beam
        geometry (ref: zone_monitor.cpp:367-418 ZoneSet::render)."""
        from .zrb import DEFAULT_M_PER_ZMBIN

        if self.sensor_to_body_transform is None or \
                not np.asarray(self.sensor_to_body_transform).any():
            # surfaces as the BeamConfig validation error, like the
            # reference (zone_monitor_test.cpp:41-71)
            beam_config = BeamConfig.from_sensor_info(
                sensor_info,
                sensor_to_body_transform=np.zeros((4, 4)))
        else:
            beam_config = BeamConfig.from_sensor_info(
                sensor_info,
                sensor_to_body_transform=self.sensor_to_body_transform,
                m_per_zmbin=getattr(self, "m_per_zmbin",
                                    DEFAULT_M_PER_ZMBIN))
        for zid in sorted(self.zones):
            zone = self.zones[zid]
            zone._ensure_stl()
            if zone.zrb is not None and zone.stl is None:
                continue  # "rendering not required" (zone_monitor.cpp:384)
            if not zone.render(beam_config):
                raise RuntimeError(
                    f"ZoneSet::render: zone {zid} was out of sensor "
                    "FOV.")
            zone.zrb.serial_number = sensor_info.sn
        # zones with pre-existing ZRBs still get the sensor serial
        for zone in self.zones.values():
            if zone.zrb is not None:
                zone.zrb.serial_number = sensor_info.sn

    # -------------------------------------------------------- serialization
    def to_json(self,
                zone_set_output=ZoneSetOutputFilter.STL) -> str:
        """metadata.json content (ref: zone_monitor.cpp:469-516
        ZoneSet::to_json). Calls check_invariants()."""
        self.check_invariants()
        zones_json: Dict[str, Any] = {}
        for zid in sorted(self.zones):
            z = self.zones[zid]
            zj: Dict[str, Any] = {
                "point_count": z.min_points,
                "frame_count": z.frame_count,
                "mode": z.mode.name,
                "label": z.name,
            }
            if z.stl is not None and \
                    zone_set_output != ZoneSetOutputFilter.ZRB:
                zj["stl"] = {
                    "file_name": z.stl.filename_or_default(zid),
                    "coordinate_frame": z.stl.coordinate_frame.name,
                    "hash": z.stl.hash,
                }
            if z.zrb is not None and \
                    zone_set_output != ZoneSetOutputFilter.STL:
                zj["zrb"] = {
                    "file_name": f"{zid}.zrb",
                    "hash": hashlib.sha256(z.zrb.blob()).hexdigest(),
                }
            zones_json[str(zid)] = zj
        out: Dict[str, Any] = {
            "label": self.label,
            "version": {"metadata": 1, "file_naming": 1},
            "power_on_live_ids": self.live_ids,
            "zones": zones_json,
            "sensor_to_body_transform": np.asarray(
                self.sensor_to_body_transform,
                dtype=np.float64).reshape(-1).tolist(),
        }
        return json.dumps(out, indent=2)

    def to_zip_blob(self,
                    zone_set_output=ZoneSetOutputFilter.STL) -> bytes:
        """The sensor-facing zip: metadata.json + <id>.stl / <id>.zrb
        entries (ref: zone_monitor.cpp:420-458)."""
        metadata = self.to_json(zone_set_output)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("metadata.json", metadata)
            for zid in sorted(self.zones):
                z = self.zones[zid]
                if z.stl is not None and \
                        zone_set_output != ZoneSetOutputFilter.ZRB:
                    blob = z.stl._data
                    if not blob:
                        raise RuntimeError(
                            f"Zone {zid} has an empty stl blob")
                    zf.writestr(z.stl.filename_or_default(zid), blob)
                if z.zrb is not None and \
                        zone_set_output != ZoneSetOutputFilter.STL:
                    zf.writestr(f"{zid}.zrb", z.zrb.blob())
        return buf.getvalue()

    def to_zip(self) -> bytes:
        """Convenience alias of to_zip_blob(STL)."""
        return self.to_zip_blob(ZoneSetOutputFilter.STL)

    def save(self, path: str,
             zone_set_output=ZoneSetOutputFilter.STL) -> None:
        with open(path, "wb") as f:
            f.write(self.to_zip_blob(zone_set_output))

    @classmethod
    def from_zip(cls, blob) -> "ZoneSet":
        """Parse the sensor-facing zip (ref: zone_monitor.cpp:216-293
        parse_and_validate_zone_set_config_zip). Accepts bytes or a
        file path."""
        if isinstance(blob, str):
            with open(blob, "rb") as f:
                blob = f.read()
        zs = cls()
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            names = set(zf.namelist())

            def read_entry(name: str) -> bytes:
                """Case-insensitive entry lookup: the metadata may name
                '0.stl' while the archive carries '0.STL'
                (ref: python/tests/test_zone_monitor.py:563-593
                test_filename_case)."""
                if name in names:
                    return zf.read(name)
                for cand in names:
                    if cand.lower() == name.lower():
                        return zf.read(cand)
                raise KeyError(name)

            if "metadata.json" not in names and "zones.json" in names:
                return cls._from_legacy_zip(zf)
            meta = json.loads(zf.read("metadata.json"))
            zs.label = meta.get("label", "")
            zs.power_on_live_ids = [
                int(i) for i in meta["power_on_live_ids"]]
            zs.sensor_to_body_transform = np.asarray(
                meta["sensor_to_body_transform"],
                dtype=np.float64).reshape(4, 4)
            for key, zj in meta["zones"].items():
                zid = int(key)
                mode = ZoneMode.__members__.get(zj["mode"])
                if mode is None or mode == ZoneMode.NONE:
                    raise ValueError(
                        f"Invalid zone mode string for zone {zid}")
                zone = Zone(zid, name=zj.get("label", ""), mode=mode,
                            min_points=int(zj["point_count"]),
                            frame_count=int(zj["frame_count"]))
                if "stl" in zj:
                    frame = CoordinateFrame.from_string(
                        zj["stl"]["coordinate_frame"])
                    if frame is None:
                        raise ValueError(
                            "Invalid coordinate frame string for zone "
                            f"{zid}")
                    stl = Stl(read_entry(zj["stl"]["file_name"]),
                              coordinate_frame=frame)
                    stl.filename = zj["stl"]["file_name"]
                    zone.stl = stl
                    zone.triangles = stl.to_mesh()
                if "zrb" in zj:
                    from .zrb import Zrb

                    zone.zrb = Zrb.from_blob(
                        read_entry(zj["zrb"]["file_name"]))
                zs.zones[zid] = zone
        return zs

    @classmethod
    def _from_legacy_zip(cls, zf) -> "ZoneSet":
        """Read the pre-0.5.1 zones.json layout for old recordings."""
        cfg = json.loads(zf.read("zones.json"))
        zones = []
        for zc in cfg.get("zones", []):
            tris = load_stl(zf.read(zc["mesh"]))
            zones.append(Zone(
                id=zc["id"], name=zc.get("name", ""),
                mode=ZoneMode[zc.get("mode", "occupancy").upper()],
                triangles=tris,
                min_points=zc.get("min_points", 1),
                frame_count=zc.get("frame_count", 1),
                min_range_m=zc.get("min_range_m", 0.0),
                max_range_m=zc.get("max_range_m", 200.0)))
        return cls(zones, power_on_live_ids=cfg.get("power_on_live_ids"))


class CoordinateFrame(Enum):
    """STL vertex frame (ref: stl.h:67-74 Stl::CoordinateFrame)."""

    NONE = 0
    BODY = 1
    SENSOR = 2

    @staticmethod
    def from_string(s: str):
        """(ref: stl.cpp string_to_coordinate_frame — no NONE; returns
        None for unknown strings instead of the reference's bool-out.)"""
        return {"BODY": CoordinateFrame.BODY,
                "SENSOR": CoordinateFrame.SENSOR}.get(s)


class Stl:
    """STL mesh handle with identity hash, constructible from a path or
    raw bytes (ref: zone_monitor.cpp:75-86 Stl binding; stl.h)."""

    def __init__(self, source,
                 coordinate_frame: CoordinateFrame = CoordinateFrame.BODY):
        if isinstance(source, str):
            self.filename = source
            with open(source, "rb") as f:
                self._data = f.read()
        else:
            self.filename = ""
            self._data = bytes(source)
        self.coordinate_frame = coordinate_frame
        self.triangles = load_stl(self._data)

    def to_mesh(self) -> "Mesh":
        """Triangle vertices, (n_tris, 3, 3) float64, with the
        reference's per-triangle accessors (ref: client.pyi:1764
        Stl.to_mesh -> Mesh)."""
        return Mesh(self.triangles)

    @property
    def hash(self) -> str:
        """sha256 of the raw STL bytes (ref: Stl::hash)."""
        import hashlib

        return hashlib.sha256(self._data).hexdigest()

    @property
    def hash_bytes(self) -> bytes:
        """sha256 digest bytes — the form stored in a Zrb's stl_hash."""
        import hashlib

        return hashlib.sha256(self._data).digest()

    def filename_or_default(self, zone_id: int) -> str:
        """Zip entry name: the original filename or <id>.stl
        (ref: zone_monitor.cpp:436-443)."""
        import os

        return (os.path.basename(self.filename) if self.filename
                else f"{zone_id}.stl")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Stl):
            return NotImplemented
        return self._data == other._data


class Triangle:
    """Mesh triangle view: coords / edges / normal
    (ref: client.pyi Triangle; zone mesh accessors)."""

    def __init__(self, vertices: np.ndarray):
        self._v = np.asarray(vertices, dtype=np.float64).reshape(3, 3)

    @property
    def coords(self) -> List[np.ndarray]:
        return [self._v[0], self._v[1], self._v[2]]

    @property
    def edges(self) -> List[np.ndarray]:
        return [self._v[1] - self._v[0], self._v[2] - self._v[1],
                self._v[0] - self._v[2]]

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self._v[1] - self._v[0], self._v[2] - self._v[0])
        mag = np.linalg.norm(n)
        return n / mag if mag > 0 else n


class Mesh(np.ndarray):
    """Triangle mesh: an (n, 3, 3) float64 vertex array that also
    offers the reference binding's ``.triangles`` accessor returning
    Triangle views (ref: client.pyi Mesh;
    python/tests/test_zone_monitor.py:159-181 test_mesh_bindings)."""

    def __new__(cls, vertices) -> "Mesh":
        arr = np.asarray(vertices, dtype=np.float64).reshape(-1, 3, 3)
        return arr.view(cls)

    @property
    def triangles(self) -> List["Triangle"]:
        return [Triangle(v) for v in np.asarray(self)]


#: Plain 3-vector used by the mesh accessors (ref: client.pyi Coord).
Coord = np.ndarray


def _scale_translation(mat: np.ndarray) -> np.ndarray:
    """Translation meters -> mm, as the XYZLut expects
    (ref: beam_config.cpp scale_translation)."""
    res = np.array(mat, dtype=np.float64)
    res[:3, 3] *= 1000.0
    return res


class BeamConfig:
    """Beam geometry bundle for zone rendering (ref: beam_config.h:26,
    beam_config.cpp:23-57). Precomputes two projection LUTs with
    range_unit=0.001: `lut` includes the sensor_to_body transform
    (translation scaled to mm) for BODY-frame meshes;
    `lut_no_sensor_to_body_transform` is the plain sensor-frame LUT.
    (The reference's Python binding leaves this class unbound; it is a
    real object here because the zone renderer needs it.)"""

    def __init__(self, n_cols: int, px_altitudes, px_azimuths,
                 beam_to_lidar_transform: np.ndarray,
                 lidar_to_sensor_transform: np.ndarray,
                 sensor_to_body_transform: np.ndarray,
                 m_per_zmbin: float, serial_number: int):
        from ..ops.xyzlut import make_xyz_lut

        beam_to_lidar_transform = np.asarray(beam_to_lidar_transform,
                                             dtype=np.float64)
        lidar_to_sensor_transform = np.asarray(lidar_to_sensor_transform,
                                               dtype=np.float64)
        sensor_to_body_transform = np.asarray(sensor_to_body_transform,
                                              dtype=np.float64)
        if not beam_to_lidar_transform.any():
            raise ValueError("BeamConfig: beam_to_lidar_transform not set")
        if not lidar_to_sensor_transform.any():
            raise ValueError(
                "BeamConfig: lidar_to_sensor_transform not set")
        if not sensor_to_body_transform.any():
            raise ValueError("BeamConfig: sensor_to_body_transform not set")
        self.n_cols = int(n_cols)
        self.n_rows = len(px_altitudes)
        self.px_altitudes = np.asarray(px_altitudes, dtype=np.float64)
        self.px_azimuths = np.asarray(px_azimuths, dtype=np.float64)
        self.beam_to_lidar_transform = beam_to_lidar_transform
        self.lidar_to_sensor_transform = lidar_to_sensor_transform
        self.sensor_to_body_transform = sensor_to_body_transform
        self.m_per_zmbin = float(m_per_zmbin)
        self.serial_number = int(serial_number)
        self.lut = make_xyz_lut(
            self.n_cols, h=self.n_rows, range_unit=0.001,
            beam_to_lidar_transform=beam_to_lidar_transform,
            transform=_scale_translation(sensor_to_body_transform)
            @ lidar_to_sensor_transform,
            azimuth_angles_deg=self.px_azimuths,
            altitude_angles_deg=self.px_altitudes)
        self.lut_no_sensor_to_body_transform = make_xyz_lut(
            self.n_cols, h=self.n_rows, range_unit=0.001,
            beam_to_lidar_transform=beam_to_lidar_transform,
            transform=lidar_to_sensor_transform,
            azimuth_angles_deg=self.px_azimuths,
            altitude_angles_deg=self.px_altitudes)

    @classmethod
    def from_sensor_info(cls, info,
                         sensor_to_body_transform: Optional[np.ndarray]
                         = None,
                         m_per_zmbin: Optional[float] = None
                         ) -> "BeamConfig":
        """Build from a SensorInfo, as zone_render_mini.cpp:46-57 does."""
        from .zrb import DEFAULT_M_PER_ZMBIN

        return cls(
            info.format.columns_per_frame, info.beam_altitude_angles,
            info.beam_azimuth_angles, info.beam_to_lidar_transform,
            info.lidar_to_sensor_transform,
            np.eye(4) if sensor_to_body_transform is None
            else sensor_to_body_transform,
            DEFAULT_M_PER_ZMBIN if m_per_zmbin is None else m_per_zmbin,
            info.sn or 1)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BeamConfig):
            return NotImplemented
        return (self.n_cols == other.n_cols
                and self.n_rows == other.n_rows
                and np.array_equal(self.px_altitudes, other.px_altitudes)
                and np.array_equal(self.px_azimuths, other.px_azimuths)
                and np.array_equal(self.beam_to_lidar_transform,
                                   other.beam_to_lidar_transform)
                and np.array_equal(self.lidar_to_sensor_transform,
                                   other.lidar_to_sensor_transform)
                and np.array_equal(self.sensor_to_body_transform,
                                   other.sensor_to_body_transform)
                and self.m_per_zmbin == other.m_per_zmbin
                and self.serial_number == other.serial_number)
