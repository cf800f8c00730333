"""Save scan streams to OSF / pcap / ROS bags / PNG / CSV / PLY / PCD / LAS.

Rebuild of the reference save sink (ref: python/src/ouster/cli/plugins/
source_save.py): dispatch on extension, re-packetize for pcap and the bags
(scan_to_packets, ref: sdk/util/parsing.py), point-cloud exports via
io/cloud_io.py. Every writer runs on the host in numpy and writes the same
bytes as the JAX package's for the same scans (rosbag2 `.db3` is sqlite:
the same rows); the sensor emulator (sensor/emulator.py) serves scans
through scan_to_packets.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..core.constants import (
    ChanField,
    FRAME_STATUS_SHOT_LIMITING_SHIFT,
    FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT,
)
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..ops.packet_format import PacketWriter
from ..ops.xyzlut import make_xyz_lut


def scan_to_packets(scan: LidarScan, info: SensorInfo) -> List[np.ndarray]:
    """Re-packetize a scan into synthetic UDP payloads
    (ref: sdk/util/parsing.py scan_to_packets ->
    impl/lidar_scan_impl.h:464-560 scan_to_packets)."""
    pw = PacketWriter(info.format)
    cpp = pw.columns_per_packet
    n_pkt_hdrs = len(scan.packet_timestamp)
    alert_flags = getattr(scan, "alert_flags", None)
    out = []
    for p in range(scan.w // cpp):
        cols = slice(p * cpp, (p + 1) * cpp)
        statuses = scan.status[cols]
        host_ts = int(scan.packet_timestamp[p]) if p < n_pkt_hdrs else 0
        # reference rule (lidar_scan_impl.h:526-529): a packet with no
        # valid column AND no host timestamp was never received — skip
        if not host_ts and not np.any(statuses & 0x1):
            continue
        buf = pw.new_packet()
        pw.set_packet_header(
            buf, init_id=info.init_id, prod_sn=info.sn, packet_type=1,
            alert_flags=int(alert_flags[p])
            if alert_flags is not None and p < len(alert_flags) else 0,
            thermal_shutdown=(scan.frame_status
                              >> FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT)
            & 0xF,
            shot_limiting=(scan.frame_status
                           >> FRAME_STATUS_SHOT_LIMITING_SHIFT) & 0xF,
            countdown_thermal=scan.shutdown_countdown,
            countdown_shot=scan.shot_limiting_countdown)
        pw.set_frame_id(buf, max(scan.frame_id, 0))
        # measurement ids are the column indices, like the reference
        # (lidar_scan_impl.h:520 set_col_measurement_id(col_buf, id)) —
        # a scan's measurement_id header is not trusted here
        pw.set_col_headers(buf, scan.timestamp[cols],
                           np.arange(p * cpp, (p + 1) * cpp,
                                     dtype=np.uint16), statuses)
        for name in pw.fields:
            if scan.has_field(name) and not name.startswith("RAW32"):
                pw.set_field(buf, name, scan.field(name)[:, cols])
        out.append(buf)
    return out


def _split_paths(path: str):
    """Yield path, then stem_001.ext, stem_002.ext, ... for --split."""
    stem, ext = os.path.splitext(path)
    yield path
    i = 1
    while True:
        yield f"{stem}_{i:03d}{ext}"
        i += 1


def _split_sets(scan_sets: Iterable, path: str, split_mb: Optional[int],
                flush) -> Iterable:
    """Wrap a scan-set iterable: call flush(next_path) when the current
    output file exceeds split_mb (ref: source_save.py --split)."""
    names = _split_paths(path)
    cur = next(names)
    for ls_set in scan_sets:
        if split_mb and os.path.exists(cur) and \
                os.path.getsize(cur) >= split_mb * 1_000_000:
            cur = next(names)
            flush(cur)
        yield ls_set


def save_scans(path: str, infos: List[SensorInfo], scan_sets: Iterable,
               fields: Optional[Sequence[str]] = None, *,
               chunk_size: int = 2 * 1024 * 1024,
               compression_level: int = 1,
               encoder: str = "png",
               ts_mode: str = "packet",
               ros2: bool = False,
               split_mb: Optional[int] = None,
               cloud_opts: Optional[dict] = None,
               overwrite: bool = True) -> int:
    """Dispatch on extension; returns number of scans written.

    Option surface mirrors the reference save command
    (ref: plugins/source_save.py): OSF codec (--png / --compression-level),
    chunk size, message-timestamp mode (--ts packet|lidar), ROS2 bag
    output (--ros2), and size-based file splitting (--split MB).
    """
    ext = os.path.splitext(path)[1].lower()
    if ts_mode not in ("packet", "lidar"):
        raise ValueError("ts_mode must be 'packet' or 'lidar'")
    if ext == ".osf":
        return _save_osf(path, infos, scan_sets, fields,
                         chunk_size=chunk_size,
                         compression_level=compression_level,
                         encoder=encoder, ts_mode=ts_mode,
                         split_mb=split_mb)
    if ext == ".pcap":
        return _save_pcap(path, infos, scan_sets, split_mb=split_mb)
    if ext == ".bag":
        return _save_bag(path, infos, scan_sets, ros2=ros2,
                         split_mb=split_mb)
    if ext == ".db3":
        return _save_bag(path, infos, scan_sets, ros2=True,
                         split_mb=split_mb)
    if ext == ".mcap":
        return _save_bag(path, infos, scan_sets, mcap=True,
                         split_mb=split_mb)
    if ext in (".csv", ".ply", ".pcd", ".las"):
        return _save_points(path, infos, scan_sets, ext[1:],
                            **(cloud_opts or {}))
    if ext == ".png":
        return _save_png(path, infos, scan_sets, fields,
                         overwrite=overwrite)
    raise ValueError(f"unsupported save format {ext}")


def _save_png(path, infos, scan_sets, fields, *, overwrite=True) -> int:
    """Per-scan per-field 8-bit normalized destaggered image series
    (ref: plugins/source_save.py:454-520 source_save_png): each written
    file is `{stem}_{sn}_{frame_id}_{field}.png` beside `path` (min-max
    normalized to the 8-bit range, like the reference). 2-D pixel fields
    write grayscale; (h, w, 3) fields write RGB; non-pixel-shaped fields
    (IMU/zone scan fields) are skipped."""
    from ..ops.destagger import destagger
    from ..utils.png import encode

    out_dir = os.path.dirname(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    n = 0
    for ls_set in scan_sets:
        # LidarScanSet also exposes field(); frame_id marks a bare scan
        scans = [ls_set] if hasattr(ls_set, "frame_id") else ls_set
        for k, scan in enumerate(scans):
            if scan is None:
                continue
            info = scan.sensor_info or infos[min(k, len(infos) - 1)]
            h = info.format.pixels_per_column
            w = info.format.columns_per_frame
            for name in (fields or list(scan.fields)):
                img = np.asarray(scan.field(name))
                if img.shape[:2] != (h, w) or img.ndim > 3:
                    continue
                img = destagger(info, img)
                lo, hi = img.min(), img.max()
                norm = np.zeros_like(img, np.float64) if hi == lo else \
                    (img.astype(np.float64) - lo) / float(hi - lo)
                img8 = (norm * 255).astype(np.uint8)
                if img.ndim == 3 and img.shape[2] == 3:
                    data = encode(img8, color_type=2, sample_depth=8)
                elif img.ndim == 2:
                    data = encode(img8, color_type=0, sample_depth=8)
                else:
                    continue
                fname = f"{stem}_{info.sn}_{scan.frame_id}_{name}.png"
                fpath = os.path.join(out_dir, fname) if out_dir else fname
                if os.path.isfile(fpath) and not overwrite:
                    raise FileExistsError(
                        f"{fpath} already exists; pass --overwrite")
                with open(fpath, "wb") as f:
                    f.write(data)
            n += 1
    return n


def _save_osf(path, infos, scan_sets, fields, *, chunk_size=2 * 1024 * 1024,
              compression_level=1, encoder="png", ts_mode="packet",
              split_mb=None) -> int:
    from ..core.lidar_scan import get_field_types
    from .osf import Writer

    n = 0
    state = {}

    def open_writer(p):
        if "w" in state:
            state["w"].close()
        w = Writer(p, chunk_size=chunk_size,
                   compression_level=compression_level, encoder=encoder)
        ids = []
        for info in infos:
            # no field filter by default so extra fields added upstream
            # (NORMALS, user add_field...) are preserved — the reference
            # passes an empty field_types list to AsyncWriter
            # (ref: plugins/source_save.py:148)
            fts = None
            if fields:
                from ..core.field import FieldClass, FieldType
                known = {ft.name: ft for ft in get_field_types(info)}
                fts = [known.get(name,
                                 FieldType(name, np.float32, (),
                                           FieldClass.PIXEL_FIELD))
                       for name in fields]
            ids.append(w.add_sensor(info, fts))
        state["w"], state["ids"] = w, ids

    open_writer(path)
    try:
        for ls_set in _split_sets(scan_sets, path, split_mb, open_writer):
            w, ids = state["w"], state["ids"]
            valid = [s for s in ls_set if s is not None]
            # record the grouping as a collation when packet timestamps
            # allow it (ref: writer.cpp:284 Writer::save(LidarScanSet));
            # otherwise fall back to plain per-sensor saves
            if ts_mode == "packet" and len(ls_set) == len(infos) and \
                    valid and all(
                        s.first_valid_packet_timestamp() for s in valid):
                w.save_set(ls_set)
                n += len(valid)
            else:
                for idx, scan in enumerate(ls_set):
                    if scan is not None:
                        ts = None if ts_mode == "packet" else \
                            int(scan.first_valid_column_timestamp() or 0)
                        w.save(ids[idx], scan, ts=ts)
                        n += 1
    finally:
        state["w"].close()
    return n


def _save_pcap(path, infos, scan_sets, *, split_mb=None) -> int:
    from .pcap import PcapWriter

    n = 0
    state = {"w": PcapWriter(path)}

    def roll(p):
        state["w"].close()
        state["w"] = PcapWriter(p)

    try:
        for ls_set in _split_sets(scan_sets, path, split_mb, roll):
            w = state["w"]
            for idx, scan in enumerate(ls_set):
                if scan is None:
                    continue
                info = infos[idx]
                port = info.config.udp_port_lidar or 7502
                base_ts = int(scan.first_valid_packet_timestamp()
                              or scan.first_valid_column_timestamp() or 0)
                for i, pkt in enumerate(scan_to_packets(scan, info)):
                    w.write(pkt.tobytes(), "127.0.0.1",
                            info.config.udp_dest or "127.0.0.1",
                            7502, port, base_ts + i)
                n += 1
    finally:
        state["w"].close()
    return n


def _save_bag(path, infos, scan_sets, ros2: bool = False,
              mcap: bool = False, split_mb=None) -> int:
    """Re-packetize scans onto ouster ROS topics
    (ref: plugins/source_save.py bag save: /osN/metadata string +
    /osN/lidar_packets PacketMsg). `.db3` targets (or ros2=True) write
    rosbag2 sqlite3 storage; `.mcap` writes MCAP."""
    from .bag import McapBagWriter, Ros1BagWriter, Ros2BagWriter

    def make(p):
        if mcap:
            return McapBagWriter(p)
        if ros2 and p.endswith(".bag"):
            p = os.path.splitext(p)[0] + ".db3"
        return Ros2BagWriter(p) if ros2 else Ros1BagWriter(p)

    n = 0
    state = {"w": make(path), "first": [None] * len(infos)}

    def roll(p):
        state["w"].close()
        state["w"] = make(p)
        state["first"] = [None] * len(infos)  # re-announce metadata

    try:
        for ls_set in _split_sets(scan_sets, path, split_mb, roll):
            w, first_ts = state["w"], state["first"]
            for idx, scan in enumerate(ls_set):
                if scan is None:
                    continue
                info = infos[idx]
                base_ts = int(scan.first_valid_packet_timestamp()
                              or scan.first_valid_column_timestamp() or 0)
                if first_ts[idx] is None:
                    first_ts[idx] = base_ts
                    w.write_string(f"/os{idx}/metadata",
                                   info.to_json_string(), base_ts)
                for i, pkt in enumerate(scan_to_packets(scan, info)):
                    w.write_packet(f"/os{idx}/lidar_packets",
                                   pkt.tobytes(), base_ts + i)
                n += 1
    finally:
        state["w"].close()
    return n


def _save_points(path, infos, scan_sets, kind: str, *,
                 field: Optional[str] = ChanField.REFLECTIVITY,
                 decimate: bool = False, voxel_size: float = 0.1,
                 min_z: Optional[float] = None,
                 max_z: Optional[float] = None,
                 pts_per_file: int = 100_000_000,
                 ascii_out: bool = False) -> int:
    """Accumulate world-frame points from all scans into output files of
    at most `pts_per_file` points (ref: source_save.py:371-460
    point-cloud convert: key field choice, voxel decimation, z band,
    per-file split, ascii)."""
    from ..ops.downsample import voxel_downsample
    from .cloud_io import write_pointcloud

    luts = [make_xyz_lut(i, use_extrinsics=True) for i in infos]
    stem, ext = os.path.splitext(path)
    key_name = None if (field is None or str(field).upper() == "NONE") \
        else str(field).upper()
    pts_acc: list = []
    key_acc: list = []
    n_scans = 0
    n_files = 0
    n_buffered = 0

    def flush(last: bool):
        nonlocal n_files, n_buffered
        if not n_buffered:
            return
        pts = np.concatenate(pts_acc)
        attrs = {}
        if key_acc:
            attrs[key_name.lower()] = np.concatenate(key_acc)
        if decimate:
            vals = voxel_downsample(
                pts, voxel_size, list(attrs.values()) or None)
            pts = vals[0]
            for name, a in zip(list(attrs), vals[1]):
                attrs[name] = a
        out = path if (last and n_files == 0) \
            else f"{stem}-{n_files:03d}{ext}"
        write_pointcloud(out, pts, kind=kind, attributes=attrs,
                         binary=not ascii_out)
        n_files += 1
        pts_acc.clear()
        key_acc.clear()
        n_buffered = 0

    for ls_set in scan_sets:
        for idx, scan in enumerate(ls_set):
            if scan is None:
                continue
            rng = scan.field(ChanField.RANGE)
            xyz = luts[idx](rng)
            valid = rng > 0
            # dewarp by per-column poses
            from ..utils.pose_util import dewarp as _dewarp

            pts = _dewarp(xyz, scan.pose)[valid]
            keep = np.ones(len(pts), bool)
            if min_z is not None:
                keep &= pts[:, 2] >= min_z
            if max_z is not None:
                keep &= pts[:, 2] <= max_z
            pts = pts[keep]
            pts_acc.append(pts)
            if key_name is not None:
                # keep key and point arrays aligned even when some
                # scans lack the field (zero-fill those)
                if scan.has_field(key_name):
                    key_acc.append(scan.field(key_name)[valid][keep])
                else:
                    key_acc.append(np.zeros(len(pts), dtype=np.float32))
            n_buffered += len(pts)
            n_scans += 1
            if n_buffered >= pts_per_file:
                flush(last=False)
    flush(last=True)
    return n_scans
