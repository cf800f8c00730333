"""The benchmark's own OSF writer, in numpy, zlib and struct alone: a
recording of a drive through the yard (lib/yard.py) as `ouster-cli source
<sensor> save rec.osf` leaves it at its defaults, so that no change to the
program's own writer changes the input a cell is judged on.

The container follows Ouster's OSF schemas (ouster_osf/fb: os_sensor/
lidar_sensor.fbs, lidar_scan_stream.fbs, collation_stream.fbs,
streaming/streaming_info.fbs, chunk.fbs, header.fbs, metadata.fbs): a
header, chunks of one stream each holding the stamped messages, and the
metadata (the sensor's json, the scan stream's field types, the
collation stream, the streaming info) at the end, each block
size-prefixed and closed by the crc32 of its bytes. `save` at its
defaults stamps each scan with its first packet's receive time and
records every scan set as a collation (writer.cpp Writer::save of a
LidarScanSet): the scan goes to its sensor's stream, then a CollationMsg
naming it (sensor index, the scan's index in that stream) goes to the
collation stream under the same time. The flatbuffers are laid out
front to back by the small writer below: every object lies after what
refers to it, and each scalar and vector element on a multiple of its
size from the block's start.

A scan's channels are its pixel fields as yard.frame gives them (a field
it leaves out is zero), destaggered and PNG-encoded as the SDK's PNG
field encoder does (png_lidarscan_encoder.cpp): 8-bit grey for u8,
16-bit grey (big-endian) for u16, 8-bit RGBA of the little-endian bytes
for u32; filter 0 on every row, one zlib stream at the recording's level
in one IDAT chunk.

Every frame is made from (seed, frame index) and the yard's geometry
alone (yard.frame), so the reference (reference/osf_scan.py) makes any
frame again without reading the recording.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Iterable, List, Tuple

import numpy as np

from portbench.lib import synth
from portbench.reference.lut import destagger

# CHAN_FIELD (os_sensor/lidar_scan_stream.fbs) of the fields a profile
# records, and CHAN_FIELD_TYPE (os_sensor/common.fbs) by element size
CHAN_FIELD = {"RANGE": 1, "RANGE2": 2, "SIGNAL": 3, "SIGNAL2": 4,
              "REFLECTIVITY": 5, "REFLECTIVITY2": 6, "NEAR_IR": 7,
              "FLAGS": 8, "FLAGS2": 9}
CHAN_TYPE = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
             np.dtype(np.uint32): 3}
OSF_VERSION = 21                  # 2.1
STATUS_VALID = 2
SCAN_STREAM = "ouster/v1/os_sensor/LidarScanStream"
SENSOR = "ouster/v1/os_sensor/LidarSensor"
COLLATION_STREAM = "ouster/v1/os_sensor/CollationStream"
STREAMING_INFO = "ouster/v1/streaming/StreamingInfo"


def field_dtype(sensor: synth.Sensor, name: str) -> np.dtype:
    """A field's element type in a LidarScan: the narrowest unsigned type
    that holds its bits."""
    bits = sensor.fields[name][1]
    return np.dtype(np.uint8 if bits <= 8 else
                    np.uint16 if bits <= 16 else np.uint32)


def recorded_fields(sensor: synth.Sensor, recording: dict) -> List[str]:
    """The channels a scan message holds, in CHAN_FIELD order."""
    return sorted((n for n in recording["fields"] if n in sensor.fields),
                  key=CHAN_FIELD.__getitem__)


# -- PNG ---------------------------------------------------------------------

def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def png_field(img: np.ndarray, level: int) -> bytes:
    """A (h, w) u8, u16 or u32 image as the SDK's PNG field encoder
    writes it."""
    h, w = img.shape
    if img.dtype == np.uint8:
        depth, color, raw = 8, 0, img
    elif img.dtype == np.uint16:
        depth, color, raw = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint32:
        depth, color, raw = 8, 6, img.astype("<u4").view(np.uint8)
    else:
        raise ValueError(f"no PNG layout for {img.dtype}")
    rows = np.zeros((h, 1 + raw.size // h), np.uint8)     # filter 0
    rows[:, 1:] = raw.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


# -- flatbuffers, front to back ----------------------------------------------
# A table is a dict {slot: value}; a value is a scalar (kind, number), a
# str, bytes or a numpy array (a vector of scalars), a list of tables,
# Structs (a vector of structs) or a table.

_SCALAR = {"u8": "<B", "u16": "<H", "u32": "<I", "i32": "<i", "u64": "<Q"}


class Structs:
    """A vector of structs: their packed bytes, count and alignment."""

    def __init__(self, packed: bytes, count: int, align: int):
        self.packed, self.count, self.align = packed, count, align


class _Out:
    def __init__(self, head: int):
        self.b = bytearray(head)

    def pad(self, align: int, extra: int = 0) -> None:
        """Pad so that `extra` bytes more end on a multiple of `align`."""
        self.b += bytes(-(len(self.b) + extra) % align)

    def _vector(self, count: int, body: bytes, align: int) -> int:
        self.pad(max(align, 4), 4)
        at = len(self.b)
        self.b += struct.pack("<I", count) + body
        return at

    def put(self, v) -> int:
        """Write `v`; its position."""
        if isinstance(v, dict):
            return self._table(v)
        if isinstance(v, str):
            data = v.encode()
            return self._vector(len(data), data + b"\0", 4)
        if isinstance(v, Structs):
            return self._vector(v.count, v.packed, v.align)
        if isinstance(v, list):
            at = self._vector(len(v), bytes(4 * len(v)), 4)
            for k, t in enumerate(v):
                slot = at + 4 + 4 * k
                struct.pack_into("<I", self.b, slot, self.put(t) - slot)
            return at
        a = np.frombuffer(v, np.uint8) if isinstance(v, bytes) \
            else np.ascontiguousarray(v)
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        return self._vector(a.size, a.tobytes(), a.dtype.itemsize)

    def _table(self, slots: dict) -> int:
        n = max(slots) + 1 if slots else 0
        self.pad(2)
        vt = len(self.b)
        self.b += bytes(4 + 2 * n)
        self.pad(4)
        t = len(self.b)
        self.b += struct.pack("<i", t - vt)      # the vtable lies before
        offs, refs = {}, []
        for slot, v in sorted(slots.items()):
            if isinstance(v, tuple):
                fmt = _SCALAR[v[0]]
                self.pad(struct.calcsize(fmt))
                offs[slot] = len(self.b) - t
                self.b += struct.pack(fmt, v[1])
            else:
                self.pad(4)
                offs[slot] = len(self.b) - t
                refs.append((len(self.b), v))
                self.b += bytes(4)
        struct.pack_into("<HH", self.b, vt, 4 + 2 * n, len(self.b) - t)
        for slot, off in offs.items():
            struct.pack_into("<H", self.b, vt + 4 + 2 * slot, off)
        for at, v in refs:
            struct.pack_into("<I", self.b, at, self.put(v) - at)
        return t


def flatbuffer(root: dict, ident: bytes = b"") -> bytes:
    """A size-prefixed flatbuffer of the table `root`, with its file
    identifier where one is given."""
    out = _Out(8 + len(ident))
    out.b[8:8 + len(ident)] = ident
    struct.pack_into("<I", out.b, 4, out.put(root) - 4)
    struct.pack_into("<I", out.b, 0, len(out.b) - 4)
    return bytes(out.b)


def block(fb: bytes) -> bytes:
    """A size-prefixed flatbuffer framed as OSF frames every block."""
    return fb + struct.pack("<I", zlib.crc32(fb))


# -- messages and the file ----------------------------------------------------

def scan_message(sensor: synth.Sensor, frame: dict, fields: List[str],
                 level: int) -> bytes:
    """The LidarScan message of a frame: each recorded field destaggered
    and PNG-encoded, the column headers, the frame id, the packets'
    receive times and their (zero) alert flags."""
    valid = (frame["status"] & 1).astype(bool)
    channels, types = [], b""
    for name in fields:
        dt = field_dtype(sensor, name)
        v = frame["fields"].get(name)
        img = np.zeros((sensor.h, sensor.w), dt) if v is None else \
            np.where(valid[None, :], v, 0).astype(dt)
        channels.append({0: png_field(destagger(img, sensor.shifts),
                                      level)})
        types += struct.pack("<BB", CHAN_FIELD[name], CHAN_TYPE[dt])
    return flatbuffer({
        0: channels,
        1: Structs(types, len(fields), 1),
        2: np.where(valid, frame["col_ts"], 0).astype(np.uint64),
        3: np.where(valid, np.arange(sensor.w), 0).astype(np.uint16),
        4: np.where(valid, frame["status"], 0).astype(np.uint32),
        5: ("i32", int(frame["frame_id"])),
        7: np.asarray(frame["pkt_ts"], np.uint64),
        12: np.zeros(sensor.n_pkts, np.uint8)})


def collation_message(scan_idx: int) -> bytes:
    """The CollationMsg of a set of one sensor's one scan: its ScanID
    (u32 sensor index, u64 index of the scan in that sensor's stream),
    and no set fields."""
    return flatbuffer({0: Structs(struct.pack("<I4xQ", 0, scan_idx), 1, 8)})


def _header(metadata_offset: int, file_length: int) -> bytes:
    return block(flatbuffer({0: ("u64", OSF_VERSION),
                             1: ("u8", STATUS_VALID),
                             2: ("u64", metadata_offset),
                             3: ("u64", file_length)}, b"OSF$"))


class _Stream:
    """The chunks of one stream as `save`'s writer lays them out (the
    port's copy: io/osf.py Writer.save_message): a chunk closes once its
    messages reach `chunk_size` bytes."""

    def __init__(self, f, base: int, stream_id: int, chunk_size: int):
        self.f, self.base, self.id, self.size = f, base, stream_id, chunk_size
        self.pending: List[Tuple[int, int, bytes]] = []
        self.chunks: List[Tuple[int, int, int, int]] = []  # ts0, ts1, off, n
        self.receive: List[int] = []
        self.sensor: List[int] = []
        self.bytes = 0

    def add(self, ts: int, ts_sensor: int, msg: bytes) -> None:
        self.pending.append((ts, ts_sensor, msg))
        self.receive.append(ts)
        self.sensor.append(ts_sensor)
        self.bytes += len(msg)
        if sum(len(m) for *_, m in self.pending) >= self.size:
            self.flush()

    def flush(self) -> None:
        if not self.pending:
            return
        msgs = [{0: ("u64", ts), 1: ("u32", self.id), 2: msg,
                 3: ("u64", ts_sensor)} for ts, ts_sensor, msg in self.pending]
        off = self.f.tell() - self.base
        self.f.write(block(flatbuffer({0: msgs}, b"OSF!")))
        ts = [m[0] for m in self.pending]
        self.chunks.append((min(ts), max(ts), off, len(msgs)))
        self.pending = []


def write_recording(path: str, metadata: dict, recording: dict,
                    frames: Iterable[dict]) -> Dict[str, int]:
    """Write `frames` (yard.frame's dicts) as an OSF recording of one
    sensor at the recording's settings (encoder png, compression_level,
    chunk_size, fields), every scan collated; returns its frames, chunks
    and bytes. The file is written under a temporary name, synced to the
    disk and renamed, so a reader never sees half a recording."""
    if recording["format"] != "OSF" or recording["encoder"] != "png" \
            or recording["sensors"] != 1 or not recording["collation"]:
        raise ValueError("the writer records one sensor's PNG OSF, "
                         "collated")
    sensor = synth.Sensor(metadata)
    fields = recorded_fields(sensor, recording)
    sensor_id, stream_id, collation_id, info_id = 1, 2, 3, 4
    head = len(_header(0, 0))
    with open(path + ".partial", "wb") as f:
        f.write(bytes(head))
        scans = _Stream(f, head, stream_id, recording["chunk_size"])
        sets = _Stream(f, head, collation_id, recording["chunk_size"])
        n = 0
        for fr in frames:
            ts = int(fr["pkt_ts"][0])
            scans.add(ts, int(fr["col_ts"][0]), scan_message(
                sensor, fr, fields, recording["compression_level"]))
            sets.add(ts, 0, collation_message(n))
            n += 1
        scans.flush()
        sets.flush()
        streams = (scans, sets)
        chunks = sorted((c for s in streams for c in s.chunks),
                        key=lambda c: c[2])
        entries = [
            (sensor_id, SENSOR, flatbuffer({0: json.dumps(metadata)},
                                           b"oLS_")),
            (stream_id, SCAN_STREAM, flatbuffer({
                0: ("u32", sensor_id),
                1: Structs(b"".join(struct.pack(
                    "<BB", CHAN_FIELD[name],
                    CHAN_TYPE[field_dtype(sensor, name)])
                    for name in fields), len(fields), 1)}, b"oLSS")),
            (collation_id, COLLATION_STREAM, flatbuffer({}, b"oCSt")),
            (info_id, STREAMING_INFO, flatbuffer({
                0: [{0: ("u64", c[2]), 1: ("u32", s.id), 2: ("u32", c[3])}
                    for s in streams for c in s.chunks],
                1: [{0: ("u32", s.id), 1: ("u64", min(s.receive)),
                     2: ("u64", max(s.receive)), 3: ("u64", n),
                     4: ("u32", s.bytes // max(n, 1)),
                     5: np.asarray(s.receive, np.uint64),
                     6: np.asarray(s.sensor, np.uint64)}
                    for s in streams]}))]
        r = scans.receive
        meta_off = f.tell()
        f.write(block(flatbuffer({
            0: "ouster_sdk",
            1: ("u64", min(r)), 2: ("u64", max(r)),
            3: Structs(b"".join(struct.pack("<QQQ", a, b, off)
                                for a, b, off, _ in chunks),
                       len(chunks), 8),
            4: [{0: ("u32", i), 1: kind, 2: buf}
                for i, kind, buf in entries]}, b"OSF#")))
        length = f.tell()
        f.seek(0)
        f.write(_header(meta_off, length))
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".partial", path)
    return {"frames": n, "chunks": len(chunks), "bytes": length}
