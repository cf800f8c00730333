"""ROS1 bag reader/writer + scan/packet sources (no external ROS deps).

Rebuild of the reference bag support (ref: python/src/ouster/sdk/bag/
bag_packet_source.py, bag_scan_source.py — which lean on the `rosbags`
package; this is a self-contained ROS1 v2.0 implementation). Handles
`ouster_ros/PacketMsg`-style messages (`uint8[] buf`) on */lidar_packets
and */imu_packets topics plus `std_msgs/String` */metadata topics, with
none/bz2-compressed chunks.
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.metadata import sensor_info_from_metadata
from ..core.packets import ImuPacket, LidarPacket, Packet, ZonePacket
from ..core.types import SDK_NAME, SensorInfo
from .sources import (
    IoType,
    LidarScanSet,
    ScanSource,
    collate_scans,
    populate_extrinsics,
)

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(data: bytes) -> Dict[bytes, bytes]:
    out = {}
    pos = 0
    while pos + 4 <= len(data):
        n = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        field = data[pos:pos + n]
        pos += n
        eq = field.find(b"=")
        if eq >= 0:
            out[field[:eq]] = field[eq + 1:]
    return out


def _make_header(fields: Dict[bytes, bytes]) -> bytes:
    parts = []
    for k, v in fields.items():
        item = k + b"=" + v
        parts.append(struct.pack("<I", len(item)) + item)
    return b"".join(parts)


@dataclass
class Connection:
    id: int
    topic: str
    msgtype: str
    md5sum: str = ""
    message_definition: str = ""
    serialization: str = "ros1"  # "ros1" | "cdr" (ROS2)


@dataclass
class BagMessage:
    connection: Connection
    timestamp: int  # nanoseconds
    data: bytes


class Ros1BagReader:
    """Iterates (connection, timestamp, raw message bytes)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_MAGIC):
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        self.connections: Dict[int, Connection] = {}
        self._messages: List[BagMessage] = []
        self._parse(memoryview(data)[len(_MAGIC):])
        # messages hold copies; sort once here so the file buffer can be
        # released and messages() is O(n) per call
        self._messages.sort(key=lambda m: m.timestamp)

    def _records(self, buf: memoryview) -> Iterator[Tuple[Dict, memoryview]]:
        pos = 0
        while pos + 4 <= len(buf):
            hlen = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            header = _parse_header(bytes(buf[pos:pos + hlen]))
            pos += hlen
            if pos + 4 > len(buf):
                break
            dlen = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            data = buf[pos:pos + dlen]
            pos += dlen
            yield header, data

    def _parse(self, buf: memoryview) -> None:
        for header, data in self._records(buf):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._add_connection(header, data)
            elif op == OP_CHUNK:
                compression = header.get(b"compression", b"none").decode()
                if compression == "none":
                    chunk = data
                elif compression == "bz2":
                    chunk = memoryview(bz2.decompress(bytes(data)))
                elif compression == "lz4":
                    chunk = memoryview(_lz4_decompress(bytes(data)))
                else:
                    raise ValueError(
                        f"unsupported bag compression {compression}")
                for h2, d2 in self._records(chunk):
                    op2 = h2.get(b"op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        self._add_connection(h2, d2)
                    elif op2 == OP_MSG:
                        self._add_message(h2, d2)
            elif op == OP_MSG:
                self._add_message(header, data)

    def _add_connection(self, header: Dict, data: memoryview) -> None:
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        info = _parse_header(bytes(data))
        self.connections[conn_id] = Connection(
            id=conn_id,
            topic=info.get(b"topic", topic.encode()).decode() or topic,
            msgtype=info.get(b"type", b"").decode(),
            md5sum=info.get(b"md5sum", b"").decode(),
            message_definition=info.get(b"message_definition",
                                        b"").decode(),
        )

    def _add_message(self, header: Dict, data: memoryview) -> None:
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        sec, nsec = struct.unpack("<II", header[b"time"])
        conn = self.connections.get(conn_id)
        if conn is not None:
            self._messages.append(BagMessage(
                conn, sec * 1_000_000_000 + nsec, bytes(data)))

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[BagMessage]:
        for m in self._messages:
            if topics is None or m.connection.topic in topics:
                yield m


def _lz4_decompress(data: bytes) -> bytes:
    raise ValueError("lz4-compressed bags are not supported yet")


# -- ROS2 (rosbag2 sqlite3 storage) ----------------------------------------
# (ref: bag/bag_packet_source.py:19,27-35 — the reference reads ROS2 db3
# bags via the `rosbags` package; this is a self-contained stdlib-sqlite3
# implementation of the same storage schema.)

_SQLITE_MAGIC = b"SQLite format 3\x00"
_ROS1_MSGTYPE_MAP = {
    # normalize ROS2 dotted msg types to one namespace set
    "ouster_ros/msg/PacketMsg": "ouster_ros/msg/PacketMsg",
}


def _resolve_db3_files(path: str) -> List[str]:
    import glob

    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.db3")))
        if not files:
            raise ValueError(f"{path}: directory contains no .db3 storage")
        return files
    return [path]


class Ros2BagReader:
    """Iterates (connection, timestamp, CDR message bytes) from rosbag2
    sqlite3 storage — a bare .db3 file or a bag directory of them."""

    def __init__(self, path: str):
        import sqlite3

        self.connections: Dict[int, Connection] = {}
        self._messages: List[BagMessage] = []
        next_id = 0
        for f in _resolve_db3_files(path):
            con = sqlite3.connect(f"file:{f}?mode=ro", uri=True,
                                  check_same_thread=False)
            try:
                cur = con.execute(
                    "SELECT id, name, type, serialization_format "
                    "FROM topics")
                local = {}
                for tid, name, msgtype, fmt in cur.fetchall():
                    c = Connection(id=next_id, topic=name, msgtype=msgtype,
                                   serialization=fmt or "cdr")
                    local[tid] = c
                    self.connections[next_id] = c
                    next_id += 1
                cur = con.execute(
                    "SELECT topic_id, timestamp, data FROM messages "
                    "ORDER BY timestamp")
                for tid, ts, data in cur:
                    c = local.get(tid)
                    if c is not None:
                        self._messages.append(BagMessage(c, int(ts),
                                                         bytes(data)))
            finally:
                con.close()
        self._messages.sort(key=lambda m: m.timestamp)

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[BagMessage]:
        for m in self._messages:
            if topics is None or m.connection.topic in topics:
                yield m


class Ros2BagWriter:
    """Write a rosbag2 sqlite3 bag: a bare `.db3` file, or a bag directory
    (path without .db3 suffix) holding `<name>_0.db3` + metadata.yaml."""

    def __init__(self, path: str):
        import sqlite3

        self._dir = None
        if not path.endswith(".db3"):
            os.makedirs(path, exist_ok=True)
            self._dir = path
            name = os.path.basename(path.rstrip("/")) or "bag"
            db_path = os.path.join(path, name + "_0.db3")
        else:
            db_path = path
        if os.path.exists(db_path):
            os.remove(db_path)
        self._db_path = db_path
        self._con = sqlite3.connect(db_path)
        self._con.executescript(
            "CREATE TABLE schema(schema_version INTEGER PRIMARY KEY, "
            "ros_distro TEXT NOT NULL);"
            "CREATE TABLE metadata(id INTEGER PRIMARY KEY, "
            "metadata_version INTEGER NOT NULL, metadata TEXT NOT NULL);"
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT "
            "NULL, type TEXT NOT NULL, serialization_format TEXT NOT "
            "NULL, offered_qos_profiles TEXT NOT NULL);"
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id "
            "INTEGER NOT NULL, timestamp INTEGER NOT NULL, data BLOB NOT "
            "NULL);")
        self._con.execute(
            "INSERT INTO schema(schema_version, ros_distro) VALUES (3, "
            "'rolling')")
        self._topics: Dict[Tuple[str, str], int] = {}
        self._counts: Dict[str, int] = {}
        self._ts_range = [None, None]

    def _topic_id(self, topic: str, msgtype: str) -> int:
        key = (topic, msgtype)
        if key not in self._topics:
            tid = len(self._topics) + 1
            self._con.execute(
                "INSERT INTO topics(id, name, type, serialization_format, "
                "offered_qos_profiles) VALUES (?, ?, ?, 'cdr', '')",
                (tid, topic, msgtype))
            self._topics[key] = tid
        return self._topics[key]

    def _write(self, topic: str, msgtype: str, cdr_body: bytes,
               ts_ns: int) -> None:
        data = b"\x00\x01\x00\x00" + cdr_body  # CDR_LE encapsulation
        tid = self._topic_id(topic, msgtype)
        self._con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) "
            "VALUES (?, ?, ?)", (tid, ts_ns, data))
        self._counts[topic] = self._counts.get(topic, 0) + 1
        lo, hi = self._ts_range
        self._ts_range = [ts_ns if lo is None else min(lo, ts_ns),
                          ts_ns if hi is None else max(hi, ts_ns)]

    def write_packet(self, topic: str, payload: bytes, ts_ns: int) -> None:
        self._write(topic, "ouster_sensor_msgs/msg/PacketMsg",
                    struct.pack("<I", len(payload)) + bytes(payload), ts_ns)

    def write_string(self, topic: str, text: str, ts_ns: int) -> None:
        raw = text.encode() + b"\x00"
        self._write(topic, "std_msgs/msg/String",
                    struct.pack("<I", len(raw)) + raw, ts_ns)

    def close(self) -> None:
        self._con.commit()
        self._con.close()
        if self._dir is not None:
            self._write_metadata_yaml()

    def _write_metadata_yaml(self) -> None:
        lo, hi = self._ts_range
        lo = lo or 0
        hi = hi if hi is not None else lo
        topics = "\n".join(
            "    - topic_metadata:\n"
            f"        name: {t}\n"
            f"        type: {m}\n"
            "        serialization_format: cdr\n"
            "        offered_qos_profiles: \"\"\n"
            f"      message_count: {self._counts.get(t, 0)}"
            for (t, m) in self._topics)
        with open(os.path.join(self._dir, "metadata.yaml"), "w") as f:
            f.write(
                "rosbag2_bagfile_information:\n"
                "  version: 5\n"
                "  storage_identifier: sqlite3\n"
                "  relative_file_paths:\n"
                f"    - {os.path.basename(self._db_path)}\n"
                "  duration:\n"
                f"    nanoseconds: {hi - lo}\n"
                "  starting_time:\n"
                f"    nanoseconds_since_epoch: {lo}\n"
                f"  message_count: {sum(self._counts.values())}\n"
                "  topics_with_message_count:\n"
                f"{topics}\n"
                "  compression_format: \"\"\n"
                "  compression_mode: \"\"\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- MCAP storage (ref: bag_packet_source.py:59-130 reads .mcap via the
# rosbags MCAPFile; this is a self-contained reader/writer of the MCAP
# spec's record framing) ----------------------------------------------------

_MCAP_MAGIC = b"\x89MCAP0\r\n"

_OP_HEADER = 0x01
_OP_FOOTER = 0x02
_OP_SCHEMA = 0x03
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_DATA_END = 0x0F


def _mcap_str(data: bytes, pos: int) -> Tuple[str, int]:
    n = struct.unpack_from("<I", data, pos)[0]
    return data[pos + 4:pos + 4 + n].decode("utf-8", "replace"), pos + 4 + n


class McapBagReader:
    """Iterates (connection, log_time, CDR bytes) from an MCAP file.

    Handles top-level and chunked records ("" / zstd / lz4* compression;
    *lz4 only when the lz4 package is present)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_MCAP_MAGIC):
            raise ValueError(f"{path}: not an MCAP file")
        self.connections: Dict[int, Connection] = {}
        self._schemas: Dict[int, str] = {}
        self._messages: List[BagMessage] = []
        self._parse_records(memoryview(data), len(_MCAP_MAGIC),
                            len(data) - len(_MCAP_MAGIC))
        self._messages.sort(key=lambda m: m.timestamp)

    def _parse_records(self, data: memoryview, pos: int, end: int) -> None:
        while pos + 9 <= end:
            op = data[pos]
            length = struct.unpack_from("<Q", data, pos + 1)[0]
            body_start = pos + 9
            pos = body_start + length
            if pos > end:
                break
            if op == _OP_SCHEMA:
                sid = struct.unpack_from("<H", data, body_start)[0]
                name, _ = _mcap_str(bytes(data[body_start + 2:pos]), 0)
                self._schemas[sid] = name
            elif op == _OP_CHANNEL:
                body = bytes(data[body_start:pos])
                cid, sid = struct.unpack_from("<HH", body, 0)
                topic, p = _mcap_str(body, 4)
                encoding, p = _mcap_str(body, p)
                self.connections[cid] = Connection(
                    id=cid, topic=topic,
                    msgtype=self._schemas.get(sid, ""),
                    serialization=encoding or "cdr")
            elif op == _OP_MESSAGE:
                body = bytes(data[body_start:pos])
                cid, _seq, log_time, _pub = struct.unpack_from(
                    "<HIQQ", body, 0)
                conn = self.connections.get(cid)
                if conn is not None:
                    self._messages.append(
                        BagMessage(conn, int(log_time), body[22:]))
            elif op == _OP_CHUNK:
                body = bytes(data[body_start:pos])
                # start/end time u64s, uncompressed_size u64, crc u32
                p = 8 + 8 + 8 + 4
                compression, p = _mcap_str(body, p)
                rec_len = struct.unpack_from("<Q", body, p)[0]
                records = body[p + 8:p + 8 + rec_len]
                if compression == "zstd":
                    import zstandard

                    records = zstandard.ZstdDecompressor().decompress(
                        records, max_output_size=1 << 31)
                elif compression == "lz4":
                    try:
                        import lz4.frame  # type: ignore

                        records = lz4.frame.decompress(records)
                    except ImportError as e:
                        raise ValueError(
                            "lz4-compressed MCAP chunk needs the lz4 "
                            "package") from e
                elif compression not in ("", "none"):
                    raise ValueError(
                        f"unknown MCAP compression {compression!r}")
                mv = memoryview(records)
                self._parse_records(mv, 0, len(mv))
            elif op in (_OP_DATA_END, _OP_FOOTER):
                break  # summary section repeats schema/channel records

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[BagMessage]:
        for m in self._messages:
            if topics is None or m.connection.topic in topics:
                yield m


class McapBagWriter:
    """Write a chunkless (uncompressed) MCAP file: header, schemas,
    channels, messages, data-end, footer — readable by any MCAP reader."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MCAP_MAGIC)
        # the library name is the JAX package's, so that both write the
        # same bytes
        self._rec(_OP_HEADER, self._s("ros2") + self._s(SDK_NAME))
        self._schemas: Dict[str, int] = {}
        self._channels: Dict[Tuple[str, str], int] = {}

    @staticmethod
    def _s(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<I", len(b)) + b

    def _rec(self, op: int, body: bytes) -> None:
        self._f.write(struct.pack("<BQ", op, len(body)) + body)

    def _schema_id(self, msgtype: str) -> int:
        if msgtype not in self._schemas:
            sid = len(self._schemas) + 1
            self._schemas[msgtype] = sid
            definition = b"uint8[] buf" if "PacketMsg" in msgtype \
                else b"string data"
            self._rec(_OP_SCHEMA, struct.pack("<H", sid) +
                      self._s(msgtype) + self._s("ros2msg") +
                      struct.pack("<I", len(definition)) + definition)
        return self._schemas[msgtype]

    def _channel_id(self, topic: str, msgtype: str) -> int:
        key = (topic, msgtype)
        if key not in self._channels:
            cid = len(self._channels) + 1
            self._channels[key] = cid
            self._rec(_OP_CHANNEL, struct.pack(
                "<HH", cid, self._schema_id(msgtype)) + self._s(topic) +
                self._s("cdr") + struct.pack("<I", 0))
        return self._channels[key]

    def _write(self, topic: str, msgtype: str, cdr_body: bytes,
               ts_ns: int) -> None:
        cid = self._channel_id(topic, msgtype)
        data = b"\x00\x01\x00\x00" + cdr_body
        self._rec(_OP_MESSAGE, struct.pack("<HIQQ", cid, 0, ts_ns, ts_ns) +
                  data)

    def write_packet(self, topic: str, payload: bytes, ts_ns: int) -> None:
        self._write(topic, "ouster_sensor_msgs/msg/PacketMsg",
                    struct.pack("<I", len(payload)) + bytes(payload), ts_ns)

    def write_string(self, topic: str, text: str, ts_ns: int) -> None:
        raw = text.encode() + b"\x00"
        self._write(topic, "std_msgs/msg/String",
                    struct.pack("<I", len(raw)) + raw, ts_ns)

    def close(self) -> None:
        self._rec(_OP_DATA_END, struct.pack("<I", 0))
        self._rec(_OP_FOOTER, struct.pack("<QQI", 0, 0, 0))
        self._f.write(_MCAP_MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_bag_reader(path: str):
    """ROS1 / ROS2-sqlite / MCAP reader by storage probe."""
    if os.path.isdir(path) or path.endswith(".db3"):
        return Ros2BagReader(path)
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(_SQLITE_MAGIC):
        return Ros2BagReader(path)
    if head.startswith(_MCAP_MAGIC):
        return McapBagReader(path)
    return Ros1BagReader(path)


def _unpack_packet_msg(data: bytes, serialization: str = "ros1") -> bytes:
    """ouster_ros/PacketMsg (uint8[] buf): u32 length + bytes; ROS2 CDR
    adds a 4-byte encapsulation header."""
    off = 4 if serialization == "cdr" else 0
    n = struct.unpack_from("<I", data, off)[0]
    return data[off + 4:off + 4 + n]


def _unpack_string_msg(data: bytes, serialization: str = "ros1") -> str:
    off = 4 if serialization == "cdr" else 0
    n = struct.unpack_from("<I", data, off)[0]
    s = data[off + 4:off + 4 + n]
    if serialization == "cdr" and s.endswith(b"\x00"):
        s = s[:-1]  # ROS2 CDR strings are NUL-terminated
    return s.decode("utf-8", errors="replace")


_PACKET_MSG_TYPES = {
    "ouster_ros/PacketMsg", "ouster_ros/msg/PacketMsg",
    "ouster_sensor_msgs/msg/PacketMsg", "ouster_msgs/msg/PacketMsg",
}


class BagPacketSource:
    """(ref: bag/bag_packet_source.py): maps */lidar_packets, */imu_packets
    and */metadata topics to per-sensor packet streams."""

    def __init__(self, path: str, *,
                 meta: Optional[List[str]] = None,
                 soft_id_check: bool = False):
        self._reader = open_bag_reader(path)
        self._soft_id_check = soft_id_check
        self.id_error_count = 0

        conns = list(self._reader.connections.values())
        lidar_conns = [c for c in conns if c.msgtype in _PACKET_MSG_TYPES
                       and "lidar_packets" in c.topic]
        imu_conns = [c for c in conns if c.msgtype in _PACKET_MSG_TYPES
                     and "imu_packets" in c.topic]
        zone_conns = [c for c in conns if c.msgtype in _PACKET_MSG_TYPES
                      and "zone_packets" in c.topic]
        meta_conns = [c for c in conns
                      if c.msgtype in ("std_msgs/String", "std_msgs/msg/String")
                      and "metadata" in c.topic]

        # sensor index by namespace (ref: bag_packet_source.py:199-210)
        self._topic_sensor: Dict[str, Tuple[int, str]] = {}
        self._infos: List[Optional[SensorInfo]] = [None] * len(lidar_conns)
        for idx, conn in enumerate(sorted(lidar_conns,
                                          key=lambda c: c.topic)):
            ns = "/".join(conn.topic.split("/")[:-1]) + "/"
            self._topic_sensor[conn.topic] = (idx, "lidar")
            for ic in imu_conns:
                if ic.topic.startswith(ns):
                    self._topic_sensor[ic.topic] = (idx, "imu")
            for zc in zone_conns:
                if zc.topic.startswith(ns):
                    self._topic_sensor[zc.topic] = (idx, "zone")
            for mc in meta_conns:
                if mc.topic.startswith(ns):
                    for m in self._reader.messages([mc.topic]):
                        self._infos[idx] = sensor_info_from_metadata(
                            _unpack_string_msg(m.data,
                                               mc.serialization))
                        break

        if meta:
            for i, p in enumerate(meta):
                if i < len(self._infos):
                    with open(p) as f:
                        self._infos[i] = sensor_info_from_metadata(f.read())
        if not lidar_conns:
            raise ValueError(f"{path}: no ouster lidar packet topics found")
        missing = [i for i, info in enumerate(self._infos) if info is None]
        if missing:
            raise ValueError(
                f"{path}: no metadata for sensor(s) {missing}; pass meta=")

        from ..ops.packet_format import PacketFormat

        self._formats = [PacketFormat.from_info(i) for i in self._infos]

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return self._infos  # type: ignore[return-value]

    def __iter__(self) -> Iterator[Tuple[int, Packet]]:
        topics = list(self._topic_sensor)
        for m in self._reader.messages(topics):
            idx, kind = self._topic_sensor[m.connection.topic]
            payload = _unpack_packet_msg(m.data, m.connection.serialization)
            pf = self._formats[idx]
            if kind == "lidar" and len(payload) == pf.lidar_packet_size:
                pkt: Packet = LidarPacket(payload, m.timestamp)
                from ..core.packets import PacketValidationFailure

                res = pkt.validate(self._infos[idx], pf)
                if res == PacketValidationFailure.ID:
                    self.id_error_count += 1
                    if not self._soft_id_check:
                        continue
                yield idx, pkt
            elif kind == "imu" and len(payload) == pf.imu_packet_size:
                yield idx, ImuPacket(payload, m.timestamp)
            elif kind == "zone" and pf.zone_packet_size and \
                    len(payload) == pf.zone_packet_size:
                yield idx, ZonePacket(payload, m.timestamp)

    def close(self) -> None:
        pass


class BagScanSource(ScanSource):
    """(ref: bag/bag_scan_source.py)"""

    def __init__(self, path: str, *, meta=None, soft_id_check=False,
                 extrinsics=None, extrinsics_file=None,
                 error_handler=None):
        # bags have no schema-version gate; error_handler is accepted
        # for option parity with the other backends
        self._packets = BagPacketSource(path, meta=meta,
                                        soft_id_check=soft_id_check)
        infos = self._packets.sensor_info
        populate_extrinsics(infos, extrinsics, extrinsics_file)
        super().__init__(infos)

    def _iter_sets(self):
        from ..core.batcher import ScanBatcher
        from ..core.lidar_scan import LidarScan

        def scans():
            batchers = [ScanBatcher(i) for i in self.sensor_info]
            current = [LidarScan(i) for i in self.sensor_info]
            for idx, pkt in self._packets:
                if batchers[idx](pkt, current[idx]):
                    out = current[idx]
                    current[idx] = LidarScan(self.sensor_info[idx])
                    yield idx, out
            for idx, s in enumerate(current):
                if s.frame_id != -1 and np.any(s.status & 1):
                    yield idx, s

        return collate_scans(scans(), len(self.sensor_info))


class Ros1BagWriter:
    """Indexed, uncompressed ROS1 v2.0 bag writer interoperable with
    standard tooling (ref: source_save.py bag save; rosbag v2.0 format
    spec): one chunk, per-connection INDEX_DATA records, post-chunk
    connection records, a CHUNK_INFO record, and a backfilled bag header
    (index_pos/conn_count/chunk_count) — `rosbag info`-compatible, with
    per-type ROS md5sums so `rosbag play` accepts the messages."""

    # dependency-free definitions: the ROS md5 of such a message is the
    # md5 of its canonical definition text
    _DEFS = {
        "std_msgs/String": "string data",
        "ouster_ros/PacketMsg": "uint8[] buf",
    }

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._conns: Dict[str, int] = {}
        self._conn_meta: List[Tuple[str, str]] = []  # (topic, msgtype)
        self._records = bytearray()
        # per conn: [(time_sec, time_nsec, chunk_offset)]
        self._index: Dict[int, List[Tuple[int, int, int]]] = {}
        self._t_min: Optional[Tuple[int, int]] = None
        self._t_max: Optional[Tuple[int, int]] = None
        self._write_bag_header(index_pos=0, conn_count=0, chunk_count=0)

    def _write_bag_header(self, index_pos: int, conn_count: int,
                          chunk_count: int) -> None:
        hdr = _make_header({
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", index_pos),
            b"conn_count": struct.pack("<I", conn_count),
            b"chunk_count": struct.pack("<I", chunk_count),
        })
        # the bag header record is padded to 4096 bytes total via its
        # data section (rosbag convention)
        pad = 4096 - (4 + len(hdr) + 4)
        self._f.write(struct.pack("<I", len(hdr)))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", pad))
        self._f.write(b" " * pad)

    @classmethod
    def _md5(cls, msgtype: str) -> bytes:
        import hashlib

        text = cls._DEFS.get(msgtype, "uint8[] buf")
        return hashlib.md5(text.encode()).hexdigest().encode()

    def _conn_record(self, cid: int, topic: str, msgtype: str) -> bytes:
        conn_data = _make_header({
            b"topic": topic.encode(),
            b"type": msgtype.encode(),
            b"md5sum": self._md5(msgtype),
            b"message_definition":
                self._DEFS.get(msgtype, "uint8[] buf").encode(),
        })
        rec_hdr = _make_header({
            b"op": bytes([OP_CONNECTION]),
            b"conn": struct.pack("<I", cid),
            b"topic": topic.encode(),
        })
        return (struct.pack("<I", len(rec_hdr)) + rec_hdr
                + struct.pack("<I", len(conn_data)) + conn_data)

    def _conn_id(self, topic: str, msgtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        self._conn_meta.append((topic, msgtype))
        self._records += self._conn_record(cid, topic, msgtype)
        return cid

    def write_string(self, topic: str, text: str, ts_ns: int) -> None:
        data = text.encode()
        payload = struct.pack("<I", len(data)) + data
        self._write_msg(topic, "std_msgs/String", payload, ts_ns)

    def write_packet(self, topic: str, payload: bytes, ts_ns: int) -> None:
        msg = struct.pack("<I", len(payload)) + bytes(payload)
        self._write_msg(topic, "ouster_ros/PacketMsg", msg, ts_ns)

    def _write_msg(self, topic: str, msgtype: str, payload: bytes,
                   ts_ns: int) -> None:
        cid = self._conn_id(topic, msgtype)
        sec, nsec = divmod(ts_ns, 1_000_000_000)
        off = len(self._records)
        rec_hdr = _make_header({
            b"op": bytes([OP_MSG]),
            b"conn": struct.pack("<I", cid),
            b"time": struct.pack("<II", sec, nsec),
        })
        self._records += struct.pack("<I", len(rec_hdr)) + rec_hdr
        self._records += struct.pack("<I", len(payload)) + payload
        self._index.setdefault(cid, []).append((sec, nsec, off))
        if self._t_min is None or (sec, nsec) < self._t_min:
            self._t_min = (sec, nsec)
        if self._t_max is None or (sec, nsec) > self._t_max:
            self._t_max = (sec, nsec)

    def close(self) -> None:
        chunk_pos = self._f.tell()
        chunk_hdr = _make_header({
            b"op": bytes([OP_CHUNK]),
            b"compression": b"none",
            b"size": struct.pack("<I", len(self._records)),
        })
        self._f.write(struct.pack("<I", len(chunk_hdr)))
        self._f.write(chunk_hdr)
        self._f.write(struct.pack("<I", len(self._records)))
        self._f.write(self._records)

        # per-connection INDEX_DATA (v1): entries (time, chunk offset)
        for cid, entries in sorted(self._index.items()):
            idx_hdr = _make_header({
                b"op": bytes([OP_INDEX]),
                b"ver": struct.pack("<I", 1),
                b"conn": struct.pack("<I", cid),
                b"count": struct.pack("<I", len(entries)),
            })
            data = b"".join(struct.pack("<III", sec, nsec, off)
                            for sec, nsec, off in entries)
            self._f.write(struct.pack("<I", len(idx_hdr)))
            self._f.write(idx_hdr)
            self._f.write(struct.pack("<I", len(data)))
            self._f.write(data)

        # index section: connection records then the chunk info record
        index_pos = self._f.tell()
        for cid, (topic, msgtype) in enumerate(self._conn_meta):
            self._f.write(self._conn_record(cid, topic, msgtype))
        t0 = self._t_min or (0, 0)
        t1 = self._t_max or (0, 0)
        ci_hdr = _make_header({
            b"op": bytes([OP_CHUNK_INFO]),
            b"ver": struct.pack("<I", 1),
            b"chunk_pos": struct.pack("<Q", chunk_pos),
            b"start_time": struct.pack("<II", *t0),
            b"end_time": struct.pack("<II", *t1),
            b"count": struct.pack("<I", len(self._conn_meta)),
        })
        ci_data = b"".join(
            struct.pack("<II", cid, len(self._index.get(cid, [])))
            for cid in range(len(self._conn_meta)))
        self._f.write(struct.pack("<I", len(ci_hdr)))
        self._f.write(ci_hdr)
        self._f.write(struct.pack("<I", len(ci_data)))
        self._f.write(ci_data)

        # backfill the bag header with the real index position/counts
        self._f.seek(len(_MAGIC))
        self._write_bag_header(index_pos, len(self._conn_meta), 1)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
