"""Golden-digest hashing of parsed lidar data.

Rebuild of the reference digest mechanism
(ref: python/src/ouster/sdk/core/_digest.py:22-168): md5 over the raw bytes
of every parsed field and header array. This is the bit-exactness conformance
contract against the reference `tests/pcaps/*_digest.json` files.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List

import numpy as np

from ..core.batcher import ScanBatcher
from ..core.lidar_scan import LidarScan
from ..core.packets import LidarPacket
from ..ops.packet_format import PacketFormat

# ColHeader indices (ref: python/src/ouster/sdk/core/data.py:69-80)
_COL_HEADERS = {
    "TIMESTAMP": 0,
    "ENCODER_COUNT": 1,
    "MEASUREMENT_ID": 2,
    "STATUS": 3,
    "FRAME_ID": 4,
}


def _md5(a: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()


class FieldDigest:
    """(ref: _digest.py:27-82)"""

    def __init__(self, **hashes: str):
        self.hashes: Dict[str, str] = hashes

    def __eq__(self, other: object) -> bool:
        return isinstance(other, FieldDigest) and self.hashes == other.hashes

    def check(self, other: "FieldDigest") -> None:
        for k, v in sorted(self.hashes.items()):
            if k == "ENCODER_COUNT":
                continue  # deprecated (ref: _digest.py:46-48)
            assert other.hashes.get(k) == v, f"Match failure key: {k}"

    @classmethod
    def from_packets(cls, packets: Iterable[LidarPacket],
                     pf: PacketFormat) -> "FieldDigest":
        hashes: Dict[str, "hashlib._Hash"] = defaultdict(hashlib.md5)
        for packet in packets:
            for name, idx in _COL_HEADERS.items():
                hashes[name].update(
                    pf.packet_header(idx, packet.buf).tobytes())
            for field_name in pf.fields:
                hashes[field_name].update(
                    pf.packet_field(field_name, packet.buf).tobytes())
        return cls(**{k: v.hexdigest() for k, v in hashes.items()})

    @classmethod
    def from_scan(cls, ls: LidarScan) -> "FieldDigest":
        hashes = {"FRAME_ID": str(ls.frame_id)}
        hashes["TIMESTAMP"] = _md5(ls.timestamp.astype(np.uint64))
        hashes["STATUS"] = _md5(ls.status.astype(np.uint64))
        hashes["MEASUREMENT_ID"] = _md5(ls.measurement_id.astype(np.uint16))
        for name in ls.fields:
            hashes[name] = _md5(ls.field(name))
        return cls(**hashes)


@dataclass
class StreamDigest:
    """(ref: _digest.py:85-168)"""

    packet_hash: FieldDigest
    scans: List[FieldDigest]

    def check(self, other: "StreamDigest") -> None:
        assert len(self.scans) == len(other.scans), \
            f"scan count mismatch: {len(self.scans)} vs {len(other.scans)}"
        self.packet_hash.check(other.packet_hash)
        for s, t in zip(self.scans, other.scans):
            s.check(t)

    def to_json(self) -> str:
        return json.dumps(
            {"packet_hash": self.packet_hash.hashes,
             "scans": [d.hashes for d in self.scans]},
            indent=4)

    @classmethod
    def from_json(cls, json_data: str) -> "StreamDigest":
        d = json.loads(json_data)
        return cls(
            packet_hash=FieldDigest(**d["packet_hash"]),
            scans=[FieldDigest(**h) for h in d.get("scans", [])])

    @classmethod
    def from_packet_source(cls, source) -> "StreamDigest":
        """Batch ALL lidar packets like the reference (no sensor-index
        filter; ref: _digest.py:124-159), restricted to packets that
        parse with sensor 0's format — the reference is only ever fed
        single-sensor streams, and mixed-format packets would make its
        own FieldDigest crash identically."""
        metadata = source.sensor_info[0]
        pf = PacketFormat.from_info(metadata)
        packets = [p for idx, p in source
                   if isinstance(p, LidarPacket)
                   and len(p.buf) == pf.lidar_packet_size]
        batcher = ScanBatcher(metadata)

        scans: List[LidarScan] = []
        scan = LidarScan(metadata)
        fresh = True
        for p in packets:
            fresh = False
            if batcher(p, scan):
                scans.append(scan)
                scan = LidarScan(metadata)
                fresh = True
        if not fresh:
            scans.append(scan)

        return cls(
            packet_hash=FieldDigest.from_packets(packets, pf),
            scans=[FieldDigest.from_scan(s) for s in scans])
