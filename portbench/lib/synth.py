"""Synthesized sensor streams, in numpy alone: an Ouster sensor's lidar
packets for a configuration's metadata, written as a pcap with IPv4
fragments, as a sensor's stream recorded on the wire.

The packet layout is Ouster's lidar data format for the non-legacy
profiles (a 32-byte packet header, 16 columns each of a 12-byte column
header and `pixels_per_column` pixels, a 32-byte packet footer), with the
pixel fields of RNG19_RFL8_SIG16_NIR16_DUAL and RNG19_RFL8_SIG16_NIR16.
Every frame is made from (seed, frame index) alone, so the reference
(reference/scan.py) makes any frame again without reading the capture.

Frames follow the smoke run's synthesizer: random ranges with a share of
zeros, RANGE2 = RANGE // 2, random signal, reflectivity and near-IR, and a
share of columns whose status bit is cleared.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

# pixel fields: name -> (first bit within the pixel, bits)
PROFILES: Dict[str, Tuple[int, Dict[str, Tuple[int, int]]]] = {
    "RNG19_RFL8_SIG16_NIR16_DUAL": (16, {
        "RANGE": (0, 19), "FLAGS": (19, 5), "REFLECTIVITY": (24, 8),
        "RANGE2": (32, 19), "FLAGS2": (51, 5), "REFLECTIVITY2": (56, 8),
        "SIGNAL": (64, 16), "SIGNAL2": (80, 16), "NEAR_IR": (96, 16),
        "WINDOW": (120, 8)}),
    "RNG19_RFL8_SIG16_NIR16": (12, {
        "RANGE": (0, 19), "FLAGS": (19, 5), "REFLECTIVITY": (32, 8),
        "SIGNAL": (48, 16), "NEAR_IR": (64, 16), "WINDOW": (88, 8)}),
}
PACKET_HEADER = 32
PACKET_FOOTER = 32
COL_HEADER = 12
FRAME_NS = 100_000_000          # 10 Hz
T0_NS = 10**9                   # host time of the first frame
MTU = 1500
LIDAR_PORT = 7502


class Sensor:
    """The numbers of a configuration's metadata that the packets and the
    reference need."""

    def __init__(self, metadata: dict):
        fmt = metadata["lidar_data_format"]
        self.metadata = metadata
        self.profile = fmt["udp_profile_lidar"]
        self.h = int(fmt["pixels_per_column"])
        self.w = int(fmt["columns_per_frame"])
        self.cpp = int(fmt["columns_per_packet"])
        self.n_pkts = self.w // self.cpp
        self.shifts = np.asarray(fmt["pixel_shift_by_row"], np.int64)
        self.px_bytes, self.fields = PROFILES[self.profile]
        self.col_bytes = COL_HEADER + self.h * self.px_bytes
        self.packet_bytes = (PACKET_HEADER + self.cpp * self.col_bytes
                             + PACKET_FOOTER)
        info = metadata["sensor_info"]
        self.init_id = int(info["initialization_id"])
        self.sn = int(info["prod_sn"])

    @property
    def dual(self) -> bool:
        return "RANGE2" in self.fields

    @property
    def returns(self) -> Tuple[str, ...]:
        return ("RANGE", "RANGE2") if self.dual else ("RANGE",)


def frame_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), index])


def frame_times(sensor: Sensor, index: int) -> Tuple[np.ndarray, np.ndarray]:
    """(column timestamps (w,), packet host timestamps (n_pkts,)) of frame
    `index`, in ns; host times are whole microseconds, as a pcap keeps
    them."""
    t = T0_NS + index * FRAME_NS
    col_ts = t + np.arange(sensor.w, dtype=np.uint64) * (FRAME_NS // sensor.w)
    step_us = FRAME_NS // 1000 // sensor.n_pkts
    pkt_ts = t + np.arange(sensor.n_pkts, dtype=np.uint64) * step_us * 1000
    return col_ts, pkt_ts


def random_frame(sensor: Sensor, data: dict, seed: int, index: int) -> dict:
    """Frame `index` of a random stream: {"fields": {name: (h, w)},
    "status": (w,) u16, "col_ts", "pkt_ts", "frame_id"}. `data` gives
    the shares of zero ranges and of invalid columns."""
    rng = frame_rng(seed, index)
    h, w = sensor.h, sensor.w
    status = (rng.random(w) >= data["invalid_column_share"]).astype(np.uint16)
    rng_ = rng.integers(1, 1 << 19, (h, w), dtype=np.uint32)
    rng_[rng.random((h, w)) < data["zero_range_share"]] = 0
    fields = {"RANGE": rng_}
    if sensor.dual:
        fields["RANGE2"] = rng_ // 2
    for name, bits in (("SIGNAL", 16), ("SIGNAL2", 16), ("REFLECTIVITY", 8),
                       ("REFLECTIVITY2", 8), ("NEAR_IR", 16)):
        if name in sensor.fields:
            fields[name] = rng.integers(0, 1 << bits, (h, w), dtype=np.uint32)
    col_ts, pkt_ts = frame_times(sensor, index)
    return {"fields": fields, "status": status, "col_ts": col_ts,
            "pkt_ts": pkt_ts, "frame_id": index + 1}


def _put(words: np.ndarray, bit: int, size: int, value) -> None:
    """OR `value` (size bits) into the little-endian u32 words at `bit`
    (last axis), across a word boundary where it falls on one."""
    v = np.asarray(value, np.uint64) & np.uint64((1 << size) - 1)
    k, s = divmod(bit, 32)
    words[..., k] |= ((v << np.uint64(s)) & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32)
    if s + size > 32:
        words[..., k + 1] |= (v >> np.uint64(32 - s)).astype(np.uint32)


def frame_payloads(sensor: Sensor, frame: dict) -> np.ndarray:
    """The frame's lidar packets as (n_pkts, packet_bytes) u8."""
    h, w, cpp = sensor.h, sensor.w, sensor.cpp
    pw = sensor.px_bytes // 4
    cw = sensor.col_bytes // 4
    cols = np.zeros((w, cw), np.uint32)
    _put(cols, 0, 64, frame["col_ts"])
    _put(cols, 64, 16, np.arange(w))
    _put(cols, 80, 16, frame["status"])
    px = cols[:, COL_HEADER // 4:].reshape(w, h, pw)
    for name, values in frame["fields"].items():
        bit, size = sensor.fields[name]
        _put(px, bit, size, values.T)
    cols[:, COL_HEADER // 4:] = px.reshape(w, h * pw)
    words = np.zeros((sensor.n_pkts, sensor.packet_bytes // 4), np.uint32)
    hw = PACKET_HEADER // 4
    words[:, hw:hw + cpp * cw] = cols.reshape(sensor.n_pkts, cpp * cw)
    _put(words, 0, 16, 1)                        # packet type: lidar
    _put(words, 16, 16, frame["frame_id"])
    _put(words, 32, 24, sensor.init_id)
    _put(words, 56, 40, sensor.sn)
    return words.view(np.uint8)


class PcapWriter:
    """Classic pcap (Ethernet, microsecond stamps) of UDP datagrams from
    10.0.0.2 to 10.0.0.1, each cut into IPv4 fragments of at most MTU
    bytes, a frame's packets at a time."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._ip_id = 0
        header = np.zeros(6, np.uint32)
        header[:] = [0xA1B2C3D4, 2 | (4 << 16), 0, 0, 0x40000, 1]
        self._f.write(header.tobytes())

    def write(self, payloads: np.ndarray, host_ts: np.ndarray) -> None:
        n, size = payloads.shape
        dgram = np.empty((n, 8 + size), np.uint8)
        udp = np.array([LIDAR_PORT, LIDAR_PORT, 8 + size, 0], ">u2")
        dgram[:, :8] = udp.view(np.uint8)
        dgram[:, 8:] = payloads
        step = (MTU - 20) & ~7
        offs = list(range(0, dgram.shape[1], step))
        rec = [16 + 14 + 20 + min(step, dgram.shape[1] - o) for o in offs]
        out = np.zeros((n, sum(rec)), np.uint8)
        ids = (self._ip_id + 1 + np.arange(n)) & 0xFFFF
        self._ip_id = int(ids[-1])
        sec, rem = np.divmod(host_ts.astype(np.uint64), np.uint64(10**9))
        usec = rem // np.uint64(1000)
        at = 0
        for off, length in zip(offs, rec):
            data = length - 50
            more = off + data < dgram.shape[1]
            hdr = np.zeros((n, 4), np.uint32)
            hdr[:, 0], hdr[:, 1] = sec, usec
            hdr[:, 2] = hdr[:, 3] = length - 16
            out[:, at:at + 16] = hdr.view(np.uint8)
            out[:, at + 28:at + 30] = np.array([0x08, 0x00], np.uint8)
            ip = np.zeros((n, 10), ">u2")
            ip[:, 0] = 0x4500
            ip[:, 1] = 20 + data
            ip[:, 2] = ids
            ip[:, 3] = (0x2000 if more else 0) | (off // 8)
            ip[:, 4] = (64 << 8) | 17
            ip[:, 6], ip[:, 7] = 0x0A00, 0x0002     # 10.0.0.2
            ip[:, 8], ip[:, 9] = 0x0A00, 0x0001     # 10.0.0.1
            out[:, at + 30:at + 50] = ip.view(np.uint8)
            out[:, at + 50:at + length] = dgram[:, off:off + data]
            at += length
        self._f.write(out.tobytes())

    def close(self) -> None:
        """Close the file once its blocks are on the disk: set-up waits for
        the write-back instead of the measured window competing with it."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()


def write_capture(directory: str, metadata: dict,
                  frames: Iterable[dict]) -> str:
    """Write `frames` (random_frame's dicts) as capture.pcap, with the
    sensor's metadata as capture.json beside it (where a replaying user
    keeps it); returns the pcap's path. Both files are written under
    temporary names and renamed, so a reader never sees half a capture,
    and synced to the disk (PcapWriter.close)."""
    os.makedirs(directory, exist_ok=True)
    sensor = Sensor(metadata)
    path = os.path.join(directory, "capture.pcap")
    meta = os.path.join(directory, "capture.json")
    writer = PcapWriter(path + ".partial")
    try:
        for frame in frames:
            writer.write(frame_payloads(sensor, frame), frame["pkt_ts"])
    finally:
        writer.close()
    with open(meta + ".partial", "w") as f:
        json.dump(metadata, f, indent=1)
    os.replace(path + ".partial", path)
    os.replace(meta + ".partial", meta)
    return path


def random_frames(sensor: Sensor, data: dict, seed: int, n: int
                  ) -> Iterator[dict]:
    return (random_frame(sensor, data, seed, k) for k in range(n))
