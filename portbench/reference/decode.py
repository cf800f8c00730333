"""A plain pcap reader (IPv4 fragments reassembled) and a decoder of Ouster
lidar packets by the profile's bit table: what a capture holds, read back
without the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..lib.synth import COL_HEADER, PACKET_HEADER, Sensor


def read_datagrams(path: str) -> List[Tuple[int, bytes]]:
    """(host time ns, UDP payload) of every datagram of a classic pcap of
    Ethernet frames, fragments reassembled by IP id."""
    with open(path, "rb") as f:
        data = f.read()
    if int.from_bytes(data[:4], "little") != 0xA1B2C3D4:
        raise ValueError(f"{path}: not a little-endian microsecond pcap")
    pos, out, parts = 24, [], {}
    while pos + 16 <= len(data):
        sec, usec, incl, _ = np.frombuffer(data[pos:pos + 16], "<u4")
        frame = data[pos + 16:pos + 16 + int(incl)]
        pos += 16 + int(incl)
        ip = frame[14:]
        ihl = (ip[0] & 15) * 4
        ip_id = int.from_bytes(ip[4:6], "big")
        ff = int.from_bytes(ip[6:8], "big")
        total = int.from_bytes(ip[2:4], "big")
        chunk = ip[ihl:total]
        got = parts.setdefault(ip_id, {})
        got[(ff & 0x1FFF) * 8] = chunk
        if ff & 0x2000:
            continue
        dgram = b"".join(got[k] for k in sorted(got))
        del parts[ip_id]
        out.append((int(sec) * 10**9 + int(usec) * 1000, dgram[8:]))
    return out


def _get(words: np.ndarray, bit: int, size: int) -> np.ndarray:
    k, s = divmod(bit, 32)
    v = words[..., k].astype(np.uint64) >> np.uint64(s)
    if s + size > 32:
        v |= words[..., k + 1].astype(np.uint64) << np.uint64(32 - s)
    return (v & np.uint64((1 << size) - 1)).astype(np.int64)


def decode_packet(sensor: Sensor, payload: bytes) -> Dict[str, np.ndarray]:
    """{frame_id, m_id (cpp,), status, timestamp, <field> (h, cpp)}."""
    words = np.frombuffer(payload, "<u4")
    cw = sensor.col_bytes // 4
    hw = PACKET_HEADER // 4
    cols = words[hw:hw + sensor.cpp * cw].reshape(sensor.cpp, cw)
    px = cols[:, COL_HEADER // 4:].reshape(sensor.cpp, sensor.h, -1)
    out = {"frame_id": int(_get(words, 16, 16)),
           "m_id": _get(cols, 64, 16), "status": _get(cols, 80, 16),
           "timestamp": _get(cols, 0, 64)}
    for name, (bit, size) in sensor.fields.items():
        out[name] = _get(px, bit, size).T
    return out
