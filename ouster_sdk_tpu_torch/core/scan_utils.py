"""Scan/packet helper utilities from the reference's core namespace.

Small, host-side helpers that the reference exports at
``ouster.sdk.core`` (ref: python/src/ouster/sdk/core/core.py:51-103,
data.py:18,69,195). Kept separate from the containers so the hot path
stays free of convenience-layer imports.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional, Union

import numpy as np

from .lidar_scan import LidarScan
from .packets import LidarPacket, Packet
from .types import SensorInfo

#: Buffer-like types accepted by packet APIs (ref: core/data.py:18).
BufferT = Union[bytes, bytearray, memoryview, np.ndarray]


class ColHeader(Enum):
    """Column headers available in lidar data (deprecated in the
    reference but still exported; ref: core/data.py:69-81)."""
    TIMESTAMP = 0
    ENCODER_COUNT = 1
    MEASUREMENT_ID = 2
    STATUS = 3
    FRAME_ID = 4

    def __int__(self) -> int:
        return self.value


class FrameBorder:
    """Callable that flags lidar packets whose frame id differs from the
    previous packet's (ref: core/core.py:51-72). ``pred`` gates whether a
    detected border is reported. Non-lidar packets never report a border.

    Consecutive calls with the same packet (identified by a nonzero host
    receive timestamp) return the cached answer instead of re-deciding, so
    wrapping iterators may probe the same packet twice.
    """

    def __init__(self, meta: SensorInfo,
                 pred: Callable[[Packet], bool] = lambda _: True):
        from ..ops.packet_format import PacketFormat

        self._pf = PacketFormat(meta)
        self._pred = pred
        self._prev_frame: Optional[int] = None
        self._memo: tuple = (None, False)  # (host_ts, last answer)

    def __call__(self, packet: Packet) -> bool:
        if not isinstance(packet, LidarPacket):
            return False
        memo_ts, memo_res = self._memo
        if memo_ts and packet.host_timestamp and memo_ts == packet.host_timestamp:
            return memo_res
        frame = self._pf.frame_id(packet.buf)
        crossed = self._prev_frame is not None and frame != self._prev_frame
        self._prev_frame = frame
        result = bool(crossed and self._pred(packet))
        self._memo = (packet.host_timestamp, result)
        return result


def first_valid_column_pose(scan: LidarScan) -> np.ndarray:
    """Pose of the first valid column (ref: core/core.py:75)."""
    return scan.pose[int(scan.get_first_valid_column())]


def last_valid_column_pose(scan: LidarScan) -> np.ndarray:
    """Pose of the last valid column (ref: core/core.py:80)."""
    return scan.pose[int(scan.get_last_valid_column())]


def valid_packet_idxs(scan: LidarScan) -> np.ndarray:
    """Indices of packets that contributed to the scan
    (ref: core/core.py:85-98).

    A packet counts as present when either holds: some column it carried
    has a valid status bit, or its host receive timestamp is nonzero (a
    packet can arrive with headers only, every pixel column invalid).
    """
    n_packets = scan.packet_timestamp.shape[0]
    col_ok = (scan.status & 0x1).astype(bool).reshape(n_packets, -1)
    present = col_ok.any(axis=1) | (scan.packet_timestamp != 0)
    return np.flatnonzero(present)


def poses_present(scan: LidarScan) -> bool:
    """True when any column pose differs from identity
    (ref: core/core.py:100-102)."""
    return not np.allclose(np.eye(4), scan.pose)


def packet_ts(packet: Packet) -> int:
    """Packet host receive timestamp in nanoseconds
    (ref: core/data.py:195)."""
    return packet.host_timestamp
