"""Active time correction: reconcile multi-sensor clocks before SLAM.

Rebuild of the reference ActiveTimeCorrection (ref: ouster_mapping/src/
active_time_correction.{h,cpp}:290): checks inter-sensor synchronization
(tolerance = the minimum frame duration) and column-timestamp
monotonicity — including continuity against the previous frame's end —
rewrites non-monotonic frames from the previous frame start + frame
duration, and when clocks disagree (no PTP) falls back to
packet-receive-time offsets applied to BOTH column and IMU timestamps.
Offsets/rewrites are applied in update() and restored in reset().
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.logging import logger
from ..core.types import SensorInfo


def is_monotonically_increasing(ts: np.ndarray,
                                last_frame_stop_ts: int = -1) -> bool:
    """Non-zero timestamps must be strictly increasing, and (when known)
    start after the previous frame's end
    (ref: active_time_correction.cpp:183-205)."""
    nz = np.asarray(ts)[np.asarray(ts) != 0].astype(np.int64)
    if nz.size <= 1:
        return True
    if last_frame_stop_ts >= 0 and nz[0] <= last_frame_stop_ts:
        return False
    return bool(np.all(np.diff(nz) > 0))


class ActiveTimeCorrection:
    def __init__(self, infos: Sequence[SensorInfo]):
        self._infos = list(infos)
        self._frame_durations = [
            1e9 / max(i.format.fps, 1) for i in infos]
        self._use_packet_offset = False
        self._last_ts_range: List[Tuple[int, int]] = \
            [(-1, -1)] * len(infos)
        # state to restore in reset(): per sensor, the original column /
        # IMU timestamp arrays (None = untouched)
        self._orig_ts: List[Optional[np.ndarray]] = [None] * len(infos)
        self._orig_imu_ts: List[Optional[np.ndarray]] = \
            [None] * len(infos)

    @staticmethod
    def _frame_ts_range(scans: Sequence[Optional[LidarScan]]
                        ) -> List[Tuple[int, int]]:
        out = []
        for s in scans:
            if s is None:
                out.append((-1, -1))
            else:
                out.append((s.first_valid_column_timestamp(),
                            s.last_valid_column_timestamp()))
        return out

    def _check_sync(self, ranges: List[Tuple[int, int]]) -> bool:
        starts = [r[0] for r in ranges if r[0] > 0]
        if len(starts) <= 1:
            return True
        # tolerance = the shortest frame duration among the sensors
        # (ref: active_time_correction.cpp:178-181)
        tol = min(self._frame_durations) if self._frame_durations \
            else 100e6
        return (max(starts) - min(starts)) <= tol

    def _correct_scan_ts(self, scan: LidarScan, idx: int) -> None:
        """Rewrite a non-monotonic frame's valid-column timestamps from
        the previous frame start + frame duration
        (ref: active_time_correction.cpp:221-244)."""
        start_col = scan.first_valid_column()
        stop_col = scan.last_valid_column()
        if start_col < 0:
            return
        last_start = self._last_ts_range[idx][0]
        new_start = (int(scan.timestamp[start_col]) if last_start <= 0
                     else last_start + int(self._frame_durations[idx]))
        col_dur = self._frame_durations[idx] / float(scan.w)
        status = scan.status
        for col in range(start_col, stop_col + 1):
            if status[col] & 0x01:
                scan.timestamp[col] = np.uint64(
                    new_start + int((col - start_col) * col_dur))

    def update(self, scans: Sequence[Optional[LidarScan]]) -> List[int]:
        """Validate clocks and apply corrections/offsets in place;
        returns the offsets (ns) applied to each sensor's timestamps."""
        ranges = self._frame_ts_range(scans)
        n = len(self._infos)
        self._orig_ts = [None] * n
        self._orig_imu_ts = [None] * n

        # monotonicity (incl. continuity vs the previous frame's end):
        # rewrite broken frames and engage packet-offset mode
        all_monotonic = True
        for i, s in enumerate(scans):
            if s is None:
                continue
            last_stop = self._last_ts_range[i][1] if \
                i < len(self._last_ts_range) else -1
            if not is_monotonically_increasing(s.timestamp, last_stop):
                self._orig_ts[i] = s.timestamp.copy()
                self._correct_scan_ts(s, i)
                all_monotonic = False

        if not all_monotonic and not self._use_packet_offset:
            self._use_packet_offset = True
            logger().warning(
                "Lidarscan timestamps are not monotonically increasing. "
                "Using estimated clock offsets, results may be affected")

        if not self._check_sync(ranges) and not self._use_packet_offset:
            self._use_packet_offset = True
            logger().warning(
                "Sensors appear unsynchronized. Using estimated clock "
                "offsets, results may be affected")

        offsets = [0] * n
        if self._use_packet_offset:
            # align each sensor's column clock to its host receive clock
            # (ref: active_time_correction.cpp calculate_fallback)
            for i, s in enumerate(scans):
                if s is None:
                    continue
                col_ts = s.first_valid_column_timestamp()
                pkt_ts = s.first_valid_packet_timestamp()
                if col_ts and pkt_ts:
                    offsets[i] = int(pkt_ts) - int(col_ts)
            for i, s in enumerate(scans):
                if s is None or not offsets[i]:
                    continue
                if self._orig_ts[i] is None:
                    self._orig_ts[i] = s.timestamp.copy()
                nz = s.timestamp != 0
                s.timestamp[nz] = (
                    s.timestamp[nz].astype(np.int64)
                    + offsets[i]).astype(np.uint64)
                # IMU timestamps ride the same clock — shift them too or
                # IMU deskew interpolates against the wrong timeline
                # (ref: active_time_correction.cpp:117-133)
                if s.has_field(ChanField.IMU_TIMESTAMP):
                    imu_ts = s.field(ChanField.IMU_TIMESTAMP)
                    self._orig_imu_ts[i] = imu_ts.copy()
                    inz = imu_ts != 0
                    imu_ts[inz] = (imu_ts[inz].astype(np.int64)
                                   + offsets[i]).astype(np.uint64)

        self._last_ts_range = self._frame_ts_range(scans)
        return offsets

    def reset(self, scans: Sequence[Optional[LidarScan]]) -> None:
        """Restore original timestamps post-registration
        (ref: active_time_correction.h reset)."""
        for i, s in enumerate(scans):
            if s is None:
                continue
            if i < len(self._orig_ts) and self._orig_ts[i] is not None:
                s.timestamp[:] = self._orig_ts[i]
            if i < len(self._orig_imu_ts) and \
                    self._orig_imu_ts[i] is not None:
                s.field(ChanField.IMU_TIMESTAMP)[:] = \
                    self._orig_imu_ts[i]
        self._orig_ts = [None] * len(self._infos)
        self._orig_imu_ts = [None] * len(self._infos)
