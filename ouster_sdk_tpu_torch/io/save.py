"""Re-packetize scans: scan_to_packets.

The one function of the SDK's save sink (ref: python/src/ouster/cli/
plugins/source_save.py) that the live path needs: the sensor emulator
(sensor/emulator.py) serves scans as the UDP packets a sensor would have
sent. The point-cloud exports of the save sink (pcap, CSV, PLY, PCD, LAS
with extension dispatch) are not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.constants import (
    FRAME_STATUS_SHOT_LIMITING_SHIFT,
    FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT,
)
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..ops.packet_format import PacketWriter


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
        # valid column AND no host timestamp was never received: skip
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
        # (lidar_scan_impl.h:520 set_col_measurement_id(col_buf, id)): a
        # scan's measurement_id header is not trusted here
        pw.set_col_headers(buf, scan.timestamp[cols],
                           np.arange(p * cpp, (p + 1) * cpp,
                                     dtype=np.uint16), statuses)
        for name in pw.fields:
            if scan.has_field(name) and not name.startswith("RAW32"):
                pw.set_field(buf, name, scan.field(name)[:, cols])
        out.append(buf)
    return out
