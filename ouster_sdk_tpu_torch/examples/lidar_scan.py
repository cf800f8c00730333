"""LidarScan anatomy example (ref: sdk/examples/lidar_scan.py):
construct scans, add custom fields, inspect headers."""

from __future__ import annotations

import numpy as np

from .. import ChanField, LidarScan, SensorInfo, get_field_types


def lidar_scan_example(info: SensorInfo) -> LidarScan:
    """Build a scan, list default field types, attach a custom field
    (ref: examples/lidar_scan.py:6)."""
    scan = LidarScan(info)
    print("default field types:")
    for ft in get_field_types(info):
        print(f"  {ft.name}: {np.dtype(ft.element_type).name}")

    # per-pixel custom field
    scan.add_field("MY_CUSTOM", np.zeros((scan.h, scan.w),
                                         dtype=np.float32))
    scan.field("MY_CUSTOM")[:] = 42.0

    # headers
    print(f"frame_id={scan.frame_id} w={scan.w} h={scan.h} "
          f"packets={scan.packet_count}")
    print(f"timestamps shape {scan.timestamp.shape}, "
          f"poses shape {scan.pose.shape}")
    assert scan.has_field(ChanField.RANGE)
    return scan


if __name__ == "__main__":
    import sys

    from ..core.metadata import sensor_info_from_metadata

    info = sensor_info_from_metadata(open(sys.argv[1]).read())
    lidar_scan_example(info)
