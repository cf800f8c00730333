"""Zone-monitor configuration example
(ref: sdk/examples/zone_monitor_example.py + examples/
zone_monitor_zone_set.cpp): author zones, render their range bounds,
check per-frame occupancy on a capture."""

from __future__ import annotations

from .. import ChanField, open_source
from ..zone import Zone, ZoneMode, ZoneSet, render_zone_bounds, \
    zone_occupancy


def zone_monitor_example(source_file: str) -> None:
    src = open_source(source_file, sensor_idx=0)
    info = src.metadata

    # author a 4x4x2 m occupancy box 6 m ahead of the sensor
    zone = Zone.box(1, center=(6.0, 0.0, 0.0), size=(4.0, 4.0, 2.0))
    zone.mode = ZoneMode.OCCUPANCY
    zone.min_points = 10
    zone_set = ZoneSet([zone])
    print(f"zone set: {len(zone_set.zones)} zone(s), "
          f"live ids {zone_set.live_ids}")

    # project the zone mesh into per-pixel near/far range bounds
    zrb = render_zone_bounds(zone, info)
    print(f"zrb: {zrb.near_range_mm.shape} near/far range image")

    # evaluate occupancy per scan
    for i, scan in enumerate(src):
        count, mask = zone_occupancy(scan.field(ChanField.RANGE), zrb)
        state = "TRIGGERED" if count >= zone.min_points else "clear"
        print(f"scan {i}: {count} points inside zone -> {state}")
        if i >= 4:
            break


if __name__ == "__main__":
    import sys

    zone_monitor_example(sys.argv[1])
