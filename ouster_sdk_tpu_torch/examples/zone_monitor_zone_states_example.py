"""Zone-states example
(ref: sdk/examples/zone_monitor_zone_states_example.py): consume
per-zone occupancy records the way a safety integration would — here
produced by the EmulatedZoneMon from any capture, so it runs without a
zone-monitor-enabled sensor."""

from __future__ import annotations

from .. import ChanField, open_source
from ..zone import EmulatedZoneMon, Zone, ZoneMode, ZoneSet


def zone_states_example(source_file: str, n_scans: int = 5) -> None:
    src = open_source(source_file, sensor_idx=0)
    info = src.metadata

    zone_set = ZoneSet([
        Zone.box(1, center=(6.0, 0.0, 0.0), size=(4.0, 4.0, 2.0),
                 name="approach"),
        Zone.box(2, center=(12.0, 0.0, 0.0), size=(6.0, 6.0, 3.0),
                 name="warning"),
    ])
    for z in zone_set.zones.values():
        z.mode = ZoneMode.OCCUPANCY
        z.min_points = 20

    mon = EmulatedZoneMon(zone_set, info)
    for i, scan in enumerate(src):
        mon.calc_triggers(scan.field(ChanField.RANGE))
        for st in mon.get_packet():
            if not st["live"]:
                continue
            trig = "TRIGGERED" if st["trigger_status"] else "clear"
            print(f"scan {i} zone {st['id']}: count={st['count']} "
                  f"mean_range={st['mean_range']}mm {trig}")
        if i + 1 >= n_scans:
            break


if __name__ == "__main__":
    import sys

    zone_states_example(sys.argv[1])
