"""Zone-monitor emulation over any source: render a ZoneSet against the
sensor geometry, evaluate occupancy per scan on the host, and write the
emulated ZONE_OCCUPANCY / ZONE_STATES / ZONE_PACKET_TIMESTAMP fields
back into each scan — the same flow the sensor firmware runs on-device
(ref: python/src/ouster/sdk/examples/zone_monitor_emulation_example.py;
zone_monitor.cpp).

Run: python -m ouster_sdk_tpu_torch.examples.zone_monitor_emulation_example \
         <pcap/osf/sensor> [zone_set.zip]
"""

from __future__ import annotations

import numpy as np


def emulate(source_url: str, zone_set_path=None, max_scans=None):
    """Yield (scan, triggered-zone summaries) with the emulated zone
    fields attached; the generator form keeps it testable headless."""
    from .. import ChanField, FieldClass, LidarScan, open_source
    from ..zone import EmulatedZoneMon, ZoneSet

    # sensor_idx=0: the monitor below is built from sensor 0's geometry
    # and keeps per-zone trigger hysteresis, so it must only ever see
    # that sensor's scans (a multi-sensor set would feed sensors 1+ into
    # the wrong zone LUT and advance the hysteresis once per sensor)
    source = open_source(source_url, sensor_idx=0)
    info = source.sensor_info[0]
    if zone_set_path is None:
        zone_set = info.zone_set
        if zone_set is None:
            raise ValueError(
                "source metadata carries no ZoneSet; pass a zip path")
    else:
        with open(zone_set_path, "rb") as f:
            zone_set = ZoneSet.from_zip(f.read())

    mon = EmulatedZoneMon(zone_set, info)
    emulated = ("ZONE_STATES", "ZONE_OCCUPANCY", "ZONE_PACKET_TIMESTAMP")
    for n, scans in enumerate(source):
        if max_scans is not None and n >= max_scans:
            break
        for scan in [scans] if isinstance(scans, LidarScan) else scans:
            if scan is None:
                continue
            # replace any recorded zone fields with the emulation's
            for name in emulated:
                if scan.has_field(name):
                    scan.del_field(name)
            scan.add_field("ZONE_OCCUPANCY", np.uint16)
            mon.calc_triggers(scan.field(ChanField.RANGE),
                              scan.field("ZONE_OCCUPANCY"))
            states = mon.get_packet()
            scan.add_field("ZONE_STATES", states, FieldClass.SCAN_FIELD)
            ts = scan.get_last_valid_packet_timestamp()
            scan.add_field("ZONE_PACKET_TIMESTAMP",
                           np.array([ts], np.uint64), FieldClass.SCAN_FIELD)
            yield scan, [(int(z["id"]), int(z["trigger_status"]))
                         for z in states if z["id"] != 255]


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", help="pcap/OSF path or sensor hostname")
    ap.add_argument("zone_set", nargs="?", default=None,
                    help="ZoneSet zip (defaults to the metadata's)")
    ap.add_argument("--max-scans", type=int, default=None)
    args = ap.parse_args()
    for _, triggers in emulate(args.source, args.zone_set, args.max_scans):
        print(triggers)


if __name__ == "__main__":
    main()
