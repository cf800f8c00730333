"""Emulate sensor-side zone monitoring on the host: define a box zone,
render its near/far bounds into the range image, and evaluate occupancy
per scan.

(ref: sdk/examples/zone_monitor_emulation_example.py, zone_monitor.cpp)
Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.zone_monitor_emulation \
        <pcap-or-osf>
"""
import sys

import numpy as np

from ouster_sdk_tpu_torch import ChanField, open_source
from ouster_sdk_tpu_torch.zone.monitor import render_zone_bounds
from ouster_sdk_tpu_torch.zone.zone import Zone


def box_mesh(xmin, xmax, ymin, ymax, zmin, zmax):
    """12 triangles of an axis-aligned box."""
    v = np.array([[x, y, z] for x in (xmin, xmax)
                  for y in (ymin, ymax) for z in (zmin, zmax)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris.append([v[a], v[b], v[c]])
        tris.append([v[a], v[c], v[d]])
    return np.asarray(tris, dtype=np.float64)


def main():
    url = sys.argv[1]
    source = open_source(url)
    info = source.sensor_info[0]

    zone = Zone(id=1, name="box",
                triangles=box_mesh(2.0, 8.0, -3.0, 3.0, -1.0, 1.0))
    zrb = render_zone_bounds(zone, info)
    near = zrb.near_range_mm
    far = zrb.far_range_mm
    print(f"zone pixels: {(far > near).sum()}")

    for ls_set in source:
        scan = ls_set.valid()[0]
        rng = scan.field(ChanField.RANGE)          # mm
        inside = (rng > 0) & (rng >= near) & (rng <= far)
        print(f"frame {scan.frame_id}: {inside.sum()} returns inside zone")
        break


if __name__ == "__main__":
    main()
