"""Read a pcap, batch scans, project to XYZ, save a PLY.

(ref: examples/pcap_example.cpp + sdk/examples — runnable doc examples)
Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.pcap_to_pointcloud \
        <pcap> [out.ply]
"""
import sys

from ouster_sdk_tpu_torch import ChanField, make_xyz_lut, open_source
from ouster_sdk_tpu_torch.io.cloud_io import write_pointcloud


def main():
    pcap = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "cloud.ply"
    source = open_source(pcap)
    info = source.sensor_info[0]
    lut = make_xyz_lut(info)
    for scan_set in source:
        scan = scan_set.valid()[0]
        rng = scan.field(ChanField.RANGE)
        xyz = lut(rng)
        pts = xyz[rng > 0]
        write_pointcloud(out, pts)
        print(f"wrote {pts.shape[0]} points to {out}")
        break


if __name__ == "__main__":
    main()
