"""Pcap examples (ref: sdk/examples/pcap.py): convert captures to point
clouds and tabular formats, inspect packets.

Run: python -m ouster_sdk_tpu_torch.examples.pcap <capture.pcap> <command>
"""

from __future__ import annotations

import os

import numpy as np

from .. import ChanField, XYZLut, destagger, open_packet_source, open_source
from ..io.cloud_io import write_pointcloud


def pcap_3d_one_scan(source_file: str, num: int = 0) -> np.ndarray:
    """Project one scan to XYZ and return the (N, 3) valid points
    (ref: examples/pcap.py:19 pcap_3d_one_scan)."""
    src = open_source(source_file, sensor_idx=0, index=True)
    scan = src[num]
    lut = XYZLut(src.metadata, use_extrinsics=True)
    rng = scan.field(ChanField.RANGE)
    xyz = lut(scan)
    return xyz[rng > 0]


def _scan_cloud(source_file: str, num: int):
    src = open_source(source_file, sensor_idx=0, index=True)
    scan = src[num]
    info = src.metadata
    lut = XYZLut(info, use_extrinsics=True)
    rng = scan.field(ChanField.RANGE)
    valid = rng > 0
    attrs = {}
    for name in (ChanField.REFLECTIVITY, ChanField.SIGNAL,
                 ChanField.NEAR_IR):
        if scan.has_field(name):
            attrs[name.lower()] = scan.field(name)[valid].astype(
                np.float32)
    return lut(scan)[valid].astype(np.float32), attrs


def pcap_to_ply(source_file: str, num: int = 0,
                ply_dir: str = ".", ply_base: str = "ply_out") -> str:
    """One scan -> binary PLY (ref: examples/pcap.py:240 pcap_to_ply)."""
    pts, attrs = _scan_cloud(source_file, num)
    path = os.path.join(ply_dir, f"{ply_base}_{num:06d}.ply")
    write_pointcloud(path, pts, attributes=attrs)
    return path


def pcap_to_pcd(source_file: str, num: int = 0,
                pcd_dir: str = ".", pcd_base: str = "pcd_out") -> str:
    """One scan -> PCD (ref: examples/pcap.py:186 pcap_to_pcd)."""
    pts, attrs = _scan_cloud(source_file, num)
    path = os.path.join(pcd_dir, f"{pcd_base}_{num:06d}.pcd")
    write_pointcloud(path, pts, attributes=attrs)
    return path


def pcap_to_las(source_file: str, num: int = 0,
                las_dir: str = ".", las_base: str = "las_out") -> str:
    """One scan -> LAS (ref: examples/pcap.py:140 pcap_to_las)."""
    pts, attrs = _scan_cloud(source_file, num)
    path = os.path.join(las_dir, f"{las_base}_{num:06d}.las")
    write_pointcloud(path, pts, attributes=attrs)
    return path


def pcap_to_csv(source_file: str, num: int = 0,
                csv_dir: str = ".", csv_base: str = "csv_out") -> str:
    """One scan -> CSV of destaggered fields
    (ref: examples/pcap.py:325 pcap_to_csv)."""
    src = open_source(source_file, sensor_idx=0, index=True)
    scan = src[num]
    info = src.metadata
    names = [f for f in scan.fields
             if scan.field(f).ndim == 2]
    cols = [destagger(info, scan.field(f)).reshape(-1) for f in names]
    path = os.path.join(csv_dir, f"{csv_base}_{num:06d}.csv")
    np.savetxt(path, np.column_stack(cols), delimiter=",", fmt="%d",
               header=",".join(names), comments="")
    return path


def pcap_query_scan(source_file: str, num: int = 0) -> None:
    """Print available fields and dtypes of one scan
    (ref: examples/pcap.py:257 pcap_query_scan)."""
    src = open_source(source_file, sensor_idx=0, index=True)
    scan = src[num]
    for name in scan.fields:
        print(f"{name:20s} {scan.field(name).dtype} "
              f"{scan.field(name).shape}")


def pcap_read_packets(source_file: str) -> None:
    """Iterate raw packets, printing headers
    (ref: examples/pcap.py:284 pcap_read_packets)."""
    from ..core.packets import ImuPacket, LidarPacket
    from .. import PacketFormat

    src = open_packet_source(source_file)
    pf = PacketFormat.from_info(src.sensor_info[0])
    for i, (idx, packet) in enumerate(src):
        if isinstance(packet, LidarPacket):
            print(f"lidar packet frame={pf.frame_id(packet.buf)} "
                  f"first_ts={pf.col_timestamp(packet.buf)[0]}")
        elif isinstance(packet, ImuPacket):
            print(f"imu packet ts={pf.imu_sys_ts(packet.buf)}")
        if i >= 9:
            break


def main() -> None:
    import argparse

    examples = {
        "plot-xyz-points": lambda a: print(
            f"{len(pcap_3d_one_scan(a.pcap_path, a.scan_num))} points"),
        "pcap-to-csv": lambda a: print(
            pcap_to_csv(a.pcap_path, a.scan_num)),
        "pcap-to-ply": lambda a: print(
            pcap_to_ply(a.pcap_path, a.scan_num)),
        "pcap-to-pcd": lambda a: print(
            pcap_to_pcd(a.pcap_path, a.scan_num)),
        "pcap-to-las": lambda a: print(
            pcap_to_las(a.pcap_path, a.scan_num)),
        "query-scan": lambda a: pcap_query_scan(a.pcap_path, a.scan_num),
        "read-packets": lambda a: pcap_read_packets(a.pcap_path),
    }
    p = argparse.ArgumentParser(
        description="ouster_sdk_tpu_torch pcap examples")
    p.add_argument("pcap_path")
    p.add_argument("example", choices=sorted(examples))
    p.add_argument("--scan-num", type=int, default=0)
    a = p.parse_args()
    examples[a.example](a)


if __name__ == "__main__":
    main()
