"""Sensor client examples (ref: sdk/examples/core.py): configure a
sensor, fetch metadata, record packets, filter points.

Run: python -m ouster_sdk_tpu_torch.examples.core <hostname> <command>

Without hardware, the same flows run against the SensorEmulator
(`ouster-cli source file.pcap replay --serve`).
"""

from __future__ import annotations

import numpy as np

from .. import ChanField, SensorConfig, UDPProfileLidar, XYZLut, open_source
from ..sensor import SensorHttp, get_config, set_config


def configure_dual_returns(hostname: str) -> None:
    """Switch the sensor to a dual-return profile when supported
    (ref: examples/core.py:21 configure_dual_returns)."""
    config = get_config(hostname)
    config.udp_profile_lidar = \
        UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_DUAL
    try:
        set_config(hostname, config, persist=True, udp_dest_auto=False)
    except Exception as e:
        raise RuntimeError(
            "error: Your sensor probably doesn't support dual returns"
        ) from e
    print(f"sensor profile: {config.udp_profile_lidar}")


def configure_sensor_params(hostname: str) -> None:
    """Set lidar mode + azimuth window
    (ref: examples/core.py:54 configure_sensor_params)."""
    from ..core.types import LidarMode

    config = SensorConfig()
    config.lidar_mode = LidarMode.from_string("1024x10")
    config.azimuth_window = (0, 360000)
    set_config(hostname, config, persist=True, udp_dest_auto=True)
    print(f"updated config: {config}")


def fetch_metadata(hostname: str) -> None:
    """Fetch + persist the sensor metadata
    (ref: examples/core.py:80 fetch_metadata)."""
    from ..sensor.http import fetch_metadata as _fetch

    info = _fetch(hostname)
    with open(f"{hostname}.json", "w") as f:
        f.write(info.to_json_string())
    print(f"wrote {hostname}.json (sn={info.sn})")


def filter_3d_by_range_and_azimuth(hostname: str,
                                   lidar_port: int = 7502,
                                   range_min: float = 2.0) -> None:
    """One live scan filtered by range + azimuth sector
    (ref: examples/core.py:110 filter_3d_by_range_and_azimuth)."""
    src = open_source(hostname, sensor_idx=0, lidar_port=lidar_port)
    scan = next(iter(src))
    lut = XYZLut(src.metadata, use_extrinsics=True)
    rng = scan.field(ChanField.RANGE)
    xyz = lut(scan)
    # keep right half of the field of view beyond range_min meters
    keep = rng / 1000.0 > range_min
    keep[:, : scan.w // 2] = False
    print(f"{int(keep.sum())} points pass the range+azimuth filter")
    return xyz[keep]


def record_pcap(hostname: str, lidar_port: int = 7502,
                n_seconds: int = 10) -> None:
    """Record live packets to a pcap next to its metadata
    (ref: examples/core.py:240 record_pcap)."""
    import time

    from .. import open_packet_source
    from ..io.pcap import record

    src = open_packet_source(hostname, lidar_port=lidar_port)
    info = src.sensor_info[0]
    with open(f"{hostname}.json", "w") as f:
        f.write(info.to_json_string())

    t_end = time.time() + n_seconds

    def until_deadline():
        for idx, packet in src:
            if time.time() > t_end:
                return
            yield packet

    n = record(until_deadline(), f"{hostname}.pcap",
               lidar_port=lidar_port)
    print(f"captured {n} packets to {hostname}.pcap")


def plot_xyz_points(hostname: str, lidar_port: int = 7502) -> None:
    """Snapshot one live scan to a PNG via the offscreen viz
    (ref: examples/core.py:202 plot_xyz_points — matplotlib there,
    PointViz snapshot here)."""
    from ..viz import ls_show

    src = open_source(hostname, sensor_idx=0, lidar_port=lidar_port)
    scan = next(iter(src))
    path = ls_show(scan, src.metadata, path=f"{hostname}_scan.png")
    print(f"wrote {path}")


def main() -> None:
    import argparse

    examples = {
        "configure-dual-returns": configure_dual_returns,
        "configure-sensor-params": configure_sensor_params,
        "fetch-metadata": fetch_metadata,
        "filter-3d-by-range-and-azimuth": filter_3d_by_range_and_azimuth,
        "record-pcap": record_pcap,
        "plot-xyz-points": plot_xyz_points,
    }
    p = argparse.ArgumentParser(
        description="ouster_sdk_tpu_torch sensor examples")
    p.add_argument("hostname")
    p.add_argument("example", choices=sorted(examples))
    a = p.parse_args()
    examples[a.example](a.hostname)


if __name__ == "__main__":
    main()
