"""Live-path inputs for the port's tests, made with the port alone (no jax,
no JAX package).

A live test sensor is a 512x10 single-return sensor (RNG19_RFL8_SIG16_NIR16,
64 beams) on free loopback ports; its frames are synthesized with the
port's PacketWriter from a seed. The emulator's pacing, the free ports and
the ScanBatcher oracle are chip_smoke.py's (jax-free too). UDP loses
packets even on loopback when the host is loaded, so the tests compare
only frames whose every packet arrived, give every loop a deadline and
assert no time or rate.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.core.types import LidarMode, UDPProfileLidar

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chip_smoke import free_udp_ports, paced  # noqa: E402,F401

SN = 122246000000


def live_info(lidar_port: int, imu_port: int, sn: int = SN,
              mode: str = "512x10",
              profile: str = "RNG19_RFL8_SIG16_NIR16"):
    """The port's SensorInfo of a live test sensor on the given ports."""
    info = pt.default_sensor_info(LidarMode.from_string(mode))
    info.format.udp_profile_lidar = UDPProfileLidar(profile)
    info.config.udp_port_lidar = lidar_port
    info.config.udp_port_imu = imu_port
    info.sn = sn
    return info


def frame_packets(info, fid: int, seed: int = 0):
    """One frame's lidar packets as bytes: every field of the profile
    random from (seed, fid), about 5% of ranges zero and 3% of columns
    with their status bit clear, column timestamps from the frame id."""
    pw = pt.PacketWriter(info.format)
    cpp, h = pw.columns_per_packet, pw.pixels_per_column
    rng = np.random.default_rng([seed, fid])
    out = []
    for p in range(info.format.columns_per_frame // cpp):
        buf = pw.new_packet()
        pw.set_packet_header(buf, init_id=info.init_id, prod_sn=info.sn)
        pw.set_frame_id(buf, fid)
        m0 = p * cpp
        status = (rng.random(cpp) >= 0.03).astype(np.uint32)
        pw.set_col_headers(
            buf, np.arange(cpp, dtype=np.uint64) * 100 + fid * 10**8 + m0,
            np.arange(cpp, dtype=np.uint16) + m0, status)
        for name in pw.fields:
            fi = pw.field_info(name)
            bits = fi.bit_size // fi.num_elements
            v = rng.integers(0, 1 << bits, size=(h, cpp), dtype=np.uint64)
            if name.startswith("RANGE"):
                v[rng.random((h, cpp)) < 0.05] = 0
            pw.set_field(buf, name, v << np.uint64(fi.upshift))
        out.append(buf.tobytes())
    return out


def collect_scans(src, n: int, seconds: float = 20.0):
    """Up to n (sensor index, scan) pairs from a SensorScanSource, within
    a deadline."""
    got = []
    deadline = time.monotonic() + seconds
    while len(got) < n and time.monotonic() < deadline:
        idx, scan = src.get_scan(timeout_sec=0.5)
        if scan is not None:
            got.append((idx, scan))
    return got


def batcher_scans(pkg, info, packets):
    """{frame_id: scan} of the frames `pkg`'s ScanBatcher (the port or the
    JAX package) releases from the packet payloads fed in order."""
    return chip_smoke.recorded_oracle(pkg, info,
                                      [(0, p, 0) for p in packets])
