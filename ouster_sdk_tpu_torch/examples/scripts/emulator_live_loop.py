"""Serve a recording as a live sensor and consume it with the live client.

(ref: plugins/source_replay.py — the reference's replay server; here the
whole loop runs in one process over loopback, exercising the real
UDP/HTTP live-sensor path with no hardware.)

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.emulator_live_loop \
        <pcap-or-osf> [n_scans]
"""
import socket
import sys

from ouster_sdk_tpu_torch import ChanField
from ouster_sdk_tpu_torch.io.sources import open_source
from ouster_sdk_tpu_torch.sensor.emulator import (SensorEmulator,
                                                  looping_packets_factory)
from ouster_sdk_tpu_torch.sensor.scan_source import SensorScanSource


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> None:
    url = sys.argv[1]
    want = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    src = open_source(url)
    sets = list(src)
    info = src.sensor_info[0]
    lidar_port, imu_port = _free_port(), _free_port()

    # rate=20x real time: fast but still paced (rate=0 floods the single
    # loopback core and starves the consumer); the looping factory rotates
    # frame ids per pass so the batcher sees fresh frames
    emu = SensorEmulator(info, looping_packets_factory(sets, info),
                         lidar_port=lidar_port, imu_port=imu_port,
                         http_port=0, rate=20.0, loop=True).start()
    print(f"emulated sensor: http://127.0.0.1:{emu.http_port} "
          f"(lidar udp :{lidar_port})")

    live = SensorScanSource([f"127.0.0.1:{emu.http_port}"],
                            lidar_port=lidar_port, imu_port=imu_port,
                            timeout=10.0)
    got = 0
    try:
        while got < want:
            idx, scan = live.get_scan(timeout_sec=5.0)
            if scan is None or not scan.complete():
                continue
            rng = scan.field(ChanField.RANGE)
            print(f"live scan {got}: frame_id={scan.frame_id} "
                  f"valid_px={(rng > 0).sum()}")
            got += 1
    finally:
        live.close()
        emu.stop()
    print(f"received {got} complete scans over the live path "
          f"({emu.packets_sent} packets served)")


if __name__ == "__main__":
    main()
