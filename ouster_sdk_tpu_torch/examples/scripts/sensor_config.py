"""Configure a sensor and fetch metadata over HTTP.

(ref: sdk/examples/core.py configure_dual_returns / configure_sensor_params
/ fetch_metadata). Works against a real sensor hostname, or — with no
hardware — against the built-in emulator (pass a pcap instead of a host).

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.sensor_config \
        <hostname-or-pcap>
"""
import os
import sys

from ouster_sdk_tpu_torch.sensor.http import SensorHttp


def main() -> None:
    target = sys.argv[1] if len(sys.argv) > 1 else None
    emu = None
    if target and os.path.isfile(target):  # serve the file as a sensor
        from ouster_sdk_tpu_torch.io.sources import open_source
        from ouster_sdk_tpu_torch.sensor.emulator import (SensorEmulator,
                                                          packets_from_scans)

        src = open_source(target)
        sets = list(src)
        info = src.sensor_info[0]
        emu = SensorEmulator(info, lambda: packets_from_scans(sets, info),
                             http_port=0).start()
        target = f"127.0.0.1:{emu.http_port}"
        print(f"emulating sensor at http://{target}")
    elif target is None:
        print(__doc__)
        return

    http = SensorHttp.create(target)
    print("firmware:", http.version)

    # fetch_metadata (ref: core.py:80)
    meta = http.metadata()
    print(f"metadata: {len(meta)} bytes")
    print("beam count:",
          len(http.beam_intrinsics()["beam_azimuth_angles"]))

    # configure_sensor_params (ref: core.py:54): stage params, then apply
    http.set_config_param("lidar_mode", "1024x10")
    http.set_config_param("azimuth_window", [0, 360000])
    print("staged:", {k: v for k, v in
                      http.staged_config_params().items()
                      if k in ("lidar_mode", "azimuth_window")})

    # configure_dual_returns (ref: core.py:21): only when supported
    prod = http.sensor_info().get("prod_line", "")
    if "OS-0" not in prod:  # dual returns unsupported on OS-0 low-bandwidth
        http.set_config_param("udp_profile_lidar",
                              "RNG19_RFL8_SIG16_NIR16_DUAL")
        print("staged dual-return profile")
    http.reinitialize()

    if emu is not None:
        emu.stop()


if __name__ == "__main__":
    main()
