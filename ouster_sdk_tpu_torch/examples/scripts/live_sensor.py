"""Stream scans from a live sensor and print per-scan stats.

(ref: sdk/examples/core.py live paths, sensor_scan_source.cpp)
Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.live_sensor \
        <hostname> [n_scans]
"""
import sys

from ouster_sdk_tpu_torch import ChanField
from ouster_sdk_tpu_torch.sensor.scan_source import SensorScanSource


def main():
    hostname = sys.argv[1]
    n_scans = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    # contacts the sensor over HTTP, configures UDP dest automatically,
    # then batches packets into scans on a background thread
    source = SensorScanSource([hostname])
    info = source.sensor_info[0]
    print(f"connected: {info.prod_line} sn={info.sn} "
          f"{info.format.pixels_per_column}x{info.format.columns_per_frame}")

    try:
        for i, ls_set in enumerate(source):
            if i >= n_scans:
                break
            scan = ls_set.valid()[0]
            rng = scan.field(ChanField.RANGE)
            valid = rng[rng > 0]
            print(f"scan {i}: frame_id={scan.frame_id} "
                  f"complete={scan.complete()} "
                  f"mean_range={valid.mean() * 1e-3 if valid.size else 0:.2f} m")
    finally:
        source.close()


if __name__ == "__main__":
    main()
