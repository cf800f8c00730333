"""OSF examples (ref: sdk/examples/osf.py): read scans, inspect sensor
info, slice a file.

Run: python -m ouster_sdk_tpu_torch.examples.osf <file.osf> <command>
"""

from __future__ import annotations

from .. import ChanField, open_source


def osf_read_scans(osf_file: str) -> None:
    """Iterate scans, printing per-scan summaries
    (ref: examples/osf.py:5 osf_read_scans)."""
    src = open_source(osf_file, sensor_idx=0)
    for scan in src:
        print(f"scan from sensor sn={src.metadata.sn}: {scan}")


def osf_get_sensors_info(osf_file: str) -> None:
    """Print the metadata of every sensor stored in the file
    (ref: examples/osf.py:23 osf_get_sensors_info)."""
    from ..io.osf import Reader

    r = Reader(osf_file)
    for i, info in enumerate(r.sensor_info):
        print(f"sensor [{i}]: sn={info.sn} prod_line={info.prod_line} "
              f"mode={info.format.pixels_per_column}x"
              f"{info.format.columns_per_frame}")
    r.close()


def osf_slice_scans(osf_file: str, out_path: str = "sliced.osf",
                    start: int = 0, stop: int = 2) -> str:
    """Copy a scan range into a new OSF, keeping only RANGE and
    REFLECTIVITY (ref: examples/osf.py:40 osf_slice_scans)."""
    import numpy as np

    from ..core.field import FieldClass, FieldType
    from ..io.osf import Reader, Writer
    from ..io.osf_ops import slice_and_cast

    r = Reader(osf_file)
    keep = [FieldType(ChanField.RANGE, np.uint32, (),
                      FieldClass.PIXEL_FIELD),
            FieldType(ChanField.REFLECTIVITY, np.uint8, (),
                      FieldClass.PIXEL_FIELD)]
    with Writer(out_path) as w:
        ids = [w.add_sensor(info, keep) for info in r.sensor_info]
        n = 0
        for msg in r.messages():
            if not msg.is_lidar_scan():
                continue
            if n >= stop:
                break
            if n >= start:
                scan = msg.decode()
                if scan is not None:
                    w.save(ids[msg.sensor_idx],
                           slice_and_cast(scan, keep), ts=msg.ts)
            n += 1
    r.close()
    return out_path


def main() -> None:
    import argparse

    examples = {
        "read-scans": lambda a: osf_read_scans(a.osf_path),
        "sensors-info": lambda a: osf_get_sensors_info(a.osf_path),
        "slice-scans": lambda a: print(osf_slice_scans(a.osf_path)),
    }
    p = argparse.ArgumentParser(
        description="ouster_sdk_tpu_torch osf examples")
    p.add_argument("osf_path")
    p.add_argument("example", choices=sorted(examples))
    a = p.parse_args()
    examples[a.example](a)


if __name__ == "__main__":
    main()
