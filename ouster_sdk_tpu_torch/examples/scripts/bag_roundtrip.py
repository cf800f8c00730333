"""Record a source to ROS1 / ROS2-sqlite3 / MCAP bags and read them back.

(ref: sdk/bag — the reference reads ROS1/ROS2/mcap bags; this framework
reads and writes all three with no external ROS dependencies.)

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.bag_roundtrip \
        <pcap-or-osf> [out_dir]
"""
import os
import sys
import tempfile

import numpy as np

from ouster_sdk_tpu_torch import ChanField
from ouster_sdk_tpu_torch.io.save import save_scans
from ouster_sdk_tpu_torch.io.sources import open_source


def main() -> None:
    url = sys.argv[1]
    out_dir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp()

    src = open_source(url)
    sets = list(src)
    ref = sets[0].valid()[0]
    print(f"source: {len(sets)} scan sets, frame_id {ref.frame_id}")

    for name in ("recording.bag", "recording.db3", "recording.mcap"):
        path = os.path.join(out_dir, name)
        n = save_scans(path, src.sensor_info, sets)
        back = open_source(path)
        scan = next(iter(back)).valid()[0]
        same = bool(np.array_equal(scan.field(ChanField.RANGE),
                                   ref.field(ChanField.RANGE)))
        print(f"{name:<16} wrote {n} scans "
              f"({os.path.getsize(path) / 1e6:.1f} MB), "
              f"RANGE roundtrip exact: {same}")


if __name__ == "__main__":
    main()
