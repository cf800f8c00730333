"""Filter a point cloud by range and azimuth; derived scan sources.

(ref: sdk/examples/core.py filter_3d_by_range_and_azimuth + the
clipped/masked/reduced derived sources).

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.filter_and_mask \
        <pcap-or-osf>
"""
import sys

import numpy as np

from ouster_sdk_tpu_torch import ChanField
from ouster_sdk_tpu_torch.io.derived import (ClippedScanSource,
                                             MaskedScanSource,
                                             ReducedScanSource)
from ouster_sdk_tpu_torch.io.sources import open_source
from ouster_sdk_tpu_torch.ops.xyzlut import make_xyz_lut


def main() -> None:
    url = sys.argv[1]
    src = open_source(url)
    info = src.sensor_info[0]
    lut = make_xyz_lut(info)

    scan = next(iter(src)).valid()[0]
    rng = scan.field(ChanField.RANGE)
    xyz = lut(rng)

    # filter by range band + azimuth sector (ref: core.py:110)
    r_m = rng * 1e-3
    azimuth = np.degrees(np.arctan2(xyz[..., 1], xyz[..., 0])) % 360.0
    keep = (r_m > 5.0) & (r_m < 60.0) & (azimuth > 45.0) & (azimuth < 135.0)
    pts = xyz[keep]
    print(f"range+azimuth filter kept {pts.shape[0]} / {(rng > 0).sum()} "
          f"valid points")

    # the same as composable derived sources
    clipped = ClippedScanSource(open_source(url), [ChanField.RANGE],
                                5.0, 60.0)
    cscan = next(iter(clipped)).valid()[0]
    crng = cscan.field(ChanField.RANGE)
    print(f"ClippedScanSource: {(crng > 0).sum()} in-band returns")

    mask = np.zeros((scan.h, scan.w), np.uint8)
    mask[:, : scan.w // 2] = 1  # keep the left half of the frame
    # the fields to mask come first (the root script leaves them out, and
    # its call raises TypeError in the JAX package)
    masked = MaskedScanSource(open_source(url), [ChanField.RANGE], [mask])
    mscan = next(iter(masked)).valid()[0]
    print(f"MaskedScanSource: {(mscan.field(ChanField.RANGE) > 0).sum()} "
          f"returns in the kept half")

    reduced = ReducedScanSource(open_source(url), [scan.h // 2])
    rscan = next(iter(reduced)).valid()[0]
    print(f"ReducedScanSource: {rscan.h} beams (from {scan.h})")


if __name__ == "__main__":
    main()
