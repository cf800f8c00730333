"""Run SLAM over a source and export the trajectory (KITTI format).

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.slam_trajectory \
        <osf|pcap> [poses.txt]
"""
import sys

from ouster_sdk_tpu_torch import open_source
from ouster_sdk_tpu_torch.slam.engine import SlamConfig, SlamEngine


def main():
    src = open_source(sys.argv[1])
    out = sys.argv[2] if len(sys.argv) > 2 else "poses_kitti.txt"
    engine = SlamEngine(src.sensor_info, SlamConfig(voxel_size=1.0))
    poses = []
    for scan_set in src:
        engine.update(scan_set)
        poses.append(engine.last_pose.copy())
    with open(out, "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.18e}" for v in p[:3].reshape(-1)) + "\n")
    print(f"wrote {len(poses)} poses to {out}")


if __name__ == "__main__":
    main()
