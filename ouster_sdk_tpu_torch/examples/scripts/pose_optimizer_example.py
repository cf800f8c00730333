"""SLAM a recording, refine the trajectory with constraints, render it.

(ref: docs python/examples/pose-optimizer-api-example +
plugins/source_po_viz.py).

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.pose_optimizer_example \
        <pcap-or-osf> [out_dir]
"""
import json
import os
import sys
import tempfile

from ouster_sdk_tpu_torch.io.save import save_scans
from ouster_sdk_tpu_torch.io.sources import open_source
from ouster_sdk_tpu_torch.slam.engine import SlamConfig, SlamEngine
from ouster_sdk_tpu_torch.slam.pose_optimizer import optimize_osf_trajectory


def main() -> None:
    url = sys.argv[1]
    out_dir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp()

    # 1. SLAM the source and record the posed scans to OSF
    src = open_source(url)
    engine = SlamEngine(src.sensor_info, SlamConfig())
    sets = []
    for ls_set in src:
        engine.update(ls_set)
        sets.append(ls_set)
    slammed = os.path.join(out_dir, "slammed.osf")
    save_scans(slammed, src.sensor_info, sets)
    print(f"slammed {len(sets)} scan sets -> {slammed}")

    # 2. refine against a constraint config (reference JSON shape,
    #    ref: constraint_config.cpp): anchor the first scan at the origin
    first = sets[0].valid()[0]
    ts0 = int(first.timestamp[int(first.w) // 2])
    cfg = {
        "key_frame_distance": 1.0,
        "loss_function": "HuberLoss",
        "constraints": [
            {"type": "ABSOLUTE_POSE", "timestamp": ts0,
             "pose": {"x": 0.0, "y": 0.0, "z": 0.0},
             "rotation_weight": 100.0, "translation_weight": 100.0},
        ],
    }
    refined = os.path.join(out_dir, "refined.osf")
    snap = os.path.join(out_dir, "po.png")
    n = optimize_osf_trajectory(slammed, refined, json.dumps(cfg),
                                viz_snapshot=snap)
    print(f"optimized {n} scans -> {refined}")
    print(f"trajectory snapshots: {snap.replace('.png', '_orbit.png')}, "
          f"{snap.replace('.png', '_top.png')}")


if __name__ == "__main__":
    main()
