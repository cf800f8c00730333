"""Run the port's device pipeline on frames from a pcap.

Shows both device paths (the root examples/tpu_pipeline.py's):
  1. the planar path (fastest): one native pass stages frames word-planar,
     the planar_project kernel decodes the ranges and projects them (+
     optional fused per-column dewarp) with no transposes;
  2. the packet-words path: whole frames of packet words through
     ScanPipeline.batch, producing every field + XYZ in PyTorch ops.

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.device_pipeline <pcap>
"""
import sys

import torch

from ouster_sdk_tpu_torch import sensor_info_from_metadata
from ouster_sdk_tpu_torch.io.frames import FrameReader
from ouster_sdk_tpu_torch.io.pcap_source import resolve_metadata_paths
from ouster_sdk_tpu_torch.ops.fused import ScanPipeline


def main():
    pcap = sys.argv[1]
    paths = resolve_metadata_paths(pcap)
    if not paths:
        raise FileNotFoundError(f"no metadata json found for {pcap}")
    with open(paths[0]) as f:
        fr = FrameReader(pcap, sensor_info_from_metadata(f.read()))
    pipe = ScanPipeline(fr.info)

    # 1. planar fast path: chunked word-planar staging -> planar_project
    for fids, planes, hdrs, _ts in fr.iter_planar_chunks(8):
        out = pipe.project_planar(planes, hdrs)
        xyz = out[0] if isinstance(out, tuple) else out  # first return
        print(f"planar chunk {list(fids)}: XYZ {tuple(xyz.shape)} "
              f"max |r| = {float(xyz.abs().max()):.2f} m")

        # full-field decode from the same staging
        fields = pipe.decode_planar(planes, hdrs)
        names = [k for k in fields if k.isupper()]
        print(f"  decoded fields: {names}")

        # fused per-column dewarp: identity poses here; a SLAM pipeline
        # passes its per-column trajectory
        poses = torch.eye(4, dtype=torch.float32, device=pipe.device) \
            .expand(fids.size, fr.plan.w, 4, 4)
        world = pipe.project_planar(planes, hdrs, poses=poses)
        for w in world if isinstance(world, tuple) else (world,):
            assert bool(torch.isfinite(w).all())
        break

    # 2. packet-words path: every field + XYZ in one batched pipeline
    batch, fids = fr.read_all(max_frames=4)
    out = pipe.batch(batch)
    print(f"packet-words batch {list(fids)}: "
          f"XYZ {tuple(out['XYZ'].shape)}, RANGE {tuple(out['RANGE'].shape)}")


if __name__ == "__main__":
    main()
