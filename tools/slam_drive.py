"""Drive chip_smoke.py's synthetic yard through a SLAM engine and print each
frame's translation error against the ground truth.

    python tools/slam_drive.py synth DIR [--frames 30] [--ramp 10]

writes DIR/yard.pcap (128x2048, RNG19_RFL8_SIG16_NIR16_DUAL), its metadata
DIR/yard.json and the ground truth DIR/truth.npy with the PyTorch port's
writers: the vehicle speeds up from rest over --ramp frames to 1 m and 1 deg
a frame (10 m/s at 10 Hz), or runs at that speed from the first frame with
--ramp 0.

    python tools/slam_drive.py run DIR --impl host|device|jax-host|jax-tpu
        [--voxel V] [--device cpu|cuda] [--frames K]

replays DIR/yard.pcap through open_source -> SlamEngine of one package
(host, device: ouster_sdk_tpu_torch with that backend; jax-host, jax-tpu:
ouster_sdk_tpu with backend "host" or "tpu", on the CPU), with voxel V (at
most 0: the engine's data-driven size, the default), and prints a line a
frame: N, M and iterations where the backend keeps them, the error of the
frame's translation delta and of its absolute translation. The result goes
to DIR/<impl>.json. Each command imports one of the two packages alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def synth(out: str, frames: int, ramp: int) -> None:
    import chip_smoke as cs
    import ouster_sdk_tpu_torch as port

    os.makedirs(out, exist_ok=True)
    info = cs.synth_info(cs.MAIN_PROFILE)
    t0 = time.perf_counter()
    truth = cs.yard_capture(port, os.path.join(out, "yard.pcap"), info,
                            frames, ramp=ramp)
    np.save(os.path.join(out, "truth.npy"), truth)
    with open(os.path.join(out, "yard.json"), "w") as f:
        f.write(info.to_json_string())
    print(f"yard: {frames} frames, ramp {ramp}, written in "
          f"{time.perf_counter() - t0:.1f} s")


def _engine(impl: str, meta: str, voxel: float, device: str):
    """The sensor info, open_source and its options, and the SlamEngine
    of the package `impl` names."""
    import chip_smoke as cs

    with open(meta) as f:
        text = f.read()
    if impl.startswith("jax-"):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from ouster_sdk_tpu import UDPProfileLidar, open_source
        from ouster_sdk_tpu.core.metadata import sensor_info_from_metadata
        from ouster_sdk_tpu.slam import engine as se

        info = sensor_info_from_metadata(text)
        kwargs, source_kwargs = {}, {}
    else:
        from ouster_sdk_tpu_torch import UDPProfileLidar, open_source
        from ouster_sdk_tpu_torch.core.metadata import \
            sensor_info_from_metadata
        from ouster_sdk_tpu_torch.slam import engine as se

        info = sensor_info_from_metadata(text)
        kwargs = {"device": device} if impl == "device" else {}
        source_kwargs = {"device": device}
    # the metadata string carries no lidar profile: set it as synth_info does
    info.format.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    backend = {"jax-host": "host", "jax-tpu": "tpu"}.get(impl, impl)
    eng = se.SlamEngine([info], se.SlamConfig(backend=backend,
                                              voxel_size=voxel), **kwargs)
    return info, open_source, source_kwargs, eng


def run(out: str, impl: str, voxel: float, device: str, frames: int) -> None:
    truth = np.load(os.path.join(out, "truth.npy"))
    gt = np.linalg.inv(truth[0]) @ truth
    info, open_source, source_kwargs, eng = _engine(
        impl, os.path.join(out, "yard.json"), voxel, device)
    rows = []
    t0 = time.perf_counter()
    for k, scans in enumerate(open_source(os.path.join(out, "yard.pcap"),
                                          sensor_info=[info],
                                          **source_kwargs)):
        if k == frames:
            break
        eng.update(scans)
        pose = eng.last_pose
        row = dict(frame=k, abs_err=float(np.linalg.norm(
            pose[:3, 3] - gt[k, :3, 3])), pose=pose.tolist())
        if k:
            prev = np.asarray(rows[-1]["pose"])
            row["delta_err"] = float(np.linalg.norm(
                (pose[:3, 3] - prev[:3, 3]) - (gt[k, :3, 3]
                                               - gt[k - 1, :3, 3])))
        else:
            row["delta_err"] = 0.0
        row.update(getattr(eng._kiss, "last_frame", None) or {})
        rows.append(row)
        keep = {key: row[key] for key in ("n", "m", "iterations")
                if key in row}
        print(f"{impl} frame {k}: delta error {row['delta_err']:.4f} m, "
              f"absolute error {row['abs_err']:.4f} m {keep or ''}",
              flush=True)
    secs = time.perf_counter() - t0
    worst = max(r["delta_err"] for r in rows)
    print(f"{impl}: voxel {eng._voxel_size} m, {len(rows)} frames in "
          f"{secs:.1f} s, worst delta error {worst:.4f} m (frame "
          f"{max(rows, key=lambda r: r['delta_err'])['frame']}), final "
          f"absolute error {rows[-1]['abs_err']:.4f} m")
    with open(os.path.join(out, f"{impl}.json"), "w") as f:
        json.dump(dict(impl=impl, voxel=eng._voxel_size, seconds=secs,
                       frames=rows), f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("synth")
    s.add_argument("dir")
    s.add_argument("--frames", type=int, default=30)
    s.add_argument("--ramp", type=int, default=10)
    r = sub.add_parser("run")
    r.add_argument("dir")
    r.add_argument("--impl", required=True,
                   choices=("host", "device", "jax-host", "jax-tpu"))
    r.add_argument("--voxel", type=float, default=-1.0)
    r.add_argument("--device", default="cuda")
    r.add_argument("--frames", type=int, default=-1)
    a = ap.parse_args()
    if a.cmd == "synth":
        synth(a.dir, a.frames, a.ramp)
    else:
        run(a.dir, a.impl, a.voxel, a.device, a.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
