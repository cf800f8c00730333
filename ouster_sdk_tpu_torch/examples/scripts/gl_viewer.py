"""Render a pcap's first scan with the real-OpenGL viewer backend.

Creates a GL 3.3 context headless (surfaceless EGL, viz/gl.py) and runs
the reference's GPU projection — the range image and XYZ-LUT tables
upload to the GPU and the vertex shader computes dir*range+offset per
point (ref: ouster_viz/src/common.h:221-260). Writes a PNG snapshot;
pass --window to open an interactive GLFW window instead (needs a
display and pip glfw).

Usage:
    python -m ouster_sdk_tpu_torch.examples.scripts.gl_viewer \
        <pcap> [out.png] [--window]
"""
import sys

import numpy as np

from ouster_sdk_tpu_torch import ChanField, open_source
from ouster_sdk_tpu_torch.ops.xyzlut import make_xyz_lut
from ouster_sdk_tpu_torch.viz import (Cloud, PointViz, render_offscreen,
                                      run_window)


def main():
    pcap = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 and \
        not sys.argv[2].startswith("-") else "gl_scan.png"
    window = "--window" in sys.argv

    src = open_source(pcap)
    info = src.sensor_info[0]
    scan = next(s for ls_set in src for s in ls_set if s is not None)
    src.close()

    lut = make_xyz_lut(info)
    rng = scan.field(ChanField.RANGE).astype(np.float64)
    refl = scan.field(ChanField.REFLECTIVITY).astype(np.float64)
    key = np.clip(refl / max(np.percentile(refl[rng > 0], 95), 1), 0, 1)

    viz = PointViz(width=1024, height=768)
    # the reference GPU path: upload range + LUT, project in-shader
    viz.add(Cloud.from_range(rng, lut, key=key.reshape(-1),
                             palette="calref", point_size=2))
    if window:
        run_window(viz)
        return
    frame = render_offscreen(viz)
    viz.save_png(out, frame)
    lit = (frame.sum(axis=2) > 0).sum()
    print(f"rendered {int((rng > 0).sum())} points on OpenGL "
          f"({lit} lit pixels) -> {out}")


if __name__ == "__main__":
    main()
