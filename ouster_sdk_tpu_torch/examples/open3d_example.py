"""Open3D point-cloud viewer for any scan source — import-gated: open3d
is an optional pip dependency, absent on many platforms, so everything
open3d-specific lives behind `require_open3d()`
(ref: python/src/ouster/sdk/examples/open3d_example.py — same role).

Run: python -m ouster_sdk_tpu_torch.examples.open3d_example <pcap/osf/sensor>
"""

from __future__ import annotations

import numpy as np


def require_open3d():
    """Import open3d or explain how to get it; callable so the module
    itself imports cleanly without the dependency."""
    try:
        import open3d as o3d  # type: ignore
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "this example needs the optional 'open3d' package "
            "(pip install open3d)") from e
    return o3d


def scan_to_geometry(info, scan, o3d=None):
    """One LidarScan -> an open3d PointCloud colored by calibrated
    reflectivity (valid returns only)."""
    o3d = o3d or require_open3d()
    from .. import ChanField, XYZLut

    xyz = XYZLut(info)(scan.field(ChanField.RANGE)).reshape(-1, 3)
    refl = np.asarray(scan.field(ChanField.REFLECTIVITY),
                      dtype=np.float64).reshape(-1)
    keep = np.linalg.norm(xyz, axis=1) > 0
    # calibrated reflectivity has a fixed 0-255 scale; normalizing by the
    # per-scan max would make colors flicker frame to frame
    key = np.clip(refl[keep] / 255.0, 0.0, 1.0)
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(xyz[keep])
    pc.colors = o3d.utility.Vector3dVector(
        np.repeat(key[:, None], 3, axis=1))
    return pc


def view(source_url: str, rate_hz: float = 10.0) -> None:
    """Stream a source through an open3d window, updating the cloud in
    place at ~rate_hz (non-blocking event loop)."""
    o3d = require_open3d()
    import time

    from .. import LidarScan, open_source

    source = open_source(source_url)
    info = source.sensor_info[0]

    vis = o3d.visualization.Visualizer()
    vis.create_window(window_name="ouster_sdk_tpu_torch open3d example")
    geom = None
    try:
        for scans in source:
            scan = scans if isinstance(scans, LidarScan) else scans[0]
            if scan is None:
                continue
            pc = scan_to_geometry(info, scan, o3d)
            if geom is None:
                geom = pc
                vis.add_geometry(geom)
            else:
                geom.points = pc.points
                geom.colors = pc.colors
                vis.update_geometry(geom)
            if not vis.poll_events():
                break
            vis.update_renderer()
            if rate_hz > 0:  # rate 0 = free-running (no frame sleep)
                time.sleep(1.0 / rate_hz)
    finally:
        vis.destroy_window()


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", help="pcap/OSF path or sensor hostname")
    ap.add_argument("--rate", type=float, default=10.0)
    args = ap.parse_args()
    view(args.source, args.rate)


if __name__ == "__main__":
    main()
