"""Replay of an OSF recording to LidarScans and their XYZ, as every user of
a recording does: a drive through the yard of `frames` frames, recorded
by the benchmark's own writer (lib/osf_write.py) at the configuration's
`recording` settings (the SDK's `save` defaults: every scan collated)
once a seed, replayed in passes through

    open_source(path)        the OSF scan source, one collated set at a
                             time: each channel's PNG inflated and
                             unfiltered on the host, the set's two range
                             images projected on the card
                             (OsfDeviceProjector.attach, the planar
                             kernel at B = 2) and the XYZ cached on the
                             scan
      -> XYZLut(info)(scan)  the XYZ of RANGE, and of RANGE2 through
                             XYZLut's return_xyz, served from the cache

The replay loop, its sample and its bookkeeping are scan_source's: a frame
counts once its scan and the XYZ of both returns are in hand, and each
pass opens the file anew, as a user's run does. The sampled scans are
compared after the window: every recorded field and column header with
the frame made again from the seed (reference/osf_scan.py), and the XYZ
with the float64 reference (reference/lut.py) in float32 units in the
last place, as the replay cells measure theirs. The control is the
projector at precision "f32".

Traffic keys: frames, drive (speed_m, yaw_deg, ramp_frames), data
(noise_mm, dropout_share, second_share), sample (share, max_scans),
limits (field_mismatches, xyz_ulp, frames_lost).
"""

from __future__ import annotations

import functools
import glob
import os
import sys

import numpy as np

from portbench.drivers import scan_source
from portbench.lib import osf_write, yard
from portbench.lib.harness import count_passes
from portbench.reference import compare, osf_scan
from portbench.reference.lut import Lut


class _CachedXYZ:
    """XYZLut as scan_source's pass calls it, the scan for the first return
    and the field of each later one, with every return served from the
    scan's cache through return_xyz."""

    def __init__(self, lut, returns):
        self.lut, self.returns, self.scan = lut, returns, None

    def __call__(self, arg):
        if hasattr(arg, "field"):
            self.scan = arg
            return self.lut(arg)
        k = next(k for k, name in enumerate(self.returns)
                 if self.scan.field(name) is arg)
        return self.lut.return_xyz(self.scan, k)


class Driver(scan_source.Driver):
    def __init__(self, cell, seed, device, variant, workdir):
        super().__init__(cell, seed, device, variant, workdir)
        self.recording = cell.config["recording"]
        self.fields = osf_write.recorded_fields(self.sensor, self.recording)
        self._restore = None

    def _frame(self, k: int) -> dict:
        return yard.frame(self.sensor, self.dist[k], self.t["data"],
                          self.seed, k)

    def _record(self) -> str:
        """The seed's recording, written once (the other seeds' taken
        away: a recording is a hundred MB or more)."""
        path = os.path.join(self.workdir, f"recording-{self.seed}.osf")
        if not os.path.exists(path):
            for old in glob.glob(os.path.join(self.workdir,
                                              "recording-*.osf*")):
                os.remove(old)
            st = osf_write.write_recording(
                path, self.meta, self.recording,
                (self._frame(k) for k in range(self.t["frames"])))
            print(f"recording: {st['frames']} frames, {st['chunks']} "
                  f"chunks, {st['bytes']} bytes", file=sys.stderr)
        return path

    def setup(self) -> None:
        os.makedirs(self.workdir, exist_ok=True)
        self.dist = yard.cached_distances(
            os.path.join(self.workdir, "yard_distances.npy"), self.meta,
            self.t["drive"], self.t["frames"])
        self.path = self._record()
        import torch
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.io import device_engine

        self.torch, self.pt = torch, pt
        if self.variant == "control":
            project = device_engine.project_ranges
            self._restore = (device_engine, project)
            device_engine.project_ranges = functools.partial(
                project, precision="f32")
        src = pt.open_source(self.path, device=str(self.device))
        try:
            self.lut = _CachedXYZ(pt.XYZLut(src.sensor_info[0]),
                                  self.sensor.returns)
        finally:
            src.close()
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, None)      # warms every shape
        self.units, self.passes, self.kept = 0, [], []

    def _copy(self, scan, xyz):
        fid, got, xyz = super()._copy(scan, xyz)
        got["alert_flags"] = np.array(scan.alert_flags)
        return fid, got, xyz

    def release(self) -> None:
        super().release()
        if self._restore is not None:
            module, project = self._restore
            module.project_ranges = project

    def check(self):
        self.attempted, lost = count_passes(self.passes, self.t["frames"])
        self.failed = lost
        ref_lut = Lut(self.meta)
        bad, worst = 0, 0.0
        for fid, got, xyz in self.kept:
            if not 1 <= fid <= self.t["frames"]:
                bad += sum(np.size(v) for v in got.values())
                continue
            want = osf_scan.expected(self.sensor, self._frame(int(fid) - 1),
                                     self.fields)
            bad += compare.mismatches(got, want)
            for got_k, ref in zip(xyz, osf_scan.xyz(ref_lut, want,
                                                    self.sensor.returns)):
                worst = max(worst, compare.ulp_error(got_k, ref))
        lim = self.t["limits"]
        return [("field_mismatches", bad, lim["field_mismatches"]),
                ("xyz_ulp", worst, lim["xyz_ulp"]),
                ("frames_lost", lost, lim["frames_lost"])]
