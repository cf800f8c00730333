"""Replay of a rig of sensors to LidarScanSets and their XYZ in the rig's
frame, the SDK's multi-sensor scan path: one capture of every sensor's
`frames` synthesized frames (lib/rig.py), each sensor on its own ports
with its own metadata file, replayed in passes through

    open_source(path, meta=[...], extrinsics=[...])
                             the pcap scan source on the engine route: one
                             DeviceScanIterator a sensor (its own capture
                             scan, admission, staging thread, copy in and
                             decode on the card), the streams merged by
                             release position and collated into sets
      -> XYZLut(info, use_extrinsics=True)
                             each sensor's RANGE and RANGE2 in the rig's
                             frame (host float64)

A frame is a set of the rig: it counts once every scan of the set and the
XYZ of each of their returns are in hand. A sample of sets drawn from the
seed is kept and compared after the window with the plain reference
(reference/rig.py): every field and column header of each scan with what
was written (reference/scan.py), and the XYZ with the float64 reference
moved by the sensor's extrinsic, in metres. Every set of the window is held
to the reference's collation: a set that lacks a sensor, or whose scans
carry other frame ids than the reference's set, is incomplete. Every scan
must come from the engine's decode (device_engine.stats["scans"]). The
control is the program's own float32 LUT (XYZLutFloat) in XYZLut's place.

Traffic keys: frames, data (zero_range_share, invalid_column_share),
sample (share, max_scans), limits (field_mismatches, xyz_err_m,
frames_lost, sets_incomplete, scans_off_engine).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import scan_source
from portbench.lib import rig, synth
from portbench.lib.harness import count_passes
from portbench.reference import compare
from portbench.reference import rig as ref_rig
from portbench.reference.scan import expected_scan, unwritten


class Driver(scan_source.Driver):
    """scan_source's window, sample and copies, over sets: the shared
    sensor model (`metadata`) gives the fields and returns."""

    def __init__(self, cell, seed, device, variant, workdir):
        super().__init__(cell, seed, device, variant, workdir)
        self.config = cell.config
        self.n = len(self.config["rig"])
        self.sensors = [synth.Sensor(rig.sensor_metadata(self.config, k))
                        for k in range(self.n)]
        self.set_ids = []       # each pass's sets: frame ids a sensor
        self.off_engine = 0

    def setup(self) -> None:
        self.path, self.meta = rig.write_capture(
            self.workdir, self.config, self.t["data"], self.seed,
            self.t["frames"])
        self.extrinsics = [rig.extrinsic(self.config, k)
                           for k in range(self.n)]
        import torch
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.io import device_engine

        self.torch, self.pt, self.engine = torch, pt, device_engine
        src = self._open()
        try:
            factory = (pt.XYZLutFloat if self.variant == "control"
                       else pt.XYZLut)
            self.luts = [factory(info, use_extrinsics=True)
                         for info in src.sensor_info]
        finally:
            src.close()
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, None)      # warms every shape
        self.units, self.passes, self.kept = 0, [], []
        self.set_ids, self.off_engine = [], 0

    def _open(self):
        return self.pt.open_source(self.path, meta=self.meta,
                                   extrinsics=self.extrinsics,
                                   device=str(self.device))

    def _pass(self, spans, deadline, keep) -> bool:
        engine_scans = self.engine.stats["scans"]
        src = self._open()
        ids, sets, delivered, hit = [], [], 0, False
        try:
            for scans in spans.iterate(iter(src), "source"):
                scans = list(scans)
                with spans.span("xyzlut"):
                    xyz = [None if scan is None else
                           [lut(scan)] + [lut(scan.field(name))
                                          for name in self.sensor.returns[1:]]
                           for lut, scan in zip(self.luts, scans)]
                self.units += 1
                fids = [None if s is None else s.frame_id for s in scans]
                delivered += sum(s is not None for s in scans)
                sets.append(fids)
                ids.append(next(f for f in fids if f is not None))
                if deadline is not None:
                    hit = time.perf_counter() >= deadline
                    if keep(hit):
                        self.kept.append([None if s is None else
                                          self._copy(s, x)
                                          for s, x in zip(scans, xyz)])
                    if hit:
                        self.window_s = time.perf_counter() - self.t0
                        break
        finally:
            src.close()
        # the engine counts a scan as it hands it out: a pass the window
        # cut may have counted a scan or two it never delivered
        counted = self.engine.stats["scans"] - engine_scans
        self.off_engine += max(0, delivered - counted) if hit \
            else abs(delivered - counted)
        self.passes.append((np.asarray(ids, np.int64), not hit))
        self.set_ids.append(sets)
        return hit

    def release(self) -> None:
        del self.luts
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def _incomplete(self) -> int:
        """Sets of the window that differ from the reference's set at their
        place in the pass (a sensor missing, or other frame ids)."""
        want = [[None if i is None else i + 1 for i in s]
                for s in ref_rig.expected_sets(
                    self.config, self.t["data"], self.seed,
                    self.t["frames"])]
        bad = 0
        for sets in self.set_ids:
            bad += sum(j >= len(want) or got != want[j]
                       for j, got in enumerate(sets))
        return bad

    def check(self):
        self.attempted, lost = count_passes(self.passes, self.t["frames"])
        incomplete = self._incomplete()
        self.failed = lost + incomplete
        data = self.t["data"]
        luts = [ref_rig.RigLut(self.config, k) for k in range(self.n)]
        bad, worst = 0, 0.0
        for kept in self.kept:
            for k, item in enumerate(kept):
                if item is None:
                    continue
                fid, got, xyz = item
                frame = rig.rig_frame(self.config, self.sensors[k], data,
                                      self.seed, k, int(fid) - 1)
                want = expected_scan(self.sensors[k], frame)
                bad += compare.mismatches(got, want,
                                          unwritten(self.sensors[k], frame))
                for r, name in enumerate(self.sensor.returns):
                    ref = luts[k](want[name])
                    worst = max(worst, float(np.abs(
                        np.asarray(xyz[r], np.float64) - ref).max()))
        lim = self.t["limits"]
        return [("field_mismatches", bad, lim["field_mismatches"]),
                ("xyz_err_m", worst, lim["xyz_err_m"]),
                ("frames_lost", lost, lim["frames_lost"]),
                ("sets_incomplete", incomplete, lim["sets_incomplete"]),
                ("scans_off_engine", self.off_engine,
                 lim["scans_off_engine"])]
