"""Replay to LidarScans and their XYZ, the SDK's own scan path: a capture
of `frames` synthesized frames replayed in passes through

    open_source(path)        the pcap scan source; the device engine
                             stages on the host, decodes on the card and
                             copies the fields back into each LidarScan
      -> XYZLut(info)(scan)  RANGE's XYZ, and XYZ of RANGE2 where the
                             profile has it (host float64)

as pcap_to_pointcloud does. A frame counts once its scan and the XYZ of
every return are in hand. A sample of scans drawn from the seed is kept
and compared after the window: every field and column header with what
the synthesizer wrote (reference/scan.py), and the XYZ with the float64
reference (reference/lut.py), in metres. The control is the program's own
float32 LUT (XYZLutFloat) in XYZLut's place.

Traffic keys: frames, data (zero_range_share, invalid_column_share),
sample (share, max_scans), limits (field_mismatches, xyz_err_m,
frames_lost).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.lib import synth
from portbench.lib.harness import count_passes
from portbench.reference import compare, lut
from portbench.reference.scan import expected_scan, unwritten

HEADERS = ("timestamp", "measurement_id", "status", "packet_timestamp")


class Driver:
    def __init__(self, cell, seed, device, variant, workdir):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant, self.workdir = variant, workdir
        self.t = cell.traffic
        self.meta = cell.config["metadata"]
        self.sensor = synth.Sensor(self.meta)
        self.units = self.attempted = self.failed = 0
        self.window_s = 0.0
        self.calls = {}
        self.kept = []            # (frame id, {field: array}, [XYZ])
        self.passes = []

    def setup(self) -> None:
        self.path = synth.write_capture(
            self.workdir, self.meta,
            synth.random_frames(self.sensor, self.t["data"], self.seed,
                                self.t["frames"]))
        import torch
        import ouster_sdk_tpu_torch as pt

        self.torch, self.pt = torch, pt
        with open(self.path[:-len(".pcap")] + ".json") as f:
            info = pt.SensorInfo(f.read())
        self.lut = (pt.XYZLutFloat if self.variant == "control"
                    else pt.XYZLut)(info)
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, None)      # warms every shape
        self.units, self.passes, self.kept = 0, [], []

    def _pass(self, spans, deadline, keep) -> bool:
        src = self.pt.open_source(self.path, device=str(self.device))
        ids, hit = [], False
        try:
            for scans in spans.iterate(iter(src), "source"):
                scan = scans[0]
                with spans.span("xyzlut"):
                    xyz = [self.lut(scan)] + [
                        self.lut(scan.field(name))
                        for name in self.sensor.returns[1:]]
                self.units += 1
                ids.append(scan.frame_id)
                if deadline is not None:
                    hit = time.perf_counter() >= deadline
                    if keep(hit):
                        self.kept.append(self._copy(scan, xyz))
                    if hit:
                        self.window_s = time.perf_counter() - self.t0
                        break
        finally:
            src.close()
        self.passes.append((np.asarray(ids, np.int64), not hit))
        return hit

    def window(self, seconds: float, spans) -> None:
        sample = self.t["sample"]
        rng = np.random.default_rng([self.seed % (1 << 63), 2])

        def keep(last: bool) -> bool:
            return not self.kept or last or (
                len(self.kept) < sample["max_scans"]
                and rng.random() < sample["share"])

        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        while not self._pass(spans, deadline, keep):
            pass

    def _copy(self, scan, xyz):
        """What the check needs of a scan, copied (a source may reuse its
        buffers for later scans)."""
        got = {name: np.array(scan.field(name))
               for name in self.sensor.fields if scan.has_field(name)}
        for name in HEADERS:
            got[name] = np.array(getattr(scan, name))
        got["frame_id"] = np.array([scan.frame_id])
        return scan.frame_id, got, [np.array(x) for x in xyz]

    def release(self) -> None:
        del self.lut
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self):
        self.attempted, lost = count_passes(self.passes, self.t["frames"])
        self.failed = lost
        ref_lut = lut.Lut(self.meta)
        bad, worst = 0, 0.0
        for fid, got, xyz in self.kept:
            frame = synth.random_frame(self.sensor, self.t["data"],
                                       self.seed, int(fid) - 1)
            want = expected_scan(self.sensor, frame)
            bad += compare.mismatches(got, want, unwritten(self.sensor, frame))
            for k, name in enumerate(self.sensor.returns):
                ref = ref_lut(want[name])
                worst = max(worst, float(np.abs(
                    np.asarray(xyz[k], np.float64) - ref).max()))
        lim = self.t["limits"]
        return [("field_mismatches", bad, lim["field_mismatches"]),
                ("xyz_err_m", worst, lim["xyz_err_m"]),
                ("frames_lost", lost, lim["frames_lost"])]
