"""Replay to XYZ on the card: a capture of `frames` synthesized frames,
replayed in passes (each pass opens the file anew, as a user replaying
files does) through the port's main path:

    FrameReader(path, info).iter_planar_chunks_pipelined(chunk)
      -> ScanPipeline.project_planar (every return, double-single)
      -> destagger_torch of each return's XYZ, on the card

A frame counts once its destaggered XYZ of every return is complete on
the card: the window waits once a chunk and copies nothing back but a
sample of chunks drawn from the seed, which goes to the host as it is
taken and, after the window, is compared with the float64 reference
(reference/lut.py) in float32 units in the last place, with every frame
id of every pass. The control is the
program's own float32 projection (ScanPipeline(precision="f32")).

Traffic keys: frames, chunk, depth (staging queue), precision, data
(zero_range_share, invalid_column_share), sample (share, max_chunks),
limits (xyz_ulp, frames_lost).
"""

from __future__ import annotations

import os
import time

import numpy as np

from portbench.lib import synth
from portbench.lib.harness import count_passes
from portbench.reference import compare, lut


class Driver:
    def __init__(self, cell, seed, device, variant, workdir):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant, self.workdir = variant, workdir
        self.t = cell.traffic
        self.meta = cell.config["metadata"]
        self.sensor = synth.Sensor(self.meta)
        self.units = self.attempted = self.failed = 0
        self.window_s = 0.0
        self.calls = {"planar_project": []}
        self.kept = []            # (frame ids, [XYZ of each return])
        self.passes = []          # frame ids of each pass, and if it ended

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        self.path = synth.write_capture(
            self.workdir, self.meta,
            synth.random_frames(self.sensor, self.t["data"], self.seed,
                                self.t["frames"]))
        import torch
        import ouster_sdk_tpu_torch as pt

        self.torch, self.pt = torch, pt
        with open(os.path.splitext(self.path)[0] + ".json") as f:
            self.info = pt.SensorInfo(f.read())
        precision = "f32" if self.variant == "control" \
            else self.t["precision"]
        self.pipe = pt.ScanPipeline(self.info, precision=precision,
                                    device=self.device)
        # one whole pass warms every shape the window uses
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, None)
        self.units, self.calls["planar_project"] = 0, []
        self.passes, self.kept = [], []

    # -- the window -----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _pass(self, spans, deadline, keep) -> bool:
        """One pass over the capture; True when the deadline was reached
        (the window's end is taken there, before the staging thread is
        joined)."""
        pipe, pt = self.pipe, self.pt
        reader = pt.FrameReader(self.path, self.info)
        it = reader.iter_planar_chunks_pipelined(self.t["chunk"],
                                                 depth=self.t["depth"])
        ids, hit = [], False
        try:
            for fids, planes, hdrs, _ in spans.iterate(it, "staging"):
                with spans.span("project"):
                    out = pipe.project_planar(planes, hdrs)
                    xyz = [pt.destagger_torch(x, pipe.shifts)
                           for x in (out if pipe.dual else (out,))]
                with spans.span("wait"):
                    self._sync()
                self.units += len(fids)
                self.calls["planar_project"].append(len(fids))
                ids.append(fids)
                if deadline is not None:
                    hit = time.perf_counter() >= deadline
                    if keep(hit):
                        # to the host at once: kept on the card, the
                        # sample would weigh in the memory peak
                        self.kept.append((fids, [x.cpu().numpy().copy()
                                                 for x in xyz]))
                    if hit:
                        self.window_s = time.perf_counter() - self.t0
                        break
        finally:
            it.close()
        self.passes.append((np.concatenate(ids) if ids else
                            np.zeros(0, np.int64), not hit))
        return hit

    def window(self, seconds: float, spans) -> None:
        sample = self.t["sample"]
        rng = np.random.default_rng([self.seed % (1 << 63), 1])

        def keep(last: bool) -> bool:
            first = not self.kept
            return first or last or (len(self.kept) < sample["max_chunks"]
                                     and rng.random() < sample["share"])

        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        while not self._pass(spans, deadline, keep):
            pass

    # -- the check ------------------------------------------------------------
    def release(self) -> None:
        del self.pipe
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self):
        self.attempted, lost = count_passes(self.passes, self.t["frames"])
        self.failed = lost
        ref_lut = lut.Lut(self.meta)
        worst = 0.0
        for fids, xyz in self.kept:
            for b, fid in enumerate(fids):
                frame = synth.random_frame(self.sensor, self.t["data"],
                                           self.seed, int(fid) - 1)
                valid = (frame["status"] & 1).astype(bool)
                for k, name in enumerate(self.sensor.returns):
                    r = np.where(valid[None, :], frame["fields"][name], 0)
                    ref = lut.destagger(ref_lut(r), self.sensor.shifts)
                    got = np.moveaxis(xyz[k][b], 0, -1)
                    worst = max(worst, compare.ulp_error(got, ref))
        lim = self.t["limits"]
        return [("xyz_ulp", worst, lim["xyz_ulp"]),
                ("frames_lost", lost, lim["frames_lost"])]
