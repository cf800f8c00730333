"""Wire-codec replay to XYZ on the card: the yard drive (lib/yard.py) of
`frames` frames written once a seed as a capture, replayed in passes (each
pass opens the file with a new reader, as a user replaying files does)
through the port's wire-codec path:

    FrameReader(path, info).iter_bp64_chunks(chunk, fields, nbits)
                             the two range words staged and BP64-coded a
                             frame on the staging thread (native encoder)
      -> fused_pipelined     the chunk's payload, widths, anchors and
                             column headers packed into one u32 buffer
                             (ChunkFuser), on the staging thread
      -> words_tensor        one pageable copy to the card
      -> unfuse_words, project_bp64_batched
                             the buffer split, the ranges decoded and
                             projected on the card (planar_project on
                             every range image of the chunk)

A frame counts once the XYZ of both its returns is complete on the card
(no destagger): the window waits once a chunk. A sample of chunks drawn
from the seed goes to the host as it is taken: the shipped buffer with its
layout (before the next chunk is taken: the fuser's ring reuses it) and
the XYZ. After the window the plain reference (reference/bp64.py) decodes
each sampled buffer, split by its layout, and its ranges must equal the
RANGE and RANGE2 made again from the seed (the codec is lossless:
`range_mismatches`, exact); the XYZ is compared with the float64
reference (reference/lut.py) of the seed's ranges in float32 units in the
last place (`xyz_ulp`); every frame id of every pass against 1..frames.
The control is the program's own float32 projection (precision "f32").

Traffic keys: frames, chunk, depth (staging queue), precision, drive
(speed_m, yaw_deg, ramp_frames), data (noise_mm, dropout_share,
second_share), sample (share, max_chunks), limits (xyz_ulp,
range_mismatches, frames_lost).
"""

from __future__ import annotations

import os
import time

import numpy as np

from portbench.lib import synth, yard
from portbench.lib.harness import count_passes
from portbench.reference import bp64, compare, lut


def _select(item):
    """What crosses the link of an iter_bp64_chunks item: (frame ids,
    [payload, widths, anchors, col_hdrs])."""
    fids, payload, widths, anchors, hdrs, _ = item
    return fids, [payload, widths, anchors, hdrs]


class Driver:
    def __init__(self, cell, seed, device, variant, workdir):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant, self.workdir = variant, workdir
        self.t = cell.traffic
        self.meta = cell.config["metadata"]
        self.wire = cell.config["wire"]
        self.sensor = synth.Sensor(self.meta)
        self.units = self.attempted = self.failed = 0
        self.window_s = 0.0
        self.calls = {}
        self.kept = []      # (frame ids, shipped buffer, layout, [XYZ])
        self.passes = []    # frame ids of each pass, and if it ended

    # -- set-up ---------------------------------------------------------------
    def _frame(self, k: int) -> dict:
        return yard.frame(self.sensor, self.dist[k], self.t["data"],
                          self.seed, k)

    def setup(self) -> None:
        n = self.t["frames"]
        self.dist = yard.cached_distances(
            os.path.join(self.workdir, "yard_distances.npy"), self.meta,
            self.t["drive"], n)
        self.path = synth.write_capture(
            self.workdir, self.meta, (self._frame(k) for k in range(n)))
        import torch
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.ops import bp64 as pbp64
        from ouster_sdk_tpu_torch.ops import packed, planar_kernels

        self.torch, self.pt = torch, pt
        self.pbp64, self.packed, self.pk = pbp64, packed, planar_kernels
        with open(os.path.splitext(self.path)[0] + ".json") as f:
            self.info = pt.SensorInfo(f.read())
        self.precision = ("f32" if self.variant == "control"
                          else self.t["precision"])
        self.pipe = pt.ScanPipeline(self.info, precision=self.precision,
                                    device=self.device)
        self.lut = self.pipe.planar_lut.stack           # on the card once
        self.fields, self.nbits, self.upshifts = \
            packed.packed_range_fields(self.pipe.plan, self.pipe.dual)
        stated = (tuple(tuple(f) for f in self.wire["fields"]),
                  self.wire["nbits"])
        if self.wire["codec"] != "bp64" or stated != (self.fields,
                                                      self.nbits):
            raise ValueError(f"the configuration's wire {self.wire} is not "
                             f"the profile's range fields {self.fields}, "
                             f"{self.nbits} bits")
        # one whole pass warms every shape the window uses
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, None)
        self.units, self.passes, self.kept = 0, [], []

    # -- the window -----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _pass(self, spans, deadline, keep) -> bool:
        """One pass over the capture; True when the deadline was reached
        (the window's end is taken there, before the staging thread is
        joined)."""
        pt, pipe = self.pt, self.pipe
        reader = pt.FrameReader(self.path, self.info)
        chunk, depth = self.t["chunk"], self.t["depth"]
        it = pt.fused_pipelined(
            lambda: reader.iter_bp64_chunks(chunk, self.fields, self.nbits,
                                            pool_depth=depth + 2),
            _select, depth)
        ids, hit = [], False
        try:
            for fids, fused, layout in spans.iterate(it, "staging"):
                with spans.span("project"):
                    words = self.pk.words_tensor(fused, self.device)
                    payload, widths, anchors, hdrs = \
                        self.packed.unfuse_words(words, layout)
                    out = self.pbp64.project_bp64_batched(
                        payload, widths, anchors, hdrs, self.lut, pipe.plan,
                        self.nbits, upshifts=self.upshifts,
                        precision=self.precision, dual=pipe.dual)
                    xyz = out if pipe.dual else (out,)
                with spans.span("wait"):
                    self._sync()
                self.units += len(fids)
                ids.append(fids)
                if deadline is not None:
                    hit = time.perf_counter() >= deadline
                    if keep(hit):
                        # to the host at once, and the buffer before the
                        # next chunk is taken: the ring reuses it
                        self.kept.append((fids, fused.copy(), layout,
                                          [x.cpu().numpy().copy()
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
        rng = np.random.default_rng([self.seed % (1 << 63), 4])

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
        del self.pipe, self.lut
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def _compare(self, fid: int, payload, widths, anchors, xyz, b, ref_lut):
        """(range mismatches, largest XYZ error in f32 ulps) of frame `fid`,
        the b-th of its chunk."""
        returns = self.sensor.returns
        want = np.stack([self._frame(fid - 1)["fields"][name]
                         for name in returns]).astype(np.int64)
        got = bp64.decode(payload[b], widths[b], anchors[b]).numpy()
        bad = (int(np.count_nonzero(got[:len(returns)] != want))
               if got.shape[1:] == want.shape[1:]
               and len(got) >= len(returns) else want.size)
        worst = 0.0
        for k in range(len(returns)):
            worst = max(worst, compare.ulp_error(
                np.moveaxis(xyz[k][b], 0, -1), ref_lut(want[k])))
        return bad, worst

    def check(self):
        self.attempted, lost = count_passes(self.passes, self.t["frames"])
        self.failed = lost
        ref_lut = lut.Lut(self.meta)
        size = self.sensor.h * self.sensor.w * len(self.sensor.returns)
        bad, worst = 0, 0.0
        for fids, fused, layout, xyz in self.kept:
            payload, widths, anchors, _ = bp64.split(fused, layout)
            for b, fid in enumerate(fids):
                if not 1 <= fid <= self.t["frames"] or b >= len(payload):
                    bad += size
                    worst = float("inf")
                    continue
                n, err = self._compare(int(fid), payload, widths, anchors,
                                       xyz, b, ref_lut)
                bad += n
                worst = max(worst, err)
        lim = self.t["limits"]
        return [("xyz_ulp", worst, lim["xyz_ulp"]),
                ("range_mismatches", bad, lim["range_mismatches"]),
                ("frames_lost", lost, lim["frames_lost"])]
