"""What a rig's capture (lib/rig.py) replays to, from the seed alone: the
sets of scans that the SDK's Collator makes of the sensors' scans, and each
scan's XYZ in the rig's frame.

A packet-by-packet batcher releases a sensor's scan at the frame's last
packet (every packet of a written frame is in the capture), so the scans
come in the order of their last packets' host times, ties in sensor
order. The Collator (scan_source_utils.h:22-88) keeps a set open until
every sensor has a scan in it; it cuts the set early when a sensor
repeats, or when a scan's time (its first valid column's, else its first
packet's) is more than dt after the set's first scan's. XYZ in the rig's
frame is the sensor's XYZ (lut.py) moved by the sensor's extrinsic; a zero
range has no point (0).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..lib import rig, synth
from .lut import Lut

COLLATION_DT_NS = 210_000_000


def _collation_ts(frame: dict) -> int:
    valid = np.flatnonzero(frame["status"] & 1)
    if valid.size:
        return int(frame["col_ts"][valid[0]])
    return int(frame["pkt_ts"][0])


def collate(scans: Iterable[Tuple[int, int, int]], n: int,
            dt_ns: int = COLLATION_DT_NS) -> List[List[Optional[int]]]:
    """The Collator over (sensor, frame index, time) in arrival order: the
    sets, each a list of a frame index (or None) a sensor."""
    sets, pending, start = [], [None] * n, None
    for k, index, ts in scans:
        if start is None:
            start = ts
        if pending[k] is not None or ts - start > dt_ns:
            sets.append(pending)
            pending, start = [None] * n, ts
        pending[k] = index
        if all(p is not None for p in pending):
            sets.append(pending)
            pending, start = [None] * n, None
    if any(p is not None for p in pending):
        sets.append(pending)
    return sets


def expected_sets(config: dict, data: dict, seed: int, n_frames: int,
                  missing: Iterable[Tuple[int, int]] = ()
                  ) -> List[List[Optional[int]]]:
    """The sets a replay of rig.write_capture's capture yields, each a list
    of a frame index (or None) a sensor."""
    missing = set(missing)
    scans = []
    for k in range(len(config["rig"])):
        sensor = synth.Sensor(rig.sensor_metadata(config, k))
        for index in range(n_frames):
            if (k, index) in missing:
                continue
            frame = rig.rig_frame(config, sensor, data, seed, k, index)
            scans.append((int(frame["pkt_ts"][-1]), k, index,
                          _collation_ts(frame)))
    scans.sort(key=lambda s: (s[0], s[1]))
    return collate([s[1:] for s in scans], len(config["rig"]))


class RigLut:
    """A sensor's XYZ in the rig's frame, metres, float64."""

    def __init__(self, config: dict, k: int):
        self.lut = Lut(rig.sensor_metadata(config, k))
        ext = rig.extrinsic(config, k)
        self.rot, self.trans = ext[:3, :3], ext[:3, 3]

    def __call__(self, ranges: np.ndarray) -> np.ndarray:
        """ranges (h, w) in mm, staggered -> (h, w, 3) metres."""
        p = self.lut(ranges) @ self.rot.T + self.trans
        return np.where(np.asarray(ranges)[..., None] == 0, 0.0, p)
