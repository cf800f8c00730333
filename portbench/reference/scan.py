"""What a scan of a synthesized frame holds, as the SDK's LidarScan keeps
it: the fields of every column whose status bit is set, as written;
columns whose status bit is cleared are zero in every field and header
(the SDK's batcher skips an invalid column and zero-fills its slot)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..lib.synth import Sensor


def expected_scan(sensor: Sensor, frame: dict) -> Dict[str, np.ndarray]:
    """{name: array} of every channel field of the profile (FLAGS and
    WINDOW, never written, are zero) and the column headers. A scan may
    leave out the fields that were never written (unwritten())."""
    valid = (frame["status"] & 1).astype(bool)
    out = {}
    for name in sensor.fields:
        v = frame["fields"].get(name)
        v = (np.zeros((sensor.h, sensor.w), np.int64) if v is None
             else v.astype(np.int64))
        out[name] = np.where(valid[None, :], v, 0)
    out["timestamp"] = np.where(valid, frame["col_ts"], 0).astype(np.uint64)
    out["measurement_id"] = np.where(valid, np.arange(sensor.w), 0)
    out["status"] = np.where(valid, frame["status"], 0)
    out["packet_timestamp"] = frame["pkt_ts"].astype(np.uint64)
    out["frame_id"] = np.array([frame["frame_id"]])
    return out


def unwritten(sensor: Sensor, frame: dict):
    """The profile's fields the synthesizer leaves zero (FLAGS, WINDOW)."""
    return {name for name in sensor.fields if name not in frame["fields"]}
