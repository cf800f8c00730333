"""What a replay of the benchmark's OSF recording (lib/osf_write.py) must
yield for a frame made again from the seed: the LidarScan the message
records, staggered as the scan held it (reference/scan.py: every recorded
field, the column headers, the packets' receive times, the frame id, and
the alert flags, zero), and the XYZ of each return in float64
(reference/lut.py)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..lib.synth import Sensor
from .lut import Lut
from .scan import expected_scan


def expected(sensor: Sensor, frame: dict, fields: Sequence[str]
             ) -> Dict[str, np.ndarray]:
    """{name: array} of the scan a replay yields: the recorded `fields`
    (a field the frame leaves out is zero) and the headers."""
    want = expected_scan(sensor, frame)
    out = {k: v for k, v in want.items()
           if k not in sensor.fields or k in fields}
    out["alert_flags"] = np.zeros(sensor.n_pkts, np.uint8)
    return out


def xyz(lut: Lut, want: Dict[str, np.ndarray], returns: Sequence[str]
        ) -> List[np.ndarray]:
    """(h, w, 3) metres of each return, staggered, a zero range at 0."""
    return [lut(want[name]) for name in returns]
