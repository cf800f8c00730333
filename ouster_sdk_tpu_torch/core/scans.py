"""Scans / Packets iteration adapters.

Rebuild of the reference Python adapters (ref: python/src/ouster/sdk/core/
core.py, multi.py:13): `Scans` batches any packet source into single-sensor
scans; `Packets` wraps a raw packet iterable with sensor metadata.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .batcher import ScanBatcher
from .lidar_scan import LidarScan, get_field_types
from .packets import Packet
from .types import SensorInfo


class Packets:
    """A packet iterable bound to sensor metadata
    (ref: core/core.py Packets)."""

    def __init__(self, packets: Iterable[Packet], info: SensorInfo):
        self._packets = packets
        self._info = info

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return [self._info]

    @property
    def metadata(self) -> SensorInfo:
        return self._info

    def __iter__(self) -> Iterator[Tuple[int, Packet]]:
        for p in self._packets:
            yield 0, p

    def close(self) -> None:
        pass


class Scans:
    """Batch a packet source into LidarScans (ref: core/multi.py:13).

    Works with any source yielding (sensor_idx, packet); produces per-sensor
    scans in arrival order as (sensor_idx, LidarScan) or bare LidarScan when
    the source has one sensor.
    """

    def __init__(self, source, *, complete: bool = False,
                 fields: Optional[List[str]] = None):
        self._source = source
        self._complete = complete
        self._fields = fields

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return self._source.sensor_info

    @property
    def metadata(self) -> SensorInfo:
        return self._source.sensor_info[0]

    def _field_types(self, info: SensorInfo):
        fts = get_field_types(info)
        if self._fields is not None:
            fts = [ft for ft in fts if ft.name in self._fields]
        return fts

    def __iter__(self):
        infos = self._source.sensor_info
        single = len(infos) == 1
        batchers = [ScanBatcher(i) for i in infos]
        scans = [LidarScan(i, field_types=self._field_types(i))
                 for i in infos]
        for idx, packet in self._source:
            if batchers[idx](packet, scans[idx]):
                out = scans[idx]
                scans[idx] = LidarScan(
                    infos[idx], field_types=self._field_types(infos[idx]))
                if self._complete and not out.complete():
                    continue
                yield out if single else (idx, out)
        for idx, s in enumerate(scans):
            if s.frame_id != -1 and np.any(s.status & 1):
                if self._complete and not s.complete():
                    continue
                yield s if single else (idx, s)

    def close(self) -> None:
        self._source.close()
