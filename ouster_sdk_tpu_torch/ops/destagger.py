"""Destagger / stagger: per-row circular shifts aligning columns in time vs
azimuth (ref: ouster_client/include/ouster/impl/lidar_scan_impl.h:764-847,
python data.py:103-126). A single gather with a per-row index map: numpy
on the host, torch.gather on the device. Both take their index maps from
one cache per (shifts, width, direction), the device path a copy of the
map kept on each device: OSF replay staggers every field of every scan
and the replay to XYZ destaggers every frame, and building the map and
copying it to the card cost more than the gather.

Semantics: destaggered[u, j] = staggered[u, (j - shift[u]) mod w]
(shift sign +1; inverse flips the sign).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..core.types import SensorInfo
from ..utils import profiling


def _shifts(info_or_shifts) -> np.ndarray:
    if isinstance(info_or_shifts, SensorInfo):
        return np.asarray(info_or_shifts.format.pixel_shift_by_row,
                          dtype=np.int64)
    return np.asarray(info_or_shifts, dtype=np.int64)


class _IndexMap:
    """The gather indices of one (shifts, w, direction), read-only: `rows`
    (h, w), the column of the staggered image each pixel reads; `flat`, the
    same as indices into the flattened (h, w) image, for the host path;
    and `on(device)`, `rows` copied once to each device."""

    def __init__(self, shifts: tuple, w: int, inverse: bool):
        sign = -1 if inverse else 1
        col = np.arange(w, dtype=np.int64)[None, :]
        self.rows = (col - sign * np.asarray(shifts, dtype=np.int64)[:, None]
                     ) % w
        self.flat = self.rows + np.arange(len(shifts),
                                          dtype=np.int64)[:, None] * w
        self.rows.flags.writeable = self.flat.flags.writeable = False
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        idx = self._on.get(device)
        if idx is None:
            idx = self._on[device] = torch.tensor(self.rows, device=device)
        return idx


@functools.lru_cache(maxsize=64)
def _index_map(shifts: tuple, w: int, inverse: bool) -> _IndexMap:
    return _IndexMap(shifts, w, inverse)


def destagger(info_or_shifts, fields: np.ndarray,
              inverse: bool = False) -> np.ndarray:
    """Host path. fields: (h, w) or (h, w, n)."""
    shifts = _shifts(info_or_shifts)
    h, w = fields.shape[:2]
    if shifts.size != h:
        raise ValueError("image height does not match shifts size")
    idx = _index_map(tuple(shifts.tolist()), w, inverse).flat
    flat = fields.reshape((h * w,) + fields.shape[2:])
    return np.take(flat, idx, axis=0)


def stagger(info_or_shifts, fields: np.ndarray) -> np.ndarray:
    """The inverse of destagger."""
    return destagger(info_or_shifts, fields, inverse=True)


def destagger_torch(fields: torch.Tensor,
                    shifts: Union[Sequence[int], np.ndarray],
                    inverse: bool = False) -> torch.Tensor:
    """Device path, same semantics as destagger(): fields (..., h, w) or
    (..., h, w, n) with shifts of length h."""
    with profiling.span("destagger"):
        shifts = tuple(np.asarray(shifts, dtype=np.int64).tolist())
        if fields.shape[-2] == len(shifts):
            axis, w = -1, fields.shape[-1]
            idx = _index_map(shifts, w, inverse).on(fields.device)
        elif fields.ndim >= 3 and fields.shape[-3] == len(shifts):
            axis, w = -2, fields.shape[-2]
            idx = _index_map(shifts, w, inverse).on(fields.device)[..., None]
        else:
            raise ValueError("image height does not match shifts size")
        idx = idx.expand(fields.shape)
        # gather has no unsigned 16/32-bit kernels: move the bits as signed
        signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}
        if fields.dtype in signed:
            return torch.gather(fields.view(signed[fields.dtype]), axis, idx) \
                .view(fields.dtype)
        return torch.gather(fields, axis, idx)


# typed variants matching the reference binding names (the C++ side has
# one per dtype, ref: client.pyi destagger_uint8...; this one is generic)
destagger_bool = destagger
destagger_int8 = destagger
destagger_int16 = destagger
destagger_int32 = destagger
destagger_int64 = destagger
destagger_uint8 = destagger
destagger_uint16 = destagger
destagger_uint32 = destagger
destagger_uint64 = destagger
destagger_float = destagger
destagger_double = destagger
