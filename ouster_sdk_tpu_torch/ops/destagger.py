"""Destagger / stagger: per-row circular shifts aligning columns in time vs
azimuth (ref: ouster_client/include/ouster/impl/lidar_scan_impl.h:764-847,
python data.py:103-126). A single gather with a per-row index map: numpy
on the host, torch.gather on the device. The host keeps its index maps
cached per (shifts, width, direction): OSF replay staggers every field of
every scan, and building the map cost more than the gather.

Semantics: destaggered[u, j] = staggered[u, (j - shift[u]) mod w]
(shift sign +1; inverse flips the sign).
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from ..core.types import SensorInfo
from ..utils import profiling


def _shifts(info_or_shifts) -> np.ndarray:
    if isinstance(info_or_shifts, SensorInfo):
        return np.asarray(info_or_shifts.format.pixel_shift_by_row,
                          dtype=np.int64)
    return np.asarray(info_or_shifts, dtype=np.int64)


def _index_map(shifts: np.ndarray, w: int, inverse: bool) -> np.ndarray:
    sign = -1 if inverse else 1
    col = np.arange(w, dtype=np.int64)[None, :]
    return (col - sign * shifts[:, None]) % w  # (h, w)


@functools.lru_cache(maxsize=64)
def _flat_index_map(shifts: tuple, w: int, inverse: bool) -> np.ndarray:
    """_index_map as read-only flat indices into an (h, w) image."""
    h = len(shifts)
    idx = _index_map(np.asarray(shifts, dtype=np.int64), w, inverse)
    idx += np.arange(h, dtype=np.int64)[:, None] * w
    idx.flags.writeable = False
    return idx


def destagger(info_or_shifts, fields: np.ndarray,
              inverse: bool = False) -> np.ndarray:
    """Host path. fields: (h, w) or (h, w, n)."""
    shifts = _shifts(info_or_shifts)
    h, w = fields.shape[:2]
    if shifts.size != h:
        raise ValueError("image height does not match shifts size")
    idx = _flat_index_map(tuple(shifts.tolist()), w, inverse)
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
        shifts = np.asarray(shifts, dtype=np.int64)
        if fields.shape[-2] == shifts.size:
            axis, w = -1, fields.shape[-1]
            idx = torch.from_numpy(_index_map(shifts, w, inverse))
        elif fields.ndim >= 3 and fields.shape[-3] == shifts.size:
            axis, w = -2, fields.shape[-2]
            idx = torch.from_numpy(_index_map(shifts, w, inverse))[..., None]
        else:
            raise ValueError("image height does not match shifts size")
        idx = idx.to(fields.device).expand(fields.shape)
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
