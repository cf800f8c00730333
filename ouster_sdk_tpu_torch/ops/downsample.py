"""Voxel downsampling: centroid (not center) per occupied voxel.

Rebuild of the reference voxel_downsample (ref: ouster_client/include/
ouster/downsample.h:11-60, impl/downsample_impl.h — robin-map accumulation
of per-voxel point/attribute means with a min_pts_per_voxel threshold).

Two paths:
  - voxel_downsample: host numpy via sort+reduceat (exact reference
    semantics, variable output size); voxel_downsample_first keeps the
    first point of each voxel (KISS-ICP's VoxelDownsample)
  - voxel_downsample_device: plain PyTorch on the points' device with a
    fixed output capacity — sort by voxel key, then segment means padded
    to `capacity`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def pack_voxel_coords(idx: np.ndarray) -> np.ndarray:
    """Pack (..., 3) int64 voxel coords into one int64 key — 21 bits per
    signed axis, so +-2^20 voxels from the origin (e.g. ~52 km at
    0.05 m voxels); coordinates beyond that wrap silently. Single
    source of truth for the packing (VoxelHashMap shares it, and
    DeviceVoxelMap, which hands it int64 tensors)."""
    off = np.int64(1 << 20)
    return ((idx[..., 0] + off) << 42) | ((idx[..., 1] + off) << 21) | \
        (idx[..., 2] + off)


def _voxel_keys_np(points: np.ndarray, voxel_size: np.ndarray) -> np.ndarray:
    return pack_voxel_coords(np.floor(points / voxel_size).astype(np.int64))


def voxel_downsample_first(points: np.ndarray,
                           voxel_size: float) -> np.ndarray:
    """First-point-per-voxel downsample — kiss-icp's VoxelDownsample
    semantics (ref: thirdparty/kiss-icp/cpp/kiss_icp/core/VoxelUtils.cpp:
    `if (!grid.contains(voxel)) grid.insert({voxel, point})`). The SDK's
    own voxel_downsample (downsample.h) keeps CENTROIDS; KISS-ICP keeps
    the first point inserted, so both live side by side. Output order is
    first-occurrence order (the reference's robin_map iteration order is
    unspecified)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if points.size == 0:
        return points.reshape(0, 3)
    vs = np.broadcast_to(np.float64(voxel_size), (3,))
    keys = _voxel_keys_np(points, vs)
    _, first_idx = np.unique(keys, return_index=True)
    return points[np.sort(first_idx)]


def voxel_downsample(
    points: np.ndarray,
    voxel_size: Union[float, Sequence[float]],
    attribs: Optional[List[np.ndarray]] = None,
    min_pts_per_voxel: int = 1,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Centroid-of-voxel downsample (ref: downsample.h:11-60).

    points: (N, 3); attribs: optional list of (N, ...) arrays averaged per
    voxel. Returns (centroids (M, 3), [attrib means]).
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    vs = np.broadcast_to(np.asarray(voxel_size, dtype=np.float64), (3,))
    if np.any(vs <= 0):
        # ref: downsample.h throws invalid_argument for non-positive sizes
        raise ValueError("voxel size is zero or negative")
    if points.size == 0:
        return points.reshape(0, 3), [
            a[:0] for a in (attribs or [])]

    keys = _voxel_keys_np(points, vs)
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    boundaries = np.flatnonzero(np.diff(keys_s)) + 1
    starts = np.concatenate([[0], boundaries])
    counts = np.diff(np.concatenate([starts, [keys_s.size]]))

    sums = np.add.reduceat(points[order], starts, axis=0)
    keep = counts >= min_pts_per_voxel
    centroids = sums[keep] / counts[keep, None]

    out_attribs: List[np.ndarray] = []
    for a in attribs or []:
        a = np.asarray(a)
        a_s = a[order].astype(np.float64)
        a_sums = np.add.reduceat(a_s, starts, axis=0)
        denom = counts[keep].reshape((-1,) + (1,) * (a.ndim - 1))
        out_attribs.append((a_sums[keep] / denom).astype(a.dtype
                           if np.issubdtype(a.dtype, np.floating)
                           else np.float64))
    return centroids, out_attribs


def voxel_downsample_device(
    points: torch.Tensor,
    voxel_size: float,
    capacity: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel downsample on the points' device with a fixed output capacity
    (the counterpart of the JAX package's voxel_downsample_jax).

    points: (N, 3) float (invalid rows masked via `valid`). Returns
    (centroids (capacity, 3), mask (capacity,)) — unused slots are zero
    with mask False. Voxels come out in lexicographic (x, y, z) order of
    their cell; those beyond `capacity` are dropped, not folded into the
    last slot.

    The sums are `index_add_`, which on CUDA accumulates with atomics in
    no fixed order: the last bits of a centroid may differ from run to run
    and from the CPU (a few f32 ulp of the largest coordinate summed; the
    voxel set and the counts are exact).
    """
    if voxel_size <= 0:
        # ref: downsample.h throws invalid_argument for non-positive sizes
        raise ValueError("voxel size is zero or negative")
    n = points.shape[0]
    device = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=device)

    # three int32 keys without a cell-coordinate range limit; the divisor
    # is a device tensor, so CUDA divides (a Python scalar would become a
    # multiplication by its reciprocal there) and cells match the JAX
    # package's floor(p / v)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=device)
    idx = torch.floor(points / vs).to(torch.int32)
    big = torch.tensor(2**30, dtype=torch.int32, device=device)
    keys = torch.where(valid[:, None], idx, big)

    # lexsort (x, y, z): stable sorts from the last key to the first;
    # invalid points sort last
    order = torch.arange(n, device=device)
    for k in (2, 1, 0):
        perm = torch.sort(keys[order, k], stable=True).indices
        order = order[perm]
    keys_s = keys[order]
    pts_s = points[order]
    valid_s = valid[order]

    # segment ids: positions where any key changes
    new_seg = torch.ones((n,), dtype=torch.bool, device=device)
    if n > 1:
        new_seg[1:] = (keys_s[1:] != keys_s[:-1]).any(dim=1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    # voxels beyond capacity go to an overflow slot, sliced off below
    seg_id = torch.clamp(seg_id, max=capacity)

    w = valid_s.to(points.dtype)
    sums = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=device)
    sums.index_add_(0, seg_id, pts_s * w[:, None])
    counts = torch.zeros((capacity + 1,), dtype=points.dtype, device=device)
    counts.index_add_(0, seg_id, w)
    sums, counts = sums[:capacity], counts[:capacity]
    mask = counts > 0
    centroids = torch.where(mask[:, None],
                            sums / torch.clamp(counts, min=1)[:, None],
                            torch.zeros((), dtype=points.dtype,
                                        device=device))
    return centroids, mask
