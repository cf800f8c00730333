"""KISS-ICP odometry: voxel-hash map + adaptive threshold + robust
point-to-point ICP.

Rebuild of the reference's vendored kiss-icp pipeline with the SAME data
structures and semantics (ref: ouster_mapping/src/kiss_icp.{h,cpp}:17-69,
thirdparty/kiss-icp/cpp/kiss_icp/core/{Registration,Threshold,
VoxelHashMap,VoxelUtils}.cpp):
  - VoxelDownsample keeps the FIRST point per voxel (VoxelUtils.cpp)
  - the local map is a voxel hash capping max_points_per_voxel per cell,
    rejecting points closer than map_resolution =
    sqrt(voxel_size^2 / max_points_per_voxel) to an existing point in
    the cell (VoxelHashMap::AddPoints), pruned when a cell's first point
    is >= max_distance from the origin
  - nearest neighbors scan the 27-voxel neighborhood of the query
    (VoxelHashMap::GetClosestNeighbor) — vectorized here over all
    queries with a sorted-key searchsorted instead of a robin_map, same
    associations
  - math in numpy float64 like the reference's Eigen doubles
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.downsample import voxel_downsample_first
from ..utils import profiling


@dataclass
class KissConfig:
    """(ref: ouster_mapping/src/kiss_icp.h:18-34)"""

    voxel_size: float = 1.0
    max_range: float = 100.0
    min_range: float = 5.0
    max_points_per_voxel: int = 20
    min_motion_th: float = 0.1
    initial_threshold: float = 2.0
    max_num_iterations: int = 500
    convergence_criterion: float = 1e-4
    deskew: bool = False


def _hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(rho(3), theta(3)) -> 4x4 (kiss-icp dx layout: translation first)."""
    rho, theta = xi[:3], xi[3:]
    angle = np.linalg.norm(theta)
    K = _hat(theta)
    if angle < 1e-10:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        K2 = K @ K
        s, c = np.sin(angle), np.cos(angle)
        R = np.eye(3) + (s / angle) * K + ((1 - c) / angle**2) * K2
        V = np.eye(3) + ((1 - c) / angle**2) * K \
            + ((angle - s) / angle**3) * K2
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


class AdaptiveThreshold:
    """(ref: Threshold.cpp)"""

    def __init__(self, initial_threshold: float, min_motion_th: float,
                 max_range: float):
        self._min_motion = min_motion_th
        self._max_range = max_range
        self._model_sse = initial_threshold * initial_threshold
        self._num_samples = 1

    def compute_threshold(self) -> float:
        with profiling.span("slam.threshold"):
            return float(np.sqrt(self._model_sse / self._num_samples))

    def update_model_deviation(self, deviation: np.ndarray) -> None:
        R = deviation[:3, :3]
        theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
        delta_rot = 2.0 * self._max_range * np.sin(theta / 2.0)
        delta_trans = np.linalg.norm(deviation[:3, 3])
        model_error = delta_trans + delta_rot
        if model_error > self._min_motion:
            self._model_sse += model_error * model_error
            self._num_samples += 1


# the 27 adjacent-voxel shifts scanned by GetClosestNeighbor
# (ref: VoxelHashMap.cpp voxel_shifts)
_SHIFTS_27 = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)], dtype=np.int64)

# one shared packing with the downsample grid (21 bits/signed axis)
from ..ops.downsample import pack_voxel_coords as _enc_vox  # noqa: E402


def _born_groups(keys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Of points given by their packed voxel keys (P,): the voxels' keys in
    the order of their first point (V,), each point's voxel in that order
    (P,) and each voxel's point count (V,)."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1)
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    born = np.argsort(first, kind="stable")
    rank = np.empty_like(born)
    rank[born] = np.arange(len(born))
    row = rank[inverse.reshape(-1)]
    return uniq[born], row, np.bincount(row, minlength=len(born))


class VoxelHashMap:
    """Local map: voxel hash of up-to-N points per cell with
    min-distance admission, adjacent-voxel nearest neighbors, pruned by
    distance from the origin (ref: VoxelHashMap.{hpp,cpp}). The robin_map
    becomes a python dict keyed by packed voxel coords; the NN scan is
    vectorized over all queries with a sorted-key searchsorted."""

    def __init__(self, voxel_size: float, max_distance: float,
                 max_points_per_voxel: int):
        self.voxel_size = voxel_size
        self.max_distance = max_distance
        self.max_points_per_voxel = max_points_per_voxel
        # AddPoints' admission radius (ref: VoxelHashMap.cpp
        # map_resolution = sqrt(voxel_size^2 / max_points_per_voxel))
        self._map_resolution2 = voxel_size * voxel_size \
            / max_points_per_voxel
        self._init_storage()

    def _init_storage(self) -> None:
        self._voxels: Dict[int, np.ndarray] = {}  # enc key -> (k, 3)
        self._arrays: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def clear(self) -> None:
        self._voxels.clear()
        self._arrays = None

    def empty(self) -> bool:
        return not self._voxels

    def pointcloud(self) -> np.ndarray:
        if not self._voxels:
            return np.zeros((0, 3))
        return np.concatenate(list(self._voxels.values()), axis=0)

    def load(self, keys: np.ndarray, points: np.ndarray) -> None:
        """Replace the map by the points (P, 3) with each point's packed
        voxel key (P,) int64: voxels in the order of their first point,
        points in their order within a voxel."""
        vkeys, row, counts = _born_groups(keys)
        order = np.argsort(row, kind="stable")
        self.clear()
        for key, pts in zip(vkeys.tolist(), np.split(
                np.asarray(points, np.float64)[order],
                np.cumsum(counts)[:-1])):
            self._voxels[key] = pts

    def add_points(self, points: np.ndarray) -> None:
        """(ref: VoxelHashMap::AddPoints): per point, in order — skip if
        the cell is full or any point already in the cell (including ones
        admitted earlier in this call) lies within map_resolution. Voxels
        keep the order they were first admitted in: a new voxel with more
        than one candidate before a new voxel with one, each in key
        order."""
        if points.size == 0:
            return
        self._add(points)

    def remove_far_points(self, origin: np.ndarray) -> None:
        """(ref: VoxelHashMap::RemovePointsFarFromLocation): a cell dies
        when its FIRST point is >= max_distance from the origin."""
        self._remove_far(origin)

    def _add(self, points: np.ndarray) -> None:
        cap = self.max_points_per_voxel
        res2 = self._map_resolution2
        keys = _enc_vox(np.floor(points / self.voxel_size).astype(np.int64))
        order = np.argsort(keys, kind="stable")  # groups keep scan order
        keys_s, pts_s = keys[order], points[order]
        starts = np.flatnonzero(
            np.concatenate([[True], np.diff(keys_s) != 0]))
        ends = np.concatenate([starts[1:], [keys_s.shape[0]]])
        pts_s = np.ascontiguousarray(pts_s, dtype=np.float64)
        voxels = self._voxels
        get = voxels.get
        pending = []  # (key, row): fresh voxel, single candidate
        for s, e in zip(starts, ends):
            key = int(keys_s[s])
            cur = get(key)
            if cur is None and e - s == 1:
                # dominant case (a fresh voxel, one candidate): the
                # admission rules are vacuous — defer to a bulk copy
                pending.append((key, s))
                continue
            if cur is not None and cur.shape[0] >= cap:
                continue
            if cur is None:
                cur = pts_s[s:s]  # empty (0, 3)
            for p in pts_s[s:e]:
                if cur.shape[0] >= cap:
                    break
                if cur.shape[0] and (
                        np.einsum("nc,nc->n", cur - p, cur - p)
                        < res2).any():
                    continue
                cur = np.concatenate([cur, p[None]], axis=0)
            voxels[key] = cur
        if pending:
            # one compact copy; the stored views keep only THIS block
            # alive, not the whole call's point array
            rows = np.fromiter((s for _, s in pending), np.int64,
                               len(pending))
            block = pts_s[rows]
            for r, (key, _) in enumerate(pending):
                voxels[key] = block[r:r + 1]
        self._arrays = None

    def _remove_far(self, origin: np.ndarray) -> None:
        md2 = self.max_distance * self.max_distance
        dead = [k for k, pts in self._voxels.items()
                if np.sum((pts[0] - origin) ** 2) >= md2]
        for k in dead:
            del self._voxels[k]
        self._arrays = None

    def update(self, points: np.ndarray, pose: np.ndarray) -> None:
        """(ref: VoxelHashMap::Update): transform to world, add, prune."""
        with profiling.span("map.add_points"):
            world = points @ pose[:3, :3].T + pose[:3, 3]
            self.add_points(world)
        with profiling.span("map.remove_far"):
            self.remove_far_points(pose[:3, 3])

    def _ensure_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sorted packed keys + (V, cap, 3) point array padded with +inf
        (pads fall out of every min-distance naturally)."""
        if self._arrays is None and self._voxels:
            keys = np.fromiter(self._voxels.keys(), dtype=np.int64,
                               count=len(self._voxels))
            order = np.argsort(keys)
            keys = keys[order]
            vals = list(self._voxels.values())
            pts = np.full((len(keys), self.max_points_per_voxel, 3),
                          np.inf, dtype=np.float64)
            for r, src_i in enumerate(order):
                v = vals[src_i]
                pts[r, :v.shape[0]] = v
            self._arrays = (keys, pts)
        return self._arrays

    def closest_neighbors(self, points: np.ndarray, max_dist: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized GetClosestNeighbor over all queries: nearest point
        within the 27-voxel neighborhood, accepted when its distance is
        STRICTLY below max_dist (ref: Registration.cpp DataAssociation
        `distance < max_correspondance_distance`)."""
        arrays = self._ensure_arrays()
        if arrays is None:
            return np.zeros(len(points), bool), np.zeros_like(points)
        keys_sorted, pts = arrays
        n = len(points)
        qv = np.floor(points / self.voxel_size).astype(np.int64)
        enc = _enc_vox(qv[:, None, :] + _SHIFTS_27[None, :, :])  # (N, 27)
        pos = np.searchsorted(keys_sorted, enc)
        pos_c = np.minimum(pos, len(keys_sorted) - 1)
        found = keys_sorted[pos_c] == enc
        # sparse gather: only EXISTING neighbor voxels contribute (the
        # dense (N, 27, cap, 3) block moved ~100 MB per call)
        qidx, _ = np.nonzero(found)                    # (K,)
        cand = pts[pos_c[found]]                       # (K, cap, 3)
        diff = cand - points[qidx, None, :]
        d2 = np.einsum("kvc,kvc->kv", diff, diff)      # (K, cap)
        flat = np.argmin(d2, axis=1)
        kmin = d2[np.arange(d2.shape[0]), flat]        # (K,)
        dmin2 = np.full(n, np.inf)
        np.fmin.at(dmin2, qidx, kmin)
        # recover the winning point: first K whose min equals the query
        # minimum (exact-tie choice is unspecified in the reference too)
        win = kmin == dmin2[qidx]
        tgt = np.zeros_like(points)
        # reversed so the FIRST winner per query lands last
        tgt[qidx[win][::-1]] = cand[np.arange(len(qidx))[win],
                                    flat[win]][::-1]
        mask = dmin2 < max_dist * max_dist
        tgt = np.where(mask[:, None], tgt, 0.0)
        return mask, tgt


def register_points_to_map(
    points: np.ndarray, voxel_map: VoxelHashMap, initial_guess: np.ndarray,
    max_correspondence_distance: float, kernel_scale: float,
    max_iterations: int = 500, convergence: float = 1e-4,
) -> np.ndarray:
    """Robust point-to-point GN ICP (ref: Registration.cpp
    AlignPointsToMap)."""
    if voxel_map.empty():
        return initial_guess.copy()

    src = points @ initial_guess[:3, :3].T + initial_guess[:3, 3]
    T_icp = np.eye(4)

    for _ in range(max_iterations):
        mask, tgt = voxel_map.closest_neighbors(
            src, max_correspondence_distance)
        if mask.sum() < 6:
            break
        s = src[mask]
        t = tgt[mask]
        residual = s - t  # (N, 3)
        r2 = np.einsum("nc,nc->n", residual, residual)
        w = (kernel_scale ** 2) / (kernel_scale + r2) ** 2  # GM kernel

        # J_r = [I | -hat(s)]; accumulate JTJ (6,6) and JTr (6,)
        JTJ = np.zeros((6, 6))
        JTr = np.zeros(6)
        # J_r^T r with J_r = [I | -hat(s)]: bottom block is
        # (-hat(s))^T r = hat(s) r = s x r
        wsum = w[:, None] * residual
        JTr[:3] = wsum.sum(axis=0)
        JTr[3:] = np.cross(s, wsum).sum(axis=0)

        W = w.sum()
        hs = _hat_batch(s)
        JTJ[:3, :3] = np.eye(3) * W
        Sx = -np.einsum("n,nij->ij", w, hs)
        JTJ[:3, 3:] = Sx
        JTJ[3:, :3] = Sx.T
        JTJ[3:, 3:] = np.einsum("n,nij,nik->jk", w, hs, hs)

        try:
            dx = np.linalg.solve(JTJ, -JTr)
        except np.linalg.LinAlgError:
            break
        dT = se3_exp(dx)
        src = src @ dT[:3, :3].T + dT[:3, 3]
        T_icp = dT @ T_icp
        if np.linalg.norm(dx) < convergence:
            break

    return T_icp @ initial_guess


def _hat_batch(v: np.ndarray) -> np.ndarray:
    n = v.shape[0]
    out = np.zeros((n, 3, 3))
    out[:, 0, 1] = -v[:, 2]
    out[:, 0, 2] = v[:, 1]
    out[:, 1, 0] = v[:, 2]
    out[:, 1, 2] = -v[:, 0]
    out[:, 2, 0] = -v[:, 1]
    out[:, 2, 1] = v[:, 0]
    return out


class KissICP:
    """(ref: ouster_mapping/src/kiss_icp.cpp:10-62)"""

    def __init__(self, config: Optional[KissConfig] = None):
        self.config = config or KissConfig()
        c = self.config
        self.adaptive_threshold = AdaptiveThreshold(
            c.initial_threshold, c.min_motion_th, c.max_range)
        self.local_map = VoxelHashMap(c.voxel_size, c.max_range,
                                      c.max_points_per_voxel)
        self._frame_count = 0

    def preprocess(self, frame: np.ndarray) -> np.ndarray:
        """Range crop (ref: kiss-icp Preprocessing.cpp)."""
        with profiling.span("slam.preprocess"):
            d = np.linalg.norm(frame, axis=1)
            keep = (d > self.config.min_range) & (d < self.config.max_range)
            return frame[keep]

    def voxelize(self, frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ref: kiss_icp.cpp:50-57): map update at 0.5*voxel, registration
        source at 1.5*voxel; first-point-per-voxel like the reference's
        VoxelDownsample (VoxelUtils.cpp)."""
        with profiling.span("slam.voxelize"):
            frame_downsample = voxel_downsample_first(
                frame, self.config.voxel_size * 0.5)
            source = voxel_downsample_first(frame_downsample,
                                            self.config.voxel_size * 1.5)
            return source, frame_downsample

    def register_frame(self, frame: np.ndarray, initial_guess: np.ndarray,
                       update_map: bool = True) -> np.ndarray:
        """(ref: kiss_icp.cpp:19-48)"""
        source, frame_downsample = self.voxelize(frame)
        sigma = self.adaptive_threshold.compute_threshold()

        new_pose = register_points_to_map(
            source, self.local_map, initial_guess,
            max_correspondence_distance=3.0 * sigma,
            kernel_scale=sigma / 3.0,
            max_iterations=self.config.max_num_iterations,
            convergence=self.config.convergence_criterion)

        deviation = np.linalg.solve(initial_guess, new_pose)
        self.adaptive_threshold.update_model_deviation(deviation)

        if update_map:
            # clear the map on the first frames to drop badly deskewed data
            # (ref: kiss_icp.cpp:39-43)
            if self._frame_count <= 2:
                self.local_map.clear()
            self._frame_count += 1
            self.local_map.update(frame_downsample, new_pose)

        return new_pose
