"""ICP registration with its loop on the device.

The reference registers scans with a host voxel-hash ICP
(ref: ouster_mapping thirdparty kiss-icp Registration.cpp). Here the
Gauss-Newton loop runs on the device, one iteration after another from
Python: the nearest-neighbour search (kernels/icp_nn.py, hand-written CUDA
kernels on the card: the map's voxel index built once a registration, one
search an iteration), the Geman-McClure-weighted normal equations, the
6 x 6 solve, the SE(3) update; the host reads one stop flag an iteration.
It is the counterpart of the JAX package's slam/jax_icp.py, which runs the
same loop as one device program (`lax.while_loop`).

- The nearest neighbour is restricted to the query's 27-voxel
  neighbourhood of the map's voxel size, the host VoxelHashMap's
  GetClosestNeighbor semantics; the distances never leave the kernel's
  registers.
- Shapes follow the data: no padding to buckets (JAX idiom for static
  shapes); `src_valid` and `map_valid` still mask rows where a caller
  passes padded arrays.
- No matrix product: the normal equations, the transforms and the 4 x 4
  products are elementwise products and sums, so a caller's
  `torch.backends.cuda.matmul.allow_tf32 = True` cannot turn them into
  TF32. The 6 x 6 solve runs in float64 (`torch.linalg.solve_ex`, no
  error-check sync); JAX's runs in float32.
- Map maintenance (voxel capping, distance pruning) stays on the host in
  VoxelHashMap; its point cloud is copied to the device each frame
  (up to ~6 MB f32).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..kernels.icp_nn import build_icp_index, icp_nn
from ..ops.pose import _device_of, _hat
from .kiss_icp import KissConfig, KissICP


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small matrices, as products and a sum (no matmul)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p @ T[:3, :3].T + T[:3, 3] for points p (N, 3), without a matmul."""
    R, t = T[:3, :3], T[:3, 3]
    return (p[:, None, :] * R[None]).sum(dim=-1) + t


def _se3_exp_kiss(dx: torch.Tensor) -> torch.Tensor:
    """(rho, theta) -> 4x4, translation-first layout like kiss-icp (the
    JAX package's _se3_exp_kiss; kiss_icp.se3_exp on the device)."""
    rho, theta = dx[:3], dx[3:]
    angle = torch.linalg.vector_norm(theta)
    K = _hat(theta)
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    small = angle < 1e-10
    a2 = torch.where(small, one, angle * angle)
    s, c = torch.sin(angle), torch.cos(angle)
    A = torch.where(small, one, s / angle)
    B = torch.where(small, 0.5 * one, (1.0 - c) / a2)
    C = torch.where(small, one / 6.0, (angle - s) / (a2 * angle))
    K2 = _mm(K, K)
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    T = torch.eye(4, dtype=dx.dtype, device=dx.device)
    T[:3, :3] = R
    T[:3, 3] = (V * rho[None, :]).sum(dim=1)
    return T


def _normal_terms(cur: torch.Tensor, r: torch.Tensor,
                  w: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """The per-point terms of JTr and JTJ for J = [I | -hat(s)], summed in
    one reduction: w r (3), s x (w r) (3), w (1), w s (3), the six
    entries of w (|s|^2 I - s s^T) (xx, yy, zz, xy, xz, yz), and the
    correspondence count (1)."""
    s0, s1, s2 = cur[:, 0], cur[:, 1], cur[:, 2]
    wr = w[:, None] * r
    a, b, c = wr[:, 0], wr[:, 1], wr[:, 2]
    ss = (s0 * s0 + s1 * s1) + s2 * s2
    terms = torch.stack([
        a, b, c,
        s1 * c - s2 * b, s2 * a - s0 * c, s0 * b - s1 * a,
        w, w * s0, w * s1, w * s2,
        w * (ss - s0 * s0), w * (ss - s1 * s1), w * (ss - s2 * s2),
        -w * (s0 * s1), -w * (s0 * s2), -w * (s1 * s2),
        corr.to(w.dtype)], dim=1)
    return terms.sum(dim=0)


def _jtj(sums: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """JTJ (6 x 6) from the sums of _normal_terms, in one stack:
    JTJ[:3, :3] = W I, JTJ[:3, 3:] = -hat(ws), JTJ[3:, :3] = hat(ws),
    JTJ[3:, 3:] = sum w (|s|^2 I - s s^T) = [[b0, b3, b4], [b3, b1, b5],
    [b4, b5, b2]], with W = sums[6], ws = sums[7:10], b = sums[10:16]."""
    W, z = sums[6], zero
    x, y, w = sums[7:10]
    nx, ny, nw = -sums[7:10]
    b = sums[10:16]
    return torch.stack([W, z, z, z, w, ny,
                        z, W, z, nw, z, x,
                        z, z, W, y, nx, z,
                        z, nw, y, b[0], b[3], b[4],
                        w, z, nx, b[3], b[1], b[5],
                        ny, x, z, b[4], b[5], b[2]]).view(6, 6)


def register_points_device(src: torch.Tensor,
                           src_valid: Optional[torch.Tensor],
                           map_pts: torch.Tensor,
                           map_valid: Optional[torch.Tensor],
                           init_pose: torch.Tensor,
                           max_corr_dist: float, kernel_scale: float,
                           voxel_size: float, max_iters: int = 100,
                           convergence: float = 1e-4,
                           stats: Optional[dict] = None) -> torch.Tensor:
    """Robust Gauss-Newton ICP of src (N, 3) against map_pts (M, 3) on
    their device (ref semantics: Registration.cpp AlignPointsToMap; GM
    kernel, J = [I | -hat(s)], left-multiplied increments); the nearest
    neighbour is limited to the 27-voxel neighbourhood of `voxel_size`
    (VoxelHashMap::GetClosestNeighbor). Stops when |dx| < convergence after
    the increment is applied, when fewer than 6 correspondences remain, or
    after max_iters. Returns the (4, 4) float32 pose. `stats`, where given,
    receives the iterations run; the host reads one stop flag an
    iteration."""
    device = src.device
    src = src.to(torch.float32)
    init_pose = init_pose.to(device, torch.float32)
    map_pts = map_pts.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=device)
    # constants filled on the device: a copy from the host would wait
    mcd = torch.full((), max_corr_dist, **f32)
    mcd2 = mcd * mcd
    ks = torch.full((), kernel_scale, **f32)
    ks2 = ks * ks
    zero = torch.zeros((), **f32)
    tikhonov = 1e-6 * torch.eye(6, dtype=torch.float64, device=device)

    cur = _transform(init_pose, src)
    T_icp = torch.eye(4, **f32)
    # the map stays fixed through the loop: one index serves every search
    index = build_icp_index(map_pts, map_valid, voxel_size)
    it = 0
    while it < max_iters:
        best_d2, best_idx = icp_nn(cur, index=index)
        # strict <, like DataAssociation's
        # `distance < max_correspondance_distance`
        corr = best_d2 < mcd2
        if src_valid is not None:
            corr &= src_valid
        r = cur - map_pts[best_idx]
        r2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
        den = ks + r2
        w = torch.where(corr, ks2 / (den * den), zero)
        sums = _normal_terms(cur, r, w, corr)
        JTJ = _jtj(sums, zero).to(torch.float64)
        # the Tikhonov floor keeps the solve finite when correspondences
        # collapse; a converged/degenerate step then yields dx ~ 0
        dx = torch.linalg.solve_ex(JTJ + tikhonov,
                                   -sums[:6].to(torch.float64)).result \
            .to(torch.float32)
        dT = _se3_exp_kiss(dx)
        enough = sums[16] >= 6
        cur = torch.where(enough, _transform(dT, cur), cur)
        T_icp = torch.where(enough, _mm(dT, T_icp), T_icp)
        stop = (torch.linalg.vector_norm(dx) < convergence) | ~enough
        it += 1
        if bool(stop):
            break
    if stats is not None:
        stats["iterations"] = it
    return _mm(T_icp, init_pose)


class DeviceICP(KissICP):
    """KissICP with the registration loop on the device: identical
    preprocessing, voxelization, adaptive threshold and host-side map
    maintenance; `register_points_to_map` replaced by
    register_points_device. Runs on `device`: CUDA when none is named
    (raises without a GPU). `last_frame` holds the last registration's
    N, M, iterations and the map copy's seconds."""

    def __init__(self, config: Optional[KissConfig] = None, device=None):
        super().__init__(config)
        self.device = _device_of(device)
        self.last_frame: dict = {}

    def register_frame(self, frame: np.ndarray,
                       initial_guess: np.ndarray,
                       update_map: bool = True) -> np.ndarray:
        source, frame_downsample = self.voxelize(frame)
        sigma = self.adaptive_threshold.compute_threshold()

        if self.local_map.empty() or source.shape[0] < 6:
            new_pose = initial_guess.copy()
            self.last_frame = dict(n=source.shape[0], m=0, iterations=0,
                                   upload_s=0.0)
        else:
            dev = self.device
            t0 = time.perf_counter()
            map_np = self.local_map.pointcloud().astype(np.float32)
            map_t = torch.from_numpy(map_np).to(dev)
            upload_s = time.perf_counter() - t0
            stats: dict = {}
            pose = register_points_device(
                torch.from_numpy(source.astype(np.float32)).to(dev), None,
                map_t, None,
                torch.from_numpy(initial_guess.astype(np.float32)).to(dev),
                float(np.float32(3.0 * sigma)),
                float(np.float32(sigma / 3.0)),
                voxel_size=self.config.voxel_size,
                max_iters=self.config.max_num_iterations,
                convergence=self.config.convergence_criterion, stats=stats)
            new_pose = pose.cpu().numpy().astype(np.float64)
            self.last_frame = dict(n=source.shape[0], m=map_np.shape[0],
                                   iterations=stats["iterations"],
                                   upload_s=upload_s)
            # re-orthonormalize: ~20 f32 GN steps leave the rotation a
            # hair off SO(3), which would accumulate over a trajectory
            u, _, vt = np.linalg.svd(new_pose[:3, :3])
            new_pose[:3, :3] = u @ vt

        deviation = np.linalg.solve(initial_guess, new_pose)
        self.adaptive_threshold.update_model_deviation(deviation)

        if update_map:
            if self._frame_count <= 2:
                self.local_map.clear()
            self._frame_count += 1
            self.local_map.update(frame_downsample, new_pose)

        return new_pose
