"""ICP registration with its loop on the device.

The reference registers scans with a host voxel-hash ICP
(ref: ouster_mapping thirdparty kiss-icp Registration.cpp). Here the
Gauss-Newton loop runs on the device. An iteration (`_gn_step`) is the
nearest-neighbour search (kernels/icp_nn.py, hand-written CUDA kernels on
the card: the map's voxel index built once a registration, one search an
iteration), the Geman-McClure-weighted normal equations, the 6 x 6 solve,
the SE(3) update, about 128 small launches on buffers it updates in place.
On the card it is captured once a registration as a CUDA graph and
replayed, one launch an iteration, until the stop flag is set; on the CPU
it runs eagerly. The host reads one stop flag an iteration. It is the
counterpart of the JAX package's slam/jax_icp.py, which runs the same loop
as one device program (`lax.while_loop`).

- The graph replays the kernels the eager step launches, in the same
  order, on the same buffers: the pose is the eager loop's, bit for bit.
  Shapes change every registration (the map grows), so the capture is
  once a registration; a thread's captures share one memory pool.
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
- The local map lives on the device too (slam/device_map.DeviceVoxelMap:
  KISS-ICP's admission rule in a hand-written kernel, distance pruning as
  a mask, in float64). The ICP takes its storage as it is: every slot of
  the held voxels cast to float32, with a mask of the slots that hold a
  point; nothing is copied to the device a frame but the source points
  and the initial guess.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.icp_nn import IcpIndex, build_icp_index, icp_nn
from ..ops.fused import resolve_device
from ..ops.pose import _hat
from ..utils import profiling
from .device_map import DeviceVoxelMap
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


class _Fixed(NamedTuple):
    """What a registration's Gauss-Newton iterations read and never
    write: the map's index and points, the source's mask, the constants
    (on the device) and the stop rule's threshold."""

    index: IcpIndex
    map_pts: torch.Tensor
    src_valid: Optional[torch.Tensor]
    mcd2: torch.Tensor
    ks: torch.Tensor
    ks2: torch.Tensor
    zero: torch.Tensor
    tikhonov: torch.Tensor
    convergence: float


def _setup(src: torch.Tensor, src_valid: Optional[torch.Tensor],
           map_pts: torch.Tensor, map_valid: Optional[torch.Tensor],
           init_pose: torch.Tensor, max_corr_dist: float,
           kernel_scale: float, voxel_size: float, convergence: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, _Fixed]:
    """A registration's buffers before its first iteration (`cur`, `T_icp`,
    `stop`) and what its iterations read (the map's index built here), for
    _gn_step; init_pose (4, 4) f32 on src's device."""
    device = src.device
    map_pts = map_pts.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=device)
    # constants filled on the device: a copy from the host would wait
    mcd = torch.full((), max_corr_dist, **f32)
    ks = torch.full((), kernel_scale, **f32)
    cur = _transform(init_pose, src.to(torch.float32))
    T_icp = torch.eye(4, **f32)
    stop = torch.zeros((), dtype=torch.bool, device=device)
    # the map stays fixed through the loop: one index serves every search
    with profiling.span("icp.index_build"):
        index = build_icp_index(map_pts, map_valid, voxel_size)
    return cur, T_icp, stop, _Fixed(
        index, map_pts, src_valid, mcd * mcd, ks, ks * ks,
        torch.zeros((), **f32),
        1e-6 * torch.eye(6, dtype=torch.float64, device=device), convergence)


def _gn_step(cur: torch.Tensor, T_icp: torch.Tensor, stop: torch.Tensor,
             fx: _Fixed) -> None:
    """One Gauss-Newton iteration on the registration's buffers, updated
    in place: the source points as moved so far `cur` (N, 3) f32, the
    increments so far `T_icp` (4, 4) f32 and `stop` (a bool). It reads
    the host nothing and waits on nothing, so a CUDA graph can hold it."""
    best_d2, best_idx = icp_nn(cur, index=fx.index)
    # strict <, like DataAssociation's `distance < max_correspondance_distance`
    corr = best_d2 < fx.mcd2
    if fx.src_valid is not None:
        corr &= fx.src_valid
    r = cur - fx.map_pts[best_idx]
    r2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
    den = fx.ks + r2
    w = torch.where(corr, fx.ks2 / (den * den), fx.zero)
    sums = _normal_terms(cur, r, w, corr)
    JTJ = _jtj(sums, fx.zero).to(torch.float64)
    # the Tikhonov floor keeps the solve finite when correspondences
    # collapse; a converged/degenerate step then yields dx ~ 0
    dx = torch.linalg.solve_ex(JTJ + fx.tikhonov,
                               -sums[:6].to(torch.float64)).result \
        .to(torch.float32)
    dT = _se3_exp_kiss(dx)
    enough = sums[16] >= 6
    cur.copy_(torch.where(enough, _transform(dT, cur), cur))
    T_icp.copy_(torch.where(enough, _mm(dT, T_icp), T_icp))
    stop.copy_((torch.linalg.vector_norm(dx) < fx.convergence) | ~enough)


class _Capture(threading.local):
    """A thread's capture state for each CUDA device: the side stream its
    captures run on, the memory pool their graphs share, and the last
    graph captured. The allocator lets a capture share a pool only while a
    live graph holds it, so a graph stays until the next capture replaces
    it (a registration's buffers are gone by then; it is never replayed
    again)."""

    def __init__(self):
        self.by_device: dict = {}


_CAPTURE = _Capture()


def _capture(cur: torch.Tensor, T_icp: torch.Tensor, stop: torch.Tensor,
             fx: _Fixed) -> torch.cuda.CUDAGraph:
    """_gn_step on these buffers captured once as a CUDA graph on their
    device, in the thread's pool, on its side stream; replay it on any
    stream. The thread's first capture on a device first runs one step
    eagerly on copies of the buffers, on the side stream, so that lazily
    made library state (the solver's handle and workspace, the search
    kernel's module) exists before a capture. Not torch.cuda.graph: its
    entry synchronizes the device, may collect garbage and empties the
    allocator's cache, every capture."""
    with torch.cuda.device(cur.device):
        device = torch.cuda.current_device()
        state = _CAPTURE.by_device.get(device)
        current = torch.cuda.current_stream(device)
        if state is None:
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                _gn_step(cur.clone(), T_icp.clone(), stop.clone(), fx)
            current.wait_stream(side)
            state = _CAPTURE.by_device[device] = [
                side, torch.cuda.graph_pool_handle(), None]
        side, pool, _ = state
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # thread_local: another thread's CUDA calls (a scan source's
            # staging thread) cannot invalidate the capture
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                _gn_step(cur, T_icp, stop, fx)
            finally:
                graph.capture_end()
        state[2] = graph
    return graph


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
    iteration (counted in the tracer's `icp.host_syncs`, the iterations in
    `icp.gn_iterations`). On CUDA the iteration is captured once as a CUDA
    graph (`icp.graph_captures`, span `icp.graph_capture`) and replayed
    (`icp.graph_replays`); on the CPU it runs eagerly."""
    device = src.device
    init_pose = init_pose.to(device, torch.float32)
    cur, T_icp, stop, fx = _setup(src, src_valid, map_pts, map_valid,
                                  init_pose, max_corr_dist, kernel_scale,
                                  voxel_size, convergence)
    it = 0
    with profiling.span("icp.gn_loop"):
        graph = None
        if device.type == "cuda" and max_iters > 0:
            with profiling.span("icp.graph_capture"):
                graph = _capture(cur, T_icp, stop, fx)
            profiling.count("icp.graph_captures")
        while it < max_iters:
            if graph is None:
                _gn_step(cur, T_icp, stop, fx)
            else:
                graph.replay()
                profiling.count("icp.graph_replays")
            it += 1
            profiling.count("icp.gn_iterations")
            profiling.count("icp.host_syncs")       # bool(stop) waits
            if bool(stop):
                break
    if stats is not None:
        stats["iterations"] = it
    return _mm(T_icp, init_pose)


class DeviceICP(KissICP):
    """KissICP with the registration loop and the local map on the
    device: identical preprocessing, voxelization and adaptive threshold;
    `register_points_to_map` replaced by register_points_device, the
    VoxelHashMap by a DeviceVoxelMap (the same map, bit for bit). Runs on
    `device`: CUDA when none is named (raises without a GPU). `last_frame`
    holds the last registration's N, M (the map's points) and
    iterations."""

    def __init__(self, config: Optional[KissConfig] = None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        c = self.config
        self.local_map = DeviceVoxelMap(c.voxel_size, c.max_range,
                                        c.max_points_per_voxel, self.device)
        self.last_frame: dict = {}

    def register_frame(self, frame: np.ndarray,
                       initial_guess: np.ndarray,
                       update_map: bool = True) -> np.ndarray:
        source, frame_downsample = self.voxelize(frame)
        sigma = self.adaptive_threshold.compute_threshold()

        if self.local_map.empty() or source.shape[0] < 6:
            new_pose = initial_guess.copy()
            self.last_frame = dict(n=source.shape[0], m=0, iterations=0)
        else:
            dev = self.device
            # the map is on the card already: a cast, no wait
            with profiling.span("icp.map_upload"):
                map_t, map_valid = self.local_map.device_points()
            # each pageable copy in, and the pose's read back, waits on
            # the card: a host sync each
            stats: dict = {}
            profiling.count("icp.host_syncs", 2)    # source, initial guess
            pose = register_points_device(
                torch.from_numpy(source.astype(np.float32)).to(dev), None,
                map_t, map_valid,
                torch.from_numpy(initial_guess.astype(np.float32)).to(dev),
                float(np.float32(3.0 * sigma)),
                float(np.float32(sigma / 3.0)),
                voxel_size=self.config.voxel_size,
                max_iters=self.config.max_num_iterations,
                convergence=self.config.convergence_criterion, stats=stats)
            new_pose = pose.cpu().numpy().astype(np.float64)
            profiling.count("icp.host_syncs")
            self.last_frame = dict(n=source.shape[0],
                                   m=self.local_map.num_points,
                                   iterations=stats["iterations"])
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
