"""SE(3) pose utilities: dewarp, transform, log/exp, interpolation.

Rebuild of the reference pose machinery (ref: ouster_client/include/ouster/
pose_util.h:44-262, impl/transformation.h). The reference runs OpenMP loops
over columns; here everything is batched tensor algebra, with numpy
mirrors for host use.

Conventions match the reference: poses are 4x4 row-major homogeneous
matrices; `dewarp` applies pose[w] to point (i, w) of an (..., W, 3) cloud.
Tensor functions compute on the device and in the dtype of their inputs.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .precision import fma_f32

Array = Union[np.ndarray, torch.Tensor]


# ---------------------------------------------------------------------------
# numpy host mirrors
# ---------------------------------------------------------------------------

def dewarp_np(points: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """points: (H, W, 3) or (N=H*W, 3); poses: (W, 4, 4) or (W, 16).
    Applies poses[w] to points[..., w, :]
    (ref: pose_util.h:44-67)."""
    poses = poses.reshape(-1, 4, 4)
    w = poses.shape[0]
    shaped = points.reshape(-1, w, 3)
    rot = poses[:, :3, :3]          # (W, 3, 3)
    trans = poses[:, :3, 3]         # (W, 3)
    out = np.einsum("wij,hwj->hwi", rot, shaped) + trans[None]
    return out.reshape(points.shape)


def transform_np(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Single-pose transform (ref: pose_util.h:127-139)."""
    pose = pose.reshape(4, 4)
    return points @ pose[:3, :3].T + pose[:3, 3]


# ---------------------------------------------------------------------------
# tensor path
# ---------------------------------------------------------------------------

def rotate_translate(rot: torch.Tensor, trans: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """out[..., i] = sum_j rot[..., i, j] * points[..., j] + trans[..., i],
    with rot (..., 3, 3) and trans (..., 3) broadcasting against points
    (..., 3).

    The rounding order is the one the reference's compiled
    `einsum(...) + trans` takes: the first product is rounded, the next
    two terms are fused multiply-adds, and the translation is added last
    with its own rounding:
        p = R_i0 * x_0; p = fma(R_i1, x_1, p); p = fma(R_i2, x_2, p);
        out_i = p + t_i
    float32 inputs take a correctly rounded fma emulated in float64
    (precision.fma_f32) on every device, the GPU included, so that CPU and
    GPU results carry the same bits; other dtypes take plain multiplies
    and adds. This is not the order of the planar projection's fused
    dewarp, which starts its accumulator from t_i
    (ops/planar_kernels._dewarp_tile).
    """
    fma = fma_f32 if points.dtype == torch.float32 else \
        (lambda a, b, c: a * b + c)
    rows = []
    for i in range(3):
        p = rot[..., i, 0] * points[..., 0]
        p = fma(rot[..., i, 1], points[..., 1], p)
        p = fma(rot[..., i, 2], points[..., 2], p)
        rows.append(p + trans[..., i])
    return torch.stack(rows, dim=-1)


def dewarp(points: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Device dewarp: points (..., W, 3) x poses (W, 4, 4) -> (..., W, 3),
    in the rounding order of rotate_translate."""
    poses = poses.reshape(-1, 4, 4).to(points.dtype)
    return rotate_translate(poses[:, :3, :3], poses[:, :3, 3], points)


def transform(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    pose = pose.reshape(4, 4).to(points.dtype)
    return points @ pose[:3, :3].T + pose[:3, 3]


# ---------------------------------------------------------------------------
# SO(3)/SE(3) log & exp (ref: impl/transformation.h PoseH/PoseV)
# ---------------------------------------------------------------------------

def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the skew-symmetric (..., 3, 3) matrix of w."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _theta(w: torch.Tensor) -> torch.Tensor:
    """Rotation angle of w (..., 3) as (..., 1, 1)."""
    return torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]


def _ones_where(small: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with 1 where `small`: a divisor that keeps the unused branch of a
    `where` free of NaN and inf."""
    return torch.where(small, torch.ones_like(x), x)


def _sinc_terms(theta: torch.Tensor):
    """a = sin(t)/t and b = (1 - cos t)/t^2 with their small-angle
    series, plus t^2 and the small-angle mask."""
    t2 = theta * theta
    small = theta < 1e-5
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(theta) / _ones_where(small, theta))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / _ones_where(small, t2))
    return a, b, t2, small


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    K = _hat(w)
    a, b, _, _ = _sinc_terms(_theta(w))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3)."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    vee = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = theta < 1e-5
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.sin(_ones_where(small, theta))))
    return vee * scale[..., None]


def exp_pose(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3): xi = (..., 6) [rot(3), trans(3)] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = _so3_exp(w)
    theta = _theta(w)
    K = _hat(w)
    _, b, t2, small = _sinc_terms(theta)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))
                    / _ones_where(small, t2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b * K + c * (K @ K)
    t = torch.einsum("...ij,...j->...i", V, v)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0, 0, 0, 1], dtype=xi.dtype, device=xi.device) \
        .expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def log_pose(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3): (..., 4, 4) -> (..., 6) [rot, trans]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = _so3_log(R)
    K = _hat(w)
    # V^{-1} = I - K/2 + (1/t^2)(1 - a/(2b)) K^2
    a, b, t2, small = _sinc_terms(_theta(w))
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - a / (2.0 * b)) / _ones_where(small, t2))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - K / 2.0 + coef * (K @ K)
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def interp_pose(t: torch.Tensor, pose0: torch.Tensor,
                pose1: torch.Tensor) -> torch.Tensor:
    """Geodesic SE(3) interpolation: pose0 * exp(t * log(pose0^-1 pose1))
    (ref: pose_util.h:207-232); t broadcasts, so a (W,) vector of fractions
    yields (W, 4, 4) per-column poses in one shot."""
    xi = log_pose(torch.linalg.solve(pose0, pose1))
    t = torch.as_tensor(t, dtype=xi.dtype, device=xi.device)
    return pose0 @ exp_pose(t[..., None] * xi)


def _device_of(device, *arrays) -> torch.device:
    """The device an entry point that also takes numpy runs on: the one
    named, else that of the first tensor among `arrays`, else CUDA (raises
    without a GPU; the entry points never move to the CPU on their own)."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    from .fused import default_device

    return default_device()


def interp_pose_np(t, pose0: np.ndarray, pose1: np.ndarray,
                   device=None) -> np.ndarray:
    """interp_pose for host callers, numpy in and out, in the dtype of the
    poses. Computes on `device`: CUDA when none is named (raises without a
    GPU); pass device="cpu" to stay on the host."""
    device = _device_of(device)
    pose0 = torch.as_tensor(np.asarray(pose0)).to(device)
    pose1 = torch.as_tensor(np.asarray(pose1)).to(device)
    t = torch.as_tensor(np.asarray(t)).to(device)
    return interp_pose(t, pose0, pose1).cpu().numpy()


def interp_trajectory(query_ts: Array, knot_ts: Array, knot_poses: Array,
                      clamp: bool = False, device=None) -> torch.Tensor:
    """Piecewise-geodesic interpolation of a pose trajectory at query
    timestamps (ref: pose_util.h:262+). Out-of-range queries EXTRAPOLATE
    along the first/last interval like the reference; pass clamp=True to
    pin to the endpoints instead. Runs on `device`; when none is named, on
    the device of the first tensor among knot_poses, knot_ts, query_ts,
    and with numpy inputs alone on CUDA (raises without a GPU)."""
    # NOTE: pass timestamps relative to a frame-local epoch: f32 cannot
    # carry absolute nanosecond epochs.
    device = _device_of(device, knot_poses, knot_ts, query_ts)
    knot_poses = torch.as_tensor(knot_poses).to(device)
    query_ts = torch.as_tensor(query_ts).to(device, torch.float32)
    knot_ts = torch.as_tensor(knot_ts).to(device, torch.float32)
    n = knot_ts.shape[0]
    idx = torch.clamp(torch.searchsorted(knot_ts, query_ts, right=True) - 1,
                      0, n - 2)
    t0 = knot_ts[idx]
    t1 = knot_ts[idx + 1]
    frac = (query_ts - t0) / torch.where(t1 == t0, torch.ones_like(t0),
                                         t1 - t0)
    if clamp:
        frac = torch.clamp(frac, 0.0, 1.0)
    return interp_pose(frac, knot_poses[idx], knot_poses[idx + 1])
