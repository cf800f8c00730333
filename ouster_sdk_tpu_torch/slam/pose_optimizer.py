"""Offline pose-graph optimization over a trajectory.

Rebuild of the reference PoseOptimizer (ref: ouster_mapping/src/
pose_optimizer.cpp, pose_optimizer_node.h:17, pose_optimizer_constraint.h:
158-505). The reference solves with Ceres LM over quaternion+translation
nodes; here nodes are (rotvec, translation) 6-vectors and the sparse
nonlinear least-squares solve runs through scipy (TRF with analytic
sparsity), with residuals evaluated in vectorized numpy. Constraint types
and semantics match: AbsolutePose, PoseToPose, PointToPoint, AbsolutePoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import least_squares
from scipy.sparse import lil_matrix


def _rotvec_to_R(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return np.eye(3) + K
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _R_to_rotvec(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2
    if theta > np.pi - 1e-6:
        # near 180 deg the off-diagonal differences cancel; recover the
        # axis from the diagonal of (R + I) / 2 = axis axis^T
        axis = np.sqrt(np.maximum(np.diag((R + np.eye(3)) / 2.0), 0.0))
        # fix the signs from the off-diagonal sums
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], R[0, 1] + R[1, 0])
            axis[2] = np.copysign(axis[2], R[0, 2] + R[2, 0])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], R[1, 2] + R[2, 1])
        n = np.linalg.norm(axis)
        return theta * axis / (n if n > 0 else 1.0)
    return theta / (2 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _params_to_T(p: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rotvec_to_R(p[:3])
    T[:3, 3] = p[3:]
    return T


def _T_to_params(T: np.ndarray) -> np.ndarray:
    return np.concatenate([_R_to_rotvec(T[:3, :3]), T[:3, 3]])


@dataclass
class Node:
    """One trajectory knot (ref: pose_optimizer_node.h:17)."""

    ts: int
    pose: np.ndarray  # 4x4
    fixed: bool = False


@dataclass
class AbsolutePoseConstraint:
    """Anchor a node to a world pose (ref: pose_optimizer_constraint.h:241)."""

    ts: int
    target_pose: np.ndarray
    rotation_weight: float = 1.0
    translation_weight: float = 1.0


@dataclass
class PoseToPoseConstraint:
    """Relative transform between two nodes
    (ref: pose_optimizer_constraint.h:298)."""

    ts1: int
    ts2: int
    relative_pose: np.ndarray  # T such that T1 * rel ~= T2
    rotation_weight: float = 1.0
    translation_weight: float = 1.0


@dataclass
class PointToPointConstraint:
    """Pin a point seen at ts1 to a point seen at ts2
    (ref: pose_optimizer_constraint.h:357)."""

    ts1: int
    point1: np.ndarray  # local frame of node 1
    ts2: int
    point2: np.ndarray
    translation_weight: float = 1.0


@dataclass
class AbsolutePointConstraint:
    """Pin a locally-observed point to a world position
    (ref: pose_optimizer_constraint.h:439)."""

    ts: int
    point: np.ndarray
    target: np.ndarray
    translation_weight: float = 1.0


# reference LossFunction enum -> scipy least_squares loss (1:1 mapping)
# (ref: pose_optimizer.cpp:75-90 create_loss_function)
LOSS_FUNCTIONS = {
    "HUBER_LOSS": "huber",
    "CAUCHY_LOSS": "cauchy",
    "SOFT_L_ONE_LOSS": "soft_l1",
    "ARCTAN_LOSS": "arctan",
    "TRIVIAL_LOSS": "linear",
}


@dataclass
class SolverConfig:
    """(ref: pose_optimizer_constraint.h:505 — defaults match)"""

    key_frame_distance: float = 1.0
    traj_rotation_weight: float = 10.0
    traj_translation_weight: float = 10.0
    max_num_iterations: int = 500
    function_tolerance: float = 1e-18
    gradient_tolerance: float = 1e-20
    parameter_tolerance: float = 1e-18
    process_printout: bool = True
    fix_first_node: bool = False
    loss: str = "huber"  # scipy loss name, or a reference *_LOSS enum name
    loss_scale: float = 1.0

    def scipy_loss(self) -> str:
        return LOSS_FUNCTIONS.get(self.loss.upper(), self.loss)

    def scipy_loss_scale(self) -> float:
        """loss_scale translated to scipy's f_scale so the robust cost
        curve matches Ceres' exactly (verified in
        tests/test_pose_optimizer_verification.py):
          HuberLoss(a)    == loss='huber',   f_scale=a
          CauchyLoss(a)   == loss='cauchy',  f_scale=a
          SoftLOneLoss(a) == loss='soft_l1', f_scale=a
          ArctanLoss(a)   == loss='arctan',  f_scale=sqrt(a)
        (ceres ArctanLoss: rho(s)=a*atan(s/a); scipy arctan:
        fs^2*atan(s/fs^2) -> fs=sqrt(a);
        ref: pose_optimizer.cpp create_loss_function)."""
        if self.loss.upper() == "ARCTAN_LOSS":
            return float(np.sqrt(self.loss_scale))
        return float(self.loss_scale)


class PoseOptimizer:
    """Pose-graph refinement (ref: pose_optimizer.cpp)."""

    def __init__(self, nodes: Sequence[Node],
                 config: Optional[SolverConfig] = None):
        self.nodes = sorted(nodes, key=lambda n: n.ts)
        self.config = config or SolverConfig()
        self._ts_index = {n.ts: i for i, n in enumerate(self.nodes)}
        self.constraints: List = []

    @classmethod
    def from_trajectory(cls, timestamps: Sequence[int],
                        poses: Sequence[np.ndarray],
                        config: Optional[SolverConfig] = None,
                        fix_first: bool = True) -> "PoseOptimizer":
        nodes = [Node(int(t), np.asarray(p, dtype=np.float64).reshape(4, 4))
                 for t, p in zip(timestamps, poses)]
        if nodes and fix_first:
            nodes[0].fixed = True
        opt = cls(nodes, config)
        # odometry chain constraints from the input trajectory
        for a, b in zip(opt.nodes[:-1], opt.nodes[1:]):
            rel = np.linalg.solve(a.pose, b.pose)
            opt.add_constraint(PoseToPoseConstraint(a.ts, b.ts, rel))
        return opt

    def node_at(self, ts: int) -> Node:
        if ts in self._ts_index:
            return self.nodes[self._ts_index[ts]]
        # closest node (reference snaps to nearest knot)
        idx = int(np.argmin([abs(n.ts - ts) for n in self.nodes]))
        return self.nodes[idx]

    def add_constraint(self, c) -> None:
        self.constraints.append(c)
        self._resolved = None

    def _resolve_indices(self) -> List[Tuple[int, ...]]:
        """Per-constraint node indices, computed once per solve —
        node_at is O(n) and least_squares evaluates residuals many
        times per iteration."""
        if getattr(self, "_resolved", None) is None:
            out: List[Tuple[int, ...]] = []
            for c in self.constraints:
                if isinstance(c, (AbsolutePoseConstraint,
                                  AbsolutePointConstraint)):
                    out.append((self._ts_index[self.node_at(c.ts).ts],))
                else:
                    out.append((self._ts_index[self.node_at(c.ts1).ts],
                                self._ts_index[self.node_at(c.ts2).ts]))
            self._resolved = out
        return self._resolved

    # ------------------------------------------------------------------
    def _residuals(self, x: np.ndarray) -> np.ndarray:
        n = len(self.nodes)
        params = x.reshape(n, 6)
        Ts = [(_params_to_T(params[i]) if not self.nodes[i].fixed
               else self.nodes[i].pose) for i in range(n)]
        res: List[np.ndarray] = []
        for c, idx in zip(self.constraints, self._resolve_indices()):
            if isinstance(c, AbsolutePoseConstraint):
                i, = idx
                diff = np.linalg.solve(Ts[i], c.target_pose)
                res.append(_R_to_rotvec(diff[:3, :3]) * c.rotation_weight)
                res.append(diff[:3, 3] * c.translation_weight)
            elif isinstance(c, PoseToPoseConstraint):
                i, j = idx
                rel = np.linalg.solve(Ts[i], Ts[j])
                diff = np.linalg.solve(c.relative_pose, rel)
                res.append(_R_to_rotvec(diff[:3, :3]) * c.rotation_weight)
                res.append(diff[:3, 3] * c.translation_weight)
            elif isinstance(c, PointToPointConstraint):
                i, j = idx
                p1 = Ts[i][:3, :3] @ c.point1 + Ts[i][:3, 3]
                p2 = Ts[j][:3, :3] @ c.point2 + Ts[j][:3, 3]
                res.append((p1 - p2) * c.translation_weight)
            elif isinstance(c, AbsolutePointConstraint):
                i, = idx
                p = Ts[i][:3, :3] @ c.point + Ts[i][:3, 3]
                res.append((p - c.target) * c.translation_weight)
        if not res:
            return np.zeros(1)
        return np.concatenate(res)

    def _jac_sparsity(self) -> lil_matrix:
        n = len(self.nodes)
        rows = 0
        entries: List[Tuple[int, List[int]]] = []
        for c, idx in zip(self.constraints, self._resolve_indices()):
            nrows = 6 if isinstance(c, (AbsolutePoseConstraint,
                                        PoseToPoseConstraint)) else 3
            entries.append((nrows, list(idx)))
        total = sum(r for r, _ in entries) or 1
        S = lil_matrix((total, n * 6), dtype=np.int8)
        row = 0
        for nrows, node_ids in entries:
            for nid in node_ids:
                S[row:row + nrows, nid * 6:(nid + 1) * 6] = 1
            row += nrows
        return S

    def solve(self) -> List[Node]:
        n = len(self.nodes)
        x0 = np.concatenate([_T_to_params(nd.pose) for nd in self.nodes])
        cfg = self.config
        eps = float(np.finfo(np.float64).eps)
        result = least_squares(
            self._residuals, x0,
            jac_sparsity=self._jac_sparsity(),
            method="trf",
            loss=cfg.scipy_loss(),
            f_scale=cfg.scipy_loss_scale(),
            max_nfev=cfg.max_num_iterations * 10,
            # reference tolerances (1e-18/1e-20) are below f64 eps; scipy
            # rejects sub-eps tolerances, so clamp like Ceres effectively
            # does by never triggering them
            ftol=max(cfg.function_tolerance, eps),
            gtol=max(cfg.gradient_tolerance, eps),
            xtol=max(cfg.parameter_tolerance, eps),
            verbose=1 if cfg.process_printout else 0,
        )
        params = result.x.reshape(n, 6)
        for i, nd in enumerate(self.nodes):
            if not nd.fixed:
                nd.pose = _params_to_T(params[i])
        return self.nodes

    # -- exports (ref: slam_util.cpp) -----------------------------------
    def save_trajectory_kitti(self, path: str) -> None:
        with open(path, "w") as f:
            for nd in self.nodes:
                row = nd.pose[:3, :].reshape(-1)
                f.write(" ".join(f"{v:.18e}" for v in row) + "\n")

    def save_trajectory_tum(self, path: str) -> None:
        with open(path, "w") as f:
            for nd in self.nodes:
                t = nd.pose[:3, 3]
                R = nd.pose[:3, :3]
                # robust 4-branch conversion (w last per TUM: x y z w)
                from ..utils.extrinsics import \
                    rotation_matrix_to_quaternion

                qw, qx, qy, qz = rotation_matrix_to_quaternion(R)
                f.write(f"{nd.ts * 1e-9:.9f} {t[0]} {t[1]} {t[2]} "
                        f"{qx} {qy} {qz} {qw}\n")


# ---------------------------------------------------------------------------
# Constraint JSON config + OSF trajectory optimization
# (ref: constraint_config.cpp, cli pose_optimize in plugins/source.py:856)
# ---------------------------------------------------------------------------

def resample_trajectory_knots(poses: Sequence[np.ndarray],
                              key_frame_distance: float) -> List[int]:
    """Indices of spatial key frames: a knot whenever cumulative travel
    reaches key_frame_distance meters; endpoints always kept
    (ref: trajectory.cpp resampling)."""
    n = len(poses)
    if n == 0:
        return []
    if key_frame_distance is None or key_frame_distance <= 0 or n <= 2:
        return list(range(n))
    keep = [0]
    acc = 0.0
    for i in range(1, n):
        acc += float(np.linalg.norm(poses[i][:3, 3] - poses[i - 1][:3, 3]))
        if acc >= key_frame_distance:
            keep.append(i)
            acc = 0.0
    if keep[-1] != n - 1:
        keep.append(n - 1)
    return keep


def _pose_from_json(obj) -> np.ndarray:
    """Pose as a 16-list (row-major 4x4), nested 4x4, or
    {x,y,z,rx,ry,rz} with ZYX euler (ref: constraint_config.cpp:255-271:
    yaw(rz,Z) * pitch(ry,Y) * roll(rx,X))."""
    if isinstance(obj, dict):
        x = float(obj.get("x", 0.0))
        y = float(obj.get("y", 0.0))
        z = float(obj.get("z", 0.0))
        rx = float(obj.get("rx", 0.0))
        ry = float(obj.get("ry", 0.0))
        rz = float(obj.get("rz", 0.0))
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        T = np.eye(4)
        T[:3, :3] = Rz @ Ry @ Rx
        T[:3, 3] = (x, y, z)
        return T
    arr = np.asarray(obj, dtype=np.float64)
    return arr.reshape(4, 4)


def load_constraints_json(text: str):
    """Parse the reference's constraint-config JSON. Returns
    (SolverConfig, traj_rotation_weight, traj_translation_weight,
    key_frame_distance, constraint dicts). Point constraints stay as raw
    dicts because resolving pixel (row, col) to a 3D point needs the scan
    data (done in optimize_osf_trajectory)."""
    import json as _json

    doc = _json.loads(text)
    cfg = SolverConfig()
    loss = str(doc.get("loss_function", "TrivialLoss")).lower()
    cfg.loss = {"trivialloss": "linear", "huberloss": "huber",
                "softloneloss": "soft_l1", "cauchyloss": "cauchy",
                "arctanloss": "arctan"}.get(loss, "linear")
    if "loss_function_scale" in doc:
        cfg.loss_scale = float(doc["loss_function_scale"])
    if "max_num_iterations" in doc:
        cfg.max_num_iterations = int(doc["max_num_iterations"])
    traj_rw = float(doc.get("traj_rotation_weight", 10.0))
    traj_tw = float(doc.get("traj_translation_weight", 10.0))
    kfd = float(doc.get("key_frame_distance", 1.0))
    return cfg, traj_rw, traj_tw, kfd, list(doc.get("constraints", []))


def optimize_osf_trajectory(src_osf: str, out_osf: str,
                            constraints_json: Optional[str] = None,
                            key_frame_distance: Optional[float] = None,
                            viz_snapshot: Optional[str] = None,
                            device=None) -> int:
    """Refine the per-column poses of an OSF recording against a
    constraint config and rewrite it (ref: plugins/source.py:856
    pose_optimize). One trajectory node per scan (mid-column); the solved
    correction is applied rigidly to that scan's column poses. Returns
    the number of scans written.

    `device` is where the OSF reader's projector and the per-scan
    correction's interpolation run: CUDA when none is named (raises
    without a GPU). The solve is numpy and scipy on the host.
    `viz_snapshot` needs the viewer, which this package does not have
    yet: it raises NotImplementedError before any file is read or
    written."""
    from ..core.constants import ChanField
    from ..io.osf import OsfScanSource, Writer
    from ..ops.xyzlut import make_xyz_lut

    if viz_snapshot:
        raise NotImplementedError(
            "viz_snapshot needs the pose-optimizer viewer, which is not "
            "ported to ouster_sdk_tpu_torch yet")

    cfg = SolverConfig()
    traj_rw = traj_tw = 10.0
    raw_constraints = []
    if constraints_json is not None:
        cfg, traj_rw, traj_tw, kfd, raw_constraints = \
            load_constraints_json(constraints_json)
        if key_frame_distance is None:
            key_frame_distance = kfd

    src = OsfScanSource(src_osf, device=device)
    infos = src.sensor_info
    sets = list(src)
    scans = [s for ls in sets for s in ls.valid()]
    if not scans:
        raise ValueError("no scans in source OSF")

    def mid_ts(s):
        cols = np.flatnonzero(s.status & 1)
        mid = int(cols[len(cols) // 2]) if cols.size else s.w // 2
        return int(s.timestamp[mid]), mid

    scan_ts, mid_cols = zip(*[mid_ts(s) for s in scans])
    scan_poses = [s.pose[m].copy() for s, m in zip(scans, mid_cols)]

    # trajectory resampling: one solver node every key_frame_distance
    # meters of travel, endpoints always kept (ref: trajectory.cpp —
    # Ceres nodes are spatial key frames, not one per scan)
    kfd = key_frame_distance if key_frame_distance is not None \
        else cfg.key_frame_distance
    knots = resample_trajectory_knots(scan_poses, kfd)
    node_ts = [scan_ts[i] for i in knots]
    node_poses = [scan_poses[i] for i in knots]

    # absolute constraints pin the gauge themselves; otherwise fix the
    # first node (ref: pose_optimizer.cpp:1241 gauge handling)
    has_absolute = any(str(c.get("type", "")).upper()
                       in ("ABSOLUTE_POSE", "ABSOLUTE_POINT")
                       for c in raw_constraints)
    opt = PoseOptimizer.from_trajectory(
        node_ts, node_poses, cfg,
        fix_first=cfg.fix_first_node or not has_absolute)
    # odometry chain carries the configured trajectory weights
    for c in opt.constraints:
        c.rotation_weight = traj_rw
        c.translation_weight = traj_tw

    lut = make_xyz_lut(infos[0])

    def pixel_point(ts, row, col, return_idx):
        """Sensor-frame 3D point of a pixel in the scan nearest ts.
        The SCAN list is searched (not the resampled knots — with
        key-frame resampling active a knot index would address the
        wrong scan); the constraint then anchors to the nearest KNOT
        timestamp, which is what the solver optimizes."""
        si = int(np.argmin([abs(t - ts) for t in scan_ts]))
        s = scans[si]
        name = ChanField.RANGE2 if return_idx == 2 else ChanField.RANGE
        r = np.zeros((s.h, s.w), dtype=np.uint32)
        r[row, col] = s.field(name)[row, col]
        ni = int(np.argmin([abs(t - scan_ts[si]) for t in node_ts]))
        return node_ts[ni], lut(r)[row, col]

    for c in raw_constraints:
        ctype = str(c.get("type", "")).upper()
        if ctype == "ABSOLUTE_POSE":
            opt.add_constraint(AbsolutePoseConstraint(
                int(c["timestamp"]), _pose_from_json(c["pose"]),
                rotation_weight=float(c.get("rotation_weight", 1.0)),
                translation_weight=float(np.mean(
                    c.get("translation_weight", 1.0)))))
        elif ctype == "POSE_TO_POSE":
            opt.add_constraint(PoseToPoseConstraint(
                int(c["timestamp_1"]), int(c["timestamp_2"]),
                _pose_from_json(c.get("pose", np.eye(4))),
                rotation_weight=float(c.get("rotation_weight", 1.0)),
                translation_weight=float(np.mean(
                    c.get("translation_weight", 1.0)))))
        elif ctype == "POINT_TO_POINT":
            p1, p2 = c["point_1"], c["point_2"]
            ts1, pt1 = pixel_point(int(p1["timestamp"]), int(p1["row"]),
                                   int(p1["col"]),
                                   int(p1.get("return_idx", 1)))
            ts2, pt2 = pixel_point(int(p2["timestamp"]), int(p2["row"]),
                                   int(p2["col"]),
                                   int(p2.get("return_idx", 1)))
            opt.add_constraint(PointToPointConstraint(
                ts1, pt1, ts2, pt2,
                translation_weight=float(np.mean(
                    c.get("translation_weight", 1.0)))))
        elif ctype == "ABSOLUTE_POINT":
            ts, pt = pixel_point(int(c["timestamp"]), int(c["row"]),
                                 int(c["col"]),
                                 int(c.get("return_idx", 1)))
            tgt = c["point"]
            target = np.array([tgt["x"], tgt["y"], tgt["z"]],
                              dtype=np.float64) if isinstance(tgt, dict) \
                else np.asarray(tgt, dtype=np.float64)
            opt.add_constraint(AbsolutePointConstraint(
                ts, pt, target,
                translation_weight=float(np.mean(
                    c.get("translation_weight", 1.0)))))
        else:
            raise ValueError(f"unknown constraint type {ctype!r}")

    opt.solve()

    # per-scan correction T_fix = T_new @ inv(T_old), SE(3)-interpolated
    # between the surrounding knots at the scan's mid timestamp
    # (ref: trajectory.cpp resampling + pose writeback)
    from ..utils.pose_util import pose_interp

    knot_fixes = [nd.pose @ np.linalg.inv(old)
                  for nd, old in zip(opt.nodes, node_poses)]
    knot_ts = np.asarray(node_ts, dtype=np.float64)
    for s, ts in zip(scans, scan_ts):
        j = int(np.searchsorted(knot_ts, ts))
        if j <= 0:
            fix = knot_fixes[0]
        elif j >= len(knot_fixes):
            fix = knot_fixes[-1]
        else:
            t0, t1 = knot_ts[j - 1], knot_ts[j]
            frac = 0.0 if t1 == t0 else (ts - t0) / (t1 - t0)
            fix = pose_interp(frac, knot_fixes[j - 1], knot_fixes[j],
                              device=device)
        s.pose[:] = np.einsum("ij,wjk->wik", fix, s.pose)

    n = 0
    with Writer(out_osf) as w:
        for info in infos:
            w.add_sensor(info)
        for ls_set in sets:
            valid = [s for s in ls_set if s is not None]
            if len(ls_set) == len(infos) and valid and all(
                    s.first_valid_packet_timestamp() for s in valid):
                w.save_set(ls_set)
            else:
                for idx, s in enumerate(ls_set):
                    if s is not None:
                        w.save(idx, s)
            n += len(valid)
    src.close()
    return n


class LossFunction(Enum):
    """Robust-loss selection (ref: _mapping.cpp:90-99 LossFunction)."""

    HUBER_LOSS = "HUBER_LOSS"
    CAUCHY_LOSS = "CAUCHY_LOSS"
    SOFT_L_ONE_LOSS = "SOFT_L_ONE_LOSS"
    ARCTAN_LOSS = "ARCTAN_LOSS"
    TRIVIAL_LOSS = "TRIVIAL_LOSS"

    @staticmethod
    def from_string(s: str) -> "LossFunction":
        return LossFunction(s.upper())


class SamplingMode(Enum):
    """Trajectory query granularity (ref: _mapping.cpp:86-88,
    pose_optimizer.h:166)."""

    KEY_FRAMES = 0
    COLUMNS = 1


def save_trajectory(filename: str, timestamps, poses,
                    file_type: str = "csv") -> None:
    """Write a (timestamps, poses) trajectory as csv or tum
    (ref: pose_optimizer.cpp:1762-1818 save_trajectory)."""
    timestamps = np.asarray(timestamps, dtype=np.uint64).reshape(-1)
    poses = np.asarray(poses, dtype=np.float64).reshape(-1, 4, 4)
    if len(timestamps) != len(poses):
        raise RuntimeError("Timestamps and poses size mismatch")

    def _quat(R):
        # 4-branch conversion: stable for 180-degree rotations too
        from ..utils.extrinsics import rotation_matrix_to_quaternion

        qw, qx, qy, qz = rotation_matrix_to_quaternion(R)
        return qx, qy, qz, qw

    with open(filename, "w") as f:
        if file_type == "csv":
            f.write("timestamp,tx,ty,tz,qx,qy,qz,qw\n")
            for ts, P in zip(timestamps, poses):
                qx, qy, qz, qw = _quat(P[:3, :3])
                t = P[:3, 3]
                f.write(f"{ts},{t[0]},{t[1]},{t[2]},"
                        f"{qx},{qy},{qz},{qw}\n")
        elif file_type == "tum":
            for ts, P in zip(timestamps, poses):
                qx, qy, qz, qw = _quat(P[:3, :3])
                t = P[:3, 3]
                f.write(f"{ts * 1e-9} {t[0]} {t[1]} {t[2]} "
                        f"{qx} {qy} {qz} {qw}\n")
        else:
            raise RuntimeError(f"Unsupported file type: {file_type}. "
                               "Currently support 'csv' or 'tum'.")
