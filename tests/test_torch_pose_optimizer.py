"""The port's pose optimizer (slam/pose_optimizer.py) against the JAX
package's, on the CPU. Both solve with numpy and scipy's least_squares
(TRF, the same sparsity), so the same seeded drifty trajectories under each
of the four constraint kinds and each robust loss give bit-equal node
poses; the knot resampling, the constraint json, the three trajectory
writers and optimize_osf_trajectory (an OSF of a SLAM run over the chip
run's yard, rewritten by each package, the port's projector and
interpolation on the CPU) give equal values and byte-equal files.
Tolerance: exact, but for the rewritten OSF's poses, whose float32 SE(3)
interpolation torch and XLA round differently (within 2e-6; byte-equal
with the JAX package's interpolation patched in)."""

import json
import os

import numpy as np
import pytest

import chip_smoke as cs
import ouster_sdk_tpu.slam.pose_optimizer as jpo
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.save  # noqa: F401
import ouster_sdk_tpu_torch.slam  # noqa: F401
import ouster_sdk_tpu_torch.slam.pose_optimizer as tpo
from _torch_helpers import assert_scans_equal
from ouster_sdk_tpu_torch.core.types import UDPProfileLidar

#: test-speed solver settings (as in tests/test_pose_optimizer.py)
FAST = dict(max_num_iterations=30, function_tolerance=1e-9,
            parameter_tolerance=1e-9, gradient_tolerance=1e-11,
            process_printout=False)
LOSSES = ("TRIVIAL_LOSS", "HUBER_LOSS", "CAUCHY_LOSS", "SOFT_L_ONE_LOSS",
          "ARCTAN_LOSS")
KINDS = ("absolute_pose", "pose_to_pose", "point_to_point",
         "absolute_point")


def _se3(rng, scale):
    """A random small rigid motion (rotation vector and translation)."""
    T = np.eye(4)
    T[:3, :3] = tpo._rotvec_to_R(rng.normal(0, scale * 0.2, 3))
    T[:3, 3] = rng.normal(0, scale, 3)
    return T


def _trajectory(n, seed):
    """Ground truth: 1 m a step along x with a slow turn; the estimate
    drifts by a seeded random motion a step."""
    rng = np.random.default_rng(seed)
    gt, est = [np.eye(4)], [np.eye(4)]
    for _ in range(n - 1):
        step = np.eye(4)
        step[:3, :3] = tpo._rotvec_to_R(np.array([0.0, 0.0, 0.05]))
        step[0, 3] = 1.0
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ step @ _se3(rng, 0.03))
    return gt, est


def _constraints(mod, kind, gt, ts):
    """Constraints of one kind that pull the estimate toward the truth."""
    lm = np.array([2.0, 1.0, 0.5])
    local = [np.linalg.solve(g, np.append(lm, 1.0))[:3] for g in gt]
    if kind == "absolute_pose":
        return [mod.AbsolutePoseConstraint(ts[-1], gt[-1], 50.0, 40.0),
                mod.AbsolutePoseConstraint(ts[2], gt[2])]
    if kind == "pose_to_pose":
        return [mod.PoseToPoseConstraint(
            ts[0], ts[-1], np.linalg.solve(gt[0], gt[-1]), 20.0, 20.0)]
    if kind == "point_to_point":
        return [mod.PointToPointConstraint(ts[0], local[0], ts[-1],
                                           local[-1], 20.0),
                mod.PointToPointConstraint(ts[1], local[1], ts[4],
                                           local[4])]
    return [mod.AbsolutePointConstraint(ts[-1], local[-1], lm, 20.0),
            # a timestamp between knots snaps to the nearest one
            mod.AbsolutePointConstraint(ts[3] + 3, local[3], lm, 5.0)]


def _solve(mod, kind, loss, n=7, seed=0):
    gt, est = _trajectory(n, seed)
    ts = [10**9 + 10**8 * i for i in range(n)]
    cfg = mod.SolverConfig(loss=loss, loss_scale=0.5, **FAST)
    opt = mod.PoseOptimizer.from_trajectory(
        ts, est, cfg, fix_first=kind not in ("absolute_pose",
                                             "absolute_point"))
    for c in _constraints(mod, kind, gt, ts):
        opt.add_constraint(c)
    return opt, opt.solve()


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", KINDS)
def test_solve_is_bit_equal_to_the_jax_package(kind, loss):
    _, want = _solve(jpo, kind, loss)
    _, got = _solve(tpo, kind, loss)
    assert [n.ts for n in got] == [n.ts for n in want]
    assert [n.fixed for n in got] == [n.fixed for n in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.pose, b.pose), (kind, loss, a.ts)
    # the solve moved the trajectory
    _, est = _trajectory(7, 0)
    assert max(np.abs(n.pose - e).max() for n, e in zip(got, est)) > 1e-3


def test_names_and_enums_match_the_jax_package():
    import ouster_sdk_tpu.slam as js

    import ouster_sdk_tpu_torch.slam as ts

    assert tpo.LOSS_FUNCTIONS == jpo.LOSS_FUNCTIONS
    assert [m.value for m in tpo.LossFunction] == \
        [m.value for m in jpo.LossFunction]
    assert [m.value for m in tpo.SamplingMode] == \
        [m.value for m in jpo.SamplingMode]
    assert tpo.LossFunction.from_string("huber_loss") is \
        tpo.LossFunction.HUBER_LOSS
    for loss in LOSSES + ("huber", "cauchy"):
        a, b = tpo.SolverConfig(loss=loss), jpo.SolverConfig(loss=loss)
        assert (a.scipy_loss(), a.scipy_loss_scale()) == \
            (b.scipy_loss(), b.scipy_loss_scale())
    assert vars(tpo.SolverConfig()) == vars(jpo.SolverConfig())
    assert ts.PoseOptimizerNode is tpo.Node
    names = ("AbsolutePointConstraint", "AbsolutePoseConstraint",
             "LossFunction", "Node", "PointToPointConstraint",
             "PoseOptimizer", "PoseToPoseConstraint", "SamplingMode",
             "SolverConfig", "save_trajectory", "Constraint",
             "PoseOptimizerNode")
    for name in names:
        assert hasattr(js, name) and hasattr(ts, name), name


def test_rotation_vector_branches_are_bit_equal():
    """The small-angle, general and near-180-degree branches of the
    rotation-vector conversions."""
    rng = np.random.default_rng(3)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    for ax, theta in zip(axes, (0.0, 1e-13, 1e-7, 0.3, 1.0, 2.0, 3.0,
                                np.pi - 1e-7, np.pi - 1e-9, np.pi, 2.5,
                                0.01)):
        w = ax * theta
        R = tpo._rotvec_to_R(w)
        assert np.array_equal(R, jpo._rotvec_to_R(w))
        assert np.array_equal(tpo._R_to_rotvec(R), jpo._R_to_rotvec(R))
        T = tpo._params_to_T(np.concatenate([w, ax]))
        assert np.array_equal(tpo._T_to_params(T), jpo._T_to_params(T))


def test_knots_and_constraint_json_match(tmp_path):
    _, est = _trajectory(21, 5)
    for kfd in (None, 0, -1.0, 0.5, 1.0, 2.5, 100.0):
        assert tpo.resample_trajectory_knots(est, kfd) == \
            jpo.resample_trajectory_knots(est, kfd)
    assert tpo.resample_trajectory_knots([], 1.0) == []
    doc = {"loss_function": "CauchyLoss", "loss_function_scale": 0.25,
           "max_num_iterations": 42, "traj_rotation_weight": 3.0,
           "traj_translation_weight": 7.0, "key_frame_distance": 0.75,
           "constraints": [
               {"type": "ABSOLUTE_POSE", "timestamp": 5,
                "pose": {"x": 1.0, "y": -2.0, "z": 0.5, "rx": 0.1,
                         "ry": -0.2, "rz": 0.3}},
               {"type": "POSE_TO_POSE", "timestamp_1": 1,
                "timestamp_2": 9, "pose": list(np.eye(4).ravel())}]}
    path = tmp_path / "constraints.json"
    path.write_text(json.dumps(doc))
    got = tpo.load_constraints_json(path.read_text())
    want = jpo.load_constraints_json(path.read_text())
    assert vars(got[0]) == vars(want[0]) and got[1:] == want[1:]
    for c in doc["constraints"]:
        assert np.array_equal(tpo._pose_from_json(c["pose"]),
                              jpo._pose_from_json(c["pose"]))
    # an unknown loss name is the trivial loss in both
    assert tpo.load_constraints_json('{"loss_function": "x"}')[0].loss \
        == "linear"


def test_trajectory_files_are_byte_equal(tmp_path):
    opts = {}
    for mod in (tpo, jpo):
        opts[mod], _ = _solve(mod, "pose_to_pose", "HUBER_LOSS")
    files = []
    for mod in (tpo, jpo):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        opts[mod].save_trajectory_kitti(str(d / "t.kitti"))
        opts[mod].save_trajectory_tum(str(d / "t.tum"))
        ts = [n.ts for n in opts[mod].nodes]
        poses = np.stack([n.pose for n in opts[mod].nodes])
        for kind in ("csv", "tum"):
            mod.save_trajectory(str(d / f"s.{kind}"), ts, poses, kind)
        with pytest.raises(RuntimeError, match="Unsupported"):
            mod.save_trajectory(str(d / "x.txt"), ts, poses, "kitti")
        with pytest.raises(RuntimeError, match="mismatch"):
            mod.save_trajectory(str(d / "y.csv"), ts[:-1], poses)
        files.append(d)
    for name in ("t.kitti", "t.tum", "s.csv", "s.tum"):
        a = (files[0] / name).read_bytes()
        assert a == (files[1] / name).read_bytes(), name
        assert len(a.splitlines()) >= 7


# -- optimize_osf_trajectory --------------------------------------------------

def _yard_osf(path, n=6):
    """An OSF of the yard (32x256 dual) with the per-column poses of the
    port's host SLAM backend, as `source X slam save Y.osf` writes it."""
    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    info.config.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    scans, truth = cs.yard_scans(pt, info, n)
    eng = pt.slam.SlamEngine([info], pt.slam.SlamConfig(voxel_size=1.0))
    sets = []
    for s in scans:
        ls = pt.LidarScanSet([s])
        eng.update(ls)
        sets.append(ls)
    pt.io.save.save_scans(path, [info], sets)
    return scans, truth


def _config(scans, truth):
    mid = [int(np.flatnonzero(s.status & 1)[s.w // 2]) for s in scans]
    ts = [int(s.timestamp[m]) for s, m in zip(scans, mid)]
    gt = np.linalg.inv(truth[0]) @ truth
    return {"loss_function": "HuberLoss", "key_frame_distance": 0.3,
            "max_num_iterations": 15,
            "constraints": [
                {"type": "ABSOLUTE_POSE", "timestamp": ts[-1],
                 "pose": list(gt[-1].ravel()), "rotation_weight": 20.0,
                 "translation_weight": 20.0},
                {"type": "POSE_TO_POSE", "timestamp_1": ts[0],
                 "timestamp_2": ts[2], "pose": list(
                     np.linalg.solve(gt[0], gt[2]).ravel())},
                {"type": "POINT_TO_POINT",
                 "point_1": {"timestamp": ts[1], "row": 3, "col": 40},
                 "point_2": {"timestamp": ts[4], "row": 3, "col": 40,
                             "return_idx": 2},
                 "translation_weight": 0.5},
                {"type": "ABSOLUTE_POINT", "timestamp": ts[3], "row": 5,
                 "col": 100, "point": {"x": 10.0, "y": 2.0, "z": 0.0},
                 "translation_weight": [0.1, 0.1, 0.1]}]}


def _optimize_both(tmp_path, src, cfg, tag, **kw):
    port_out = str(tmp_path / f"port_{tag}.osf")
    jax_out = str(tmp_path / f"jax_{tag}.osf")
    n = tpo.optimize_osf_trajectory(src, port_out, cfg, device="cpu", **kw)
    m = jpo.optimize_osf_trajectory(src, jax_out, cfg, **kw)
    assert n == m
    return n, port_out, jax_out


def _scans(path):
    return [ls[0] for ls in pt.open_source(path, device="cpu")]


@pytest.mark.parametrize("kfd", [0.0, None])
def test_optimize_osf_trajectory_writes_the_jax_packages_bytes(
        tmp_path, monkeypatch, kfd):
    """With the same float32 SE(3) interpolation in both (the JAX
    package's utils/pose_util.pose_interp patched into the port), the
    files are byte-equal: every scan a key frame (kfd 0) and key frames
    0.3 m apart (None: the config's), where the scans between two knots
    take an interpolated correction."""
    import ouster_sdk_tpu.utils.pose_util as jpu

    import ouster_sdk_tpu_torch.utils.pose_util as tpu

    monkeypatch.setattr(tpu, "pose_interp",
                        lambda t, p0, p1, device=None:
                        jpu.pose_interp(t, p0, p1))
    src = str(tmp_path / "slam.osf")
    scans, truth = _yard_osf(src)
    cfg = json.dumps(_config(scans, truth))
    n, port_out, jax_out = _optimize_both(tmp_path, src, cfg, "patched",
                                          key_frame_distance=kfd)
    assert n == len(scans)
    with open(port_out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()


def test_optimize_osf_trajectory_differs_by_the_interpolation_alone(
        tmp_path):
    """The port as it runs: the correction of each scan is interpolated on
    the SE(3) geodesic in float32 (utils/pose_util.pose_interp, at the
    fraction 0 or 1 on a knot), which the port evaluates with torch on the
    CPU and the JAX package with XLA; their sin, cos, arccos and 3x3 solve
    differ in the last bit, so the poses may differ by about one float32
    ulp of the correction (measured 2.98e-8) and are held within the 2e-6
    of tests/test_torch_pose_util.py. Every other byte of each scan is
    equal, and each scan moved rigidly."""
    src = str(tmp_path / "slam.osf")
    scans, truth = _yard_osf(src)
    cfg = json.dumps(_config(scans, truth))   # key_frame_distance 0.3
    n, port_out, jax_out = _optimize_both(tmp_path, src, cfg, "kfd")
    assert n == len(scans)
    assert os.path.getsize(port_out) == os.path.getsize(jax_out)
    poses = np.stack([s.pose[s.w // 2] for s in _scans(src)])
    assert 2 < len(tpo.resample_trajectory_knots(poses, 0.3)) < n
    moved = 0.0
    for k, (a, b, c) in enumerate(zip(_scans(port_out), _scans(jax_out),
                                      _scans(src))):
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=2e-6)
        fix = a.pose @ np.linalg.inv(c.pose)
        np.testing.assert_allclose(fix, np.broadcast_to(fix[0], fix.shape),
                                   atol=1e-9)
        moved = max(moved, np.abs(fix[0] - np.eye(4)).max())
        b.pose[:] = c.pose[:] = a.pose
        assert_scans_equal(a, b, str(k))
        assert_scans_equal(a, c, str(k))
    assert moved > 1e-4


def test_optimize_osf_trajectory_refuses_a_viz_snapshot_first(tmp_path):
    out = tmp_path / "out.osf"
    with pytest.raises(NotImplementedError, match="viewer"):
        tpo.optimize_osf_trajectory(str(tmp_path / "missing.osf"), str(out),
                                    viz_snapshot=str(tmp_path / "po.png"),
                                    device="cpu")
    assert not out.exists() and not any(tmp_path.iterdir())


def test_optimize_osf_trajectory_raises_on_an_unknown_constraint(tmp_path):
    src = str(tmp_path / "slam.osf")
    _yard_osf(src, n=3)
    cfg = json.dumps({"constraints": [{"type": "LOOP"}]})
    for mod, kw in ((tpo, {"device": "cpu"}), (jpo, {})):
        with pytest.raises(ValueError, match="unknown constraint type"):
            mod.optimize_osf_trajectory(src, str(tmp_path / "x.osf"), cfg,
                                        **kw)
