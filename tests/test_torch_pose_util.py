"""The port's pose helpers (utils/pose_util.py), the SLAM engine's deskew
and time-correction copies (slam/deskew.py, slam/time_correction.py) and
utils/profiling.py against the JAX package's on the same inputs.

Tolerances: the numpy functions are copies and equal to the JAX package's
bit for bit; the float32 wrappers that evaluate on a device (exp_pose6,
log_pose, pose_interp, Trajectory.pose_at, here on the CPU) within 2e-6
(other implementations of sin, cos and arccos).
"""

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
from ouster_sdk_tpu.slam import kiss_icp as jkiss
from ouster_sdk_tpu.utils import pose_util as jpu
from ouster_sdk_tpu_torch.utils import pose_util as tpu
from test_torch_slam import _yard


def test_pose_util_matches_the_jax_package():
    rng = np.random.default_rng(4)
    xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 3, 3)])
    T = tpu.exp_pose6(xi, device="cpu")
    np.testing.assert_allclose(T, jpu.exp_pose6(xi), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tpu.log_pose(T, device="cpu"),
                               jpu.log_pose(T), atol=2e-6, rtol=0)
    T1 = tpu.exp_pose6(xi * 0.5 + 0.1, device="cpu")
    t = np.linspace(0, 1, 7)
    np.testing.assert_allclose(tpu.pose_interp(t, T, T1, device="cpu"),
                               jpu.pose_interp(t, T, T1), atol=2e-6, rtol=0)
    knots = np.array([0, 10**8, 3 * 10**8], np.int64) + 10**18
    poses = np.stack([np.eye(4), T, T1])
    q = np.array([-5 * 10**7, 0, 2 * 10**8, 4 * 10**8]) + 10**18
    got = tpu.Trajectory(knots, poses, device="cpu").pose_at(q)
    np.testing.assert_allclose(got, jpu.Trajectory(knots, poses).pose_at(q),
                               atol=2e-6, rtol=0)
    # the numpy helpers are copies
    for fn in ("interp_pose", "interp_pose_float"):
        assert np.array_equal(getattr(tpu, fn)(q, knots, poses),
                              getattr(jpu, fn)(q, knots, poses))
    for a, b in ((tpu.euler_pose_to_matrix(xi), jpu.euler_pose_to_matrix(xi)),
                 (tpu.interp_pose_pair(t, T, T1),
                  jpu.interp_pose_pair(t, T, T1)),
                 (tpu.get_rot_matrix_to_align_to_gravity(0.1, 0.2, 9.8),
                  jpu.get_rot_matrix_to_align_to_gravity(0.1, 0.2, 9.8))):
        assert np.array_equal(a, b)


def test_time_correction_and_deskew_match_the_jax_package():
    """ActiveTimeCorrection on a non-monotonic frame, and the three deskew
    methods, on the same scans in both packages."""
    from ouster_sdk_tpu.slam import deskew as jd
    from ouster_sdk_tpu.slam import time_correction as jtc
    from ouster_sdk_tpu_torch.slam import deskew as td
    from ouster_sdk_tpu_torch.slam import time_correction as ttc

    info, jinfo, scans, jscans = _yard(n=2, w=128, h=16)
    s, j = scans[1], jscans[1]
    for x in (s, j):
        x.timestamp[10] = 1                      # a backwards jump
        x.packet_timestamp[:] += 123_456
    ct, cj = ttc.ActiveTimeCorrection([info]), jtc.ActiveTimeCorrection(
        [jinfo])
    for a, b in zip(scans, jscans):
        assert ct.update([a]) == cj.update([b])
        assert np.array_equal(a.timestamp, b.timestamp)
        ct.reset([a])
        cj.reset([b])
        assert np.array_equal(a.timestamp, b.timestamp)
    P = jkiss.se3_exp(np.array([0.4, 0.1, 0.0, 0.0, 0.0, 0.05]))
    for name in ("none", "constant_velocity"):
        mt, mj = td.make_deskew_method(name), jd.make_deskew_method(name)
        for k, (a, b) in enumerate(zip(scans, jscans)):
            mt.update([a])
            mj.update([b])
            assert np.array_equal(a.pose, b.pose)
            ts = int(a.first_valid_column_timestamp())
            mt.set_last_pose(ts, np.linalg.matrix_power(P, k + 1))
            mj.set_last_pose(ts, np.linalg.matrix_power(P, k + 1))
    with pytest.raises(ValueError):
        td.make_deskew_method("bogus")


def test_device_none_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    for fn, args in ((tpu.exp_pose6, (np.zeros(6),)),
                     (tpu.log_pose, (np.eye(4),)),
                     (tpu.pose_interp, (0.5, np.eye(4), np.eye(4)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
    traj = tpu.Trajectory(np.array([0, 10**8]), np.stack([np.eye(4)] * 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        traj.pose_at(5 * 10**7)


def test_profiling(tmp_path):
    from ouster_sdk_tpu_torch.utils.profiling import (ProfileRunner,
                                                      device_trace)

    runner = ProfileRunner()
    with runner.run("stage"):
        torch.ones(8).sum()
    assert set(runner.summary()) == {"stage", "stage_cpu"}
    assert '"stages_ms"' in runner.report({"extra": 1})
    with device_trace(str(tmp_path / "trace")) as d:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert d == str(tmp_path / "trace")
