"""The port's SE(3) utilities (ops/pose.py) against the JAX package's on
the same seeded inputs.

Tolerance: rtol=1e-5, atol=1e-6 in float32, the dtype the JAX package
returns (sin, cos, arccos and the 4x4 solve are other implementations, and
sums run in another order), except `dewarp`, which is bit-exact: the port
reproduces the rounding order of the JAX package's compiled einsum (first
product rounded, two fused multiply-adds, translation added last). The
numpy mirrors are the same numpy code: bit-exact. The JAX functions run
under jax.jit (one compilation each), as their callers run them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import poses
from ouster_sdk_tpu.ops import pose as jp
from ouster_sdk_tpu_torch.ops import pose as pp

TOL = dict(rtol=1e-5, atol=1e-6)

J_EXP, J_LOG = jax.jit(jp.exp_pose), jax.jit(jp.log_pose)
J_SO3_EXP, J_SO3_LOG = jax.jit(jp._so3_exp), jax.jit(jp._so3_log)
J_INTERP = jax.jit(jp.interp_pose)
J_TRAJECTORY = jax.jit(jp.interp_trajectory, static_argnames="clamp")


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _xi(n: int, seed: int, small: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 2, (n, 3))],
                        axis=1)
    if small:   # rotations under the small-angle threshold, and none at all
        xi[:, :3] *= 1e-7
        xi[0, :3] = 0
    return xi.astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 256, 3), (2, 32, 256, 3),
                                   (256, 3)], ids=["hw", "bhw", "w"])
def test_dewarp_bit_exact(shape):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 30, shape).astype(np.float32)
    P = poses(1, 256, seed=1)[0]
    want = np.asarray(jp.dewarp(jnp.asarray(pts), jnp.asarray(P)))
    got = pp.dewarp(torch.from_numpy(pts), torch.from_numpy(P))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # (W, 16) poses are the same poses
    got = pp.dewarp(torch.from_numpy(pts), torch.from_numpy(P.reshape(-1, 16)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_dewarp_float64_is_plain_arithmetic():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 30, (8, 16, 3))
    P = poses(1, 16, seed=3)[0].astype(np.float64)
    got = pp.dewarp(torch.from_numpy(pts), torch.from_numpy(P))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), pp.dewarp_np(pts, P),
                               rtol=1e-13, atol=1e-13)


def test_numpy_mirrors_match():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 30, (32, 256, 3))
    P = poses(1, 256, seed=5)[0].astype(np.float64)
    np.testing.assert_array_equal(pp.dewarp_np(pts, P), jp.dewarp_np(pts, P))
    np.testing.assert_array_equal(pp.dewarp_np(pts.reshape(-1, 3), P),
                                  jp.dewarp_np(pts.reshape(-1, 3), P))
    np.testing.assert_array_equal(pp.transform_np(pts, P[7]),
                                  jp.transform_np(pts, P[7]))


def test_transform_matches():
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 30, (500, 3)).astype(np.float32)
    T = poses(1, 1, seed=7)[0, 0]
    _close(pp.transform(torch.from_numpy(pts), torch.from_numpy(T)),
           jp.transform(jnp.asarray(pts), jnp.asarray(T)))
    _close(pp.transform(torch.from_numpy(pts),
                        torch.from_numpy(T.reshape(16))),
           jp.transform(jnp.asarray(pts), jnp.asarray(T)))


@pytest.mark.parametrize("small", [False, True], ids=["any", "small_angle"])
def test_exp_and_log_match(small):
    xi = _xi(64, 8, small)
    want_T = J_EXP(jnp.asarray(xi))
    got_T = pp.exp_pose(torch.from_numpy(xi))
    assert got_T.shape == (64, 4, 4) and torch.isfinite(got_T).all()
    _close(got_T, want_T)
    _close(pp._so3_exp(torch.from_numpy(xi[:, :3])),
           J_SO3_EXP(jnp.asarray(xi[:, :3])))
    T = np.array(want_T)
    got_xi = pp.log_pose(torch.from_numpy(T))
    assert torch.isfinite(got_xi).all()
    _close(got_xi, J_LOG(jnp.asarray(T)))
    _close(pp._so3_log(torch.from_numpy(T[:, :3, :3])),
           J_SO3_LOG(jnp.asarray(T[:, :3, :3])))
    # a single pose, no batch axis
    _close(pp.exp_pose(torch.from_numpy(xi[3])),
           J_EXP(jnp.asarray(xi[3])))
    _close(pp.log_pose(torch.from_numpy(T[3])),
           J_LOG(jnp.asarray(T[3])))


def test_exp_log_round_trip():
    xi = torch.from_numpy(_xi(32, 9))
    np.testing.assert_allclose(pp.log_pose(pp.exp_pose(xi)).numpy(),
                               xi.numpy(), rtol=1e-4, atol=1e-5)


def test_interp_pose_matches():
    T = np.array(J_EXP(jnp.asarray(_xi(2, 10))))
    t = np.linspace(-0.5, 1.5, 256).astype(np.float32)
    want = J_INTERP(jnp.asarray(t), jnp.asarray(T[0]),
                          jnp.asarray(T[1]))
    got = pp.interp_pose(torch.from_numpy(t), torch.from_numpy(T[0]),
                         torch.from_numpy(T[1]))
    assert got.shape == (256, 4, 4)
    _close(got, want)
    # the ends are the two poses
    ends = pp.interp_pose(torch.tensor([0.0, 1.0]), torch.from_numpy(T[0]),
                          torch.from_numpy(T[1]))
    np.testing.assert_allclose(ends.numpy(), T, rtol=1e-4, atol=1e-5)
    got_np = pp.interp_pose_np(t, T[0], T[1], device="cpu")
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, jp.interp_pose_np(t, T[0], T[1]),
                               **TOL)


@pytest.mark.parametrize("clamp", [False, True], ids=["extrapolate", "clamp"])
def test_interp_trajectory_matches(clamp):
    knots = np.array(J_EXP(jnp.asarray(_xi(5, 11) * 0.3)))
    knot_ts = np.array([0.0, 1.0, 2.5, 2.5, 4.0], np.float32)  # a repeat
    query = np.concatenate([np.linspace(-1, 5, 61),
                            knot_ts]).astype(np.float32)
    want = J_TRAJECTORY(query, knot_ts, knots, clamp=clamp)
    got = pp.interp_trajectory(query, knot_ts, knots, clamp=clamp,
                               device="cpu")
    assert torch.isfinite(got).all()
    _close(got, want)
    got_t = pp.interp_trajectory(torch.from_numpy(query),
                                 torch.from_numpy(knot_ts),
                                 torch.from_numpy(knots), clamp=clamp)
    assert torch.equal(got, got_t)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_numpy_entry_points_raise_without_a_gpu():
    """With numpy inputs and no device named, the entry points run on
    CUDA and never move to the CPU on their own."""
    T = poses(1, 2, seed=12)[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pp.interp_pose_np(0.5, T[0], T[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pp.interp_trajectory(np.float32([0.5]), np.float32([0, 1]), T)
