"""The port's voxel downsampling (ouster_sdk_tpu_torch/ops/downsample.py)
against the JAX package's on the same seeded points.

Tolerances: the numpy copies (voxel_downsample, voxel_downsample_first,
pack_voxel_coords) are equal to the JAX package's, bit for bit. On the CPU
voxel_downsample_device gives the mask of voxel_downsample_jax exactly and
centroids within 1 f32 ulp of 32 m (the two sum in different orders); on
the card index_add_ sums with atomics in no fixed order, which chip_smoke.py
measures. Against the numpy centroids in float64: the same voxel set, and
centroids within 1e-4 m (the JAX package's own bound for f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
from ouster_sdk_tpu.ops import downsample as jds
from ouster_sdk_tpu_torch.ops import downsample as tds

ULP_32M = float(np.spacing(np.float32(32.0)))


def _points(n: int, seed: int, spread: float = 10.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)


def _lex(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


@pytest.mark.parametrize("voxel", [0.25, 1.0, (0.5, 1.0, 2.0)])
def test_numpy_copies_equal_the_jax_package(voxel):
    pts = _points(3000, 1).astype(np.float64)
    refl = np.random.default_rng(2).integers(0, 255, 3000).astype(np.uint8)
    got, (ga,) = tds.voxel_downsample(pts, voxel, attribs=[refl],
                                      min_pts_per_voxel=2)
    want, (wa,) = jds.voxel_downsample(pts, voxel, attribs=[refl],
                                       min_pts_per_voxel=2)
    assert np.array_equal(got, want) and np.array_equal(ga, wa)
    if np.ndim(voxel) == 0:
        assert np.array_equal(tds.voxel_downsample_first(pts, voxel),
                              jds.voxel_downsample_first(pts, voxel))
    idx = np.floor(pts / 0.5).astype(np.int64)
    assert np.array_equal(tds.pack_voxel_coords(idx),
                          jds.pack_voxel_coords(idx))
    with pytest.raises(ValueError):
        tds.voxel_downsample(pts, 0.0)


@pytest.mark.parametrize("capacity", [4096, 700, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_device_version_matches_voxel_downsample_jax(capacity, masked):
    """Capacity 700 and 1 overflow: the voxels past the capacity are
    dropped in both, and the kept ones agree."""
    pts = _points(2000, 3)
    valid = (np.random.default_rng(4).random(2000) > 0.2) if masked else None
    cj, mj = jds.voxel_downsample_jax(
        jnp.asarray(pts), 1.0, capacity,
        None if valid is None else jnp.asarray(valid))
    ct, mt = tds.voxel_downsample_device(
        torch.from_numpy(pts), 1.0, capacity,
        None if valid is None else torch.from_numpy(valid))
    assert ct.shape == (capacity, 3) and mt.shape == (capacity,)
    assert np.array_equal(np.asarray(mj), mt.numpy())
    assert np.abs(np.asarray(cj) - ct.numpy()).max() <= ULP_32M
    if capacity == 4096:
        assert 0 < int(mt.sum()) < capacity    # no overflow here


def test_device_version_matches_numpy_centroids():
    pts = _points(5000, 5)
    cent_np, _ = tds.voxel_downsample(pts, 1.0)
    ct, mt = tds.voxel_downsample_device(torch.from_numpy(pts), 1.0, 8192)
    got = ct[mt].numpy()
    assert got.shape == cent_np.shape
    # both come out in lexicographic cell order
    np.testing.assert_allclose(got, cent_np, atol=1e-4, rtol=0)
    np.testing.assert_allclose(_lex(got), _lex(cent_np), atol=1e-4, rtol=0)


def test_device_version_far_coordinates():
    """Cells beyond +-2^14 do not collide (three int32 keys)."""
    pts = np.array([[0.05, 1700.0, 0.0], [1.05, -1576.85, 0.0],
                    [0.05, 1700.05, 0.0]], np.float32)
    ct, mt = tds.voxel_downsample_device(torch.from_numpy(pts), 0.1, 16)
    cj, mj = jds.voxel_downsample_jax(jnp.asarray(pts), 0.1, capacity=16)
    assert int(mt.sum()) == 2
    assert np.array_equal(np.asarray(mj), mt.numpy())
    assert np.abs(np.asarray(cj) - ct.numpy()).max() <= 2 * float(
        np.spacing(np.float32(1700.0)))


def test_device_version_edge_cases():
    with pytest.raises(ValueError):
        tds.voxel_downsample_device(torch.zeros((4, 3)), 0.0, 8)
    ct, mt = tds.voxel_downsample_device(torch.zeros((0, 3)), 1.0, 8)
    assert ct.shape == (8, 3) and not mt.any()
    one = torch.tensor([[1.5, 2.5, -0.5]])
    ct, mt = tds.voxel_downsample_device(one, 1.0, 2)
    assert mt.tolist() == [True, False] and torch.equal(ct[0], one[0])
    # float64 points stay float64
    ct, _ = tds.voxel_downsample_device(one.double(), 1.0, 2)
    assert ct.dtype == torch.float64
