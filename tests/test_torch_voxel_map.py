"""DeviceICP's local map (slam/device_map.DeviceVoxelMap) against the host
VoxelHashMap (slam/kiss_icp.py), on the CPU: the same voxels, counts and
points, in the same `_voxels` and `pointcloud()` order, bit for bit, over
sequences of updates that reach the cap, test the admission radius, create
voxels of one and of several candidates in one call, prune in the middle
of the born order, and go through clear() and load(). Also what the ICP is
handed (`device_points()`), the read-only view, and the tracer's
`map.host_syncs` and `map.new_voxels`. The admission kernel itself is held
to its plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ouster_sdk_tpu_torch.ops.downsample import pack_voxel_coords
from ouster_sdk_tpu_torch.slam.device_map import DeviceVoxelMap
from ouster_sdk_tpu_torch.slam.kiss_icp import VoxelHashMap, se3_exp
from ouster_sdk_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def _pair(voxel=1.0, max_distance=30.0, cap=5):
    return (VoxelHashMap(voxel, max_distance, cap),
            DeviceVoxelMap(voxel, max_distance, cap, CPU))


def _same(host, dev) -> None:
    assert dev.empty() == host.empty()
    assert list(dev._voxels) == list(host._voxels)
    for key, pts in host._voxels.items():
        got = dev._voxels[key]
        assert got.dtype == np.float64 and np.array_equal(got, pts), key
    cloud = host.pointcloud()
    assert np.array_equal(dev.pointcloud(), cloud)
    assert dev.num_points == len(cloud)


def _cloud(rng, n, half=12.0):
    return rng.uniform(-half, half, (n, 3))


def _updates(rng):
    """Seeded clouds at random poses, some points repeated nearby."""
    for _ in range(6):
        p = _cloud(rng, 1500)
        near = p[:300] + rng.normal(0.0, 0.05, (300, 3))
        yield np.concatenate([p, near, p[:50]]), se3_exp(
            rng.normal(0.0, 0.4, 6))


def _cap(rng):
    """Few voxels, each offered far more points than the cap, spread wider
    than the admission radius: every voxel fills to the cap."""
    corners = rng.integers(-3, 3, (8, 3)).astype(np.float64)
    for _ in range(3):
        p = corners[rng.integers(0, 8, 400)] + rng.uniform(0, 1, (400, 3))
        yield p, np.eye(4)


def _radius(rng):
    """Candidates inside the admission radius of a point held, or of one
    admitted earlier in the same call (sqrt(1 / 5) = 0.447 m here)."""
    base = rng.uniform(-5, 5, (200, 3))
    for scale in (0.0, 0.2, 0.3, 0.6):
        jitter = rng.normal(0.0, scale, base.shape) if scale else 0.0
        p = np.concatenate([base + jitter, base + 1e-3])
        yield p, np.eye(4)


def _new_voxels(rng):
    """One call that creates voxels of one candidate and of several,
    interleaved in key order, beside voxels already held."""
    held = rng.uniform(-6, 6, (100, 3))
    yield held, np.eye(4)
    single = rng.uniform(-10, 10, (150, 3))
    multi = np.repeat(rng.uniform(-10, 10, (60, 3)), 3, axis=0) \
        + rng.uniform(-0.3, 0.3, (180, 3))
    p = np.concatenate([single, multi, held[:40]])
    yield p[rng.permutation(len(p))], np.eye(4)


def _prune(rng):
    """Three regions added in turn, the middle one 24 m out: a pose on the
    far side of the first prunes the voxels born in the middle of the
    map (max_distance 30 m)."""
    for centre, origin in (((0, 0, 0), (0, 0, 0)), ((24, 0, 0), (12, 0, 0)),
                           ((0, 6, 0), (0, 3, 0)), ((0, 0, 0), (-10, 0, 0))):
        pose = np.eye(4)
        pose[:3, 3] = origin
        world = np.array(centre, np.float64) + rng.uniform(-3, 3, (300, 3))
        yield world - pose[:3, 3], pose


@pytest.mark.parametrize("steps", [_updates, _cap, _radius, _new_voxels,
                                   _prune])
def test_device_map_equals_the_host_map(steps):
    host, dev = _pair()
    rng = np.random.default_rng(7)
    sizes = []
    for points, pose in steps(rng):
        host.update(points, pose)
        dev.update(points, pose)
        _same(host, dev)
        sizes.append(len(host._voxels))
    counts = [len(v) for v in host._voxels.values()]
    if steps is _cap:
        assert max(counts) == host.max_points_per_voxel
    if steps is _radius:
        assert max(counts) < host.max_points_per_voxel
    if steps is _prune:
        assert sizes[-1] < sizes[-2]


def test_the_born_order_puts_several_candidates_before_one():
    host, dev = _pair()
    # voxel keys a < b < c: b has one candidate, a and c two
    p = np.array([[0.5, 0.5, 0.5], [0.1, 0.1, 0.1],
                  [1.5, 0.5, 0.5],
                  [2.5, 0.5, 0.5], [2.1, 0.9, 0.1]])
    for m in (host, dev):
        m.add_points(p)
    keys = pack_voxel_coords(np.floor(p[[0, 3, 2]]).astype(np.int64))
    assert list(host._voxels) == list(dev._voxels) == keys.tolist()


def test_clear_and_load_keep_the_maps_equal():
    host, dev = _pair()
    rng = np.random.default_rng(3)
    for points, pose in _updates(rng):
        host.update(points, pose)
        dev.update(points, pose)
    keys = np.concatenate([np.full(len(v), k, np.int64)
                           for k, v in host._voxels.items()])
    cloud = host.pointcloud()
    host2, dev2 = _pair()
    host2.load(keys, cloud)
    dev2.load(keys, cloud)
    _same(host2, dev2)
    _same(host, dev2)
    for points, pose in _updates(rng):
        host2.update(points, pose)
        dev2.update(points, pose)
    _same(host2, dev2)
    for m in (host2, dev2):
        m.clear()
    _same(host2, dev2)
    assert dev2.empty() and dev2.device_points()[0].shape == (0, 3)
    p, pose = next(_updates(rng))
    host2.update(p, pose)
    dev2.update(p, pose)
    _same(host2, dev2)
    with pytest.raises(ValueError):
        DeviceVoxelMap(1.0, 30.0, 2, CPU).load(
            np.zeros(3, np.int64), np.zeros((3, 3)))


def test_the_icp_gets_pointcloud_order_and_a_read_only_view():
    _, dev = _pair()
    rng = np.random.default_rng(5)
    for points, pose in _updates(rng):
        dev.update(points, pose)
    pts, valid = dev.device_points()
    slots = len(dev._voxels) * dev.max_points_per_voxel
    assert pts.dtype == torch.float32 and pts.shape == (slots, 3)
    assert np.array_equal(pts[valid].numpy(),
                          dev.pointcloud().astype(np.float32))
    view = dev._voxels
    with pytest.raises(TypeError):
        view[0] = np.zeros((1, 3))
    arr = next(iter(view.values()))
    with pytest.raises(ValueError):
        arr[0, 0] = 1.0
    dev.update(*next(_updates(rng)))
    assert dev._voxels is not view


def test_an_update_counts_its_host_syncs_and_new_voxels():
    _, dev = _pair(max_distance=1000.0)
    rng = np.random.default_rng(11)
    profiling.clear()
    news = []
    with profiling.tracing(True):
        for points, pose in _updates(rng):
            before = set(dev._voxels)
            dev.update(points, pose)
            news.append(len(set(dev._voxels) - before))
    snap = profiling.snapshot()
    profiling.clear()
    syncs = [c.n for c in snap.counts if c.name == "map.host_syncs"]
    new = [c.n for c in snap.counts if c.name == "map.new_voxels"]
    assert sum(syncs) == 3 * len(news)
    assert new == news and sum(news) == len(dev._voxels)
