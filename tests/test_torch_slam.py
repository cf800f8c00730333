"""The port's SLAM (ouster_sdk_tpu_torch/slam/, kernels/icp_nn.py,
utils/pose_util.py, utils/profiling.py, state.kiss_icp_from_numpy) against
the JAX package's on the same seeded inputs.

Tolerances, each with its reason:
- icp_nn_reference against `_chunked_nn` run by JAX on the CPU: the
  indices equal (0 near ties on these inputs: a differing index is
  allowed only where the two distances lie within 2 ulp of each other),
  the distances within 2 ulp (XLA's CPU lowering sums the three squares in
  its own way; the port rounds ((dx dx + dy dy) + dz dz) op by op).
- register_points_device(device="cpu") against register_points_jax on the
  inputs of tests/test_slam.py::test_jax_icp_matches_host_single_shot:
  translation within 1e-4 m, rotation within 1e-5 (other summation orders,
  and the port's 6 x 6 solve runs in float64).
- DeviceICP against JaxICP over the 4-frame drive of
  tests/test_slam.py::test_jax_icp_odometry_matches_host: within 1e-3 m,
  and so is a hand-off mid-trajectory through kiss_icp_from_numpy.
- The host backend (KissICP, SlamEngine(backend="host"),
  LocalizationEngine) is a numpy copy: equal to the JAX package's bit for
  bit.
- The device backend's frame gather on the CPU (kernels/slam_gather's
  plain version) against the host backend's numpy gather: the same points
  in the same order within 1e-12 m (the mask and the LUT product are the
  same operations; the relative poses and the rotation sum in another
  order than numpy's einsum).
The pose helpers, deskew, time correction and profiling are held in
tests/test_torch_pose_util.py.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
import chip_smoke as cs
import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu import UDPProfileLidar
from ouster_sdk_tpu.core.lidar_scan import LidarScan as JaxLidarScan
from ouster_sdk_tpu.core.metadata import \
    sensor_info_from_metadata as jax_sensor_info
from ouster_sdk_tpu.slam import engine as jengine
from ouster_sdk_tpu.slam import jax_icp
from ouster_sdk_tpu.slam import kiss_icp as jkiss
from ouster_sdk_tpu_torch.kernels.icp_nn import (build_icp_index, icp_nn,
                                                 icp_nn_reference)
from ouster_sdk_tpu_torch.slam import device_icp as tdev
from ouster_sdk_tpu_torch.slam import engine as tengine
from ouster_sdk_tpu_torch.slam import kiss_icp as tkiss
from ouster_sdk_tpu_torch.utils.pose_util import interp_pose_pair
from test_slam import _random_world

CFG = dict(voxel_size=0.5, min_range=0.5, max_range=200)
MOTION = np.eye(4)
MOTION[:3, 3] = [0.5, 0.05, 0.0]


def _single_shot():
    """The inputs of test_jax_icp_matches_host_single_shot."""
    world = _random_world()
    vm = jkiss.VoxelHashMap(voxel_size=1.0, max_distance=200.0,
                            max_points_per_voxel=20)
    vm.add_points(world)
    T = jkiss.se3_exp(np.array([0.3, -0.2, 0.1, 0.02, -0.01, 0.03]))
    scan = ((world - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    return scan, vm.pointcloud().astype(np.float32), T


def _pad(a: np.ndarray, n: int):
    """JaxICP's padding: zeros past the rows, and their valid mask."""
    out = np.zeros((n, 3), np.float32)
    out[:len(a)] = a
    valid = np.zeros(n, bool)
    valid[:len(a)] = True
    return out, valid


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("voxel,masked", [(1.0, False), (0.5, True)])
def test_icp_nn_reference_matches_chunked_nn(voxel, masked):
    scan, mp, _ = _single_shot()
    M = jax_icp._bucket(max(len(mp), jax_icp._MAP_CHUNK), jax_icp._MAP_CHUNK)
    mpad, mvalid = _pad(mp, M)
    if masked:
        mvalid[:len(mp)] = np.random.default_rng(1).random(len(mp)) > 0.3
    jd, ji = jax_icp._chunked_nn(jnp.asarray(scan), jnp.asarray(mpad),
                                 jnp.asarray(mvalid), jnp.float32(voxel))
    jd, ji = np.asarray(jd), np.asarray(ji)
    valid_t = torch.from_numpy(mvalid[:len(mp)]) if masked else None
    td, ti = icp_nn_reference(torch.from_numpy(scan), torch.from_numpy(mp),
                              valid_t, voxel)
    td, ti = td.numpy(), ti.numpy()
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td)) and fin.mean() > 0.9
    assert (ji[~fin] == 0).all() and (ti[~fin] == 0).all()
    assert _ulps(jd[fin], td[fin]).max() <= 2
    assert int((ji != ti).sum()) == 0    # no near ties on these inputs
    # the wrapper's CPU route (its own chunking) gives the same result
    wd, wi = icp_nn(torch.from_numpy(scan), torch.from_numpy(mp), valid_t,
                    voxel)
    assert torch.equal(wi, torch.from_numpy(ti))
    assert torch.equal(wd.view(torch.int32), torch.from_numpy(td)
                       .view(torch.int32))


@pytest.mark.parametrize("voxel,masked", [(1.0, False), (0.5, True)])
def test_icp_nn_with_a_prebuilt_index_equals_the_reference(voxel, masked):
    """The index form, icp_nn(src, index=build_icp_index(...)), as a
    registration calls it: on the CPU the index holds the inputs and the
    search is icp_nn_reference's, bit for bit; no kernel is launched."""
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn

    scan, mp, _ = _single_shot()
    valid = (torch.from_numpy(np.random.default_rng(2).random(len(mp)) > 0.3)
             if masked else None)
    src, map_t = torch.from_numpy(scan), torch.from_numpy(mp)
    nn.reset_launches()
    index = build_icp_index(map_t, valid, voxel)
    assert index.device.type == "cpu" and index.cells is None
    want_d, want_i = icp_nn_reference(src, map_t, valid, voxel)
    for q in (src, src[::3] + 0.1):
        got_d, got_i = icp_nn(q, index=index)
        ref_d, ref_i = icp_nn_reference(q, map_t, valid, voxel)
        assert torch.equal(got_i, ref_i)
        assert torch.equal(got_d.view(torch.int32), ref_d.view(torch.int32))
    assert torch.equal(icp_nn(src, index=index)[1], want_i)
    assert all(n == 0 for n in nn.launches.values())
    with pytest.raises(ValueError):
        icp_nn(src, map_t, valid, voxel, index=index)
    with pytest.raises(ValueError):
        build_icp_index(map_t, valid, 0.0)


def test_register_points_device_matches_register_points_jax():
    scan, mp, T = _single_shot()
    N = jax_icp._bucket(len(scan))
    M = jax_icp._bucket(max(len(mp), jax_icp._MAP_CHUNK), jax_icp._MAP_CHUNK)
    sp, sv = _pad(scan, N)
    mpad, mv = _pad(mp, M)
    want = np.asarray(jax_icp.register_points_jax(
        jnp.asarray(sp), jnp.asarray(sv), jnp.asarray(mpad),
        jnp.asarray(mv), jnp.asarray(np.eye(4), jnp.float32),
        jnp.float32(1.0), jnp.float32(0.3), voxel_size=jnp.float32(1.0)))
    stats = {}
    got = tdev.register_points_device(
        torch.from_numpy(scan), None, torch.from_numpy(mp), None,
        torch.eye(4), 1.0, 0.3, voxel_size=1.0, stats=stats).numpy()
    assert np.linalg.norm(got[:3, 3] - want[:3, 3]) <= 1e-4
    assert np.abs(got[:3, :3] - want[:3, :3]).max() <= 1e-5
    assert np.linalg.norm(got[:3, 3] - T[:3, 3]) < 0.02
    assert stats["iterations"] > 1


def test_register_points_device_takes_padded_rows():
    """src_valid and map_valid mask rows as JaxICP's padding does: padded
    inputs give the pose of the unpadded ones."""
    world = _random_world(800, seed=5)
    T = jkiss.se3_exp(np.array([0.2, 0.1, 0.0, 0.0, 0.0, 0.02]))
    scan = ((world - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    mp = world.astype(np.float32)
    sp, sv = _pad(scan, 1024)
    mpad, mv = _pad(mp, 1024)
    args = (torch.eye(4), 1.0, 0.3)
    want = tdev.register_points_device(torch.from_numpy(scan), None,
                                       torch.from_numpy(mp), None, *args,
                                       voxel_size=1.0)
    got = tdev.register_points_device(
        torch.from_numpy(sp), torch.from_numpy(sv), torch.from_numpy(mpad),
        torch.from_numpy(mv), *args, voxel_size=1.0)
    assert np.abs(got.numpy() - want.numpy()).max() <= 1e-6
    assert np.linalg.norm(want.numpy()[:3, 3] - T[:3, 3]) < 0.05


@pytest.mark.parametrize("case", cs.GN_CASES)
def test_register_points_device_on_the_cpu_steps_eagerly(case):
    """On the CPU the Gauss-Newton loop runs _gn_step eagerly (the card
    replays it as a CUDA graph): the pose is the step's own after as many
    iterations, bit for bit, to the same stop; the tracer counts an
    iteration and a sync each, and no capture or replay."""
    from ouster_sdk_tpu_torch.utils import profiling

    def as_t(a):
        return None if a is None else torch.from_numpy(a)

    for src, sv, mp, mv, init, mcd, ks, max_iters in cs.gn_cases(case):
        src, sv, mp, mv, init = map(as_t, (src, sv, mp, mv, init))
        cur, T_icp, stop, fx = tdev._setup(src, sv, mp, mv, init, mcd, ks,
                                           1.0, 1e-4)
        eager = []
        for _ in range(max_iters):
            tdev._gn_step(cur, T_icp, stop, fx)
            eager.append(tdev._mm(T_icp, init))
            if bool(stop):
                break
        st = {}
        profiling.clear()
        with profiling.tracing(True):
            got = tdev.register_points_device(
                src, sv, mp, mv, init, mcd, ks, voxel_size=1.0,
                max_iters=max_iters, stats=st)
        snap = profiling.snapshot()
        profiling.clear()
        counts = {}
        for c in snap.counts:
            counts[c.name] = counts.get(c.name, 0) + c.n
        assert st["iterations"] == len(eager)
        assert torch.equal(got.view(torch.int32),
                           eager[-1].view(torch.int32))
        assert counts == {"icp.gn_iterations": len(eager),
                          "icp.host_syncs": len(eager)}
        assert "icp.graph_capture" not in {s.name for s in snap.spans}
    if case in ("first", "few"):
        assert len(eager) == 1
    if case == "max_iters":
        assert len(eager) == 3 and not bool(stop)


def _drive(icp, world, n=4):
    """test_jax_icp_odometry_matches_host's drive."""
    est, T = [], np.eye(4)
    for _ in range(n):
        frame = (world - T[:3, 3]) @ T[:3, :3]
        guess = np.eye(4) if len(est) < 2 else est[-1] @ np.linalg.solve(
            est[-2], est[-1])
        if len(est) == 1:
            guess = est[-1]
        est.append(icp.register_frame(frame, guess))
        T = T @ MOTION
    return est


def test_kiss_icp_and_device_icp_match_the_jax_package():
    world = _random_world(6000, seed=1)
    host_j = _drive(jkiss.KissICP(jkiss.KissConfig(**CFG)), world)
    host_t = _drive(tkiss.KissICP(tkiss.KissConfig(**CFG)), world)
    for a, b in zip(host_j, host_t):
        assert np.array_equal(a, b)
    dev_j = _drive(jax_icp.JaxICP(jkiss.KissConfig(**CFG)), world)
    icp = tdev.DeviceICP(tkiss.KissConfig(**CFG), device="cpu")
    dev_t = _drive(icp, world)
    for a, b in zip(dev_j, dev_t):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-3
    assert icp.last_frame["iterations"] > 0 and icp.last_frame["m"] > 0


def _export(k):
    keys = np.concatenate([np.full(len(v), key, np.int64)
                           for key, v in k.local_map._voxels.items()])
    return (k.local_map.pointcloud(), keys, k.adaptive_threshold._model_sse,
            k.adaptive_threshold._num_samples, k._frame_count)


def test_hand_off_mid_trajectory_through_kiss_icp_from_numpy():
    """Two frames in the JAX package, then its state into the port's
    KissICP and DeviceICP; both continue two more frames beside it."""
    world = _random_world(6000, seed=1)
    frames = [(world - T[:3, 3]) @ T[:3, :3] for T in
              (np.linalg.matrix_power(MOTION, k) for k in range(4))]
    for jcls, backend in ((jkiss.KissICP, "host"),
                          (jax_icp.JaxICP, "device")):
        j = jcls(jkiss.KissConfig(**CFG))
        est = [j.register_frame(frames[0], np.eye(4))]
        est.append(j.register_frame(frames[1], est[-1]))
        t = pt.kiss_icp_from_numpy(tkiss.KissConfig(**CFG), *_export(j),
                                   backend=backend, device="cpu")
        assert type(t) is (tdev.DeviceICP if backend == "device"
                           else tkiss.KissICP)
        assert np.array_equal(t.local_map.pointcloud(),
                              j.local_map.pointcloud())
        ej, et = list(est), list(est)
        for f in frames[2:]:
            ej.append(j.register_frame(f, ej[-1] @ np.linalg.solve(
                ej[-2], ej[-1])))
            et.append(t.register_frame(f, et[-1] @ np.linalg.solve(
                et[-2], et[-1])))
        for a, b in zip(ej[2:], et[2:]):
            if backend == "host":
                assert np.array_equal(a, b)
            else:
                assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-3
        assert _export(t)[2:] == _export(j)[2:]
    with pytest.raises(ValueError):
        pt.kiss_icp_from_numpy(tkiss.KissConfig(), np.zeros((2, 3)),
                               np.zeros(3, np.int64), 4.0, 1, 0)


def _yard(n=4, w=256, h=16):
    """The chip run's yard at a small size, as the port's scans and the
    JAX package's (the same metadata string and fields)."""
    info = cs.synth_info(cs.MAIN_PROFILE, w=w, h=h)
    jinfo = jax_sensor_info(info.to_json_string())
    # the metadata string carries no lidar profile: set it as synth_info does
    jinfo.format.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    for key in ("beam_altitude_angles", "beam_azimuth_angles"):
        assert np.array_equal(getattr(jinfo, key), getattr(info, key))
    assert list(jinfo.format.pixel_shift_by_row) == list(
        info.format.pixel_shift_by_row)
    scans, _ = cs.yard_scans(pt, info, n)
    jscans = []
    for s in scans:
        j = JaxLidarScan(jinfo)
        for name in ("RANGE", "RANGE2", "REFLECTIVITY"):
            j.field(name)[:] = s.field(name)
        j.status[:] = s.status
        j.timestamp[:] = s.timestamp
        j.packet_timestamp[:] = s.packet_timestamp
        j.frame_id = s.frame_id
        jscans.append(j)
    return info, jinfo, scans, jscans


def test_slam_engines_match_the_jax_package():
    """SlamEngine host backend against the JAX package's (equal poses and
    per-column poses), and the device backend on the CPU against the JAX
    package's "tpu" backend (within 1e-3 m)."""
    info, jinfo, scans, jscans = _yard()
    cfg = dict(voxel_size=1.0)
    runs = {}
    for name, eng, ss in (
            ("host", tengine.SlamEngine([info], tengine.SlamConfig(**cfg)),
             copy.deepcopy(scans)),
            ("jax host", jengine.SlamEngine([jinfo],
                                            jengine.SlamConfig(**cfg)),
             copy.deepcopy(jscans)),
            ("device", tengine.SlamEngine(
                [info], tengine.SlamConfig(backend="device", **cfg),
                device="cpu"), copy.deepcopy(scans)),
            ("jax tpu", jengine.SlamEngine(
                [jinfo], jengine.SlamConfig(backend="tpu", **cfg)),
             copy.deepcopy(jscans))):
        out = []
        for s in ss:
            eng.update([s])
            out.append((eng.last_pose.copy(), s.pose.copy()))
        runs[name] = out
    for (a, pa), (b, pb) in zip(runs["host"], runs["jax host"]):
        assert np.array_equal(a, b) and np.array_equal(pa, pb)
    for (a, pa), (b, pb) in zip(runs["device"], runs["jax tpu"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-3
        assert np.abs(pa[:, :3, 3] - pb[:, :3, 3]).max() <= 1e-3
    # LocalizationEngine against a prior map, host backend: equal
    prior = np.random.default_rng(2).uniform([-40, -40, 0], [40, 40, 8],
                                             (3000, 3))
    lt = tengine.LocalizationEngine([info], prior, tengine.SlamConfig(**cfg))
    lj = jengine.LocalizationEngine([jinfo], prior, jengine.SlamConfig(**cfg))
    for s, j in zip(copy.deepcopy(scans[:2]), copy.deepcopy(jscans[:2])):
        lt.update([s])
        lj.update([j])
        assert np.array_equal(lt.last_pose, lj.last_pose)


GATHER_CASES = ("zero_ranges", "status_cleared", "range_limits",
                "all_invalid", "none_scan", "two_sensors", "localization")


def _gather_scan(info, seed: int):
    """A scan of `info`: ranges up to 120 m, a tenth of them zero, a fifth
    of the columns invalid, and the column poses of a turn 120 m from the
    origin."""
    rng = np.random.default_rng(seed)
    s = pt.LidarScan(info)
    r = rng.integers(1, 120_000, (s.h, s.w))
    r[rng.random(r.shape) < 0.1] = 0
    s.field("RANGE")[:] = r
    s.status[:] = rng.random(s.w) >= 0.2
    p0 = tkiss.se3_exp(rng.normal(0.0, 0.3, 6))
    p0[:3, 3] += [120.0, -40.0, 3.0]
    p1 = p0 @ tkiss.se3_exp(rng.normal(0.0, 0.05, 6))
    s.pose[:] = interp_pose_pair(np.linspace(0.0, 1.0, s.w), p0, p1)
    return s


@pytest.mark.parametrize("case", GATHER_CASES)
def test_device_gather_equals_the_host_gather(case):
    """SlamEngine._gather_frame of the device backend on the CPU against
    the host backend's on the same scans: the same N and point order,
    within 1e-12 m; the array returned is the caller's (the next gather
    leaves it alone)."""
    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    infos = [info]
    if case in ("none_scan", "two_sensors"):
        other = copy.deepcopy(info)
        other.extrinsic = tkiss.se3_exp(np.array([0.4, -1.2, 0.3, 0.1,
                                                  -0.05, 1.4]))
        infos.append(other)
    scans = [_gather_scan(i, 7 + k) for k, i in enumerate(infos)]
    s = scans[0]
    r = s.field("RANGE")
    if case == "zero_ranges":
        r[:, ::3] = 0
        r[5] = 0
    elif case == "status_cleared":
        s.status[::4] = 0
        s.status[1::4] = 2           # another bit set, bit 0 clear
    elif case == "range_limits":
        limits = np.array([4999, 5000, 5001, 99999, 100000, 100001])
        r[:] = np.resize(limits, r.size).reshape(r.shape)
    elif case == "all_invalid":
        s.status[:] = 0
    elif case == "none_scan":
        scans[0] = None
    mid_inv = np.linalg.inv(scans[-1].pose[info.format.columns_per_frame
                                           // 2])
    cfg = dict(voxel_size=1.0)
    if case == "localization":
        prior = np.random.default_rng(2).uniform([-40, -40, 0], [40, 40, 8],
                                                 (3000, 3))
        host = tengine.LocalizationEngine(infos, prior,
                                          tengine.SlamConfig(**cfg))
        dev = tengine.LocalizationEngine(
            infos, prior, tengine.SlamConfig(backend="device", **cfg),
            device="cpu")
    else:
        host = tengine.SlamEngine(infos, tengine.SlamConfig(**cfg))
        dev = tengine.SlamEngine(
            infos, tengine.SlamConfig(backend="device", **cfg), device="cpu")
    want = host._gather_frame(scans, mid_inv)
    got = dev._gather_frame(scans, mid_inv)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape
    if case == "all_invalid":
        assert got.shape == (0, 3)
    else:
        assert len(got) > 0
        assert np.abs(got - want).max() <= 1e-12
    if case == "range_limits":
        # 5000 and 100 000 mm lie on the limits: 5001 and 99 999 pass
        assert len(got) == np.count_nonzero(
            s.status[None, :] & 1 & np.isin(r, [5001, 99999]))
    kept = got.copy()
    dev._gather_frame([_gather_scan(i, 30 + k) for k, i in enumerate(infos)],
                      mid_inv)
    assert np.array_equal(got, kept)


def test_backend_names_and_devices():
    _, pinfo = _torch_helpers.infos(_torch_helpers.DUAL)
    with pytest.raises(ValueError, match='"device"'):
        tengine.SlamEngine([pinfo], tengine.SlamConfig(backend="tpu"))
    with pytest.raises(ValueError, match="unknown SLAM backend"):
        tengine.SlamEngine([pinfo], tengine.SlamConfig(backend="gpu"))
    # the host backend needs no device
    assert tengine.SlamEngine([pinfo]).device is None
    eng = tengine.SlamEngine([pinfo], tengine.SlamConfig(backend="device"),
                             device="cpu")
    assert eng.device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.SlamEngine([pinfo], tengine.SlamConfig(backend="device"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.LocalizationEngine([pinfo], np.zeros((4, 3)),
                                   tengine.SlamConfig(backend="device"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.DeviceICP()
