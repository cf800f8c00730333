"""The port's multi-device face (ouster_sdk_tpu_torch.parallel) on meshes of
CPU "devices", [cpu] * k for k in {2, 4}, against the unsharded port and
against the JAX package on the 8-device CPU mesh of tests/conftest.py.

Tolerance: 0 differing elements for every projection, pipeline output and
the multi-sensor step's XYZ. The step's centroid is a float32 sum of every
XYZ, reduced in another order on each side (XLA's reduction tree and two
psums; torch's sum a block, then the blocks in mesh order): rtol 1e-5
against the JAX package and against a float64 sum of the port's XYZ.
fuse_multi_sensor_clouds is `cloud @ R.T + t`: the port's matmul and XLA's
dot accumulate in their own order (none of the six orders of three
products, fused or not, gives XLA's bits), so it is held within 2 f32 ulp
of the terms' magnitude sum_k |R_ik x_k| + |t_i| of the JAX package's
cloud (measured: 169 of 1200 elements differ, by at most 2.4e-7) and
within 1e-6 of the float64 product (both sides within 3.0e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ouster_sdk_tpu_torch as pt
from _torch_helpers import (DUAL, SINGLE, batch, frame_packets,
                            frames_batch, infos, lidar_stream, poses,
                            write_pcap)
from ouster_sdk_tpu.io.frames import FrameReader as JaxFrameReader
from ouster_sdk_tpu.ops.fused import ScanPipeline as JaxScanPipeline
from ouster_sdk_tpu.parallel import sharding as jsh
from ouster_sdk_tpu_torch.parallel import (Sharded, fuse_multi_sensor_clouds,
                                           make_mesh, make_mesh_2d,
                                           shard_frames,
                                           sharded_multi_sensor_step,
                                           sharded_pipeline)

CPU = torch.device("cpu")


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _pipes(profile):
    jinfo, pinfo = infos(profile)
    return jinfo, JaxScanPipeline(jinfo), pt.ScanPipeline(pinfo, device="cpu")


def _joined(out):
    return tuple(o.join() for o in out) if isinstance(out, tuple) \
        else out.join()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", ["single", "dual", "dual_poses"])
def test_sharded_project_matches(k, case):
    """ScanPipeline.sharded(mesh).project: the blocks live on the mesh's
    devices and join to the unsharded project_planar's bits and to the JAX
    package's sharded projection. With poses the first return alone is
    projected, as in the JAX package."""
    jinfo, jpipe, pipe = _pipes(SINGLE if case == "single" else DUAL)
    planes, hdrs = batch(jinfo, jpipe.cfg.plan, seeds=range(1, 9))
    P_ = poses(8, pipe.plan.w, seed=4) if case == "dual_poses" else None
    sp = pipe.sharded(make_mesh(devices=[CPU] * k))
    assert sp.n_shards == k
    got = sp.project(sp.shard(planes), sp.shard(hdrs),
                     None if P_ is None else sp.shard(P_))
    blocks = got if isinstance(got, tuple) else (got,)
    assert len(blocks) == (2 if case == "dual" else 1)
    for b in blocks:
        assert len(b.shards) == k and b.shape == (8, 3, 32, 256)
        assert all(s.shape[0] == 8 // k for s in b.shards)
    got = _joined(got)
    ref = pipe.project_planar(planes, hdrs, poses=P_)
    if case == "dual_poses":
        ref = ref[0]
    # the JAX package's XLA twin dewarps in another rounding order than
    # its Pallas kernel, which the port follows: poses take the kernel
    # (interpret mode)
    jsp = jpipe.sharded(jsh.make_mesh(k),
                        engine="xla" if P_ is None else "pallas")
    want = jsp.project(jsp.shard(planes), jsp.shard(hdrs),
                       None if P_ is None else jsp.shard(P_))
    for g, r, w in zip(*(x if isinstance(x, tuple) else (x,)
                         for x in (got, ref, want))):
        _same(g.numpy(), r.numpy())
        _same(g.numpy(), np.asarray(w))
    # numpy inputs are sharded on the way in, and __call__ is project
    for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (_joined(sp(planes, hdrs, P_)), got))):
        _same(g.numpy(), r.numpy())


def test_divisibility_and_no_cpu_fallback():
    _, _, pipe = _pipes(SINGLE)
    sp = pipe.sharded(make_mesh(devices=[CPU] * 4))
    with pytest.raises(ValueError, match="not divisible"):
        sp.shard(np.zeros((6, 4, 32, 256), dtype=np.uint32))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        next(sp.map_source(None, chunk=6))
    with pytest.raises(ValueError, match="not divisible"):
        shard_frames(make_mesh(devices=[CPU] * 4), np.zeros((3, 2)))
    with pytest.raises(ValueError, match="3 devices asked for"):
        make_mesh(3, devices=[CPU, CPU])
    if not torch.cuda.is_available():
        # no list of devices: every CUDA device, and no CPU fallback
        for fn in (make_mesh, lambda: make_mesh_2d(1, 1), pipe.sharded):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()


@pytest.mark.parametrize("k", [2, 4])
def test_map_source_pads_the_tail(tmp_path, k):
    """6 frames in chunks of 8: the tail is padded with copies of its last
    frame, only the real frame ids are reported, and every frame's XYZ is
    the unsharded call's and the JAX package's map_source's."""
    jinfo, jpipe, pipe = _pipes(SINGLE)
    path = write_pcap(str(tmp_path / "six.pcap"), lidar_stream(
        [frame_packets(jinfo, fid, seed=1) for fid in range(1, 7)]))
    reader = pt.FrameReader(path, pipe.info)
    fids, planes, hdrs, _ = next(reader.iter_planar_chunks(8))
    ref = pipe.project_planar(planes, hdrs).numpy()
    sp = pipe.sharded(make_mesh(devices=[CPU] * k))
    for pipelined in (True, False):
        out = list(sp.map_source(reader, chunk=8, pipelined=pipelined))
        assert len(out) == 1
        got_fids, xyz = out[0]
        assert got_fids.tolist() == [1, 2, 3, 4, 5, 6]
        assert xyz.shape == (8, 3, 32, 256)
        xyz = xyz.join().numpy()
        _same(xyz[:6], ref)
        _same(xyz[6], ref[5])
        _same(xyz[7], ref[5])
    jsp = jpipe.sharded(jsh.make_mesh(k), engine="xla")
    (jfids, jxyz), = list(jsp.map_source(JaxFrameReader(path, info=jinfo),
                                         chunk=8))
    assert jfids.tolist() == got_fids.tolist()
    _same(xyz, np.asarray(jxyz))


def test_sharded_pipeline_matches():
    """The packet-layout pipeline over a batch split on two devices: every
    joined entry equals the unsharded ScanPipeline.batch, and XYZ, XYZ2 and
    RANGE equal the JAX package's sharded_pipeline."""
    jinfo, jpipe, pipe = _pipes(DUAL)
    frames = frames_batch(jinfo, jpipe.cfg.plan, seeds=(1, 2, 3, 4))
    P_ = poses(4, pipe.plan.w, seed=2)
    mesh = make_mesh(devices=[CPU] * 2)
    got = sharded_pipeline(pipe, mesh)(frames, P_)
    ref = pipe.batch(frames, torch.from_numpy(P_))
    assert sorted(got) == sorted(ref)
    for key, v in got.items():
        assert isinstance(v, Sharded) and len(v.shards) == 2
        _same(v.join().numpy(), ref[key].numpy(), key)
    jmesh = jsh.make_mesh(2)
    shard = NamedSharding(jmesh, P("batch"))
    want = jsh.sharded_pipeline(jpipe, jmesh)(
        jax.device_put(jnp.asarray(frames), shard),
        jax.device_put(jnp.asarray(P_), shard))
    for key in ("XYZ", "XYZ2", "RANGE"):
        _same(got[key].join().numpy(), np.asarray(want[key]), key)


def _rig(S, w=64, h=16):
    """S sensors of one rig (the JAX test's: beams tilted by a degree a
    sensor), each as (JAX SensorInfo, port SensorInfo)."""
    from __graft_entry__ import _make_info
    from ouster_sdk_tpu.core.metadata import sensor_info_from_metadata

    out = []
    for s in range(S):
        info = _make_info(w=w, h=h, dual=False)
        info.config.udp_port_lidar = 7502
        info.beam_altitude_angles = list(np.linspace(20.0 - s, -20.0 - s, h))
        meta = info.to_json_string()
        out.append((sensor_info_from_metadata(meta),
                    pt.sensor_info_from_metadata(meta)))
    return out


@pytest.mark.parametrize("posed", [False, True])
def test_multi_sensor_step_on_a_2d_mesh(posed):
    """(sensor, frame) mesh of 2 x 2 CPU devices: per-sensor LUTs on the
    sensor axis, XYZ bit-equal to the unsharded pipeline and to the JAX
    package's, the centroid within rtol 1e-5 of the JAX package's step and
    of a float64 sum. With identity poses (the JAX package's own test) the
    JAX step's XYZ is bit-equal too; with random poses it is not even its
    own pipeline's bits (its sensor vmap lowers the dewarp einsum in
    another order), so there the port is held to the JAX pipeline, sensor
    by sensor."""
    S, F = 2, 4
    rig = _rig(S)
    jpipes = [JaxScanPipeline(j) for j, _ in rig]
    pipes = [pt.ScanPipeline(p, device="cpu") for _, p in rig]
    frames = np.stack([frames_batch(j, jp.cfg.plan, seeds=range(1, F + 1))
                       for (j, _), jp in zip(rig, jpipes)])
    P_ = (np.stack([poses(F, 64, seed=s) for s in range(S)]) if posed else
          np.broadcast_to(np.eye(4, dtype=np.float32), (S, F, 64, 4, 4)))
    step, luts = sharded_multi_sensor_step(
        pipes, make_mesh_2d(S, 2, devices=[CPU] * 4))
    assert tuple(luts.dir_hi.shape) == (S, 16, 64, 3)
    xyz, centroid = step(frames, luts, P_)
    assert xyz.blocks.shape == (2, 2) and xyz.shape == (S, F, 16, 64, 3)
    xyz = xyz.join().numpy()

    jmesh = jsh.make_mesh_2d(S, 2)
    jstep, jluts = jsh.sharded_multi_sensor_step(jpipes, jmesh)
    with jmesh:
        sf = NamedSharding(jmesh, P("sensor", "frame"))
        jxyz, jcentroid = jstep(
            jax.device_put(jnp.asarray(frames), sf),
            jax.device_put(jluts, NamedSharding(jmesh, P("sensor"))),
            jax.device_put(jnp.asarray(P_), sf))
    if not posed:
        _same(xyz, np.asarray(jxyz))
    total, count = np.zeros(3), 0
    for s in range(S):
        out = pipes[s].batch(frames[s], torch.from_numpy(P_[s].copy()))
        _same(xyz[s], out["XYZ"].numpy())
        want = jpipes[s]._batch(jnp.asarray(frames[s]), jpipes[s].lut,
                                jnp.asarray(P_[s]))
        _same(xyz[s], np.asarray(want["XYZ"]))
        total += out["XYZ"].numpy().astype(np.float64).sum(axis=(0, 1, 2))
        count += int((out["RANGE"].view(torch.int32) != 0).sum())
    np.testing.assert_allclose(centroid.numpy(), np.asarray(jcentroid),
                               rtol=1e-5)
    np.testing.assert_allclose(centroid.numpy(), total / count, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_fuse_multi_sensor_clouds(k):
    rng = np.random.default_rng(3)
    S, N = 8, 50
    clouds = rng.normal(size=(S, N, 3)).astype(np.float32)
    ext = np.broadcast_to(np.eye(4), (S, 4, 4)).copy()
    ext[:, :3, :3] = np.linalg.qr(rng.normal(size=(S, 3, 3)))[0]
    ext[:, :3, 3] = rng.normal(size=(S, 3))
    ext = ext.astype(np.float32)
    got = fuse_multi_sensor_clouds(make_mesh(axis_name="sensor",
                                             devices=[CPU] * k),
                                   clouds, ext)
    assert tuple(got.shape) == (S * N, 3) and got.dtype == torch.float32
    jmesh = jsh.make_mesh(k, axis_name="sensor")
    shard = NamedSharding(jmesh, P("sensor"))
    want = np.asarray(jsh.fuse_multi_sensor_clouds(
        jmesh, jax.device_put(jnp.asarray(clouds), shard),
        jax.device_put(jnp.asarray(ext), shard)))
    got = got.numpy()
    mag = np.concatenate([np.abs(clouds[i]) @ np.abs(ext[i, :3, :3]).T
                          + np.abs(ext[i, :3, 3]) for i in range(S)])
    assert (np.abs(got - want) <= 2 * np.spacing(mag)).all()
    f64 = np.concatenate([clouds[i].astype(np.float64) @ ext[i, :3, :3].T
                          + ext[i, :3, 3] for i in range(S)])
    np.testing.assert_allclose(got, f64, atol=1e-6)
