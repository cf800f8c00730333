"""The port stands alone: no module of ouster_sdk_tpu_torch imports jax or
the JAX package, it runs with both made unimportable, its entry points
default to CUDA and raise without it, and a CPU tensor launches no
kernel."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ouster_sdk_tpu_torch as pt
from _torch_helpers import DUAL, batch, infos, words
from ouster_sdk_tpu_torch.ops import lutfree_kernels as lf
from ouster_sdk_tpu_torch.ops import packet_kernels as pkt
from ouster_sdk_tpu_torch.ops import planar_kernels as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ouster_sdk_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ouster_sdk_tpu")


def _modules():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(_modules()) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imported(tree):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_runs_with_jax_unimportable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.core.types import (DataFormat, LidarMode,
                                                     UDPProfileLidar)
        info = pt.default_sensor_info(LidarMode(1024, 10))
        info.format = DataFormat(
            pixels_per_column=16, columns_per_packet=16,
            columns_per_frame=128, pixel_shift_by_row=[3, 2, 1, 0] * 4,
            column_window=(0, 127),
            udp_profile_lidar=UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_DUAL)
        info.beam_azimuth_angles = [0.0] * 16
        info.beam_altitude_angles = list(np.linspace(10, -10, 16))
        pipe = pt.ScanPipeline(info, device="cpu")
        rng = np.random.default_rng(0)
        planes = rng.integers(0, 1 << 19, (2, 4, 16, 128), dtype=np.uint32)
        hdrs = np.full((2, 3, 128), 1 << 16, dtype=np.uint32)
        fields = pipe.decode_planar(planes, hdrs)
        xyz, xyz2 = pipe.project_planar(planes, hdrs)
        assert xyz.shape == (2, 3, 16, 128) and torch.isfinite(xyz).all()
        assert fields["RANGE"].dtype == torch.uint32
        plan = pipe.plan
        frames = rng.integers(0, 1 << 32, (2, plan.n_pkts, plan.pkt_words),
                              dtype=np.uint32)
        out = pipe.batch(frames, np.tile(np.eye(4, dtype=np.float32),
                                         (2, plan.w, 1, 1)))
        assert out["XYZ2"].shape == (2, 16, 128, 3)
        assert torch.isfinite(out["XYZ"]).all()
        pxyz, _ = pt.unpack_project_packet_batched(
            torch.from_numpy(frames.view(np.int32)),
            *pt.lut_planes(pipe.planar_lut), plan, dual=True)
        staggered = pt.ScanPipeline(info, device="cpu", destagger=False)
        assert torch.equal(pxyz.movedim(1, -1),
                           staggered.batch(frames)["XYZ"])
        tables = pt.FactorTables(info, device="cpu")
        assert pt.lutfree_supported(info)
        words = torch.from_numpy(frames.view(np.int32))
        lxyz, lxyz2 = pt.unpack_project_lutfree_dd(words, tables, plan,
                                                   dual=True)
        assert lxyz.shape == (2, 3, 16, 128) and torch.isfinite(lxyz2).all()
        # the LUT projection and the LUT-free one: both within 1 f32 ulp
        # of float64, so at most 1 ulp apart
        assert torch.allclose(lxyz, pxyz, rtol=3e-7, atol=1e-7)
        assert pt.unpack_project_lutfree(words[0], tables, plan).shape == (
            3, 16, 128)
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_viewer_and_examples_run_with_jax_unimportable(tmp_path):
    """ouster_sdk_tpu_torch.viz, .examples (every module) and
    .slam.ply_to_png with jax and the JAX package made unimportable: one
    software snapshot of a scan and one top-down render of a point
    cloud."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import ouster_sdk_tpu_torch as pt
        import ouster_sdk_tpu_torch.examples as examples
        import ouster_sdk_tpu_torch.viz as viz
        from ouster_sdk_tpu_torch.core.types import LidarMode
        from ouster_sdk_tpu_torch.io.cloud_io import write_pointcloud
        from ouster_sdk_tpu_torch.slam.ply_to_png import ply_to_png
        for m in pkgutil.iter_modules(examples.__path__):
            importlib.import_module("ouster_sdk_tpu_torch.examples."
                                    + m.name)
        info = pt.default_sensor_info(LidarMode(512, 10))
        scan = pt.LidarScan(info)
        rng = np.random.default_rng(0)
        scan.field("RANGE")[:] = rng.integers(500, 30000, (scan.h, scan.w))
        scan.status[:] = 1
        snap = viz.ls_show(scan, info, path={str(tmp_path / "s.png")!r})
        ply = {str(tmp_path / "c.ply")!r}
        write_pointcloud(ply, rng.normal(size=(2000, 3)).astype(np.float32))
        top = ply_to_png(ply, {str(tmp_path / "c.png")!r})
        for path in (snap, top):
            with open(path, "rb") as f:
                data = f.read()
            assert data[:8] == b"\\x89PNG\\r\\n\\x1a\\n" and len(data) > 1000
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

def test_wire_and_parallel_run_with_jax_unimportable(tmp_path):
    """ops.packed, ops.bp64, the wire stagings of io.frames and parallel/
    with jax and the JAX package made unimportable: a capture staged packed
    and BP64, fused, decoded and projected on the CPU, equal to the planar
    path, then split over two CPU devices."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.ops import bp64, packed
        from ouster_sdk_tpu_torch import parallel
        info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
        path = {str(tmp_path / "wire.pcap")!r}
        cs.synth_capture(path, info, 5)
        pipe = pt.ScanPipeline(info, device="cpu")
        fields, nbits, ups = packed.packed_range_fields(pipe.plan, True)
        reader = pt.FrameReader(path, info)
        _, planes, hdrs, _ = next(reader.iter_planar_chunks(8))
        want = pipe.project_planar(planes, hdrs)
        for it, fn in ((reader.iter_packed_chunks,
                        packed.project_packed_batched),
                       (reader.iter_bp64_chunks, bp64.project_bp64_batched)):
            for _, fused, layout in pt.fused_pipelined(
                    lambda: it(8, fields=fields, nbits=nbits),
                    lambda item: (item[0], list(item[1:-1]))):
                parts = packed.unfuse_words(
                    torch.from_numpy(fused.view(np.int32)), layout)
                got = fn(*parts, pipe.planar_lut.stack, pipe.plan, nbits,
                         upshifts=ups, dual=True)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
        sp = pipe.sharded(parallel.make_mesh(devices=["cpu", "cpu"]))
        (fids, xyz), = list(sp.map_source(reader, chunk=6))
        assert fids.tolist() == [1, 2, 3, 4, 5]
        assert torch.equal(xyz[0].join()[:5], want[0])
        if not torch.cuda.is_available():
            try:
                parallel.make_mesh()
                raise AssertionError("make_mesh() without CUDA")
            except RuntimeError:
                pass
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_engine_runs_with_jax_unimportable():
    """The device engine end to end (capture, iterator, index, live
    batcher, projector) and the chip smoke run's jax-free synthesizer,
    with jax and the JAX package made unimportable."""
    code = textwrap.dedent(f"""
        import os, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        info = cs.synth_info(cs.MAIN_PROFILE, w=128, h=16)
        tmp = tempfile.mkdtemp()
        main, path = os.path.join(tmp, "m.pcap"), os.path.join(tmp, "e.pcap")
        cs.synth_capture(main, info, 2)
        assert cs.engine_capture(path, main, info, 2) == 5
        packets = cs.capture_packets(pt, info, path)
        oracle = cs.batcher_scans(pt, info, packets)
        it = pt.DeviceScanIterator(path, info, device="cpu", batch=2)
        got = list(it.iter_released())
        cs.hold_scans(got, oracle, "iterator")
        index = pt.DeviceScanIndex(it)
        assert len(index) == 5 and index.scan_at(3) == got[3][1]
        live = pt.LiveDeviceBatcher(info, device="cpu")
        scans = [s for _, p in packets
                 for s in live.push(p.buf, p.host_timestamp)]
        assert len(scans) == 4 and all(s.fields_deferred for s in scans)
        assert all(a == b for a, (_, b) in zip(scans, oracle))
        pt.OsfDeviceProjector([info], device="cpu").attach(
            [(0, s) for s in scans])
        xyz = scans[0].cached_xyz(1, True, scans[0].field("RANGE2"))
        assert xyz.shape == (16, 128, 3) and np.isfinite(xyz).all()
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sources_run_with_jax_unimportable():
    """open_source over a pcap (engine route on the CPU, and the numpy
    batcher) with jax and the JAX package unimportable, the native library
    built from the port's own copy of its source into a fresh directory."""
    code = textwrap.dedent(f"""
        import os, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.utils import native
        tmp = tempfile.mkdtemp()
        native.BUILD_DIR = os.path.join(tmp, "build")
        assert native.SOURCE.startswith({PORT!r} + os.sep)
        assert native.get_lib() is not None and native.build_seconds > 0
        assert os.listdir(native.BUILD_DIR)
        info = cs.synth_info(cs.MAIN_PROFILE, w=128, h=16)
        path = os.path.join(tmp, "m.pcap")
        cs.synth_capture(path, info, 3)
        oracle = cs.batcher_scans(pt, info, cs.capture_packets(pt, info,
                                                               path))
        for env in ("1", "0"):
            os.environ["OUSTER_SDK_TPU_DEVICE_DECODE"] = env
            native.reset_calls()
            pt.io.device_engine.stats["batches"] = 0
            got = [ls[0] for ls in pt.open_source(path, sensor_info=[info],
                                                  device="cpu")]
            assert got == [s for _, s in oracle] and len(got) == 3
            assert (pt.io.device_engine.stats["batches"] > 0) == (env == "1")
            assert native.calls["pcap_scan"] == (env == "1")
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_osf_runs_with_jax_unimportable():
    """OSF recording and replay (PNG and zPNG, the projector on the CPU
    and the policy off) and the file operations, with jax and the JAX
    package unimportable."""
    code = textwrap.dedent(f"""
        import os, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.io import osf, osf_ops
        from ouster_sdk_tpu_torch.ops import planar_kernels as pk
        info = cs.synth_info(cs.MAIN_PROFILE, w=128, h=16)
        tmp = tempfile.mkdtemp()
        cap = os.path.join(tmp, "m.pcap")
        cs.synth_capture(cap, info, 3)
        scans = [s for _, s in cs.batcher_scans(
            pt, info, cs.capture_packets(pt, info, cap))]
        path = os.path.join(tmp, "x.osf")
        cs.write_osf(path, [info], scans)
        for env in ("1", "0"):
            os.environ["OUSTER_SDK_TPU_DEVICE_DECODE"] = env
            got = [ls[0] for ls in pt.open_source(path, device="cpu")]
            assert all(cs.scans_differ(a, b) == 0 for a, b in zip(got,
                                                                  scans))
            if env == "1":
                n_diff, worst, n_img = cs.hold_osf_xyz(
                    torch, pt, pk, torch.device("cpu"), info, got)
                assert n_diff == 0 and worst <= 1.0 and n_img == 6
            else:
                assert got[0].cached_xyz(0, False,
                                         got[0].field("RANGE")) is None
        z = os.path.join(tmp, "z.osf")
        with osf.Writer(z, encoder="zpng") as w:
            w.add_sensor(info)
            for s in scans:
                w.save(0, s)
        back = [m.decode() for m in osf.Reader(z).messages()]
        assert all(cs.scans_differ(a, b) == 0 for a, b in zip(back, scans))
        assert osf_ops.osf_info(z)["scan_messages"] == {{2: 3}}
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_slam_normals_downsample_run_with_jax_unimportable(tmp_path):
    """open_source -> SlamEngine on both backends (the device one on the
    CPU), kiss_icp_from_numpy, normals_device, scan_normals,
    voxel_downsample_device, pose_util and profiling, with jax and the JAX
    package made unimportable."""
    code = textwrap.dedent(f"""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch import slam
        from ouster_sdk_tpu_torch.utils import pose_util, profiling
        info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
        path = {str(tmp_path / "yard.pcap")!r}
        cs.yard_capture(pt, path, info, 4)
        poses = {{}}
        for backend in ("host", "device"):
            eng = slam.SlamEngine([info], slam.SlamConfig(
                backend=backend, voxel_size=1.0), device="cpu")
            for scans in pt.open_source(path, sensor_info=[info],
                                        device="cpu"):
                eng.update(scans)
            poses[backend] = eng.last_pose
        assert np.abs(poses["host"] - poses["device"]).max() < 1e-3
        k = eng._kiss
        keys = np.concatenate([np.full(len(v), key)
                               for key, v in k.local_map._voxels.items()])
        twin = pt.kiss_icp_from_numpy(
            k.config, k.local_map.pointcloud(), keys,
            k.adaptive_threshold._model_sse,
            k.adaptive_threshold._num_samples, k._frame_count,
            backend="device", device="cpu")
        assert np.array_equal(twin.local_map.pointcloud(),
                              k.local_map.pointcloud())
        scan = scans[0]
        pt.scan_normals(scan, info, backend="device", device="cpu")
        assert scan.field("NORMALS").shape == (16, 256, 3)
        assert scan.has_field("NORMALS2")
        xyz = pt.make_xyz_lut(info)(scan.field("RANGE")).reshape(-1, 3)
        cent, mask = pt.voxel_downsample_device(
            torch.from_numpy(xyz.astype(np.float32)), 0.5, 4096)
        assert 0 < int(mask.sum()) < 4096
        T = pose_util.exp_pose6([0.1, 0.0, 0.2, 1.0, 2.0, 3.0],
                                device="cpu")
        assert np.allclose(pose_util.log_pose(T, device="cpu"),
                           [0.1, 0.0, 0.2, 1.0, 2.0, 3.0], atol=1e-5)
        with profiling.device_trace(os.path.dirname(path)) as d:
            torch.ones(4).sum()
        assert os.path.exists(os.path.join(d, "trace.json"))
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_cli_util_and_pose_optimizer_run_without_click(tmp_path):
    """ouster_sdk_tpu_torch.cli and cli.util import, and run_benchmark,
    system_info and the pose optimizer run, with click blocked as well as
    jax and the JAX package; asking for the click group then raises."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "ouster_sdk_tpu", "click"):
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        import ouster_sdk_tpu_torch.cli as cli
        from ouster_sdk_tpu_torch.cli import util
        from ouster_sdk_tpu_torch.core.types import UDPProfileLidar
        from ouster_sdk_tpu_torch.slam import pose_optimizer as po
        info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
        info.config.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
        info.config.udp_port_lidar = 7502
        path = {str(tmp_path / "yard.pcap")!r}
        truth = cs.yard_capture(pt, path, info, 3)
        with open(path[:-5] + ".json", "w") as f:
            f.write(info.to_json_string())
        lines = []
        report = util.run_benchmark(path, frames=2, echo=lines.append,
                                    device="cpu")
        assert sorted(report) == ["pcap", "sys_info", "times"]
        assert {{"device_xyz", "icp_host", "icp_device"}} <= set(
            report["times"])
        assert any("icp_device" in ln for ln in lines)
        assert sorted(util.system_info(True)) == [
            "cpuinfo", "devices", "packages", "platform"]
        opt = po.PoseOptimizer.from_trajectory(
            [0, 1, 2], list(truth), po.SolverConfig(
                max_num_iterations=5, process_printout=False))
        opt.add_constraint(po.AbsolutePoseConstraint(2, truth[0]))
        assert len(opt.solve()) == 3
        try:
            cli.cli
        except ImportError:
            pass
        else:
            raise AssertionError("the click group imported without click")
        assert "click" not in sys.modules or sys.modules["click"] is None
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda():
    _, pinfo = infos(DUAL)
    if torch.cuda.is_available():
        assert pt.ScanPipeline(pinfo).device.type == "cuda"
        assert pt.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.ScanPipeline(pinfo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.default_device()
    assert pt.ScanPipeline(pinfo, device="cpu").device.type == "cpu"


def test_cpu_tensors_launch_no_kernel():
    jinfo, pinfo = infos(DUAL)
    pipe = pt.ScanPipeline(pinfo, device="cpu")
    planes, hdrs = batch(jinfo, pipe.plan)
    pk.reset_launches()
    assert set(pk.launches) == set(pk.CASES)
    pipe.project_planar(planes, hdrs)
    pipe.project_planar(planes, hdrs,
                        poses=np.tile(np.eye(4, dtype=np.float32),
                                      (2, pipe.plan.w, 1, 1)))
    pk.unpack_project_planar_batched(words(planes), words(hdrs),
                                     pipe.planar_lut.stack, pipe.plan,
                                     dual=True)
    assert all(n == 0 for n in pk.launches.values())


def test_cpu_tensors_launch_no_packet_kernel():
    from _torch_helpers import frames_batch

    jinfo, pinfo = infos(DUAL)
    pipe = pt.ScanPipeline(pinfo, device="cpu")
    frames = frames_batch(jinfo, pipe.plan)
    pkt.reset_launches()
    assert set(pkt.launches) == set(pkt.CASES)
    planes = pt.lut_planes(pipe.planar_lut)
    pt.unpack_project_packet_batched(words(frames), *planes, pipe.plan,
                                     dual=True)
    pt.unpack_project_packet(words(frames[0]), *planes, pipe.plan)
    pt.unpack_project(words(frames[0]), pipe.lut, pipe.plan)
    pipe.batch(frames)
    pipe(frames[0])
    assert all(n == 0 for n in pkt.launches.values())


def test_cpu_tensors_launch_no_lutfree_kernel():
    from _torch_helpers import frames_batch

    jinfo, pinfo = infos(DUAL)
    plan = pt.make_decode_plan(pinfo)
    frames = frames_batch(jinfo, plan)
    planes, hdrs = batch(jinfo, plan)
    tables = pt.FactorTables(pinfo, device="cpu")
    lf.reset_launches()
    assert set(lf.launches) == set(lf.CASES)
    pt.unpack_project_lutfree(words(frames), tables, plan)
    pt.unpack_project_lutfree_dd(words(frames), tables, plan)
    pt.unpack_project_lutfree_dd(words(frames[0]), tables, plan, dual=True)
    pt.unpack_project_lutfree_planar(words(planes), words(hdrs), tables,
                                     plan)
    assert all(n == 0 for n in lf.launches.values())


def test_cpu_tensors_launch_no_icp_nn_kernel():
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.slam.device_icp import register_points_device

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(0, 10, (300, 3)).astype(np.float32))
    nn.reset_launches()
    assert set(nn.launches) == set(nn.CASES)
    nn.icp_nn(pts, pts, None, 1.0)
    register_points_device(pts + 0.05, None, pts, None, torch.eye(4), 1.0,
                           0.3, voxel_size=1.0)
    assert all(n == 0 for n in nn.launches.values())


def test_wrapper_rejects_other_devices_and_precisions():
    jinfo, pinfo = infos(DUAL)
    pipe = pt.ScanPipeline(pinfo, device="cpu")
    planes, hdrs = batch(jinfo, pipe.plan)
    with pytest.raises(ValueError, match="precision"):
        pk.unpack_project_planar_batched(words(planes), words(hdrs),
                                         pipe.planar_lut.stack, pipe.plan,
                                         precision="f64")
    with pytest.raises(ValueError, match="not meta"):
        pk.unpack_project_planar_batched(
            words(planes).to("meta"), words(hdrs).to("meta"),
            pipe.planar_lut.stack.to("meta"), pipe.plan, dual=True)
    with pytest.raises(ValueError, match="poses must be"):
        pipe.project_planar(planes, hdrs,
                            poses=np.tile(np.eye(4, dtype=np.float32),
                                          (2, pipe.plan.w - 1, 1, 1)))


def test_sensor_runs_with_jax_unimportable():
    """The live layer with jax and the JAX package unimportable: the
    port's emulator (HTTP plane, mDNS advertiser, paced UDP) serving
    open_source("127.0.0.1:<port>") on the CPU, its scans equal to the
    ScanBatcher's over the packets received, and the planar assembler's
    frames through decode_planar + project_planar."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["ouster_sdk_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import chip_smoke as cs
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch.sensor.emulator import SensorEmulator
        info, frames = cs.live_sensor(cs.MAIN_PROFILE, 256, 992240000060, 4,
                                      seed=2, h=16)
        got, _, _, src, seen = cs.live_run(pt, [info], [frames], 2.0,
                                           device="cpu")
        assert src.engine_used == ["device"] and got
        assert all(not s.fields_deferred for _, s in got)   # touched
        assert cs.hold_live(pt, [info], got, seen, "isolated") >= 1
        emu = SensorEmulator(info, cs.paced(frames), rate=4.0, mdns=True,
                             mdns_port=0).start()
        try:
            h = pt.SensorHttp.create(f"127.0.0.1:{{emu.http_port}}")
            assert pt.sensor_info_from_metadata(h.metadata()).sn == info.sn
            assert emu.mdns_port > 0
        finally:
            emu.stop()
        asm = pt.PlanarStreamAssembler(info)
        rel = [asm.push(p) for f in frames for p in f] + [asm.flush()]
        fid, planes, hdrs, _ = [r for r in rel if r is not None][0]
        pipe = pt.ScanPipeline(info, device="cpu")
        xyz, xyz2 = pipe.project_planar(planes[None], hdrs[None])
        assert fid == 1 and xyz.shape == (1, 3, 16, 256)
        assert pipe.decode_planar(planes, hdrs)["RANGE"].shape == (16, 256)
        assert not any(m == "jax" or m.startswith(("jax.", "ouster_sdk_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
