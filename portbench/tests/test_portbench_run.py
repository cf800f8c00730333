"""Whole runs of every cell at 16 x 256 on the CPU: the result line's
shape, and `correct` false under each fault a cell can have and under the
cell's control."""

import json
import os

import pytest

from conftest import ROOT, copy_bench, run_cell, shrink

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
REPLAY = ["os2-128-2048x10-dual.device_xyz",
          "os2-128-1024x10-single.device_xyz"]
SCANS = "os2-128-2048x10-dual.scans"
SLAM = "os2-128-2048x10-dual.slam"
SLAM_S = 5.0        # seconds: enough scans at 16 x 256 for the sample


def metrics_of(cell, kind):
    return {m["name"] for m in BENCHMARK[kind]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, cell, trace):
    rc, line = run_cell(tiny, cell, "--trace", str(trace),
                        seconds=SLAM_S if cell == SLAM else 1.0)
    assert rc == 0
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert set(line["metrics"]) <= metrics_of(cell, "per_layer")
        assert line["metrics"], "no per-layer metric read"
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == metrics_of(cell, "end_to_end")
        assert "breakdown" not in line
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", REPLAY + [SCANS, SLAM])
def test_the_control_is_not_correct(tiny, cell):
    rc, line = run_cell(tiny, cell, "--variant", "control",
                        seconds=SLAM_S if cell == SLAM else 1.0)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _patch_projection(monkeypatch, fault):
    from ouster_sdk_tpu_torch.ops.fused import ScanPipeline

    project = ScanPipeline.project_planar

    def faulty(self, *args, **kwargs):
        out = project(self, *args, **kwargs)
        xyz = list(out) if isinstance(out, tuple) else [out]
        xyz = [fault(x.clone()) for x in xyz]
        return tuple(xyz) if isinstance(out, tuple) else xyz[0]

    monkeypatch.setattr(ScanPipeline, "project_planar", faulty)


def _altered(x):
    x[..., 3, 100] += 0.01          # one coordinate, 1 cm
    return x


def _half_left_out(x):
    x[x.shape[0] // 2:] = 0
    return x


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell", REPLAY)
def test_replay_faults_are_not_correct(tiny, monkeypatch, cell, fault):
    _patch_projection(monkeypatch, fault)
    rc, line = run_cell(tiny, cell)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _patch_source(monkeypatch, fault):
    import ouster_sdk_tpu_torch as pt

    open_source = pt.open_source

    class Faulty:
        def __init__(self, *args, **kwargs):
            self.src = open_source(*args, **kwargs)

        def __iter__(self):
            return fault(iter(self.src))

        def close(self):
            self.src.close()

    monkeypatch.setattr(pt, "open_source", Faulty)


def _scan_altered(it):
    for scans in it:
        scans[0].field("SIGNAL")[5, 7] ^= 1
        yield scans


def _half_of_the_scans(it):
    for k, scans in enumerate(it):
        if k % 2 == 0:
            yield scans


@pytest.mark.parametrize("fault", [_scan_altered, _half_of_the_scans])
def test_scan_faults_are_not_correct(tiny, monkeypatch, fault):
    _patch_source(monkeypatch, fault)
    rc, line = run_cell(tiny, SCANS)
    assert rc == 0 and line["correct"] is False, line["checks"]


def _registration_altered(monkeypatch):
    from ouster_sdk_tpu_torch.slam import device_icp

    register = device_icp.register_points_device

    def faulty(*args, **kwargs):
        pose = register(*args, **kwargs).clone()
        pose[0, 3] += 0.05          # beyond register_err_m's limit
        return pose

    monkeypatch.setattr(device_icp, "register_points_device", faulty)


def _gather_altered(monkeypatch):
    from ouster_sdk_tpu_torch.slam import engine

    gather = engine.SlamEngine._gather_frame

    def faulty(self, scans, mid_pose_inv):
        pts = gather(self, scans, mid_pose_inv)
        pts[len(pts) // 2, 2] += 0.01
        return pts

    monkeypatch.setattr(engine.SlamEngine, "_gather_frame", faulty)


def _scans_left_out(monkeypatch):
    _patch_source(monkeypatch, _half_of_the_scans)


def _range_altered(monkeypatch):
    def altered(it):
        for scans in it:
            scans[0].field("RANGE")[3, 40] += 7
            yield scans

    _patch_source(monkeypatch, altered)


def _map_half_left_out(monkeypatch):
    from ouster_sdk_tpu_torch.slam import kiss_icp

    update = kiss_icp.VoxelHashMap.update

    def faulty(self, points, pose):
        update(self, points[: len(points) // 2], pose)

    monkeypatch.setattr(kiss_icp.VoxelHashMap, "update", faulty)


def _far_points_kept(monkeypatch):
    from ouster_sdk_tpu_torch.slam import kiss_icp

    monkeypatch.setattr(kiss_icp.VoxelHashMap, "remove_far_points",
                        lambda self, origin: None)


def _threshold_never_adapts(monkeypatch):
    from ouster_sdk_tpu_torch.slam import kiss_icp

    monkeypatch.setattr(kiss_icp.AdaptiveThreshold, "update_model_deviation",
                        lambda self, deviation: None)


def _source_half_left_out(monkeypatch):
    from ouster_sdk_tpu_torch.slam import kiss_icp

    voxelize = kiss_icp.KissICP.voxelize

    def faulty(self, frame):
        source, frame_downsample = voxelize(self, frame)
        return source[: len(source) // 2], frame_downsample

    monkeypatch.setattr(kiss_icp.KissICP, "voxelize", faulty)


@pytest.mark.parametrize("fault", [
    _registration_altered, _gather_altered, _scans_left_out, _range_altered,
    _map_half_left_out, _threshold_never_adapts, _source_half_left_out])
def test_slam_faults_are_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    rc, line = run_cell(tiny, SLAM, seconds=SLAM_S)
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_far_map_points_kept_is_not_correct(tmp_path, monkeypatch):
    # a 20 m range, so that a few frames of the tiny drive leave voxels
    # behind that the map has to drop
    root = copy_bench(str(tmp_path))
    shrink(root)
    path = os.path.join(root, "traffic", "slam.json")
    t = json.load(open(path))
    t["slam"]["max_range"] = 20.0
    json.dump(t, open(path, "w"))
    rc, line = run_cell(root, SLAM, seconds=SLAM_S)
    assert rc == 0 and line["correct"] is True, line["checks"]
    _far_points_kept(monkeypatch)
    rc, line = run_cell(root, SLAM, seconds=SLAM_S)
    assert rc == 0 and line["correct"] is False, line["checks"]
