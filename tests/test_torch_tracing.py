"""The port's tracer (ouster_sdk_tpu_torch/utils/profiling.py) and the spans
and counters the program records with it, on the CPU.

- Off, a span and a count record nothing; on, spans nest by thread and
  counts carry their times; the buffer is bounded and counts what it drops.
- Tracing follows torch.profiler on the profiling thread, goes with the
  staging thread that io.frames._pipelined starts, and stays off on a
  thread the program did not start.
- A span is never a profiler range; device_trace() writes the spans into
  its Chrome trace on the profiler's time base.
- A 16 x 256 replay to XYZ, open_source with XYZLut, and SlamEngine on the
  device backend record every span and counter of the program's layers,
  but the card's own (the Gauss-Newton iteration's CUDA graph).
- A wire-codec pass records an encode a frame, a pack a chunk, the bytes
  packed and the range images decoded; a planar pass records none of them.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.core.types import UDPProfileLidar
from ouster_sdk_tpu_torch.io.frames import _pipelined
from ouster_sdk_tpu_torch.utils import profiling

REPLAY = {"frames.capture_scan", "frames.stage_chunk", "frames.queue_wait",
          "frames.queue_full", "h2d_copy", "project.issue", "destagger"}
ENGINE = {"engine.admission", "engine.decode", "engine.copy_back",
          "engine.materialize", "xyzlut"}
SLAM = {"slam.predict", "slam.gather", "slam.preprocess", "slam.voxelize",
        "slam.threshold", "icp.map_upload", "icp.index_build", "icp.gn_loop",
        "map.add_points", "map.remove_far"}
# the wire path's alone (io.frames' BP64 staging and ChunkFuser, ops.bp64)
WIRE = {"frames.bp64_encode", "frames.fuse", "frames.fused_bytes",
        "bp64.decode", "bp64.ranges_decoded"}
# the card's alone: the Gauss-Newton iteration's CUDA graph (slam/device_icp)
CARD_ONLY = {"icp.graph_capture", "icp.graph_captures", "icp.graph_replays"}


@pytest.fixture
def tracer():
    """The process's tracer, emptied, following the profiler."""
    profiling.clear()
    with profiling.tracing(None):
        yield profiling
    profiling.clear()


@pytest.fixture(scope="module")
def yard(tmp_path_factory):
    """chip_smoke's yard, 6 frames at 16 x 256 dual, as a pcap; returns
    (path, info)."""
    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    info.config.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    info.config.udp_port_lidar = 7502
    path = str(tmp_path_factory.mktemp("tracing") / "yard.pcap")
    cs.yard_capture(pt, path, info, 6)
    return path, info


def names(snap) -> set:
    return {s.name for s in snap.spans} | {c.name for c in snap.counts}


def test_the_host_backend_gathers_on_the_host(tracer, yard):
    """The host backend records the gather's span and no device gather."""
    path, info = yard
    with tracer.tracing(True):
        eng = pt.slam.SlamEngine([info], pt.slam.SlamConfig(voxel_size=1.0))
        for scans in pt.open_source(path, sensor_info=[info],
                                    device="cpu"):
            eng.update(scans)
        slam = tracer.snapshot()
    assert {"slam.predict", "slam.gather", "slam.preprocess"} <= names(slam)
    assert "slam.device_gathers" not in names(slam)


def test_off_records_nothing_and_the_cost_of_a_span(tracer):
    n = 20000

    def per_span_us() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with tracer.span("x"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span_us()                 # no profiler, no switch: off
    with tracer.tracing(False):
        tracer.count("c")
        with tracer.span("y") as s:
            s.key = 3
    assert names(tracer.snapshot()) == set()
    with tracer.tracing(True):
        on = per_span_us()
    snap = tracer.snapshot()
    assert len(snap.spans) == n and snap.dropped == 0
    print(f"one span: {off:.3f} us off, {on:.3f} us on (CPU, {n} spans)")


def test_follows_the_profiler_and_the_staging_thread(tracer):
    main = threading.get_native_id()
    other = []

    def elsewhere():
        other.append(threading.get_native_id())
        with tracer.span("elsewhere"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("here"):
            pass
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(10)
        items = list(_pipelined(lambda: iter(range(5)), 1))
    assert not t.is_alive() and items == list(range(5))
    with tracer.span("after"):
        pass
    snap = tracer.snapshot()
    by = {}
    for s in snap.spans:
        by.setdefault(s.name, set()).add(s.thread)
    assert by["here"] == {main}
    assert "elsewhere" not in by and "after" not in by
    assert by["frames.queue_wait"] == {main}
    (staging,) = by["frames.queue_full"]
    assert staging not in (main, other[0])


def test_parents_nest_on_a_thread_and_counts_carry_their_times(tracer):
    with tracer.tracing(True):
        t0 = time.time_ns()
        with tracer.span("outer", key=7) as outer:
            with tracer.span("inner") as inner:
                tracer.count("n", 3)
            with tracer.span("outer"):      # folded into the outer one
                pass
        t1 = time.time_ns()
    snap = tracer.snapshot()
    spans = {s.name: s for s in snap.spans}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"].parent == 0 and spans["outer"].key == 7
    assert spans["inner"].parent == spans["outer"].id == outer.id
    assert spans["inner"].id == inner.id
    assert t0 <= spans["outer"].start_ns <= spans["inner"].start_ns \
        <= spans["inner"].end_ns <= spans["outer"].end_ns <= t1
    assert spans["outer"].cpu_ns >= 0
    (c,) = snap.counts
    assert c.name == "n" and c.n == 3
    assert spans["inner"].start_ns <= c.time_ns <= spans["inner"].end_ns
    tn, pc = snap.clock
    assert abs((tn - time.time_ns()) - (pc - time.perf_counter_ns())) < 1e7


def test_the_bound_drops_the_oldest_and_counts_them():
    tr = profiling.Tracer(limit=3)
    with tr.tracing(True):
        for k in range(5):
            with tr.span(f"s{k}"):
                pass
        for k in range(4):
            tr.count("c", k)
    snap = tr.snapshot()
    assert [s.name for s in snap.spans] == ["s2", "s3", "s4"]
    assert [c.n for c in snap.counts] == [1, 2, 3]
    assert snap.dropped == 3
    tr.clear()
    assert tr.snapshot().dropped == 0 and not tr.snapshot().spans


def test_a_span_is_no_profiler_range(tracer, yard):
    path, info = yard
    pipe = pt.ScanPipeline(info, device="cpu")
    fids, planes, hdrs, _ = next(iter(
        pt.FrameReader(path, info).iter_planar_chunks(2)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe.project_planar(planes, hdrs)
        pt.destagger_torch(out[0], pipe.shifts)
    recorded = names(tracer.snapshot())
    assert {"h2d_copy", "project.issue", "destagger"} <= recorded
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not events & recorded


def test_device_trace_holds_the_program_spans(tracer, tmp_path):
    x = torch.arange(1 << 16, dtype=torch.float32)
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("program.sum"):
            x.sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "program"]
    assert mine["name"] == "program.sum" and mine["pid"] == os.getpid()
    assert mine["tid"] == threading.get_native_id()
    ops = [e for e in events if e.get("name") == "aten::sum"
           and e.get("ph") == "X"]
    assert ops
    op = ops[0]
    # the span encloses the op, each edge within 1 ms of the op's
    assert op["ts"] - 1e3 <= mine["ts"] <= op["ts"]
    assert op["ts"] + op["dur"] <= mine["ts"] + mine["dur"] \
        <= op["ts"] + op["dur"] + 1e3


def test_every_layer_records_its_spans_and_counters(tracer, yard):
    path, info = yard
    with tracer.tracing(True):
        pipe = pt.ScanPipeline(info, device="cpu")
        reader = pt.FrameReader(path, info)
        for fids, planes, hdrs, _ in reader.iter_planar_chunks_pipelined(2):
            out = pipe.project_planar(planes, hdrs)
            [pt.destagger_torch(x, pipe.shifts) for x in out]
        replay = tracer.snapshot()
        tracer.clear()

        lut = pt.XYZLut(info)
        for scans in pt.open_source(path, sensor_info=[info],
                                    device="cpu"):
            lut(scans[0])
            lut(scans[0].field("RANGE2"))
        engine = tracer.snapshot()
        tracer.clear()

        eng = pt.slam.SlamEngine([info], pt.slam.SlamConfig(
            backend="device", voxel_size=1.0), device="cpu")
        updates = 0
        for scans in pt.open_source(path, sensor_info=[info],
                                    device="cpu"):
            eng.update(scans)
            updates += 1
        slam = tracer.snapshot()
    assert REPLAY <= names(replay)
    assert ENGINE | {"engine.d2h_copies"} <= names(engine)
    # scans decoded on the CPU are projected on the host: no card returns
    assert "xyzlut.device_returns" not in names(engine)
    assert SLAM | {"icp.gn_iterations", "icp.host_syncs", "map.host_syncs",
                   "map.new_voxels", "slam.device_gathers"} <= names(slam)
    # the device backend gathers every scan's frame on its device
    assert sum(c.n for c in slam.counts
               if c.name == "slam.device_gathers") == updates > 0
    # on the CPU the Gauss-Newton loop steps eagerly: no capture, no replay
    assert not CARD_ONLY & names(slam)
    main = threading.get_native_id()
    staged = {s.thread for s in replay.spans
              if s.name == "frames.stage_chunk"}
    assert main not in staged
    # a chunk's and a scan's spans carry its first frame id
    keys = [s.key for s in replay.spans if s.name == "frames.stage_chunk"]
    assert keys and all(isinstance(k, int) for k in keys)
    assert all(s.key is not None for s in engine.spans
               if s.name in ("engine.decode", "engine.materialize"))
    # every registration: its iterations, and a sync each, plus three (the
    # source and the initial guess copied in, the pose read back); the map
    # waits three times an update
    its = sum(c.n for c in slam.counts if c.name == "icp.gn_iterations")
    syncs = sum(c.n for c in slam.counts if c.name == "icp.host_syncs")
    loops = sum(s.name == "icp.gn_loop" for s in slam.spans)
    assert its > 0 and syncs == its + 3 * loops
    updates = sum(s.name == "map.remove_far" for s in slam.spans)
    assert sum(c.n for c in slam.counts
               if c.name == "map.host_syncs") == 3 * updates > 0
    assert set(eng._kiss.last_frame) == {"n", "m", "iterations"}
    # spans of one thread nest: a child lies inside its parent
    by_id = {s.id: s for s in slam.spans}
    for s in slam.spans:
        if s.parent in by_id:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert np.isfinite(eng.last_pose).all()


def test_a_rig_pass_records_a_collation_a_set_and_the_bytes_scanned(
        tracer, tmp_path, monkeypatch):
    """Two sensors of one capture (the benchmark's rig at 16 x 256): one
    `source.collate` span a set, none open across the pull of a scan, and
    `frames.capture_bytes` the capture's size once a sensor's reader."""
    from portbench.lib import rig
    from test_torch_rig import DATA, SEED, tiny_config

    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_DECODE", "1")
    config = tiny_config()
    path, metas = rig.write_capture(str(tmp_path), config, DATA, SEED, 4)
    with tracer.tracing(True):
        sets = list(pt.open_source(path, meta=metas, device="cpu"))
        snap = tracer.snapshot()
    assert len(sets) == 4 and all(None not in list(s) for s in sets)
    collate = [s for s in snap.spans if s.name == "source.collate"]
    assert len(collate) == len(sets)
    # the engine's work lies outside the collation: no span nests in it
    ids = {s.id for s in collate}
    assert not [s for s in snap.spans if s.parent in ids]
    scanned = [c.n for c in snap.counts if c.name == "frames.capture_bytes"]
    assert scanned == [os.path.getsize(path)] * 2
    assert sum(s.name == "frames.capture_scan" for s in snap.spans) == 2


def test_a_wire_pass_records_the_encode_the_pack_and_the_decode(tracer,
                                                                 yard):
    from ouster_sdk_tpu_torch.ops import bp64, packed
    from ouster_sdk_tpu_torch.ops.planar_kernels import words_tensor

    path, info = yard
    pipe = pt.ScanPipeline(info, device="cpu")
    fields, nbits, ups = packed.packed_range_fields(pipe.plan, pipe.dual)
    reader = pt.FrameReader(path, info)
    sizes, frames = [], 0
    with tracer.tracing(True):
        for fids, fused, layout in pt.fused_pipelined(
                lambda: reader.iter_bp64_chunks(2, fields, nbits,
                                                pool_depth=4),
                lambda item: (item[0], list(item[1:5])), 2):
            parts = packed.unfuse_words(words_tensor(fused, "cpu"), layout)
            bp64.project_bp64_batched(*parts, pipe.planar_lut.stack,
                                      pipe.plan, nbits, upshifts=ups,
                                      dual=True)
            sizes.append(fused.nbytes)
            frames += len(fids)
        wire = tracer.snapshot()
        tracer.clear()
        for _, planes, hdrs, _ in pt.FrameReader(
                path, info).iter_planar_chunks_pipelined(2):
            pipe.project_planar(planes, hdrs)
        planar = tracer.snapshot()
    spans = [s.name for s in wire.spans]
    assert frames == 6 and len(sizes) == 3
    assert spans.count("frames.bp64_encode") == frames
    assert spans.count("frames.fuse") == len(sizes)
    assert spans.count("bp64.decode") == len(sizes)
    counted = lambda name: [c.n for c in wire.counts if c.name == name]
    assert counted("frames.fused_bytes") == sizes
    assert sum(counted("bp64.ranges_decoded")) == 2 * frames
    # the encode and the pack on the staging thread, the decode on this one
    main = threading.get_native_id()
    assert all(s.thread != main for s in wire.spans
               if s.name in ("frames.bp64_encode", "frames.fuse"))
    assert all(s.thread == main for s in wire.spans
               if s.name == "bp64.decode")
    assert REPLAY - {"destagger"} <= names(planar)
    assert not WIRE & names(planar)
