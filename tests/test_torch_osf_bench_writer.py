"""The benchmark's own OSF writer (portbench/lib/osf_write.py) against the
port's reader and an independent one, at 16 x 256 on the CPU.

- The port's OsfScanSource reads every scan of the recording equal to the
  frames the seed makes (reference/osf_scan.py), one collated set of one
  scan at a time, its XYZ cache within half a float32 unit of the float64
  reference, at chunk sizes that put all, several and one message in a
  chunk.
- The port's own `save`, at its defaults, records the same scans as the
  same streams, messages, timestamps and collations.
- Each PNG channel is byte for byte what the port's encode_field_png
  makes of the destaggered field at the recording's level.
- tests/osf_oracle.py (the pip flatbuffers runtime and libpng) reads the
  same scans and collations from the file.
- The replay records one `osf.decode` span a scan, one `png.inflate` a
  channel, one `osf.project` a collated set, and counts every channel
  decoded and every range image projected.
"""

import json
import os

import numpy as np
import pytest

import ouster_sdk_tpu_torch as pt
import osf_oracle
from ouster_sdk_tpu_torch.io import osf
from ouster_sdk_tpu_torch.io.save import _save_osf
from ouster_sdk_tpu_torch.ops.destagger import destagger
from ouster_sdk_tpu_torch.utils import flatbuf as fb
from ouster_sdk_tpu_torch.utils import png, profiling
from portbench.lib import osf_write, synth, yard
from portbench.reference import compare, lut, osf_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "os2-128-2048x10-dual-osf.json")
H, W, N, SEED = 16, 256, 6, 2**31 + 77
DATA = {"noise_mm": 5.0, "dropout_share": 0.02, "second_share": 0.15}
DRIVE = {"speed_m": 1.0, "yaw_deg": 1.0, "ramp_frames": 2}
HEADERS = ("timestamp", "measurement_id", "status", "packet_timestamp",
           "alert_flags")


def tiny_metadata():
    """The configuration's sensor cut to H x W (as portbench's tests cut
    it)."""
    m = json.load(open(CONFIG))["metadata"]
    f = m["lidar_data_format"]
    f["pixels_per_column"], f["columns_per_frame"] = H, W
    f["column_window"] = [0, W - 1]
    f["pixel_shift_by_row"] = f["pixel_shift_by_row"][:H]
    b = m["beam_intrinsics"]
    b["beam_altitude_angles"] = b["beam_altitude_angles"][::128 // H]
    b["beam_azimuth_angles"] = b["beam_azimuth_angles"][:H]
    m["config_params"]["lidar_mode"] = f"{W * 2}x10"
    return m


@pytest.fixture(scope="module")
def drive():
    """(metadata, sensor, the drive's frames)."""
    m = tiny_metadata()
    sensor = synth.Sensor(m)
    dist = yard.distances(m, DRIVE, N)
    return m, sensor, [yard.frame(sensor, dist[k], DATA, SEED, k)
                       for k in range(N)]


def record(tmp_path, drive, chunk_size):
    m, sensor, frames = drive
    rec = dict(json.load(open(CONFIG))["recording"], chunk_size=chunk_size)
    path = str(tmp_path / "rec.osf")
    st = osf_write.write_recording(path, m, rec, frames)
    return path, rec, st


@pytest.mark.parametrize("chunk_size", [2 * 1024 * 1024, 50_000, 1])
def test_the_port_reads_the_recording_as_the_seed_made_it(tmp_path, drive,
                                                          chunk_size):
    m, sensor, frames = drive
    path, rec, st = record(tmp_path, drive, chunk_size)
    msg_bytes = len(osf_write.scan_message(
        sensor, frames[0], osf_write.recorded_fields(sensor, rec), 1))
    set_bytes = len(osf_write.collation_message(0))
    # a chunk closes once its messages reach chunk_size
    chunks = sum(-(-N // -(-chunk_size // n)) for n in (msg_bytes, set_bytes))
    assert st["frames"] == N and st["chunks"] == chunks
    fields = osf_write.recorded_fields(sensor, rec)
    assert fields == ["RANGE", "RANGE2", "SIGNAL", "SIGNAL2", "REFLECTIVITY",
                      "REFLECTIVITY2", "NEAR_IR", "FLAGS", "FLAGS2"]
    ref = lut.Lut(m)
    src = pt.open_source(path, device="cpu")
    try:
        assert src.is_collated() and len(src) == N
        xyzlut = pt.XYZLut(src.sensor_info[0])
        n = 0
        for k, scans in enumerate(src):
            assert len(scans) == 1
            scan = scans[0]
            want = osf_scan.expected(sensor, frames[k], fields)
            got = {name: np.array(scan.field(name)) for name in fields}
            got.update({h: np.array(getattr(scan, h)) for h in HEADERS})
            got["frame_id"] = np.array([scan.frame_id])
            assert compare.mismatches(got, want) == 0
            for name in fields:
                assert scan.field(name).dtype == \
                    osf_write.field_dtype(sensor, name)
            xyz = [xyzlut(scan), xyzlut.return_xyz(scan, 1)]
            for got_k, ref_k in zip(xyz, osf_scan.xyz(ref, want,
                                                      sensor.returns)):
                assert compare.ulp_error(got_k, ref_k) <= 0.5 + 1e-3
            n += 1
        assert n == N
    finally:
        src.close()


@pytest.mark.parametrize("chunk_size", [2 * 1024 * 1024, 50_000, 1])
def test_the_ports_save_records_the_same_streams(tmp_path, drive,
                                                 chunk_size):
    path, rec, _ = record(tmp_path, drive, chunk_size)
    src = pt.open_source(path, device="cpu")
    try:
        saved = str(tmp_path / "saved.osf")
        assert _save_osf(saved, src.sensor_info, list(src), None,
                         chunk_size=chunk_size) == N
    finally:
        src.close()
    ours, theirs = osf.Reader(path), osf.Reader(saved)
    try:
        assert [(e.id, e.type) for e in sorted(ours.entries.values(),
                                               key=lambda e: e.id)] == \
            [(e.id, e.type) for e in sorted(theirs.entries.values(),
                                            key=lambda e: e.id)]
        assert ours.collation_stream_id is not None
        assert ours.collation_stream_id == theirs.collation_stream_id
        got, want = list(ours.messages()), list(theirs.messages())
        assert [(m.id, m.ts, m.ts_sensor) for m in got] == \
            [(m.id, m.ts, m.ts_sensor) for m in want]
        assert ours.chunk_offsets["start_ts"].tolist() == \
            theirs.chunk_offsets["start_ts"].tolist()
        assert [len(ours._chunk_messages(int(o)))
                for o in ours.chunk_offsets["offset"]] == \
            [len(theirs._chunk_messages(int(o)))
             for o in theirs.chunk_offsets["offset"]]
        for a, b in zip(got, want):
            if a.id == ours.collation_stream_id:
                assert osf.decode_collation_msg(a.buffer) == \
                    osf.decode_collation_msg(b.buffer)
    finally:
        ours.close()
        theirs.close()


def test_each_channel_is_the_ports_png_of_the_field(drive):
    m, sensor, frames = drive
    rec = json.load(open(CONFIG))["recording"]
    fields = osf_write.recorded_fields(sensor, rec)
    shifts = m["lidar_data_format"]["pixel_shift_by_row"]
    for level in (rec["compression_level"], 6):
        msg = fb.root_auto(osf_write.scan_message(sensor, frames[1], fields,
                                                  level))
        chans = msg.vector_tables(0)
        assert len(chans) == len(fields)
        for name, ch in zip(fields, chans):
            dt = osf_write.field_dtype(sensor, name)
            img = frames[1]["fields"].get(name, np.zeros((H, W), dt))
            assert ch.vector_bytes(0) == png.encode_field_png(
                destagger(shifts, img.astype(dt)), level), name


def test_an_independent_reader_reads_the_same_scans(tmp_path, drive):
    if not osf_oracle.HAVE_FB or osf_oracle.png_oracle() is None:
        pytest.skip("the pip flatbuffers runtime or libpng is missing")
    m, sensor, frames = drive
    path, rec, _ = record(tmp_path, drive, 120_000)
    out = osf_oracle.read_osf(path)
    assert out["status"] == 2 and len(out["scans"]) == N
    fields = osf_write.recorded_fields(sensor, rec)
    for k, scan in enumerate(out["scans"]):
        want = osf_scan.expected(sensor, frames[k], fields)
        got = dict(scan["fields"], frame_id=np.array([scan["frame_id"]]))
        got.update({h: scan[h] for h in HEADERS})
        assert compare.mismatches(got, want) == 0
        assert scan["ts"] == frames[k]["pkt_ts"][0]
    assert [c["scan_ids"] for c in out["collations"]] == \
        [[(0, k)] for k in range(N)]


def test_the_replay_records_its_spans_and_counters(tmp_path, drive):
    m, sensor, frames = drive
    path, rec, _ = record(tmp_path, drive, 2 * 1024 * 1024)
    profiling.clear()
    try:
        with profiling.tracing(True):
            src = pt.open_source(path, device="cpu")
            xyzlut = pt.XYZLut(src.sensor_info[0])
            for scans in src:
                xyzlut(scans[0])
            src.close()
        snap = profiling.snapshot()
    finally:
        profiling.clear()
    spans = [s.name for s in snap.spans]
    counts = {}
    for c in snap.counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    fields = len(rec["fields"])
    assert spans.count("osf.decode") == N
    assert spans.count("png.inflate") == fields * N
    assert spans.count("osf.project") == N
    assert counts["osf.fields_decoded"] == fields * N
    assert counts["osf.images_projected"] == 2 * N
    # each inflate lies inside a decode on its thread
    by_id = {s.id: s for s in snap.spans}
    for s in snap.spans:
        if s.name == "png.inflate":
            assert by_id[s.parent].name == "osf.decode"
