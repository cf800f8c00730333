"""A rig of two sensors in one capture (the benchmark's rig configuration,
portbench/lib/rig.py) replayed through the port's open_source on the engine
route, at 16 x 256 on the CPU, against the benchmark's plain reference
(portbench/reference/rig.py).

- Every set the reference's collation gives, in order: each scan's fields
  and column headers equal to what was written, its XYZ with the sensor's
  extrinsic (XYZLut with use_extrinsics) within 1e-9 m of the float64
  reference in the rig's frame; every scan decoded by the engine, one
  DeviceScanIterator a sensor.
- A capture in which sensor B lacks a frame yields that frame's set with B
  None, as the reference's collation rule gives.
- The rig's two streams share a packet size but not a port: the source
  does not call them ambiguous, so it stays on the engine.
"""

import json
import os

import numpy as np
import pytest

import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.io import device_engine as de
from portbench.lib import rig, synth
from portbench.reference import compare
from portbench.reference import rig as ref_rig
from portbench.reference.scan import expected_scan, unwritten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "os2-128-2048x10-dual-rig2.json")
H, W, N, SEED = 16, 256, 5, 2**31 + 91
DATA = {"zero_range_share": 0.05, "invalid_column_share": 0.03}
HEADERS = ("timestamp", "measurement_id", "status", "packet_timestamp")


def tiny_config():
    """The rig's configuration with its shared sensor cut to H x W (as the
    benchmark's tests cut it)."""
    c = json.load(open(CONFIG))
    m = c["metadata"]
    f = m["lidar_data_format"]
    f["pixels_per_column"], f["columns_per_frame"] = H, W
    f["column_window"] = [0, W - 1]
    f["pixel_shift_by_row"] = f["pixel_shift_by_row"][:H]
    b = m["beam_intrinsics"]
    b["beam_altitude_angles"] = b["beam_altitude_angles"][::128 // H]
    b["beam_azimuth_angles"] = b["beam_azimuth_angles"][:H]
    m["config_params"]["lidar_mode"] = f"{W * 2}x10"
    return c


@pytest.fixture
def engine(monkeypatch):
    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_DECODE", "1")


def replay(path, metas, config):
    """open_source's sets of the capture, with each sensor's XYZ of both
    returns in the rig's frame; and the scans the engine handed out."""
    exts = [rig.extrinsic(config, k) for k in range(len(metas))]
    before = de.stats["scans"]
    src = pt.open_source(path, meta=metas, extrinsics=exts, device="cpu")
    try:
        assert not src._device_ambiguous()
        luts = [pt.XYZLut(info, use_extrinsics=True)
                for info in src.sensor_info]
        out = []
        for scans in src:
            out.append([None if s is None else
                        (s, [lut(s), lut(s.field("RANGE2"))])
                        for s, lut in zip(scans, luts)])
    finally:
        src.close()
    return out, de.stats["scans"] - before


def hold(out, want, config):
    """Each set against the reference's: the same frames a sensor, every
    field and column header as written, XYZ within 1e-9 m."""
    sensors = [synth.Sensor(rig.sensor_metadata(config, k))
               for k in range(len(config["rig"]))]
    luts = [ref_rig.RigLut(config, k) for k in range(len(sensors))]
    assert [[None if s is None else s[0].frame_id - 1 for s in got]
            for got in out] == want
    for got in out:
        for k, item in enumerate(got):
            if item is None:
                continue
            scan, xyz = item
            frame = rig.rig_frame(config, sensors[k], DATA, SEED, k,
                                  scan.frame_id - 1)
            exp = expected_scan(sensors[k], frame)
            have = {n: np.asarray(scan.field(n)) for n in sensors[k].fields
                    if scan.has_field(n)}
            have.update({n: np.asarray(getattr(scan, n)) for n in HEADERS})
            have["frame_id"] = np.array([scan.frame_id])
            assert compare.mismatches(
                have, exp, unwritten(sensors[k], frame)) == 0, (k, scan)
            for r, name in enumerate(("RANGE", "RANGE2")):
                err = np.abs(xyz[r] - luts[k](exp[name])).max()
                assert err < 1e-9, (k, scan.frame_id, name, err)


def test_the_rig_replays_to_the_reference_sets(tmp_path, engine):
    config = tiny_config()
    path, metas = rig.write_capture(str(tmp_path), config, DATA, SEED, N)
    out, engine_scans = replay(path, metas, config)
    hold(out, ref_rig.expected_sets(config, DATA, SEED, N), config)
    assert len(out) == N
    assert engine_scans == 2 * N


def test_a_frame_missing_from_one_sensor(tmp_path, engine):
    config = tiny_config()
    missing = {(1, 2)}
    path, metas = rig.write_capture(str(tmp_path), config, DATA, SEED, N,
                                    missing=missing)
    want = ref_rig.expected_sets(config, DATA, SEED, N, missing=missing)
    assert [2, None] in want
    out, engine_scans = replay(path, metas, config)
    hold(out, want, config)
    assert engine_scans == 2 * N - 1


def test_the_rig_ports_are_not_ambiguous(tmp_path, engine):
    config = tiny_config()
    path, metas = rig.write_capture(str(tmp_path), config, DATA, SEED, 1)
    src = pt.open_source(path, meta=metas, device="cpu")
    try:
        assert [i.config.udp_port_lidar for i in src.sensor_info] == \
            [7502, 7504]
        assert not src._device_ambiguous()
        assert src._device_route()
        # the same two sensors on one port would be
        src.sensor_info[1].config.udp_port_lidar = 7502
        assert src._device_ambiguous()
    finally:
        src.close()
