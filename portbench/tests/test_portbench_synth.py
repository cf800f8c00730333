"""The synthesized captures read back, through the reference's own pcap
reader and packet decoder, to what was written; the reference's XYZ and
destagger agree with the program's on the same metadata (a cross-check of
the formula; the benchmark's runs never import the program's LUT)."""

import json
import os

import numpy as np
import pytest

from conftest import H, W, shrink, copy_bench
from portbench.lib import synth, yard
from portbench.reference import decode, lut
from portbench.reference.scan import expected_scan

DATA = {"zero_range_share": 0.05, "invalid_column_share": 0.03}


def small_meta(tmp_path, config):
    root = copy_bench(str(tmp_path))
    shrink(root)
    return json.load(open(os.path.join(root, "configs",
                                       config + ".json")))["metadata"]


@pytest.mark.parametrize("config", ["os2-128-2048x10-dual",
                                    "os2-128-1024x10-single"])
def test_packets_decode_to_what_was_written(tmp_path, config):
    meta = small_meta(tmp_path, config)
    s = synth.Sensor(meta)
    frames = list(synth.random_frames(s, DATA, 2**31 + 5, 3))
    path = synth.write_capture(str(tmp_path / "cap"), meta, frames)
    got = decode.read_datagrams(path)
    assert len(got) == 3 * s.n_pkts
    for k, frame in enumerate(frames):
        for p in range(s.n_pkts):
            ts, payload = got[k * s.n_pkts + p]
            assert len(payload) == s.packet_bytes
            assert ts == frame["pkt_ts"][p]
            d = decode.decode_packet(s, payload)
            cols = slice(p * s.cpp, (p + 1) * s.cpp)
            assert d["frame_id"] == k + 1
            assert (d["m_id"] == np.arange(s.w)[cols]).all()
            assert (d["status"] == frame["status"][cols]).all()
            assert (d["timestamp"] == frame["col_ts"][cols]).all()
            for name, values in frame["fields"].items():
                assert (d[name] == values[:, cols]).all(), name
            for name in set(s.fields) - set(frame["fields"]):
                assert not d[name].any()


def test_a_frame_is_made_again_from_seed_and_index():
    meta = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "configs",
        "os2-128-1024x10-single.json")))["metadata"]
    s = synth.Sensor(meta)
    a = synth.random_frame(s, DATA, 2**31 + 9, 5)
    b = synth.random_frame(s, DATA, 2**31 + 9, 5)
    c = synth.random_frame(s, DATA, 2**31 + 10, 5)
    assert (a["fields"]["RANGE"] == b["fields"]["RANGE"]).all()
    assert (a["fields"]["RANGE"] != c["fields"]["RANGE"]).any()
    want = expected_scan(s, a)
    bad = (a["status"] & 1) == 0
    assert bad.any() and not want["RANGE"][:, bad].any()
    assert not want["timestamp"][bad].any()


@pytest.mark.parametrize("config", ["os2-128-2048x10-dual",
                                    "os2-128-1024x10-single"])
def test_reference_xyz_and_destagger_agree_with_the_program(config):
    import torch
    import ouster_sdk_tpu_torch as pt
    from ouster_sdk_tpu_torch.ops.xyzlut import make_xyz_lut

    meta = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "configs",
        config + ".json")))["metadata"]
    info = pt.SensorInfo(json.dumps(meta))
    r = np.random.default_rng(0).integers(0, 1 << 19, (128, info.format
                                                       .columns_per_frame))
    r[:, ::7] = 0
    ref = lut.Lut(meta)(r)
    assert np.abs(ref - make_xyz_lut(info)(r)).max() < 1e-11
    shifts = info.format.pixel_shift_by_row
    want = pt.destagger_torch(torch.from_numpy(ref), shifts).numpy()
    assert (lut.destagger(ref, shifts) == want).all()


def test_rays_give_the_formula():
    meta = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "configs",
        "os2-128-2048x10-dual.json")))["metadata"]
    L = lut.Lut(meta)
    origin, step = L.rays()
    r = np.full((128, 2048), 12345)
    assert np.abs(origin + r[..., None] * step - L(r)).max() < 1e-12


def test_yard_poses_follow_the_drive():
    drive = {"speed_m": 1.0, "yaw_deg": 1.0, "ramp_frames": 10}
    P = yard.poses(np.arange(31.0), drive)
    step = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
    assert abs(step[-1] - 1.0) < 1e-3 and step[0] < 0.1
    yaw = np.arctan2(P[:, 1, 0], P[:, 0, 0])
    assert abs(np.rad2deg(yaw[-1] - yaw[-2]) - 1.0) < 1e-9
    assert (P[:, 2, 3] == yard.HEIGHT).all()


def test_yard_frames_carry_the_ray_cast(tmp_path):
    meta = small_meta(tmp_path, "os2-128-2048x10-dual")
    s = synth.Sensor(meta)
    drive = {"speed_m": 1.0, "yaw_deg": 1.0, "ramp_frames": 2}
    d = yard.cached_distances(str(tmp_path / "d.npy"), meta, drive, 2)
    assert (tmp_path / "d.npy").exists() and d.shape == (2, H, W)
    assert np.isfinite(d).mean() > 0.3
    data = {"noise_mm": 5.0, "dropout_share": 0.02, "second_share": 0.15}
    f = yard.frame(s, d[1], data, 7, 1)
    r = f["fields"]["RANGE"].astype(float)
    hit = np.isfinite(d[1]) & (r > 0)
    assert np.abs(r[hit] - d[1][hit] * 1000).max() < 40
    assert f["status"].all() and f["frame_id"] == 2
