"""The rig cell (`os2-128-2048x10-dual-rig2.scan_sets`) at 16 x 256 on the
CPU: the rig's capture read back through the reference's own pcap reader,
the reference's collation, and `correct` false under each fault the cell
can have and under its control."""

import json
import os

import numpy as np
import pytest

from conftest import copy_bench, run_cell, shrink
from portbench.lib import rig, synth
from portbench.reference import decode
from portbench.reference import rig as ref_rig

CELL = "os2-128-2048x10-dual-rig2.scan_sets"
CONFIG = "os2-128-2048x10-dual-rig2"
DATA = {"zero_range_share": 0.05, "invalid_column_share": 0.03}
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = copy_bench(str(tmp_path_factory.mktemp("rig")))
    shrink(root)
    return json.load(open(os.path.join(root, "configs", CONFIG + ".json")))


def udp_ports(path):
    """The destination port of every datagram of a classic pcap, in capture
    order (its first fragment's UDP header)."""
    data = open(path, "rb").read()
    pos, out = 24, []
    while pos + 16 <= len(data):
        incl = int(np.frombuffer(data[pos + 8:pos + 12], "<u4")[0])
        ip = data[pos + 16 + 14:pos + 16 + incl]
        pos += 16 + incl
        if int.from_bytes(ip[6:8], "big") & 0x1FFF == 0:
            ihl = (ip[0] & 15) * 4
            out.append(int.from_bytes(ip[ihl + 2:ihl + 4], "big"))
    return out


def test_the_capture_holds_each_sensor_on_its_port(tmp_path, config):
    path, metas = rig.write_capture(str(tmp_path), config, DATA, SEED, 3)
    sensors = [synth.Sensor(json.load(open(m))) for m in metas]
    got = decode.read_datagrams(path)
    ports = udp_ports(path)
    assert len(got) == len(ports) == 3 * sum(s.n_pkts for s in sensors)
    ts = [t for t, _ in got]
    assert ts == sorted(ts)
    assert [json.load(open(m))["config_params"]["udp_port_lidar"]
            for m in metas] == [7502, 7504]
    for k, sensor in enumerate(sensors):
        mine = [p for p, port in zip(got, ports)
                if port == config["rig"][k]["udp_port_lidar"]]
        assert len(mine) == 3 * sensor.n_pkts
        for index in range(3):
            frame = rig.rig_frame(config, sensor, DATA, SEED, k, index)
            for p in range(sensor.n_pkts):
                t, payload = mine[index * sensor.n_pkts + p]
                assert t == frame["pkt_ts"][p]
                words = np.frombuffer(payload, "<u4")
                assert decode._get(words, 32, 24) == sensor.init_id
                assert decode._get(words, 56, 40) == sensor.sn
    # the sensors' frames differ: a swap is seen
    a, b = (rig.rig_frame(config, s, DATA, SEED, k, 0)
            for k, s in enumerate(sensors))
    assert not np.array_equal(a["fields"]["RANGE"], b["fields"]["RANGE"])
    assert b["col_ts"][0] - a["col_ts"][0] == 25_000_000


def test_the_reference_collation():
    assert ref_rig.collate([(0, 0, 0), (1, 0, 5), (0, 1, 100), (1, 1, 105)],
                           2) == [[0, 0], [1, 1]]
    # a sensor repeats: the set is cut with the other one missing
    assert ref_rig.collate([(0, 0, 0), (0, 1, 100), (1, 1, 105)], 2) == \
        [[0, None], [1, 1]]
    # more than dt after the set's first scan: cut
    assert ref_rig.collate([(0, 0, 0), (1, 0, 300)], 2, dt_ns=210) == \
        [[0, None], [None, 0]]


def test_expected_sets_of_a_capture_missing_a_frame(config):
    full = ref_rig.expected_sets(config, DATA, SEED, 4)
    assert full == [[i, i] for i in range(4)]
    assert ref_rig.expected_sets(config, DATA, SEED, 4, missing={(1, 2)}) \
        == [[0, 0], [1, 1], [2, None], [3, 3]]


def test_the_rig_lut_moves_by_the_extrinsic(config):
    sensor = synth.Sensor(rig.sensor_metadata(config, 1))
    frame = rig.rig_frame(config, sensor, DATA, SEED, 1, 0)
    rng = frame["fields"]["RANGE"]
    a = ref_rig.RigLut(dict(config, rig=[config["rig"][0]] * 2), 1)(rng)
    b = ref_rig.RigLut(config, 1)(rng)
    hit = rng > 0
    np.testing.assert_allclose(b[hit][:, :2], -a[hit][:, :2]
                               + [-1.5, 0.0], atol=1e-12)
    np.testing.assert_allclose(b[hit][:, 2], a[hit][:, 2] - 0.2, atol=1e-12)
    assert not b[~hit].any()


def _patch_sets(monkeypatch, fault):
    import ouster_sdk_tpu_torch as pt

    open_source = pt.open_source

    class Faulty:
        def __init__(self, *args, **kwargs):
            self.src = open_source(*args, **kwargs)
            self.sensor_info = self.src.sensor_info

        def __iter__(self):
            for k, scans in enumerate(self.src):
                yield fault(k, pt.LidarScanSet(list(scans)))

        def close(self):
            self.src.close()

    monkeypatch.setattr(pt, "open_source", Faulty)


def _swapped(k, scans):
    scans[0] = scans[1]             # sensor B's scan in A's place
    return scans


def _one_dropped(k, scans):
    if k == 1:
        scans[1] = None             # the set lacks sensor B
    return scans


@pytest.mark.parametrize("fault, check", [(_swapped, "field_mismatches"),
                                          (_one_dropped, "sets_incomplete")])
def test_set_faults_are_not_correct(tiny, monkeypatch, fault, check):
    _patch_sets(monkeypatch, fault)
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"][check]["value"] > 0


def test_xyz_without_extrinsics_is_not_correct(tiny, monkeypatch):
    import ouster_sdk_tpu_torch as pt

    lut = pt.XYZLut
    monkeypatch.setattr(pt, "XYZLut",
                        lambda info, use_extrinsics=False: lut(info))
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["xyz_err_m"]["value"] > 1.0


def test_scans_off_the_engine_are_not_correct(tiny, monkeypatch):
    # the numpy batcher gives the same scans, but not through the engine
    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_DECODE", "0")
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["scans_off_engine"]["value"] > 0
    assert line["checks"]["field_mismatches"]["value"] == 0


def test_the_control_is_not_correct(tiny):
    rc, line = run_cell(tiny, CELL, "--variant", "control")
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert 1e-6 < line["checks"]["xyz_err_m"]["value"] < 1e-3
