"""The port's derived views (ouster_sdk_tpu_torch.io.derived) against the
JAX package's, on the CPU: ScanSource.reduce / clip / mask and their
chain over open_source(pcap) (the port's engine on the CPU, the JAX
package's numpy batcher), the scan functions (clip, clip_scan, mask_scan,
filter_field, filter_uv, filter_xyz, reduce_scan) on the same scans, and
the three trouble spots of the host layer: a scan whose pixel fields still
wait on a deferred fill, the OSF replay's XYZ cache (served while RANGE is
unchanged, missed once a view changes it, absent after reduce), and a
reduced SensorInfo carrying its zone set. Captures are synthesized from a
seed at 32x256. Tolerance: exact (equal arrays and dtypes, equal metadata
json)."""

import copy
import json
import os
import time
import types
import zipfile

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.derived as jd
import ouster_sdk_tpu.zone as jz
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.derived as pd
import ouster_sdk_tpu_torch.zone as pz
from _torch_helpers import (DUAL, SINGLE, assert_scans_equal, engine_infos,
                            frame_packets, lidar_stream, write_pcap)
from ouster_sdk_tpu_torch.io.sources import LidarScanSet, ScanSource

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"
H, W = 32, 256


def _capture(tmp_path, profile=DUAL):
    jinfo, pinfo = engine_infos(profile, w=W, h=H)
    frames = [frame_packets(jinfo, fid, alert_flags=1) for fid in (1, 2, 3)]
    path = write_pcap(str(tmp_path / "cap.pcap"), lidar_stream(frames))
    return path, jinfo, pinfo


def _sources(path, jinfo, pinfo, **kw):
    """The port's source on its engine (CPU) and the JAX package's on its
    numpy batcher, over the same capture."""
    os.environ.pop(ENV, None)
    psrc = pt.open_source(path, sensor_info=[pinfo], device="cpu", **kw)
    os.environ[ENV] = "0"
    jsrc = jx.open_source(path, sensor_info=[jinfo], **kw)
    return psrc, jsrc


def _iterate(src, env):
    if env is None:
        os.environ.pop(ENV, None)
    else:
        os.environ[ENV] = env
    try:
        return list(src)
    finally:
        os.environ.pop(ENV, None)


MASK = np.random.default_rng(0).random((H, W)) > 0.3

VIEWS = {
    "reduce": lambda s: s.reduce([8]),
    "clip": lambda s: s.clip(["RANGE", "RANGE2"], 20000, 400000),
    "mask": lambda s: s.mask(["RANGE", "SIGNAL"], [MASK]),
    "mask_all": lambda s: s.mask([], [MASK]),
    "chain": lambda s: s.reduce([16]).clip(["RANGE"], 1000, 300000)
    .mask(["RANGE", "REFLECTIVITY"], [MASK[::2]]),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("index", [False, True])
def test_views_over_open_source_equal(tmp_path, view, index):
    path, jinfo, pinfo = _capture(tmp_path)
    psrc, jsrc = _sources(path, jinfo, pinfo, index=index)
    pv, jv = VIEWS[view](psrc), VIEWS[view](jsrc)
    assert [i.to_json_string() for i in pv.sensor_info] == \
        [i.to_json_string() for i in jv.sensor_info]
    assert pv.is_live == jv.is_live and pv.is_indexed == jv.is_indexed
    if index:
        assert len(pv) == len(jv) == 3 and pv.scans_num == jv.scans_num
    got, want = _iterate(pv, None), _iterate(jv, "0")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_scans_equal(a[0], b[0], view)
        assert a[0].sensor_info.to_json_string() == \
            b[0].sensor_info.to_json_string()
    # the parent's scans are not touched by the view
    again = _iterate(psrc, None)
    plain = _iterate(jsrc, "0")
    for a, b in zip(again, plain):
        assert_scans_equal(a[0], b[0], "parent")


def _scan_pair(tmp_path, profile=DUAL):
    path, jinfo, pinfo = _capture(tmp_path, profile)
    psrc, jsrc = _sources(path, jinfo, pinfo)
    p = _iterate(psrc, None)[1][0]
    j = _iterate(jsrc, "0")[1][0]
    poses = np.broadcast_to(np.eye(4), (W, 4, 4)).copy()
    poses[:, :3, 3] = np.random.default_rng(5).normal(size=(W, 3))
    p.pose[:] = poses
    j.pose[:] = poses
    return p, j, pinfo, jinfo


OPS = {
    "clip": lambda m, s, i: m.clip(s, ["RANGE", "SIGNAL2", "NOT_HERE"],
                                   2000, 90000, invalid=7),
    "clip_scan": lambda m, s, i: m.clip_scan(s, 5.0, 200.0),
    "clip_scan_inf": lambda m, s, i: m.clip_scan(s, 1.5, float("inf")),
    "mask_scan": lambda m, s, i: m.mask_scan(s, MASK),
    "mask_scan_fields": lambda m, s, i: m.mask_scan(s, MASK, ["RANGE2"]),
    "filter_field": lambda m, s, i: m.filter_field(
        s, "REFLECTIVITY", 10, 80, invalid=3,
        filtered_fields=["RANGE", "NEAR_IR"]),
    "filter_uv_u": lambda m, s, i: m.filter_uv(s, "u", 3, 11),
    "filter_uv_v": lambda m, s, i: m.filter_uv(s, "v", 0.25, 0.5,
                                               filtered_fields=["RANGE"]),
    "filter_uv_inf": lambda m, s, i: m.filter_uv(s, "v", float("-inf"), 40),
    "filter_xyz_z": lambda m, s, i: m.filter_xyz(
        s, _lut(m, i), 2, -20.0, 0.5),
    "filter_xyz_x_dewarp": lambda m, s, i: m.filter_xyz(
        s, _lut(m, i), 0, 0.0, 60.0, invalid=1,
        filtered_fields=["RANGE", "SIGNAL2"], dewarp_points=True),
    "reduce_scan": lambda m, s, i: m.reduce_scan(s, 4),
}


def _lut(mod, info):
    root = jx if mod is jd else pt
    return root.make_xyz_lut(info)


@pytest.mark.parametrize("op", sorted(OPS))
def test_scan_functions_equal(tmp_path, op):
    p, j, pinfo, jinfo = _scan_pair(tmp_path)
    assert_scans_equal(p, j, "input")
    got = OPS[op](pd, p, pinfo)
    want = OPS[op](jd, j, jinfo)
    assert (got is p) == (want is j) and (got is None) == (want is None)
    if got is None:     # clip works in place and returns nothing
        got, want = p, j
    assert_scans_equal(got, want, op)
    assert got.sensor_info.to_json_string() == \
        want.sensor_info.to_json_string()


ERRORS = {
    "reduce_zero": lambda m, s: m.reduce_scan(s, 0),
    "reduce_uneven": lambda m, s: m.reduce_scan(s, 7),
    "mask_shape": lambda m, s: m.mask_scan(s, MASK[:5]),
    "uv_axis": lambda m, s: m.filter_uv(s, "w", 0, 1),
    "uv_bounds": lambda m, s: m.filter_uv(s, "u", 5, 400),
    "uv_order": lambda m, s: m.filter_uv(s, "u", 9, 3),
    "xyz_axis": lambda m, s: m.filter_xyz(s, None, 3),
    "non_pixel": lambda m, s: m.clip(s, ["RANGE", "X"], 0, 1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_equal(tmp_path, case):
    p, j, _, _ = _scan_pair(tmp_path)
    for s in (p, j):
        s.add_field("X", np.zeros(W, np.uint8),
                    pt.FieldClass.COLUMN_FIELD if s is p
                    else jx.FieldClass.COLUMN_FIELD)
    with pytest.raises(ValueError) as pe:
        ERRORS[case](pd, p)
    with pytest.raises(ValueError) as je:
        ERRORS[case](jd, j)
    assert str(pe.value) == str(je.value)


def test_view_construction_errors_equal(tmp_path):
    path, jinfo, pinfo = _capture(tmp_path)
    psrc, jsrc = _sources(path, jinfo, pinfo)
    for make in (lambda s: s.reduce([8, 8]), lambda s: s.reduce([5]),
                 lambda s: s.clip(["RANGE"], 10, 5),
                 lambda s: s.mask(["RANGE"], [MASK, MASK])):
        with pytest.raises(ValueError) as pe:
            make(psrc)
        with pytest.raises(ValueError) as je:
            make(jsrc)
        assert str(pe.value) == str(je.value)


# -- trouble spot 1: a scan whose pixel fields wait on a deferred fill ------

class _Parent(ScanSource):
    """A source yielding one set a scan made by `make`."""

    def __init__(self, info, makes):
        super().__init__([info])
        self._makes = makes

    def _iter_sets(self):
        for make in self._makes:
            yield LidarScanSet([make()])


def _deferred(scan):
    """A copy of `scan` whose pixel fields are filled on first touch, as
    a live scan's are; the headers are set at once."""
    out = pt.LidarScan(scan.sensor_info)
    for attr in ("timestamp", "measurement_id", "status", "packet_timestamp",
                 "alert_flags", "pose"):
        getattr(out, attr)[:] = getattr(scan, attr)
    out.frame_id, out.frame_status = scan.frame_id, scan.frame_status
    calls = []

    def fill(s):
        calls.append(1)
        for name in scan.fields:
            s.field(name)[:] = scan.field(name)

    out.set_deferred_fields(fill)
    out.fill_calls = calls
    return out


@pytest.mark.parametrize("view", ["reduce", "clip", "mask", "chain"])
def test_views_resolve_a_deferred_fill(tmp_path, view):
    p, _, pinfo, _ = _scan_pair(tmp_path)
    made = []

    def make():
        made.append(_deferred(p))
        assert made[-1].fields_deferred
        return made[-1]

    got = _iterate(VIEWS[view](_Parent(pinfo, [make, make])), None)
    want = _iterate(VIEWS[view](_Parent(pinfo, [lambda: p])), None)
    assert len(got) == 2
    for ls in got:
        assert not ls[0].fields_deferred
        assert_scans_equal(ls[0], want[0][0], view)
    for d in made:
        assert d.fill_calls == [1]
        if view != "reduce":    # a copy was changed, not the parent's scan
            assert_scans_equal(d, p, "parent")


def test_copies_of_a_deferred_scan_carry_its_fields(tmp_path):
    p, _, _, _ = _scan_pair(tmp_path)
    half = (lambda s: pd.reduce_scan(s, H // 2))
    for copier, want in ((copy.deepcopy, p), (pt.LidarScan, p),
                         (half, half(p))):
        d = _deferred(p)
        c = copier(d)
        assert not c.fields_deferred and d.fill_calls == [1]
        assert_scans_equal(c, want)
    # reduce to the scan's own height is the scan itself, still deferred
    d = _deferred(p)
    assert pd.reduce_scan(d, H) is d and d.fields_deferred


# -- trouble spot 2: the XYZ cache of an OSF replay -------------------------

def _osf_scans(tmp_path, pinfo, scans):
    path = str(tmp_path / "x.osf")
    with pt.io.osf.Writer(path) as w:
        w.add_sensor(pinfo)
        for s in scans:
            w.save(0, s)
    os.environ.pop(ENV, None)
    return pt.open_source(path, device="cpu")


def _count_hits(monkeypatch):
    hits = []
    real = pt.LidarScan.cached_xyz

    def counted(self, ret, ext, rng):
        out = real(self, ret, ext, rng)
        hits.append((ret, out is not None))
        return out

    monkeypatch.setattr(pt.LidarScan, "cached_xyz", counted)
    return hits


def test_filter_xyz_serves_the_cache_until_range_changes(tmp_path,
                                                         monkeypatch):
    path, jinfo, pinfo = _capture(tmp_path)
    psrc, jsrc = _sources(path, jinfo, pinfo)
    scans = [ls[0] for ls in _iterate(psrc, None)]
    jscans = [ls[0] for ls in _iterate(jsrc, "0")]
    src = _osf_scans(tmp_path, pinfo, scans)
    osf = [ls[0] for ls in _iterate(src, None)]
    hits = _count_hits(monkeypatch)
    lut = pt.XYZLut(src.sensor_info[0])
    for dewarp in (False, True):
        for s, j in zip(osf, jscans):
            for x in (s, j):
                x.pose[:] = np.eye(4)
                x.pose[:, :3, 3] = np.linspace(0, 3, W)[:, None]
            got = pd.filter_xyz(copy.deepcopy(s), lut, 2, -1.0, 0.3,
                                dewarp_points=dewarp)
            host = pd.filter_xyz(copy.deepcopy(s), pt.make_xyz_lut(pinfo), 2,
                                 -1.0, 0.3, dewarp_points=dewarp)
            want = jd.filter_xyz(copy.deepcopy(j), jx.make_xyz_lut(jinfo), 2,
                                 -1.0, 0.3, dewarp_points=dewarp)
            assert_scans_equal(got, host, "host")
            assert_scans_equal(got, want, "jax")
    assert hits == [(0, True), (1, True)] * 6
    # a clip that changes RANGE misses; one that changes nothing hits
    hits.clear()
    for lo, changed in ((30000, True), (0, False)):
        view = src.clip(["RANGE"], lo, 2**32)
        for ls in _iterate(view, None):
            s = ls[0]
            assert s._xyz_cache     # deepcopy carried it
            served = lut(s)
            assert np.array_equal(served, pt.make_xyz_lut(pinfo)(
                s.field("RANGE"))) or not changed
            assert (s.cached_xyz(0, False, s.field("RANGE")) is None) \
                == changed
    assert [h for _, h in hits] == [False, False] * 3 + [True, True] * 3
    # a mask that changes RANGE misses; RANGE2 is untouched and hits
    masked = [ls[0] for ls in _iterate(src.mask(["RANGE"], [MASK]), None)]
    for s in masked:
        assert s.cached_xyz(0, False, s.field("RANGE")) is None
        assert s.cached_xyz(1, False, s.field("RANGE2")) is not None
    # a reduced scan is a new scan under a new SensorInfo: no cache
    for ls in _iterate(src.reduce([8]), None):
        assert not ls[0]._xyz_cache
        assert ls[0].cached_xyz(0, False, ls[0].field("RANGE")) is None


# -- trouble spot 3: reduce keeps the zone set --------------------------------

@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """zipfile's clock held at one instant, so zone-set blobs made a
    moment apart carry the same timestamps."""
    t = time.mktime((2026, 1, 2, 3, 4, 6, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: t, localtime=time.localtime))


def test_reduce_keeps_the_zone_set(tmp_path, frozen_zip_clock):
    p, j, pinfo, jinfo = _scan_pair(tmp_path, SINGLE)
    for s, info, mod in ((p, pinfo, pz), (j, jinfo, jz)):
        info.zone_set = mod.ZoneSet(
            [mod.Zone.box(1, center=(6, 0, 0), size=(4, 4, 2))],
            label="yard")
        info.zone_set.sensor_to_body_transform = np.eye(4)
        s.sensor_info = info
    got, want = pd.reduce_scan(p, 8), jd.reduce_scan(j, 8)
    assert got.sensor_info.zone_set == pinfo.zone_set
    assert got.sensor_info.zone_set is not pinfo.zone_set
    assert json.loads(got.sensor_info.to_json_string()) == \
        json.loads(want.sensor_info.to_json_string())
    assert got.sensor_info.to_json_string() == \
        want.sensor_info.to_json_string()
    pv = pd.ReducedScanSource(_Parent(pinfo, [lambda: p]), [8])
    jv = jd.ReducedScanSource(types.SimpleNamespace(sensor_info=[jinfo]),
                              [8])
    assert pv.sensor_info[0].to_json_string() == \
        jv.sensor_info[0].to_json_string()
