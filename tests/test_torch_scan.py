"""The port's LidarScan, field model and packet containers against the JAX
package's: the same metadata string gives scans with the same fields,
dtypes and shapes, and the host semantics (equality, completeness, valid
columns, deferred fill, XYZ cache) behave alike. Comparison is exact."""

import pickle

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu_torch as pt
from _torch_helpers import (DUAL, PROFILES, SINGLE, assert_scans_equal,
                            engine_infos, frame_packets)
from ouster_sdk_tpu.core import field as jfield
from ouster_sdk_tpu.core.lidar_scan import LidarScan as JaxLidarScan
from ouster_sdk_tpu.core.lidar_scan import get_field_types as jax_field_types
from ouster_sdk_tpu.core.lidar_scan import \
    resolve_field_types as jax_resolve_field_types
from ouster_sdk_tpu_torch.core import field as pfield
from ouster_sdk_tpu_torch.core import packets as ppackets


def _types(fts):
    return [(str(ft.name), np.dtype(ft.storage_dtype), tuple(ft.extra_dims),
             int(ft.field_class)) for ft in fts]


@pytest.mark.parametrize("profile", PROFILES)
def test_construction_matches(profile):
    """Field set, dtypes, shapes and header arrays of a new scan, all 12
    profiles and LEGACY."""
    jinfo, pinfo = engine_infos(profile)
    assert _types(jax_field_types(jinfo)) == _types(pt.get_field_types(pinfo))
    a, b = pt.LidarScan(pinfo), JaxLidarScan(jinfo)
    assert_scans_equal(a, b, profile)
    assert _types(a.field_types) == _types(b.field_types)
    assert a.frame_id == b.frame_id == -1
    assert a.packet_count == b.packet_count
    assert pt.lidar_scan_from_jax(pinfo, b) == a


@pytest.mark.parametrize("kw", [dict(nmea_imu=True), dict(zone_port=7504),
                                dict(nmea_imu=True, zone_port=7504)],
                         ids=["imu", "zone", "imu+zone"])
def test_scan_level_fields_match(kw):
    """The IMU and zone scan fields the metadata switches on."""
    jinfo, pinfo = engine_infos(DUAL, **kw)
    assert pinfo.format.zone_monitoring_enabled == \
        jinfo.format.zone_monitoring_enabled
    assert pinfo.format.imu_packets_per_frame == \
        jinfo.format.imu_packets_per_frame
    a, b = pt.LidarScan(pinfo), JaxLidarScan(jinfo)
    assert_scans_equal(a, b)
    assert _types(a.field_types) == _types(b.field_types)
    assert a.zones.dtype == b.zones.dtype and a.zones.shape == b.zones.shape


@pytest.mark.parametrize("raw_fields,names", [
    (False, None), (True, None), (False, ["RANGE", "SIGNAL"]),
    (True, ["RANGE"])])
def test_resolve_field_types_matches(raw_fields, names):
    jinfo, pinfo = engine_infos(DUAL)
    a = pt.resolve_field_types(pinfo, raw_fields=raw_fields,
                               field_names=names)
    b = jax_resolve_field_types(jinfo, raw_fields=raw_fields,
                                field_names=names)
    assert [_types(x) for x in a] == [_types(x) for x in b]


def test_window_field_needs_firmware_3_2():
    """get_field_types drops WINDOW below fw 3.2, by the version parsed
    from the metadata's image_rev, in both packages."""
    jinfo, pinfo = engine_infos("RNG15_RFL8_WIN8")
    assert pinfo.get_version() == pt.core.types.Version.from_string(
        jinfo.image_rev or jinfo.fw_rev)
    names = [ft.name for ft in pt.get_field_types(pinfo)]
    assert names == [ft.name for ft in jax_field_types(jinfo)]
    pinfo.image_rev = "ousteros-image-prod-aries-v3.2.0+1"
    jinfo.image_rev = pinfo.image_rev
    names = [ft.name for ft in pt.get_field_types(pinfo)]
    assert "WINDOW" in names
    assert names == [ft.name for ft in jax_field_types(jinfo)]


def test_field_model_matches():
    assert {m.name: m.value for m in pfield.FieldClass} == \
        {m.name: m.value for m in jfield.FieldClass}
    assert {m.name: m.value for m in pfield.ChanFieldType} == \
        {m.name: m.value for m in jfield.ChanFieldType}
    assert pfield.ZONE_STATE_DTYPE == jfield.ZONE_STATE_DTYPE
    for tag in pfield.ChanFieldType:
        jtag = jfield.ChanFieldType(tag.value)
        if tag.name in ("VOID", "UNREGISTERED", "ZONE_STATE"):
            continue
        assert pfield.dtype_of(tag) == jfield.dtype_of(jtag)
        assert pfield.tag_of(pfield.dtype_of(tag)) == tag
    ft = pt.FieldType("NOTE", np.dtype("S25"), (3,),
                      pt.FieldClass.SCAN_FIELD)
    jt = jfield.FieldType("NOTE", np.dtype("S25"), (3,),
                          jfield.FieldClass.SCAN_FIELD)
    assert ft.extra_dims == jt.extra_dims == (3, 25)
    assert ft.element_type == jt.element_type == np.dtype("S25")
    assert ft.shape(4, 8, 2) == jt.shape(4, 8, 2) == (3, 25)


def _filled(info, pkg_scan, seed=3):
    ls = pkg_scan(info)
    rng = np.random.default_rng(seed)
    for name in ls.fields:
        f = ls.field(name)
        f[...] = rng.integers(0, 200, f.shape).astype(f.dtype)
    ls.frame_id = 12
    ls.status[:] = 1
    ls.timestamp[:] = np.arange(ls.w) + 5
    ls.packet_timestamp[:] = np.arange(ls.packet_count) + 100
    return ls


def test_equality_and_dtype_identity():
    jinfo, pinfo = engine_infos(SINGLE)
    a, b = _filled(pinfo, pt.LidarScan), _filled(pinfo, pt.LidarScan)
    assert a == b
    assert pt.lidar_scan_from_jax(pinfo, _filled(jinfo, JaxLidarScan)) == a
    b.field("RANGE")[3, 4] += 1
    assert a != b
    b = _filled(pinfo, pt.LidarScan)
    b.status[7] = 0
    assert a != b
    # a field of another dtype with the same values is another scan
    c = pt.LidarScan(pinfo, field_types=[
        pt.FieldType(ft.name, np.uint32 if ft.name == "SIGNAL"
                     else ft.storage_dtype, ft.extra_dims, ft.field_class)
        for ft in a.field_types])
    for name in a.fields:
        c.field(name)[...] = a.field(name)
    for attr in ("status", "timestamp", "packet_timestamp"):
        getattr(c, attr)[:] = getattr(a, attr)
    c.frame_id = a.frame_id
    assert c.field("SIGNAL").dtype == np.uint32
    assert a != c
    assert a.__eq__(object()) is NotImplemented


@pytest.mark.parametrize("window", [(0, 255), (32, 95), (200, 40)])
def test_complete_and_valid_columns(window):
    """complete() over a plain, an inner and a wrapped azimuth window;
    first/last valid column and their timestamps; packet timestamps."""
    jinfo, pinfo = engine_infos(SINGLE, column_window=window)
    assert pinfo.format.lidar_packets_per_frame() == \
        jinfo.format.lidar_packets_per_frame()
    a, b = pt.LidarScan(pinfo), JaxLidarScan(jinfo)
    for ls in (a, b):
        assert not ls.complete()
        assert ls.first_valid_column() == ls.last_valid_column() == -1
        assert ls.first_valid_column_timestamp() == 0
        assert ls.first_valid_packet_timestamp() == 0
        start, end = window
        cols = (np.arange(start, end + 1) if start <= end else
                np.concatenate([np.arange(start, ls.w),
                                np.arange(0, end + 1)]))
        ls.status[cols] = 1
        ls.timestamp[:] = np.arange(ls.w) * 10 + 1
        ls.packet_timestamp[2:5] = (7, 8, 9)
    for ls in (a, b):
        assert ls.complete()
        assert ls.complete(window)
        assert ls.complete((0, ls.w - 1)) == (window == (0, 255))
    for m in ("first_valid_column", "last_valid_column",
              "first_valid_column_timestamp", "last_valid_column_timestamp",
              "first_valid_packet_timestamp", "last_valid_packet_timestamp",
              "get_first_valid_column", "get_last_valid_packet_timestamp"):
        assert getattr(a, m)() == getattr(b, m)(), m
    assert a.first_valid_packet_timestamp() == 7
    assert a.last_valid_packet_timestamp() == 9
    a.status[cols[0]] = 0
    assert not a.complete()
    with pytest.raises(RuntimeError):
        pt.LidarScan(w=16, h=4).complete()


def test_frame_status_accessors():
    jinfo, pinfo = engine_infos(SINGLE)
    a, b = pt.LidarScan(pinfo), JaxLidarScan(jinfo)
    a.frame_status = b.frame_status = (3 << 4) | 1
    assert a.thermal_shutdown().value == b.thermal_shutdown().value == 1
    assert a.shot_limiting().value == b.shot_limiting().value == 3
    assert a.shot_limiting().name == b.shot_limiting().name


def test_deferred_fill_runs_once():
    _, pinfo = engine_infos(SINGLE)
    ls = pt.LidarScan(pinfo)
    calls = []

    def fill(scan):
        calls.append(1)
        scan.field("RANGE")[:] = 7

    ls.set_deferred_fields(fill)
    assert ls.fields_deferred
    # headers, names and unknown fields never force the fill
    assert ls.has_field("RANGE") and list(ls.fields)
    assert ls.status.sum() == 0
    with pytest.raises(IndexError):
        ls.field("NO_SUCH_FIELD")
    assert ls.fields_deferred and not calls
    assert (ls.field("RANGE") == 7).all()
    assert not ls.fields_deferred
    ls.field("SIGNAL")
    assert ls == ls
    assert len(calls) == 1


def test_deferred_fill_restored_on_failure():
    _, pinfo = engine_infos(SINGLE)
    ls = pt.LidarScan(pinfo)
    ls.frame_id = 41
    state = {"fail": True}

    def fill(scan):
        if state["fail"]:
            raise ValueError("device lost")
        scan.field("RANGE")[:] = 9

    ls.set_deferred_fields(fill)
    with pytest.raises(RuntimeError, match="frame_id=41.*device lost"):
        ls.field("RANGE")
    assert ls.fields_deferred          # never serves zeroed arrays as data
    state["fail"] = False
    assert (ls.field("RANGE") == 9).all()
    assert not ls.fields_deferred


def test_pickle_and_copy_resolve_deferred():
    _, pinfo = engine_infos(SINGLE)
    ls = pt.LidarScan(pinfo)
    ls.frame_id = 3
    ls.set_deferred_fields(lambda s: s.field("RANGE").fill(5))
    back = pickle.loads(pickle.dumps(ls))
    assert not ls.fields_deferred and not back.fields_deferred
    assert (back.field("RANGE") == 5).all() and back == ls
    back.set_deferred_fields(lambda s: s.field("SIGNAL").fill(2))
    assert (back.field("SIGNAL") == 2).all()    # the lock came back too

    ls2 = pt.LidarScan(pinfo)
    ls2.set_deferred_fields(lambda s: s.field("RANGE").fill(6))
    clone = pt.LidarScan(ls2)
    assert not clone.fields_deferred and (clone.field("RANGE") == 6).all()
    clone.field("RANGE")[0, 0] = 1
    assert ls2.field("RANGE")[0, 0] == 6


def test_cached_xyz_refuses_a_mutated_range():
    _, pinfo = engine_infos(SINGLE)
    ls = pt.LidarScan(pinfo)
    rng = ls.field("RANGE")
    rng[:] = np.arange(rng.size, dtype=np.uint32).reshape(rng.shape)
    xyz = np.ones(rng.shape + (3,), np.float32)
    assert ls.cached_xyz(0, False, rng) is None
    ls.attach_xyz_cache(0, False, xyz, rng)
    assert ls.cached_xyz(0, False, rng) is xyz
    assert ls.cached_xyz(0, True, rng) is None
    assert ls.cached_xyz(1, False, rng) is None
    rng[2, 3] += 1                      # in place, after the projection
    assert ls.cached_xyz(0, False, rng) is None
    rng[2, 3] -= 1
    assert ls.cached_xyz(0, False, rng) is xyz
    # the cache is no part of equality
    other = pt.LidarScan(pinfo)
    other.field("RANGE")[:] = rng
    assert ls == other


def test_add_and_del_field():
    _, pinfo = engine_infos(SINGLE)
    ls = pt.LidarScan(pinfo)
    with pytest.raises(ValueError):
        ls.add_field(pt.FieldType("RANGE", np.uint32))
    f = ls.add_field("EXTRA", np.zeros((ls.h, ls.w, 2), np.int16))
    assert f.shape == (ls.h, ls.w, 2) and ls.field_class("EXTRA") == \
        pt.FieldClass.PIXEL_FIELD
    ls.add_field("PER_COL", dtype=np.float32, shape=(3,),
                 field_class=pt.FieldClass.COLUMN_FIELD)
    assert ls.field("PER_COL").shape == (ls.w, 3)
    ls.del_field("EXTRA")
    assert not ls.has_field("EXTRA")
    with pytest.raises(ValueError):
        ls.del_field("EXTRA")


def test_packets_and_validation():
    """Packet containers and LidarPacket.validate against the JAX
    package's, on a good packet, a wrong size and wrong ids."""
    from ouster_sdk_tpu.core import packets as jpackets

    jinfo, pinfo = engine_infos(DUAL, init_id=1234, sn=99887766)
    good = frame_packets(jinfo, 5)[0]
    bad = good.copy()
    jx.PacketWriter(jinfo.format).set_packet_header(
        bad, init_id=1241, prod_sn=99887767)
    cases = [good, bad, good[:-4]]
    for buf in cases:
        a = ppackets.LidarPacket(buf.tobytes(), 17)
        b = jpackets.LidarPacket(buf.tobytes(), 17)
        assert a.type().value == b.type().value == "Lidar"
        assert a.host_timestamp == 17 and a.size == b.size
        assert a.validate(pinfo).name == b.validate(jinfo).name
    assert ppackets.LidarPacket(good.tobytes()).validate(pinfo).name == "NONE"
    assert ppackets.LidarPacket(bad.tobytes()).validate(pinfo).name == "ID"
    assert ppackets.LidarPacket(good[:-4].tobytes()).validate(
        pinfo).name == "PACKET_SIZE"
    assert ppackets.Packet(64).buf.shape == (64,)
    assert ppackets.ImuPacket(b"\0" * 48).validate(pinfo).name == "NONE"
    assert ppackets.ZonePacket(b"\0" * 48).type().value == "Zone"
