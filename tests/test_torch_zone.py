"""The zone model of the PyTorch port (ouster_sdk_tpu_torch.zone) against
the JAX package's (ouster_sdk_tpu.zone) on the CPU: zip blobs byte-equal
and round trips equal, set hashes equal, rendered near/far bounds equal on
a 32x512 sensor, zone_occupancy_device equal to zone_occupancy_jax and to
the numpy zone_occupancy (bounds of 0 and 2**32 - 1 included), the
emulated monitor's outputs equal, and SensorInfo.zone_set carried through
the metadata json and an OSF file byte for byte.

Zones are built in code (Zone.box, ZoneSet). A zip records the time it was
written (two-second resolution), so the tests that compare blobs fix
zipfile's clock. Tolerance: exact everywhere (integer bounds and counts,
byte-equal blobs)."""

import base64
import json
import time
import types
import zipfile

import numpy as np
import pytest
import torch

import ouster_sdk_tpu as J
import ouster_sdk_tpu.io.osf as josf
import ouster_sdk_tpu.zone as jz
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.osf as posf
import ouster_sdk_tpu_torch.zone as pz
from _torch_helpers import infos
from ouster_sdk_tpu.zone.monitor import zone_occupancy_jax

PROFILE = "RNG19_RFL8_SIG16_NIR16"
SN = 992210000957    # a serial: a rendered bound records it
S2B = np.array([[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -0.25],
                [0.0, 0.0, 1.0, 1.25], [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """zipfile's clock held at one instant, so blobs made a moment apart
    carry the same timestamps."""
    t = time.mktime((2026, 1, 2, 3, 4, 6, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: t, localtime=time.localtime))


def _zone_set(mod, s2b=S2B, live=None):
    """Two boxes in front of and beside the sensor, one of each mode."""
    a = mod.Zone.box(1, center=(6.0, 0.0, 0.0), size=(4.0, 4.0, 2.0))
    a.min_points, a.frame_count = 10, 2
    b = mod.Zone.box(3, center=(0.5, 5.0, 0.0), size=(2.0, 1.0, 3.0))
    b.mode = mod.ZoneMode.VACANCY
    b.min_points = 4
    return mod.ZoneSet([a, b], power_on_live_ids=live,
                       sensor_to_body_transform=s2b, label="yard")


def _infos(w=512, h=32):
    ji, pi = infos(PROFILE, w=w, h=h)
    ji.sn = pi.sn = SN
    return ji, pi


def _rendered(w=512, h=32, s2b=S2B):
    ji, pi = _infos(w, h)
    jzs, pzs = _zone_set(jz, s2b), _zone_set(pz, s2b)
    jzs.render(ji)
    pzs.render(pi)
    return (ji, jzs), (pi, pzs)


def test_rendered_bounds_are_equal():
    (_, jzs), (_, pzs) = _rendered()
    assert sorted(jzs.zones) == sorted(pzs.zones) == [1, 3]
    for zid in jzs.zones:
        a, b = jzs.zones[zid].zrb, pzs.zones[zid].zrb
        assert a.near_range_mm.shape == (32, 512)
        assert np.array_equal(a.near_range_mm, b.near_range_mm)
        assert np.array_equal(a.far_range_mm, b.far_range_mm)
        assert int((a.far_range_mm > 0).sum()) > 0
        assert a.blob() == b.blob()
    assert jzs.hash() == pzs.hash()


@pytest.mark.parametrize("rendered", [False, True])
@pytest.mark.parametrize("filt", ["STL", "ZRB", "STL_AND_ZRB"])
def test_zip_blobs_byte_equal_and_round_trip(frozen_zip_clock, filt,
                                             rendered):
    if rendered:
        (_, jzs), (_, pzs) = _rendered()
    else:
        jzs, pzs = _zone_set(jz, live=[3]), _zone_set(pz, live=[3])
    jblob = jzs.to_zip_blob(jz.ZoneSetOutputFilter[filt])
    pblob = pzs.to_zip_blob(pz.ZoneSetOutputFilter[filt])
    assert jblob == pblob
    assert jzs.to_json(jz.ZoneSetOutputFilter[filt]) == \
        pzs.to_json(pz.ZoneSetOutputFilter[filt])
    if filt == "ZRB" and not rendered:
        return  # nothing but metadata.json: not a zone set to read back
    jback, pback = jz.ZoneSet.from_zip(jblob), pz.ZoneSet.from_zip(pblob)
    assert pback.live_ids == jback.live_ids
    assert pback.hash() == jback.hash()
    assert np.array_equal(pback.sensor_to_body_transform,
                          jback.sensor_to_body_transform)
    # a blob of one package read by the other writes the same blob again
    assert pz.ZoneSet.from_zip(jblob).to_zip_blob(
        pz.ZoneSetOutputFilter[filt]) == \
        jback.to_zip_blob(jz.ZoneSetOutputFilter[filt])
    if filt != "ZRB":
        assert pback == pz.ZoneSet.from_zip(pblob)


def test_zone_set_hash_equal():
    for live in (None, [1]):
        assert _zone_set(jz, live=live).hash() == \
            _zone_set(pz, live=live).hash()
    assert _zone_set(pz).hash() != pz.ZoneSet(
        [pz.Zone.box(1, center=(6.0, 0.0, 0.0), size=(4.0, 4.0, 2.0))],
        sensor_to_body_transform=S2B).hash()


def _bounds_and_ranges(seed=0, z=3, h=32, w=512):
    """Random u32 bounds with a zone of far = 0 and one of far = 2**32 - 1,
    and a range image that spans them (zeros and the top value
    included)."""
    rng = np.random.default_rng(seed)
    near = rng.integers(0, 20000, (z, h, w)).astype(np.uint32)
    far = (near + rng.integers(0, 20000, (z, h, w))).astype(np.uint32)
    far[0, :, : w // 2] = 0
    far[1] = 0xFFFFFFFF
    near[1, : h // 2] = 0
    r = rng.integers(0, 45000, (h, w)).astype(np.uint32)
    r[rng.random((h, w)) < 0.1] = 0
    r[0, :8] = 0xFFFFFFFF
    return r, near, far


@pytest.mark.parametrize("seed", [0, 1])
def test_zone_occupancy_device_equals_jax_and_numpy(seed):
    r, near, far = _bounds_and_ranges(seed)
    got = pz.zone_occupancy_device(r, near, far, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = np.asarray(zone_occupancy_jax(r, near, far))
    assert np.array_equal(got.numpy(), want)
    for k in range(near.shape[0]):
        zrb = pz.Zrb(32, 512, 0.004)
        zrb.near_range_mm, zrb.far_range_mm = near[k], far[k]
        count, mask = pz.zone_occupancy(r, zrb)
        assert count == int(got[k])
        jzrb = jz.Zrb(32, 512, 0.004)
        jzrb.near_range_mm, jzrb.far_range_mm = near[k], far[k]
        assert np.array_equal(mask, jz.zone_occupancy(r, jzrb)[1])
    assert int(got[1]) > 0 and int(got[0]) < int(got[2]) + int(got[1])
    # tensors in: uint32 and int64, on the device they lie on
    tt = [torch.from_numpy(a.view(np.int32)).view(torch.uint32)
          for a in (r, near, far)]
    assert torch.equal(pz.zone_occupancy_device(*tt), got)
    t64 = [torch.from_numpy(a.astype(np.int64)) for a in (r, near, far)]
    assert torch.equal(pz.zone_occupancy_device(*t64), got)


def test_zone_occupancy_device_on_rendered_zones():
    (ji, jzs), (pi, pzs) = _rendered()
    zrbs = [pzs.zones[k].zrb for k in sorted(pzs.zones)]
    near = np.stack([z.near_range_mm for z in zrbs])
    far = np.stack([z.far_range_mm for z in zrbs])
    rng = np.random.default_rng(5)
    r = rng.integers(0, 12000, (32, 512)).astype(np.uint32)
    got = pz.zone_occupancy_device(r, near, far, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(zone_occupancy_jax(r, near, far)))
    assert got.sum() > 0


def test_emulated_zone_mon_outputs_equal():
    (ji, jzs), (pi, pzs) = _rendered()
    jm, pm = jz.EmulatedZoneMon(jzs), pz.EmulatedZoneMon(pzs)
    rng = np.random.default_rng(3)
    walls = [5500, 20000, 1000, 0]
    for k in range(8):
        r = np.full((32, 512), walls[k % 4], np.uint32)
        r[rng.random(r.shape) < 0.3] = rng.integers(0, 15000)
        jmask = np.zeros((32, 512), np.uint16)
        pmask = np.zeros((32, 512), np.uint16)
        if k == 5:
            jm.set_live_zones([3])
            pm.set_live_zones([3])
        jm.calc_triggers(r, jmask)
        pm.calc_triggers(r, pmask)
        assert np.array_equal(jmask, pmask)
        for name in ("zone_counts", "occlusion_counts", "invalid_counts",
                     "zone_mins", "zone_maxes", "zone_avgs",
                     "triggered_zone_ids", "zone_triggers", "zone_alerts",
                     "max_counts", "live_zones"):
            assert getattr(jm, name) == getattr(pm, name), name
        assert jm.get_packet().tobytes() == pm.get_packet().tobytes()
    assert jm.update_count == pm.update_count == 8


def _fault_infos(rendered: bool):
    """The input of the fault record: the 32x512 single-return sensor with
    one box zone and an identity sensor-to-body transform (and a serial,
    which a rendered bound records)."""
    ji, pi = _infos() if rendered else infos(PROFILE, w=512, h=32)
    for info, mod in ((ji, jz), (pi, pz)):
        info.zone_set = mod.ZoneSet(
            [mod.Zone.box(1, center=(6, 0, 0), size=(4, 4, 2))])
        info.zone_set.sensor_to_body_transform = np.eye(4)
        if rendered:
            info.zone_set.render(info)
    return ji, pi


@pytest.mark.parametrize("rendered", [False, True])
def test_sensor_info_zone_set_in_the_metadata_json(frozen_zip_clock,
                                                   rendered):
    ji, pi = _fault_infos(rendered)
    jd, pd = json.loads(ji.to_json_string()), json.loads(pi.to_json_string())
    assert "zone_set" in pd
    assert pd == jd
    back = pt.sensor_info_from_metadata(pi.to_json_string())
    assert sorted(back.zone_set.zones) == [1]
    assert back.zone_set == pi.zone_set
    assert back.zone_set.hash() == pi.zone_set.hash()
    if rendered:
        # the bounds come back binned, as in the JAX package
        jback = J.core.metadata.sensor_info_from_metadata(
            ji.to_json_string()).zone_set.zones[1].zrb
        pback = back.zone_set.zones[1].zrb
        assert np.array_equal(pback.near_range_mm, jback.near_range_mm)
        assert np.array_equal(pback.far_range_mm, jback.far_range_mm)
        assert pback.blob() == pi.zone_set.zones[1].zrb.blob()
    # the JAX package's string parses to the same zone set in the port
    cross = pt.sensor_info_from_metadata(ji.to_json_string())
    assert cross.zone_set.to_zip_blob(pz.ZoneSetOutputFilter.STL_AND_ZRB) \
        == back.zone_set.to_zip_blob(pz.ZoneSetOutputFilter.STL_AND_ZRB)
    assert json.loads(cross.to_json_string()) == jd
    # no zone set: no key, and None back
    plain = pt.sensor_info_from_metadata(infos(PROFILE, w=512, h=32)[1]
                                         .to_json_string())
    assert plain.zone_set is None
    assert "zone_set" not in json.loads(plain.to_json_string())


def test_unparsable_zone_set_warns_in_both_packages():
    ji, _ = infos(PROFILE, w=512, h=32)
    d = json.loads(ji.to_json_string())
    d["zone_set"] = base64.b64encode(b"not a zip").decode()
    meta = json.dumps(d)
    jinfo, jissues = J.core.metadata.parse_and_validate_metadata(meta)
    pinfo, pissues = pt.core.metadata.parse_and_validate_metadata(meta)
    assert jinfo.zone_set is None and pinfo.zone_set is None

    def warned(issues):
        return [(e.path, e.msg.split(":")[0]) for e in issues.warning
                if e.path == "$.zone_set"]

    assert warned(pissues) == warned(jissues) != []


@pytest.mark.parametrize("rendered", [False, True])
def test_osf_of_a_zoned_sensor_byte_identical(tmp_path, frozen_zip_clock,
                                              rendered):
    ji, pi = _fault_infos(rendered)
    rng = np.random.default_rng(7)
    js = J.LidarScan(ji)
    for name in list(js.fields):
        a = js.field(name)
        a[...] = rng.integers(0, 1 << 16, a.shape).astype(a.dtype)
    js.frame_id = 3
    ps = pt.lidar_scan_from_jax(pi, js)
    paths = []
    for mod, info, scan in ((josf, ji, js), (posf, pi, ps)):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.osf")
        with mod.Writer(path) as w:
            w.add_sensor(info)
            w.save(0, scan)
        paths.append(path)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    # read back by the port, the sensor keeps its zones
    src = pt.open_source(paths[1], device="cpu")
    zs = src.sensor_info[0].zone_set
    assert sorted(zs.zones) == [1] and zs.hash() == pi.zone_set.hash()
    src.close()
