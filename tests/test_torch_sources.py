"""The port's scan-source layer (io/sources.py, io/pcap_source.py,
io/pcap_scan_source.py) on the CPU against the JAX package's, on captures
synthesized from a seed: open_source's semantics and error texts, scans and
their yield order from one sensor, two sensors on distinct and on
colliding ports and a hybrid NMEA-IMU/zone capture, through the engine
(OUSTER_SDK_TPU_DEVICE_DECODE=1, device="cpu") and the numpy batcher (=0),
held equal to the JAX package's sources under both values of the variable.
Scans are compared field by field and header by header, dtypes included;
tolerance 0.
"""

import json
import os

import numpy as np
import pytest
import torch

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.pcap as jpcap
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.pcap as ppcap
from _torch_helpers import (DUAL, SINGLE, assert_scans_equal, aux_packet,
                            engine_infos, engine_metadata, frame_packets,
                            lidar_stream, write_pcap)
from ouster_sdk_tpu.io import device_engine as jde
from ouster_sdk_tpu.io import sources as jsources
from ouster_sdk_tpu.io.pcap_scan_source import \
    PcapScanSource as JaxPcapScanSource
from ouster_sdk_tpu.io.pcap_source import \
    PcapPacketSource as JaxPcapPacketSource
from ouster_sdk_tpu.utils import extrinsics as jext
from ouster_sdk_tpu.utils import native as jnative
from ouster_sdk_tpu_torch.io import device_engine as de
from ouster_sdk_tpu_torch.io import sources
from ouster_sdk_tpu_torch.io.pcap_scan_source import PcapScanSource
from ouster_sdk_tpu_torch.utils import extrinsics as pext

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"


# -- captures -----------------------------------------------------------------

def _one_sensor(tmp_path, profile=DUAL, h=32):
    """Four frames of one sensor, the last one left open."""
    jinfo, pinfo = engine_infos(profile, h=h)
    frames = [frame_packets(jinfo, fid, alert_flags=1) for fid in (1, 2, 3, 4)]
    path = write_pcap(str(tmp_path / "one.pcap"), lidar_stream(frames)[:-3])
    return path, [jinfo], [pinfo]


def _two_sensors(tmp_path, colliding: bool):
    """Two dual-return sensors with their own ids, their packets
    interleaved one by one; on colliding ports both send to 7502 and only
    the ids tell the packets apart."""
    ja, pa = engine_infos(DUAL, init_id=11, sn=1001)
    jb, pb = engine_infos(DUAL, init_id=22, sn=2002,
                          lidar_port=7502 if colliding else 7512)
    fa = [p for fid in (1, 2, 3) for p in frame_packets(ja, fid, seed=1)]
    fb = [p for fid in (7, 8) for p in frame_packets(jb, fid, seed=2)]
    fb += frame_packets(jb, 9, seed=2)[:5]
    stream, t = [], 10**9
    for k in range(max(len(fa), len(fb))):
        for port, pkts in ((7502, fa), (pb.config.udp_port_lidar, fb)):
            if k < len(pkts):
                stream.append((port, pkts[k], t))
                t += 1000
    path = write_pcap(str(tmp_path / "two.pcap"), stream)
    return path, [ja, jb], [pa, pb]


def _hybrid(tmp_path):
    """NMEA IMU and zone packets mixed into the lidar frames, and a frame of
    aux packets alone."""
    jinfo, pinfo = engine_infos("RNG19_RFL8_SIG16_NIR16_ZONE16",
                                nmea_imu=True, zone_port=7504)
    items = []
    for fid in (1, 2, 4):
        mix = [("lidar", p) for p in frame_packets(jinfo, fid)]
        aux = [("imu", aux_packet(jinfo, "imu", fid, m_id0=0)),
               ("imu", aux_packet(jinfo, "imu", fid, m_id0=128)),
               ("zone", aux_packet(jinfo, "zone", fid))]
        mix.insert(3, aux[0])
        mix.insert(9, aux[2])
        items += mix + [aux[1]]
        if fid == 2:
            items += [("imu", aux_packet(jinfo, "imu", 3, m_id0=0)),
                      ("zone", aux_packet(jinfo, "zone", 3))]
    stream = [(kind, p, 10**9 + k * 10**5) for k, (kind, p) in
              enumerate(items)]
    path = write_pcap(str(tmp_path / "hybrid.pcap"), stream)
    return path, [jinfo], [pinfo]


CAPTURES = {
    "one-sensor": _one_sensor,
    "two-sensors-distinct-ports": lambda p: _two_sensors(p, False),
    "two-sensors-colliding-ports": lambda p: _two_sensors(p, True),
    "hybrid-imu-zone": _hybrid,
}


def _port_scans(path, pinfos, **kw):
    """[(sensor idx, scan)] in yield order, and the collated sets' frame
    ids, of the port's open_source."""
    src = pt.open_source(path, sensor_info=pinfos, device="cpu", **kw)
    return list(src._iter_scans()), _set_ids(src)


def _jax_scans(path, jinfos, **kw):
    src = jsources.open_source(path, sensor_info=jinfos, **kw)
    return list(src._iter_scans()), _set_ids(src)


def _set_ids(src):
    return [[None if s is None else s.frame_id for s in ls] for ls in src]


def _hold(got, want, tag):
    assert [(i, s.frame_id) for i, s in got] == \
        [(i, s.frame_id) for i, s in want], tag
    for k, ((_, a), (_, b)) in enumerate(zip(got, want)):
        assert_scans_equal(a, b, f"{tag}[{k}]")


@pytest.mark.parametrize("capture", list(CAPTURES))
def test_scan_source_matches_the_jax_package(tmp_path, monkeypatch,
                                             capture):
    """The port's open_source on the engine (variable at 1) and on the
    batcher (at 0) against the JAX package's open_source at 1 and at 0:
    scans, interleaved yield order, collated sets, full_index and
    scans_num. Ambiguous captures take the batcher under either value."""
    path, jinfos, pinfos = CAPTURES[capture](tmp_path)
    runs = {}
    for env in ("1", "0"):
        monkeypatch.setenv(ENV, env)
        de.stats.update(batches=0, scans=0)
        runs["port", env] = _port_scans(path, pinfos)
        runs["port batches", env] = de.stats["batches"]
        jde.stats["batches"] = 0
        runs["jax", env] = _jax_scans(path, jinfos)
        runs["jax batches", env] = jde.stats["batches"]
    ambiguous = capture == "two-sensors-colliding-ports"
    assert PcapScanSource(path, sensor_infos=pinfos)._device_ambiguous() \
        == ambiguous
    assert (runs["port batches", "1"] > 0) != ambiguous
    assert runs["port batches", "0"] == 0
    if jnative.get_lib() is not None:
        assert (runs["jax batches", "1"] > 0) != ambiguous
    want, want_sets = runs["jax", "0"]
    assert len(want) >= 3 and len({i for i, _ in want}) == len(pinfos)
    for key in (("port", "1"), ("port", "0"), ("jax", "1")):
        got, sets = runs[key]
        _hold(got, want, f"{capture} {key}")
        assert sets == want_sets, key
    # the index: lazy on the engine for one sensor, else materialized
    for env in ("1", "0"):
        monkeypatch.setenv(ENV, env)
        src = pt.open_source(path, sensor_info=pinfos, device="cpu",
                             index=True)
        jsrc = jsources.open_source(path, sensor_info=jinfos, index=True)
        assert (src._lazy is not None) == (
            env == "1" and len(pinfos) == 1), env
        assert src.full_index() == jsrc.full_index()
        assert src.scans_num == jsrc.scans_num
        assert src.individual_index() == jsrc.individual_index()
        assert len(src) == len(jsrc) == len(want_sets)
        for i in (len(src) - 1, 0, 1):
            for a, b in zip(src[i], jsrc[i]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert_scans_equal(a, b, f"{capture} [{i}] env={env}")


def test_multi_sensor_device_gate_ambiguous(tmp_path, monkeypatch):
    """Two sensors on one port with the same packet size: the engine's
    per-sensor readers cannot reproduce the per-packet attribution by id,
    so the source stays on the batcher even at 1, with scans equal to 0's
    and to the JAX package's."""
    path, jinfos, pinfos = _two_sensors(tmp_path, colliding=True)
    src = PcapScanSource(path, sensor_infos=pinfos, device="cpu")
    assert src._device_ambiguous()
    assert JaxPcapScanSource(path, sensor_infos=jinfos)._device_ambiguous()
    monkeypatch.setenv(ENV, "1")
    de.stats["batches"] = 0
    dev = list(src._iter_scans())
    assert de.stats["batches"] == 0
    monkeypatch.setenv(ENV, "0")
    _hold(dev, list(src._iter_scans()), "ambiguous")
    assert {i for i, _ in dev} == {0, 1}


def test_device_gate_imu_zone_cross_kind(monkeypatch):
    """A datagram matching one sensor's NMEA-IMU stream and another's (or
    its own) zone stream is classified once by the batcher but would be
    double-assigned by the engine's per-kind masks: _device_ambiguous
    catches it, as the JAX package's does."""
    import types

    from ouster_sdk_tpu_torch.ops import packet_format as pfmod

    monkeypatch.setattr(pfmod.PacketFormat, "from_info", staticmethod(
        lambda info: types.SimpleNamespace(
            lidar_packet_size=1000 + (info.init_id or 0),
            imu_packet_size=500, zone_packet_size=500)))

    def ambiguous(infos):
        return PcapScanSource._device_ambiguous(
            types.SimpleNamespace(sensor_info=infos))

    def info(init_id, nmea=False, zone=False, imu_port=0, zm_port=0):
        meta = json.loads(engine_metadata(SINGLE, init_id=init_id))
        if nmea:
            meta["lidar_data_format"]["udp_profile_imu"] = \
                "ACCEL32_GYRO32_NMEA"
        meta["config_params"]["udp_port_imu"] = imu_port
        meta["config_params"]["udp_port_zm"] = zm_port
        out = pt.sensor_info_from_metadata(json.dumps(meta))
        out.format.zone_monitoring_enabled = zone
        return out

    a = info(1, nmea=True, imu_port=7503, zm_port=7605)
    b = info(2, zone=True, imu_port=7604, zm_port=7503)
    assert ambiguous([a, b])          # cross-sensor imu-vs-zone
    b.config.udp_port_zm = 7603
    assert not ambiguous([a, b])      # distinct ports: fine
    c = info(3, nmea=True, zone=True, imu_port=7503, zm_port=7503)
    assert ambiguous([c])             # same-sensor imu-vs-zone
    d = info(4, imu_port=7503, zm_port=7503)
    assert not ambiguous([d])         # neither stream batches into scans


# -- open_source semantics ------------------------------------------------------

def test_open_source_empty_url():
    with pytest.raises(ValueError, match="No valid source specified"):
        pt.open_source("")
    with pytest.raises(ValueError, match="No valid source specified"):
        pt.open_packet_source("")


def test_open_source_unsupported_extension(tmp_path):
    p = tmp_path / "data.txt"
    p.write_text("hello")
    with pytest.raises(pt.SourceURLException) as got:
        pt.open_source(str(p))
    with pytest.raises(jsources.SourceURLException) as want:
        jsources.open_source(str(p))
    assert str(got.value) == str(want.value)
    assert "Could not detect IO type" in str(got.value)
    assert got.value.get_url() == [str(p)]


def test_open_source_only_pcap_is_registered(tmp_path):
    """PNG and STL are recognized and refused with the JAX package's own
    text; the bag and point-cloud backends are registered, so a file of
    their type that is not one fails in their reader as in the JAX
    package; OSF and the point clouds have no packet source, as there."""
    for ext, name in ((".png", "PNG"), (".stl", "STL")):
        p = tmp_path / f"x{ext}"
        p.write_bytes(b"\0" * 32)
        with pytest.raises(pt.SourceURLException) as got:
            pt.open_source(str(p))
        with pytest.raises(jsources.SourceURLException) as want:
            jsources.open_source(str(p))
        assert str(got.value) == str(want.value)
        assert isinstance(got.value.get_sub_exception(), NotImplementedError)
        assert ("Could not open scan source. Unhandled source type "
                f"{name}.") in str(got.value)
    for ext in (".bag", ".mcap", ".ply", ".pcd", ".las"):
        p = tmp_path / f"x{ext}"
        p.write_bytes(b"\0" * 32)
        with pytest.raises(pt.SourceURLException) as got:
            pt.open_source(str(p))
        with pytest.raises(jsources.SourceURLException) as want:
            jsources.open_source(str(p))
        assert str(got.value) == str(want.value)
        assert "Unhandled source type" not in str(got.value)
    for ext in (".ply", ".osf"):
        p = tmp_path / f"x{ext}"
        p.write_bytes(b"\0" * 32)
        with pytest.raises(pt.SourceURLException,
                           match="Could not open packet source"):
            pt.open_packet_source(str(p))
    p = tmp_path / "x.osf"
    with pytest.raises(pt.SourceURLException) as got:
        pt.open_source(str(p))
    with pytest.raises(jsources.SourceURLException) as want:
        jsources.open_source(str(p))
    assert str(got.value) == str(want.value)
    assert "invalid OSF file: bad header identifier" in str(got.value)


def test_open_source_options(tmp_path):
    """check-on-unused: an option the PCAP backend does not take raises
    with the JAX package's text; an unknown keyword raises as there."""
    path, jinfos, pinfos = _one_sensor(tmp_path)
    with pytest.raises(pt.SourceURLException) as got:
        pt.open_source(path, sensor_info=pinfos, timeout=1.0)
    with pytest.raises(jsources.SourceURLException) as want:
        jsources.open_source(path, sensor_info=jinfos, timeout=1.0)
    assert str(got.value) == str(want.value)
    assert "Parameter 'timeout' not supported by PCAP scan source" in \
        str(got.value)
    with pytest.raises(TypeError):
        pt.open_source(path, definitely_not_an_option=1)
    with pytest.raises(TypeError):
        jsources.open_source(path, definitely_not_an_option=1)
    with pytest.raises(pt.SourceURLException, match="'device' not supported"):
        pt.open_packet_source(path, sensor_info=pinfos, device="cpu")


def test_open_source_meta_override_and_discovery(tmp_path, monkeypatch):
    """Metadata from `meta`, and found beside the capture by its stem."""
    monkeypatch.setenv(ENV, "1")
    path, _, _ = _one_sensor(tmp_path)
    meta = engine_metadata(DUAL, sn=4242)
    json_path = tmp_path / "other.json"
    json_path.write_text(meta)
    src = pt.open_source(path, meta=[str(json_path)], device="cpu")
    assert src.sensor_info[0].sn == 4242
    with pytest.raises(pt.SourceURLException, match="no metadata json"):
        pt.open_source(path, device="cpu")
    (tmp_path / "one.json").write_text(meta)
    src = pt.open_source(path, device="cpu")
    jsrc = jsources.open_source(path)
    assert src.sensor_info[0].sn == jsrc.sensor_info[0].sn == 4242
    assert [ls[0].frame_id for ls in src] == [ls[0].frame_id for ls in jsrc]
    single = pt.open_source(path, device="cpu", sensor_idx=0)
    assert isinstance(single, pt.Singler)
    assert [s.frame_id for s in single] == [1, 2, 3, 4]


def test_unindexed_source(tmp_path):
    path, _, pinfos = _one_sensor(tmp_path)
    src = pt.open_source(path, sensor_info=pinfos, device="cpu")
    assert not src.is_indexed
    with pytest.raises(TypeError, match="unindexed"):
        len(src)
    with pytest.raises(RuntimeError, match="Cannot perform 'scans_num'"):
        src.scans_num
    with pytest.raises(TypeError):
        src[0]
    # the derived views of an unindexed source are unindexed too
    for view in (src.mask(["RANGE"], [None]), src.clip(["RANGE"], 0, 10),
                 src.reduce([16])):
        assert not view.is_indexed and not view.is_live
        with pytest.raises(TypeError, match="unindexed"):
            len(view)
        with pytest.raises(RuntimeError, match="Cannot perform 'scans_num'"):
            view.scans_num


@pytest.fixture(params=["1", "0"], ids=["engine", "batcher"])
def indexed(request, tmp_path, monkeypatch):
    """An indexed one-sensor source of 4 scans on either route."""
    monkeypatch.setenv(ENV, request.param)
    path, _, pinfos = _one_sensor(tmp_path)
    src = pt.open_source(path, sensor_info=pinfos, device="cpu", index=True)
    assert (src._lazy is not None) == (request.param == "1")
    return src


@pytest.mark.parametrize("start,stop,step", [
    (0, None, None), (1, None, None), (None, 2, None), (0, 3, 2),
    (1, 3, None), (None, None, 2), (-1, None, None), (0, -1, 3)])
def test_slicing_level_1(indexed, start, stop, step):
    ids = [ls[0].frame_id for ls in indexed]
    assert ids == [1, 2, 3, 4] and len(indexed) == 4
    got = indexed[start:stop:step]
    assert [ls[0].frame_id for ls in got] == ids[start:stop:step]


def test_slicing_level_2_and_bounds(indexed):
    n = len(indexed)
    sliced = pt.Slicer(indexed, slice(1, n))
    assert len(sliced) == n - 1
    assert sliced[0][0].frame_id == indexed[1][0].frame_id
    assert [ls[0].frame_id for ls in sliced] == [2, 3, 4]
    assert [ls[0].frame_id for ls in pt.Slicer(sliced, slice(0, 2))] == \
        [2, 3]
    with pytest.raises(ValueError):
        indexed[::-1]
    with pytest.raises(IndexError):
        indexed[n + 5]
    assert indexed[-1][0].frame_id == 4


def test_raw_headers_and_raw_fields(tmp_path, monkeypatch):
    """raw_headers stays on the batcher by static rule; raw_fields rides the
    engine. Both equal the JAX package's scans. 128 rows: a column's header
    and footer bytes (76 here) must fit the u8 RAW_HEADERS column, in both
    packages."""
    monkeypatch.setenv(ENV, "1")
    path, jinfos, pinfos = _one_sensor(tmp_path, h=128)
    de.stats["batches"] = 0
    got, _ = _port_scans(path, pinfos, raw_headers=True)
    assert de.stats["batches"] == 0
    want, _ = _jax_scans(path, jinfos, raw_headers=True)
    _hold(got, want, "raw_headers")
    scan = got[0][1]
    col = scan.first_valid_column()
    rh = scan.field("RAW_HEADERS")
    assert rh[:8, col].copy().view("<u8")[0] == scan.timestamp[col]
    got, _ = _port_scans(path, pinfos, raw_fields=True)
    assert de.stats["batches"] > 0
    want, _ = _jax_scans(path, jinfos, raw_fields=True)
    _hold(got, want, "raw_fields")
    raw1 = got[0][1].field("RAW32_WORD1")
    np.testing.assert_array_equal(raw1 & 0x7FFFF, got[0][1].field("RANGE"))


def test_field_names_and_extrinsics(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "1")
    path, jinfos, pinfos = _one_sensor(tmp_path)
    got, _ = _port_scans(path, pinfos, field_names=["RANGE", "SIGNAL"])
    want, _ = _jax_scans(path, jinfos, field_names=["RANGE", "SIGNAL"])
    _hold(got, want, "field_names")
    assert sorted(got[0][1].fields) == ["RANGE", "SIGNAL"]
    ext = np.arange(16, dtype=np.float64).reshape(4, 4)
    src = pt.open_source(path, sensor_info=pinfos, device="cpu",
                         extrinsics=[ext])
    np.testing.assert_array_equal(src.sensor_info[0].extrinsic, ext)


# -- routes and devices -----------------------------------------------------

def test_device_route_failure_raises(tmp_path, monkeypatch):
    """A failure on the engine route raises: nothing moves the source to
    the batcher."""
    monkeypatch.setenv(ENV, "1")
    path, _, pinfos = _one_sensor(tmp_path)

    def broken(*args, **kwargs):
        raise RuntimeError("engine broke")

    monkeypatch.setattr(de, "DeviceScanIterator", broken)
    src = pt.open_source(path, sensor_info=pinfos, device="cpu")
    with pytest.raises(RuntimeError, match="engine broke"):
        list(src)
    with pytest.raises(pt.SourceURLException, match="engine broke"):
        pt.open_source(path, sensor_info=pinfos, device="cpu", index=True)


@pytest.mark.parametrize("env", [None, "1"], ids=["unset", "1"])
def test_default_device_raises_without_a_gpu(tmp_path, monkeypatch, env):
    if torch.cuda.is_available():
        pytest.skip("shows the raise on a host without a GPU")
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    path, _, pinfos = _one_sensor(tmp_path)
    src = pt.open_source(path, sensor_info=pinfos)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(iter(src))
    monkeypatch.setenv(ENV, "0")
    assert [ls[0].frame_id for ls in src] == [1, 2, 3, 4]
    monkeypatch.setenv(ENV, "yes")
    with pytest.raises(ValueError, match="expected 0 or 1"):
        next(iter(src))


def test_id_errors_reported_once_after_the_merge(tmp_path, monkeypatch):
    """Packets whose ids contradict the metadata: dropped and counted, and
    reported once through the error handler, with the JAX package's text,
    on both routes and by the packet source."""
    jinfo, pinfo = engine_infos(DUAL, init_id=1234, sn=99887766)
    frames = [frame_packets(jinfo, fid) for fid in (5, 6)]
    writer = pt.PacketWriter(pinfo.format)
    for k in (2, 3):
        writer.set_packet_header(frames[0][k], init_id=1241,
                                 prod_sn=99887767)
    path = write_pcap(str(tmp_path / "ids.pcap"), lidar_stream(frames))
    messages = {}
    for env in ("1", "0"):
        monkeypatch.setenv(ENV, env)
        for pkg, info in (("port", pinfo), ("jax", jinfo)):
            log = []
            opener = pt.open_source if pkg == "port" else \
                jsources.open_source
            kw = {"device": "cpu"} if pkg == "port" else {}
            src = opener(path, sensor_info=[info],
                         error_handler=lambda sev, msg: log.append(
                             (sev.value, msg)), **kw)
            assert [ls[0].frame_id for ls in src] == [5, 6]
            messages[pkg, env] = log
    want = [("WARNING", f"{path}: 2 lidar packets with mismatched "
             "init_id/serial (dropped)")]
    assert all(v == want for v in messages.values()), messages
    log = []
    pkts = pt.PcapPacketSource(path, sensor_infos=[pinfo],
                               error_handler=lambda s, m: log.append(m))
    assert len(list(pkts)) == 2 * len(frames[0]) - 2
    assert pkts.id_error_count == 2 and log == [want[0][1]]


# -- the packet source ------------------------------------------------------

def test_packet_source_classification(tmp_path):
    """Lidar, IMU and zone datagrams to their sensor and type, datagrams of
    no stream counted, as the JAX package's packet source does."""
    path, jinfos, pinfos = _hybrid(tmp_path)
    # a foreign-size datagram among them
    stream = [("lidar", frame_packets(jinfos[0], 9)[0], 5),
              (7599, np.arange(100, dtype=np.uint8), 6)]
    path2 = write_pcap(str(tmp_path / "mixed.pcap"), stream)
    for p in (path, path2):
        got = pt.PcapPacketSource(p, sensor_infos=pinfos)
        want = JaxPcapPacketSource(p, sensor_infos=jinfos)
        a, b = list(got), list(want)
        assert [(i, type(x).__name__, x.host_timestamp, bytes(x.buf))
                for i, x in a] == \
            [(i, type(x).__name__, x.host_timestamp, bytes(x.buf))
             for i, x in b]
        assert got.size_error_count == want.size_error_count
    assert {type(x).__name__ for _, x in a} == {"LidarPacket"}
    assert got.size_error_count == 1


def test_packet_source_duplicate_ports():
    """Two sensors may share a port only when their serials tell them
    apart; LEGACY packets carry none."""
    a = pt.sensor_info_from_metadata(engine_metadata(DUAL, sn=7))
    b = pt.sensor_info_from_metadata(engine_metadata(DUAL, sn=7))
    with pytest.raises(pt.io.PcapDuplicatePortException,
                       match="Duplicate lidar port/sn found in pcap: 7:7502"):
        pt.PcapPacketSource("unused.pcap", sensor_infos=[a, b])
    b.sn = 8
    pt.PcapPacketSource("unused.pcap", sensor_infos=[a, b])
    la = pt.sensor_info_from_metadata(engine_metadata("LEGACY", sn=7))
    lb = pt.sensor_info_from_metadata(engine_metadata("LEGACY", sn=8))
    with pytest.raises(pt.io.PcapDuplicatePortException, match="LEGACY"):
        pt.PcapPacketSource("unused.pcap", sensor_infos=[la, lb])


# -- the rest of the layer --------------------------------------------------

def test_collation_and_multi_source(tmp_path, monkeypatch):
    """collate over a two-sensor source, and MultiScanSource merging two
    one-sensor sources, as the JAX package's."""
    monkeypatch.setenv(ENV, "1")
    path, jinfos, pinfos = _two_sensors(tmp_path, colliding=False)
    src = pt.open_source(path, sensor_info=pinfos, device="cpu")
    jsrc = jsources.open_source(path, sensor_info=jinfos)
    assert _set_ids(pt.collate(src)) == _set_ids(jsources.collate(jsrc))
    singles = [pt.open_source(path, sensor_info=[i], device="cpu")
               for i in pinfos]
    jsingles = [jsources.open_source(path, sensor_info=[i]) for i in jinfos]
    multi = pt.MultiScanSource(singles)
    jmulti = jsources.MultiScanSource(jsingles)
    assert len(multi.sensor_info) == 2
    assert _set_ids(multi) == _set_ids(jmulti)
    assert multi.size_hint() == 0


def test_io_type_and_extensions(tmp_path):
    for name in ("a.pcap", "b.OSF", "c.db3", "d.ply", "e.las"):
        assert sources.io_type_from_extension(name).value == \
            jsources.io_type_from_extension(name).value
        t = sources.io_type_from_extension(name)
        assert sources.extension_from_io_type(t) == \
            jsources.extension_from_io_type(jsources.IoType(t.value))
    assert sources.extension_from_io_type(sources.IoType.SENSOR) is None
    with pytest.raises(ValueError, match="Could not detect IO type"):
        sources.io_type_from_extension("x.txt")
    (tmp_path / "bag.bag").mkdir()
    assert sources.io_type(str(tmp_path / "bag.bag")) is sources.IoType.BAG
    with pytest.raises(ValueError, match="was not a ROSbag"):
        sources.io_type(str(tmp_path))
    assert sources.io_type(str(tmp_path / "missing.pcap")) is \
        pt.OusterIoType.PCAP


def test_extrinsics_files(tmp_path):
    """resolve_extrinsics over the three file layouts and a directory, and
    the string parser, against the JAX package's."""
    infos = [pt.sensor_info_from_metadata(engine_metadata(DUAL, sn=sn))
             for sn in (101, 202)]
    m = np.arange(16, dtype=np.float64).tolist()
    layouts = {
        "transforms.json": {"transforms": [
            {"source_frame": "202", "p_x": 1.0, "p_y": -2.0, "p_z": 0.5,
             "q_w": 0.9, "q_x": 0.1, "q_y": -0.3, "q_z": 0.2}]},
        "by_sn.json": {"101": m},
        "bare.json": m,
    }
    for name, data in layouts.items():
        p = tmp_path / name
        p.write_text(json.dumps(data))
        got = pext.resolve_extrinsics(str(p), infos)
        want = jext.resolve_extrinsics(str(p), infos)
        assert [g is None for g in got] == [w is None for w in want], name
        for g, w in zip(got, want):
            if g is not None:
                np.testing.assert_array_equal(g, w)
    d = tmp_path / "dir"
    d.mkdir()
    (d / "101.json").write_text(json.dumps(m))
    got = pext.resolve_extrinsics(str(d), infos)
    assert got[1] is None and got[0].shape == (4, 4)
    for text in ("identity", "1 2 3 10 20 30", "1,2,3,0.1,0.2,0.3,0.9",
                 " ".join(str(v) for v in range(16))):
        np.testing.assert_array_equal(
            pext.parse_extrinsics_from_string(text),
            jext.parse_extrinsics_from_string(text))
    sources.populate_extrinsics(infos, extrinsics_file=str(
        tmp_path / "by_sn.json"))
    np.testing.assert_array_equal(infos[0].extrinsic,
                                  np.reshape(m, (4, 4)))


def test_pcap_stream_info_guess_ports_and_record(tmp_path):
    path, jinfos, pinfos = _hybrid(tmp_path)
    got, want = ppcap.stream_info(path), jpcap.stream_info(path)
    assert {k: (v.count, v.sizes) for k, v in got.items()} == \
        {k: (v.count, v.sizes) for k, v in want.items()}
    pf = pt.PacketFormat.from_info(pinfos[0])
    assert ppcap.guess_ports(got, pf.lidar_packet_size,
                             pf.imu_packet_size) == \
        jpcap.guess_ports(want, pf.lidar_packet_size, pf.imu_packet_size)
    pkts = list(pt.PcapPacketSource(path, sensor_infos=pinfos))
    lidar_imu = [p for _, p in pkts if not isinstance(p, pt.ZonePacket)]
    out = str(tmp_path / "rec.pcap")
    assert ppcap.record(lidar_imu, out) == len(lidar_imu)
    jout = str(tmp_path / "jrec.pcap")
    jcls = {pt.LidarPacket: jx.LidarPacket, pt.ImuPacket: jx.ImuPacket}
    jpcap.record([jcls[type(p)](bytes(p.buf), p.host_timestamp)
                  for p in lidar_imu], jout)
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="Unexpected packet type"):
        ppcap.record([pkts[0][1], pt.ZonePacket(b"\0" * 8)],
                     str(tmp_path / "bad.pcap"))
    with ppcap.PcapReader(out) as reader:
        first = reader.next_packet()
        reader.next_packet()
        reader.reset()
        assert reader.next_packet()[0] == first[0]
        assert reader.path == out
