"""The port's ScanBatcher and PacketFormat readers against the JAX
package's, on the same seeded packets: every scan the batchers release,
every field and header, dtype included, and the index of the packet that
released it. Comparison is exact."""

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu_torch as pt
from _torch_helpers import (DUAL, PROFILES, SINGLE, assert_scans_equal,
                            aux_packet, batcher_scans, engine_infos,
                            frame_packets, has_nan, lidar_stream)
from ouster_sdk_tpu.ops.packet_format import PacketFormat as JaxPacketFormat


def _both(jinfo, pinfo, stream, n_scans=None, **kw):
    """Run both batchers over the stream; scans and release points must
    agree. Returns the port's [(released_by, scan)]."""
    got = batcher_scans(pt, pinfo, stream, **kw)
    want = batcher_scans(jx, jinfo, stream, **kw)
    assert [(k, s.frame_id) for k, s in got] == \
        [(k, s.frame_id) for k, s in want]
    if n_scans is not None:
        assert len(got) == n_scans
    for (k, a), (_, b) in zip(got, want):
        assert_scans_equal(a, b, f"scan released by {k}")
        if not has_nan(a):     # `==` holds no scan with a NaN equal
            assert pt.lidar_scan_from_jax(pinfo, b) == a
    return got


@pytest.mark.parametrize("profile", PROFILES)
def test_clean_frames(profile):
    """Three whole frames of every profile (LEGACY among them), with some
    invalid columns: released by count at their last packet, or, where
    the profile waits for a zone packet that never comes, by the next
    frame's first packet and the trailing flush."""
    jinfo, pinfo = engine_infos(profile)
    frames = [frame_packets(jinfo, fid) for fid in (7, 8, 9)]
    got = _both(jinfo, pinfo, lidar_stream(frames), n_scans=3)
    n = len(frames[0])
    if pinfo.format.zone_monitoring_enabled:
        assert [k for k, _ in got] == [n, 2 * n, None]
    else:
        assert [k for k, _ in got] == [n - 1, 2 * n - 1, 3 * n - 1]
    for _, s in got:
        assert 0 < int((s.status & 1).sum()) < s.w


@pytest.mark.parametrize("size", [(32, 256), (128, 512)],
                         ids=["32x256", "128x512"])
def test_dropped_packet(size):
    """A lost packet: its columns stay zero, the frame releases at the
    next frame's first packet, which is kept for the next scan."""
    h, w = size
    jinfo, pinfo = engine_infos(DUAL, w=w, h=h)
    frames = [frame_packets(jinfo, fid) for fid in (1, 2, 3)]
    del frames[1][4]
    got = _both(jinfo, pinfo, lidar_stream(frames), n_scans=3)
    n = w // 16
    assert [k for k, _ in got] == [n - 1, 2 * n - 1, 3 * n - 2]
    s = got[1][1]
    assert (s.field("RANGE")[:, 64:80] == 0).all()
    assert (s.status[64:80] == 0).all() and s.packet_timestamp[4] == 0
    assert not s.complete()


def test_reordered_straggler_and_duplicate_after_release():
    """Stragglers of the frame before the open one are dropped, and so is
    a duplicate of a frame right after its release."""
    jinfo, pinfo = engine_infos(SINGLE)
    f1, f2, f3 = (frame_packets(jinfo, fid) for fid in (10, 11, 12))
    seq = (f1[:-1] + [f2[0]] + [f1[-1]]     # straggler while f2 builds
           + f2[1:4] + [f1[2]]              # another straggler
           + f2[4:] + [f2[3]]               # duplicate after f2's release
           + f3)
    got = _both(jinfo, pinfo, lidar_stream([seq]), n_scans=3)
    assert [s.frame_id for _, s in got] == [10, 11, 12]
    assert got[0][1].packet_timestamp[-1] == 0      # the straggler's slot


def test_frame_id_wraps_at_0xffff():
    jinfo, pinfo = engine_infos(DUAL)
    fids = (0xFFFE, 0xFFFF, 0, 1)
    frames = [frame_packets(jinfo, fid) for fid in fids]
    # a straggler of 0xFFFF while frame 0 builds is one frame older mod
    # 2**16 and drops
    frames[2].insert(3, frames[1][5])
    del frames[1][7]
    got = _both(jinfo, pinfo, lidar_stream(frames), n_scans=4)
    assert [s.frame_id for _, s in got] == list(fids)


@pytest.mark.parametrize("window", [(32, 95), (200, 40)],
                         ids=["inner", "wrapped"])
def test_azimuth_window(window):
    """A windowed sensor sends only the window's packets: the scan
    completes on their count."""
    jinfo, pinfo = engine_infos(SINGLE, column_window=window)
    start, end = window
    slots = (range(start // 16, end // 16 + 1) if start <= end else
             list(range(start // 16, 16)) + list(range(0, end // 16 + 1)))
    frames = [[frame_packets(jinfo, fid, invalid=0)[s] for s in slots]
              for fid in (3, 4)]
    got = _both(jinfo, pinfo, lidar_stream(frames), n_scans=2)
    n = len(frames[0])
    assert n == pinfo.format.lidar_packets_per_frame()
    assert [k for k, _ in got] == [n - 1, 2 * n - 1]
    assert got[0][1].complete()


def test_header_bits_set_by_the_writer():
    """Alert flags by packet, and the frame status and countdowns of the
    frame's opening packet."""
    jinfo, pinfo = engine_infos(DUAL)
    frames = [
        frame_packets(jinfo, 20, alert_flags=0x5, thermal_shutdown=1,
                      countdown_thermal=30),
        frame_packets(jinfo, 21, alert_flags=0x81, shot_limiting=3,
                      countdown_shot=77),
        frame_packets(jinfo, 22),
    ]
    # only the opener's status counts: a later packet's differs
    jx.PacketWriter(jinfo.format).set_packet_header(
        frames[2][5], init_id=jinfo.init_id, prod_sn=jinfo.sn,
        shot_limiting=9, alert_flags=0xFF)
    got = _both(jinfo, pinfo, lidar_stream(frames), n_scans=3)
    s0, s1, s2 = (s for _, s in got)
    assert (s0.alert_flags == 0x5).all() and s0.shutdown_countdown == 30
    assert s0.thermal_shutdown() == pt.core.types.ThermalShutdownStatus(1)
    assert s1.shot_limiting().value == 3 and s1.shot_limiting_countdown == 77
    assert s1.frame_status == 3 << 4
    assert s2.frame_status == 0 and s2.alert_flags[5] == 0xFF


def test_writer_setters_match():
    """The writer's alert-flag and countdown setters, on either package's
    packet, read back by either package's format."""
    jinfo, pinfo = engine_infos(DUAL)
    jw, pw = jx.PacketWriter(jinfo.format), pt.PacketWriter(pinfo.format)
    a, b = jw.new_packet(), pw.new_packet()
    for w_, buf in ((jw, a), (pw, b)):
        w_.set_frame_id(buf, 777)
        w_.set_alert_flags(buf, 0xA5)
        w_.set_shot_limiting_countdown(buf, 19)
        w_.set_shutdown_countdown(buf, 23)
        w_.set_col_status(buf, 3, 1)
        w_.set_col_measurement_id(buf, 3, 99)
        w_.set_col_timestamp(buf, 3, 2**40 + 5)
    assert (a == b).all()
    pf = pt.PacketFormat.from_info(pinfo)
    assert pf.frame_id(a) == 777 and pf.alert_flags(a) == 0xA5
    assert pf.countdown_shot_limiting(a) == 19
    assert pf.countdown_thermal_shutdown(a) == 23
    assert pf.col_status(a)[3] == 1 and pf.col_measurement_id(a)[3] == 99
    assert pf.col_timestamp(a)[3] == 2**40 + 5


@pytest.mark.parametrize("profile", [SINGLE, DUAL, "LEGACY",
                                     "RNG19_RFL8_SIG16_NIR16_RGB16",
                                     "FUSA_RNG15_RFL8_NIR8_DUAL"])
def test_packet_format_readers_match(profile):
    """Every reader of the port's PacketFormat against the JAX package's
    on the same packet."""
    jinfo, pinfo = engine_infos(profile, init_id=4321, sn=11223344)
    jf, pf = JaxPacketFormat.from_info(jinfo), pt.PacketFormat.from_info(pinfo)
    assert pt.PacketFormat.from_info(pinfo) is pf        # cached
    bufs = frame_packets(jinfo, 33, alert_flags=9, shot_limiting=2,
                         thermal_shutdown=1, countdown_shot=5,
                         countdown_thermal=6)
    buf = bufs[3]
    for m in ("frame_id", "init_id", "prod_sn", "alert_flags",
              "thermal_shutdown", "shot_limiting", "packet_type",
              "countdown_thermal_shutdown", "countdown_shot_limiting"):
        assert getattr(pf, m)(buf) == getattr(jf, m)(buf), m
    for m in ("col_timestamp", "col_measurement_id", "col_status"):
        x, y = getattr(pf, m)(buf), getattr(jf, m)(buf)
        assert x.dtype == y.dtype and (x == y).all(), m
    for idx in (0, 2, 3):
        x, y = pf.packet_header(idx, buf), jf.packet_header(idx, buf)
        assert x.dtype == y.dtype and (x == y).all()
    assert list(pf.fields) == list(jf.fields)
    stack = np.stack(bufs)
    for name in pf.fields:
        x, y = pf.packet_field(name, buf), jf.packet_field(name, buf)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert pf.field_value_mask(name) == jf.field_value_mask(name)
        assert pf.field_bitness(name) == jf.field_bitness(name)
        if pf.field_info(name).num_elements == 1:
            assert np.array_equal(pf.packet_field_all(name, stack),
                                  jf.packet_field_all(name, stack))
    assert pf.crc(buf) == jf.crc(buf)
    if pf.packet_footer_size:
        assert pf.calculate_crc(buf) == jf.calculate_crc(buf)


def test_imu_and_zone_readers_and_batching():
    """The NMEA IMU and zone readers on seeded random packets, and the
    batcher's writers of their scan fields: aux packets mixed into lidar
    frames complete the scan by count."""
    jinfo, pinfo = engine_infos(DUAL, nmea_imu=True, zone_port=7504)
    jf, pf = JaxPacketFormat.from_info(jinfo), pt.PacketFormat.from_info(pinfo)
    assert (pf.imu_packet_size, pf.zone_packet_size) == \
        (jf.imu_packet_size, jf.zone_packet_size)
    imu, zone = aux_packet(jinfo, "imu", 4, m_id0=128), \
        aux_packet(jinfo, "zone", 4)
    for got, want in zip(pf.imu_measurement_headers(imu),
                         jf.imu_measurement_headers(imu)):
        assert got.dtype == want.dtype and (got == want).all()
    for m in ("parse_accel", "parse_gyro"):
        assert np.array_equal(getattr(pf, m)(imu).view(np.uint32),
                              getattr(jf, m)(imu).view(np.uint32))
    assert pf.imu_nmea_sentence(imu) == jf.imu_nmea_sentence(imu)
    assert pf.imu_nmea_ts(imu) == jf.imu_nmea_ts(imu)
    assert pf.zone_timestamp(zone) == jf.zone_timestamp(zone)
    assert (pf.live_zoneset_hash(zone) == jf.live_zoneset_hash(zone)).all()
    zp, zj = pf.zone_measurements(zone), jf.zone_measurements(zone)
    assert list(zp) == list(zj)
    for k in zp:
        assert zp[k].dtype == zj[k].dtype and (zp[k] == zj[k]).all()

    frames = [frame_packets(jinfo, fid) for fid in (4, 5)]
    stream, t = [], 10**9
    for fid, pkts in zip((4, 5), frames):
        mix = [("lidar", p) for p in pkts]
        mix.insert(3, ("imu", aux_packet(jinfo, "imu", fid, m_id0=0)))
        mix.insert(9, ("zone", aux_packet(jinfo, "zone", fid)))
        mix.append(("imu", aux_packet(jinfo, "imu", fid, m_id0=128)))
        for kind, p in mix:
            stream.append((kind, p, t))
            t += 1000
    got = _both(jinfo, pinfo, stream, n_scans=2)
    n = len(frames[0]) + 3
    assert [k for k, _ in got] == [n - 1, 2 * n - 1]   # the last imu packet
    s = got[0][1]
    assert (s.field("IMU_PACKET_TIMESTAMP") > 0).all()
    assert s.field("ZONE_PACKET_TIMESTAMP")[0] > 0
    assert s.field("IMU_MEASUREMENT_ID")[4] == 128


def test_nmea_sentence_parses_alike():
    from ouster_sdk_tpu.utils.nmea import parse_lat_long as jax_parse
    from ouster_sdk_tpu_torch.utils.nmea import parse_lat_long

    body = "GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W"
    ck = 0
    for ch in body:
        ck ^= ord(ch)
    good = f"${body}*{ck:02X}".encode()
    for s in (good, good[:-1] + b"0", b"", b"$GPGGA,1*00", good + b"\0\0"):
        a, b = parse_lat_long(s), jax_parse(s)
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    assert parse_lat_long(good) == pytest.approx((48.1173, 11.516666),
                                                 abs=1e-5)


def test_batcher_rejects_what_the_reference_rejects():
    jinfo, pinfo = engine_infos(SINGLE)
    b = pt.ScanBatcher(pinfo)
    pkt = pt.LidarPacket(frame_packets(jinfo, 1)[0].tobytes(), 5)
    with pytest.raises(ValueError):
        b(pkt, pt.LidarScan(w=128, h=32))
    # a legacy-profile IMU packet is no part of a scan
    assert b(pt.ImuPacket(b"\0" * 48, 1), pt.LidarScan(pinfo)) is False
    narrow = pt.LidarScan(pinfo, field_types=[
        pt.FieldType("RANGE", np.uint16)])
    with pytest.raises(ValueError, match="too small"):
        b(pkt, narrow)
    pinfo.format.columns_per_packet = 0
    with pytest.raises(ValueError):
        pt.ScanBatcher(pinfo)
