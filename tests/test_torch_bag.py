"""The port's ROS bags (io/bag.py: the ROS1, rosbag2 sqlite and MCAP readers
and writers, BagPacketSource, BagScanSource; io/bag_source.py: their
open_source / open_packet_source registrations) against the JAX package's,
on the CPU, with packets synthesized from a seed at 32x256: the writers'
bytes equal (rosbag2: its rows), every reader's messages equal on plain,
bz2-chunked ROS1 and zstd-chunked MCAP files, the packet sources equal
packet for packet (imu and zone topics, the metadata override, the id
check, soft and hard), and the scan sources equal scan for scan.
Tolerance: exact (equal bytes, rows, arrays and dtypes)."""

import bz2
import os
import sqlite3
import struct

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.bag as jbag
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.bag as pbag
from _torch_helpers import (DUAL, assert_scans_equal, aux_packet,
                            engine_infos, frame_packets)

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"
KINDS = ("ros1", "db3", "mcap", "dir")


def _writer(mod, kind, path):
    return {"ros1": mod.Ros1BagWriter, "db3": mod.Ros2BagWriter,
            "dir": mod.Ros2BagWriter, "mcap": mod.McapBagWriter}[kind](path)


NAMES = {"ros1": "x.bag", "db3": "x.db3", "mcap": "x.mcap", "dir": "x"}


def _path(tmp_path, tag, kind):
    """The file (or rosbag2 directory) of `kind` under tmp_path/tag."""
    os.makedirs(str(tmp_path / tag), exist_ok=True)
    return str(tmp_path / tag / NAMES[kind])


def _messages(jinfo, zone=False, bad_id=False):
    """[(topic, kind, payload, ts)]: metadata, lidar packets of 3 frames,
    NMEA-IMU packets and (with `zone`) zone packets; `bad_id` gives frame
    2's packets another init_id."""
    out = [("/os0/metadata", "str", jinfo.to_json_string(), 10**9)]
    t = 10**9 + 1000
    for fid in (1, 2, 3):
        hdr = {}
        if bad_id and fid == 2:
            saved = jinfo.init_id
            jinfo.init_id = saved + 1
        for p in frame_packets(jinfo, fid, **hdr):
            out.append(("/os0/lidar_packets", "pkt", p.tobytes(), t))
            t += 1000
        if bad_id and fid == 2:
            jinfo.init_id = saved
        out.append(("/os0/imu_packets", "pkt",
                    aux_packet(jinfo, "imu", fid).tobytes(), t))
        if zone:
            out.append(("/os0/zone_packets", "pkt",
                        aux_packet(jinfo, "zone", fid).tobytes(), t + 1))
        t += 1000
    # a topic of another namespace and type, ignored by the sources
    out.append(("/other/lidar_packets", "str", "not a packet", t))
    return out


def _write(mod, kind, path, msgs):
    w = _writer(mod, kind, path)
    for topic, what, data, ts in msgs:
        if what == "str":
            w.write_string(topic, data, ts)
        else:
            w.write_packet(topic, data, ts)
    w.close()
    return path


def _rows(path):
    con = sqlite3.connect(path)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("schema", "metadata", "topics", "messages")}
    finally:
        con.close()


def _files(path):
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path))
    return [path]


def _infos(**kw):
    return engine_infos(DUAL, nmea_imu=True, init_id=5, sn=77, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_writers_equal_and_readers_equal(tmp_path, kind):
    jinfo, _ = _infos()
    msgs = _messages(jinfo)
    p = _write(pbag, kind, _path(tmp_path, "p", kind), msgs)
    j = _write(jbag, kind, _path(tmp_path, "j", kind), msgs)
    for a, b in zip(_files(p), _files(j)):
        assert os.path.basename(a) == os.path.basename(b)
        if a.endswith(".db3"):
            assert _rows(a) == _rows(b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
    for path in (p, j):
        got = list(pbag.open_bag_reader(path).messages())
        want = list(jbag.open_bag_reader(path).messages())
        assert type(pbag.open_bag_reader(path)).__name__ == \
            type(jbag.open_bag_reader(path)).__name__
        assert len(got) == len(want) == len(msgs)
        for a, b in zip(got, want):
            assert (a.timestamp, a.data) == (b.timestamp, b.data)
            assert vars(a.connection) == vars(b.connection)
        topics = ["/os0/imu_packets"]
        assert [m.data for m in pbag.open_bag_reader(path).messages(
            topics)] == [m.data for m in jbag.open_bag_reader(path).messages(
                topics)]


def _ros1_bz2(path, msgs, mod):
    """A ROS1 bag whose one chunk is bz2-compressed: connection and message
    records, no index."""
    mh = mod._make_header
    recs = bytearray()
    conns = {}
    for topic, what, data, ts in msgs:
        msgtype = "std_msgs/String" if what == "str" else \
            "ouster_ros/PacketMsg"
        if topic not in conns:
            cid = conns[topic] = len(conns)
            h = mh({b"op": bytes([mod.OP_CONNECTION]),
                    b"conn": struct.pack("<I", cid),
                    b"topic": topic.encode()})
            d = mh({b"topic": topic.encode(), b"type": msgtype.encode()})
            recs += struct.pack("<I", len(h)) + h + \
                struct.pack("<I", len(d)) + d
        raw = data.encode() if what == "str" else data
        body = struct.pack("<I", len(raw)) + raw
        h = mh({b"op": bytes([mod.OP_MSG]),
                b"conn": struct.pack("<I", conns[topic]),
                b"time": struct.pack("<II", *divmod(ts, 10**9))})
        recs += struct.pack("<I", len(h)) + h + \
            struct.pack("<I", len(body)) + body
    comp = bz2.compress(bytes(recs))
    h = mh({b"op": bytes([mod.OP_CHUNK]), b"compression": b"bz2",
            b"size": struct.pack("<I", len(recs))})
    with open(path, "wb") as f:
        f.write(mod._MAGIC + struct.pack("<I", len(h)) + h +
                struct.pack("<I", len(comp)) + comp)
    return path


def _mcap_zstd(plain, out, mod):
    """`plain` (an MCAP file) with every record after the header re-wrapped
    into one zstd chunk."""
    import zstandard

    with open(plain, "rb") as f:
        data = f.read()
    pos = len(mod._MCAP_MAGIC)
    ln = struct.unpack_from("<Q", data, pos + 1)[0]
    header = data[pos:pos + 9 + ln]
    inner = data[pos + 9 + ln:-len(mod._MCAP_MAGIC)]
    comp = zstandard.ZstdCompressor().compress(inner)
    body = struct.pack("<QQQI", 0, 0, len(inner), 0) + \
        struct.pack("<I", 4) + b"zstd" + struct.pack("<Q", len(comp)) + comp
    with open(out, "wb") as f:
        f.write(mod._MCAP_MAGIC + header +
                struct.pack("<BQ", mod._OP_CHUNK, len(body)) + body +
                mod._MCAP_MAGIC)
    return out


def _read_scans(root, path, **kw):
    os.environ[ENV] = "0"       # the JAX package's numpy batcher
    try:
        return [[s for s in ls] for ls in root.open_source(path, **kw)]
    finally:
        os.environ.pop(ENV, None)


@pytest.mark.parametrize("kind", KINDS + ("ros1_bz2", "mcap_zstd"))
def test_scan_sources_equal(tmp_path, kind):
    jinfo, pinfo = _infos()
    msgs = _messages(jinfo)
    if kind == "ros1_bz2":
        path = _ros1_bz2(str(tmp_path / "c.bag"), msgs, pbag)
    elif kind == "mcap_zstd":
        plain = _write(jbag, "mcap", str(tmp_path / "plain.mcap"), msgs)
        path = _mcap_zstd(plain, str(tmp_path / "z.mcap"), pbag)
    else:
        path = _write(pbag, kind, _path(tmp_path, "p", kind), msgs)
    src = pt.open_source(path)
    assert type(src).__name__ == "BagScanSource"
    assert src.sensor_info[0].to_json_string() == jinfo.to_json_string()
    got, want = _read_scans(pt, path), _read_scans(jx, path)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_scans_equal(a[0], b[0], kind)
    # the host ScanBatcher over the packets, as in the JAX package
    from ouster_sdk_tpu_torch.io import device_engine as de

    de.stats.update(batches=0, scans=0, osf_batches=0)
    list(pt.open_source(path))
    assert de.stats["scans"] == 0
    pkts = list(pt.open_packet_source(path))
    jpkts = list(jx.open_packet_source(path))
    assert [(i, type(p).__name__, bytes(p.buf), p.host_timestamp)
            for i, p in pkts] == \
        [(i, type(p).__name__, bytes(p.buf), p.host_timestamp)
         for i, p in jpkts]
    with pytest.raises(Exception, match="not supported"):
        pt.open_source(path, device="cpu")


@pytest.mark.parametrize("soft", [False, True])
def test_packet_source_id_check_zone_and_meta(tmp_path, soft):
    jinfo, pinfo = engine_infos("RNG19_RFL8_SIG16_NIR16_ZONE16",
                                nmea_imu=True, zone_port=7504, init_id=5,
                                sn=77)
    msgs = _messages(jinfo, zone=True, bad_id=True)
    path = _write(pbag, "ros1", str(tmp_path / "z.bag"), msgs)
    meta = str(tmp_path / "meta.json")
    other = pt.sensor_info_from_metadata(jinfo.to_json_string())
    other.extrinsic[:3, 3] = (1.0, 2.0, 3.0)
    with open(meta, "w") as f:
        f.write(other.to_json_string())
    for kw in ({}, {"meta": [meta]}):
        ps = pbag.BagPacketSource(path, soft_id_check=soft, **kw)
        js = jbag.BagPacketSource(path, soft_id_check=soft, **kw)
        got, want = list(ps), list(js)
        assert [(i, type(p).__name__, bytes(p.buf), p.host_timestamp)
                for i, p in got] == \
            [(i, type(p).__name__, bytes(p.buf), p.host_timestamp)
             for i, p in want]
        assert ps.id_error_count == js.id_error_count > 0
        kinds = {type(p).__name__ for _, p in got}
        assert kinds == {"LidarPacket", "ImuPacket", "ZonePacket"}
        assert ps.sensor_info[0].to_json_string() == \
            js.sensor_info[0].to_json_string()
        assert (ps.sensor_info[0].extrinsic[0, 3] == 1.0) == bool(kw)
        g = _read_scans(pt, path, soft_id_check=soft, **kw)
        w = _read_scans(jx, path, soft_id_check=soft, **kw)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert_scans_equal(a[0], b[0])


def test_errors_equal(tmp_path):
    jinfo, _ = _infos()
    no_meta = [m for m in _messages(jinfo) if "metadata" not in m[0]]
    cases = {"no_meta": _write(pbag, "ros1", str(tmp_path / "a.bag"),
                               no_meta),
             "no_lidar": _write(pbag, "mcap", str(tmp_path / "b.mcap"),
                                [m for m in _messages(jinfo)
                                 if "lidar" not in m[0]]),
             "empty_dir": str(tmp_path)}
    os.makedirs(str(tmp_path / "e.bag"))
    cases["empty_dir"] = str(tmp_path / "e.bag")
    for name, path in cases.items():
        with pytest.raises(ValueError) as pe:
            pbag.BagPacketSource(path)
        with pytest.raises(ValueError) as je:
            jbag.BagPacketSource(path)
        assert str(pe.value) == str(je.value), name
    with open(str(tmp_path / "bad.mcap"), "wb") as f:
        f.write(b"not mcap")
    with pytest.raises(ValueError):
        pbag.McapBagReader(str(tmp_path / "bad.mcap"))
