"""The port's native host library (utils/native.py, its own copy of the C++
source under ouster_sdk_tpu_torch/native/) against the numpy versions in
io/frames.py that keep its contracts: pcap_scan, the word-planar grouper
(instance staging, resumed chunks, the live slab), the packet-layout
grouper and crc64, byte for byte on the captures the engine tests
synthesize, on big-endian and nanosecond captures, on truncated tails and
on files shorter than a pcap header; pcap_scan takes a capture's bytes as the
JAX package's does, with equal outputs. Then FrameReader and the device engine
with the library and with `native.get_lib` patched to None give equal
output, and the build and the wrappers refuse what they cannot run.
"""

import os
import struct

import numpy as np
import pytest

import ouster_sdk_tpu_torch as pt
from _torch_helpers import (DUAL, SINGLE, assert_scans_equal, aux_packet,
                            engine_infos, frame_packets, lidar_stream,
                            write_pcap)
from ouster_sdk_tpu_torch.io import device_engine as de
from ouster_sdk_tpu_torch.io import frames as fr
from ouster_sdk_tpu_torch.utils import native


@pytest.fixture(autouse=True)
def _library():
    if native.get_lib() is None:
        pytest.skip("no g++ on this host: the numpy staging runs alone")


# -- captures (those of tests/test_torch_engine.py) -----------------------------

def _frames(jinfo, fids, **kw):
    return [frame_packets(jinfo, fid, **kw) for fid in fids]


def _clean(profile, h=32, w=256):
    def make():
        jinfo, pinfo = engine_infos(profile, w=w, h=h)
        return pinfo, lidar_stream(_frames(jinfo, (3, 4, 5, 6),
                                           alert_flags=3))[:-2]
    return make


def _boundaries():
    jinfo, pinfo = engine_infos(DUAL)
    f1, f2, f3, f4 = _frames(jinfo, (10, 11, 12, 13))
    del f3[6]
    seq = (f1[:-1] + [f2[0]] + [f1[-1]] + f2[1:4] + [f1[2]] + f2[4:]
           + [f2[5]] + f3 + f4)
    return pinfo, lidar_stream([seq])


def _wrap():
    jinfo, pinfo = engine_infos(SINGLE)
    frames = _frames(jinfo, (0xFFFE, 0xFFFF, 0, 1))
    frames[2].insert(3, frames[1][5])
    del frames[1][7]
    return pinfo, lidar_stream(frames)


def _ids():
    jinfo, pinfo = engine_infos(DUAL, init_id=1234, sn=99887766)
    frames = _frames(jinfo, (5, 6))
    writer = pt.PacketWriter(pinfo.format)
    for k in (2, 3):
        writer.set_packet_header(frames[0][k], init_id=1241,
                                 prod_sn=99887767)
    return pinfo, lidar_stream(frames)


def _zero_ts():
    jinfo, pinfo = engine_infos(SINGLE)
    f1, f2 = _frames(jinfo, (10, 11))
    T = 10**9
    stream = [("lidar", p, T + k * 10**5) for k, p in enumerate(f1[:-1])]
    stream += [("lidar", f1[0], 0), ("lidar", f1[-1], 2 * T),
               ("lidar", f1[0], 3 * T)]
    stream += [("lidar", p, 4 * T + k * 10**5) for k, p in enumerate(f2)]
    return pinfo, stream


def _foreign_ports():
    jinfo, pinfo = engine_infos(DUAL)
    stream = []
    for k, p in enumerate(sum(_frames(jinfo, (1, 2)), [])):
        stream.append(("lidar", p, 10**9 + 2000 * k))
        stream.append((7512, p, 10**9 + 2000 * k + 1000))
    return pinfo, stream


def _hybrid():
    jinfo, pinfo = engine_infos("RNG19_RFL8_SIG16_NIR16_ZONE16",
                                nmea_imu=True, zone_port=7504)
    f1, f2, f3 = _frames(jinfo, (1, 2, 3))
    items = ([("lidar", p) for p in f1[:-1]]
             + [("imu", aux_packet(jinfo, "imu", 2, m_id0=0))]
             + [("lidar", p) for p in f1[-1:] + f2]
             + [("zone", aux_packet(jinfo, "zone", 2))]
             + [("lidar", p) for p in f3])
    return pinfo, [(k, p, 10**9 + i * 10**5)
                   for i, (k, p) in enumerate(items)]


def _one_packet():
    jinfo, pinfo = engine_infos(SINGLE)
    return pinfo, [("lidar", frame_packets(jinfo, 3, invalid=1.0)[0], 5000)]


CAPTURES = {
    "dual": _clean(DUAL), "single-128x512": _clean(SINGLE, 128, 512),
    "legacy": _clean("LEGACY"),
    "rgb-dual": _clean("RNG19_RFL8_SIG16_NIR16_RGB16_DUAL"),
    "fusa": _clean("FUSA_RNG15_RFL8_NIR8_DUAL"),
    "low-data-rate": _clean("RNG15_RFL8_WIN8"),
    "boundaries": _boundaries, "frame-id-wrap": _wrap, "id-check": _ids,
    "zero-ts-duplicate": _zero_ts, "foreign-ports": _foreign_ports,
    "hybrid": _hybrid, "one-packet": _one_packet,
    "empty": lambda: (engine_infos(SINGLE)[1], []),
}


@pytest.fixture(params=list(CAPTURES))
def capture(request, tmp_path):
    pinfo, stream = CAPTURES[request.param]()
    return write_pcap(str(tmp_path / "c.pcap"), stream), pinfo


def _numpy_route(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _scan(path, monkeypatch=None):
    """FrameReader._scan of a fresh reader: native, or numpy when
    `monkeypatch` is given."""
    if monkeypatch is None:
        return fr.FrameReader(path, _info())._scan()
    with monkeypatch.context() as m:
        _numpy_route(m)
        return fr.FrameReader(path, _info())._scan()


def _info():
    return engine_infos(SINGLE)[1]


def _same(a, b, tag=""):
    assert len(a) == len(b), tag
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{tag}[{k}]"
        assert np.array_equal(x, y), f"{tag}[{k}]"


# -- pcap_scan ------------------------------------------------------------------

def test_pcap_scan_matches_numpy(capture, monkeypatch):
    path, _ = capture
    native.reset_calls()
    got = _scan(path)
    assert native.calls["pcap_scan"] == 1
    _same(got, _scan(path, monkeypatch), "pcap_scan")
    assert native.calls["pcap_scan"] == 1


def _rewrite(path, out, endian=">", nano=False):
    """The capture rewritten with another byte order or nanosecond
    timestamps: every header field converted, the packets unchanged."""
    with open(path, "rb") as f:
        data = f.read()
    hdr = list(struct.unpack("<IHHiIII", data[:24]))
    hdr[0] = 0xA1B23C4D if nano else 0xA1B2C3D4
    parts = [struct.pack(endian + "IHHiIII", *hdr)]
    pos = 24
    while pos + 16 <= len(data):
        sec, frac, incl, orig = struct.unpack("<IIII", data[pos:pos + 16])
        parts.append(struct.pack(endian + "IIII", sec,
                                 frac * 1000 if nano else frac, incl, orig))
        parts.append(data[pos + 16:pos + 16 + incl])
        pos += 16 + incl
    with open(out, "wb") as f:
        f.write(b"".join(parts))
    return out


@pytest.mark.parametrize("variant", ["big-endian", "nanoseconds"])
def test_pcap_scan_byte_orders_and_resolutions(tmp_path, monkeypatch,
                                               variant):
    pinfo, stream = _foreign_ports()
    path = write_pcap(str(tmp_path / "c.pcap"), stream)
    out = _rewrite(path, str(tmp_path / "v.pcap"),
                   endian=">" if variant == "big-endian" else "<",
                   nano=variant == "nanoseconds")
    got = _scan(out)
    _same(got, _scan(out, monkeypatch), variant)
    _same(got, _scan(path), f"{variant} against the original")


def _reassembly_captures():
    """The captures of tests/test_pcap_reassembly.py's native cases
    (test_native_scan_null_loopback, test_native_scan_ipv6,
    test_native_duplicate_fragment_hole): (name, frames, linktype)."""
    from test_pcap_reassembly import _udp4, _udp6

    from ouster_sdk_tpu_torch.io.pcap import LINKTYPE_ETHERNET, LINKTYPE_NULL

    eth, eth6 = (b"\x00" * 12 + struct.pack(">H", t) for t in (0x0800,
                                                              0x86DD))
    payload = bytes(range(256)) * 9
    udp = struct.pack(">HHHH", 7000, 7502, 8 + len(payload), 0) + payload

    def frag(off, chunk, more):
        ff = (0x2000 if more else 0) | (off // 8)
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(chunk), 42, ff,
                         64, 17, 0, b"\x0a\x00\x00\x01", b"\x0a\x00\x00\x02")
        return eth + ip + chunk

    return [
        ("null_loopback", [struct.pack("<I", 2) + _udp4(b"x" * 100)
                           for _ in range(3)], LINKTYPE_NULL),
        ("ipv6", [eth6 + _udp6(bytes([i]) * 64) for i in range(4)],
         LINKTYPE_ETHERNET),
        ("duplicate_fragment_hole",
         [frag(0, udp[:800], True), frag(0, udp[:800], True),
          frag(1600, udp[1600:], False), frag(800, udp[800:1600], True)],
         LINKTYPE_ETHERNET)]


@pytest.mark.parametrize("case", range(3), ids=["null_loopback", "ipv6",
                                                 "duplicate_fragment_hole"])
def test_pcap_scan_takes_bytes_as_the_jax_package_does(tmp_path, case):
    """pcap_scan on a capture's bytes (not an array) equals the JAX
    package's native pcap_scan on the same bytes, and itself on the same
    bytes as a u8 array."""
    from test_pcap_reassembly import _write_raw_pcap

    from ouster_sdk_tpu.utils import native as jnative

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    name, frames, linktype = _reassembly_captures()[case]
    path = str(tmp_path / f"{name}.pcap")
    _write_raw_pcap(path, frames, linktype)
    with open(path, "rb") as f:
        data = f.read()
    got = native.pcap_scan(data, False, False, linktype)
    want = jnative.pcap_scan(data, False, False, linktype)
    # the JAX package returns its whole payload buffer, the port the bytes
    # up to the last datagram's end
    _same(got[1:], want[1:], name)
    assert np.array_equal(got[0], want[0][:got[0].size])
    assert got[0].size == int(got[1][-1] + got[2][-1])
    _same(got, native.pcap_scan(np.frombuffer(data, np.uint8), False, False,
                                linktype), name)
    assert len(got[1]) == (1 if case == 2 else len(frames))
    _same(native.pcap_scan(bytearray(data), False, False, linktype), got,
          name)


def test_pcap_scan_truncated_and_short_files(tmp_path, monkeypatch):
    """Cut inside a record header, inside a fragment and between the
    fragments of one datagram; and files of 0, 10, 23 and 24 bytes."""
    pinfo, stream = _boundaries()
    path = write_pcap(str(tmp_path / "c.pcap"), stream)
    with open(path, "rb") as f:
        data = f.read()
    full = len(_scan(path)[1])
    for k, cut in enumerate((len(data) - 5, len(data) - 700,
                             len(data) // 2, len(data) // 3 + 1, 24 + 8,
                             23, 10, 0, 24)):
        p = str(tmp_path / f"cut{k}.pcap")
        with open(p, "wb") as f:
            f.write(data[:cut])
        got = _scan(p)
        _same(got, _scan(p, monkeypatch), f"cut at {cut}")
        assert len(got[1]) < full
    with open(str(tmp_path / "bad.pcap"), "wb") as f:
        f.write(b"\x01" * 64)
    with pytest.raises(ValueError, match="unknown pcap magic"):
        _scan(str(tmp_path / "bad.pcap"))


# -- the groupers -----------------------------------------------------------------

def _staging(path, pinfo, chunk=2):
    """Everything FrameReader stages from the capture: instance batches of
    the admission replay's groups, planar chunks (all words and a subset)
    and packet-layout chunks."""
    reader = fr.FrameReader(path, pinfo, strict_ports=True)
    lidar, aux = reader.hybrid_streams()
    inst = de._AuxRouter(de._AuxApplier(pinfo), reader.plan, reader.pf,
                         lidar, aux).instances
    groups = [i.pkt_idx for i in inst if i.has_lidar]
    out = []
    for b in reader.iter_instance_batches(groups, chunk):
        out += [b.frame_ids, b.planes.copy(), b.col_hdrs.copy(), b.host_ts,
                b.pkt_ts.copy(), b.pkt_hdrs.copy(), b.first_hdr.copy()]
    lenient = fr.FrameReader(path, pinfo)
    for words in (None, (0,)):
        for item in lenient.iter_planar_chunks(chunk, words=words):
            out += list(item)
    for item in lenient.iter_chunks(chunk):
        out += list(item)
    return out, len(groups)


def test_staging_matches_numpy(capture, monkeypatch):
    """Instance staging (one single-frame grouper call a frame, with the
    scan headers), resumed planar chunks with and without a word subset,
    and resumed packet-layout chunks: byte-equal to the numpy versions."""
    path, pinfo = capture
    native.reset_calls()
    got, n = _staging(path, pinfo)
    n_planar = native.calls["group_frames_planar"]
    assert n_planar >= n
    assert (native.calls["group_frames"] > 0) == (n > 0)
    with monkeypatch.context() as m:
        _numpy_route(m)
        want, _ = _staging(path, pinfo)
    _same(got, want, "staging")
    assert native.calls["group_frames_planar"] == n_planar


@pytest.mark.parametrize("max_frames", [1, 2, 3])
def test_resumed_grouping_carries_the_released_id(tmp_path, max_frames):
    """Direct calls, max_frames at a time, resumed where the last one
    stopped, with io_released carried: the same frames as one pass of the
    numpy grouper over the whole run, stragglers and duplicates dropped
    across the breaks."""
    pinfo, stream = _boundaries()
    pf, plan = pt.PacketFormat.from_info(pinfo), pt.make_decode_plan(pinfo)
    pkts = np.stack([np.asarray(p, np.uint8) for _, p, _ in stream])
    payloads = pkts.reshape(-1)
    offs = np.arange(len(pkts), dtype=np.int64) * pkts.shape[1]
    ts = np.asarray([t for _, _, t in stream], np.uint64)
    n_all = 8

    def run(group, max_frames, resume):
        planes = np.zeros((n_all, plan.pw, plan.h, plan.w), np.uint32)
        hdrs = np.zeros((n_all, plan.schw, plan.w), np.uint32)
        fids = np.zeros(n_all, np.int64)
        tss = np.zeros(n_all, np.uint64)
        released = np.full(1, -1, np.int64)
        pos = nf = 0
        while pos < offs.size:
            c, k = group(payloads, offs[pos:], ts[pos:], pf, plan,
                         planes[nf:nf + max_frames],
                         hdrs[nf:nf + max_frames], fids[nf:nf + max_frames],
                         tss[nf:nf + max_frames],
                         io_released=released if resume else None)
            if k == 0:
                break
            pos, nf = pos + c, nf + k
        return [fids[:nf], tss[:nf], planes[:nf], hdrs[:nf]]

    def numpy_group(payloads, offs, *args, **kw):
        return fr.group_frames_planar(
            fr._gather_packets(payloads, offs, pf.lidar_packet_size),
            *args, **kw)

    want = run(numpy_group, n_all, False)
    assert list(want[0]) == [10, 11, 12, 13]
    _same(run(fr.stage_planar, max_frames, True), want, "resumed")
    _same(run(numpy_group, max_frames, True), want, "numpy resumed")


def test_engine_and_live_batcher_without_the_library(tmp_path, monkeypatch):
    """The device engine's iterator, index and live batcher give the same
    scans with the native staging and with the numpy one."""
    pinfo, stream = _hybrid()
    path = write_pcap(str(tmp_path / "h.pcap"), stream)

    def run():
        it = de.DeviceScanIterator(path, pinfo, device="cpu", batch=2)
        scans = list(it.iter_released())
        index = de.DeviceScanIndex(it)
        live = de.LiveDeviceBatcher(pinfo, device="cpu")
        out = []
        for kind, p, t in stream:
            out += (live.push(p, t) if kind == "lidar"
                    else live.push_aux(kind, p, t))
        return scans, [index.scan_at(i) for i in range(len(index))], out

    native.reset_calls()
    got = run()
    assert native.calls["pcap_scan"] == 1
    assert native.calls["group_frames_planar"] >= 3 + len(got[2])
    with monkeypatch.context() as m:
        _numpy_route(m)
        want = run()
    assert [r for r, _ in got[0]] == [r for r, _ in want[0]]
    for a, b in zip([s for _, s in got[0]] + got[1] + got[2],
                    [s for _, s in want[0]] + want[1] + want[2],
                    strict=True):
        assert_scans_equal(a, b)


# -- crc64 --------------------------------------------------------------------

def test_crc64_matches_the_table(monkeypatch):
    rng = np.random.default_rng(3)
    jinfo, pinfo = engine_infos(DUAL)
    pf = pt.PacketFormat.from_info(pinfo)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8) for n in (8, 9, 1000)]
    bufs += frame_packets(jinfo, 1)[:2]
    native.reset_calls()
    got = [pf.calculate_crc(b) for b in bufs] + [
        pf.calculate_crc(bytes(bufs[2]))]
    assert native.calls["crc64"] == len(got)
    with monkeypatch.context() as m:
        _numpy_route(m)
        want = [pf.calculate_crc(b) for b in bufs] + [
            pf.calculate_crc(bytes(bufs[2]))]
    assert got == want
    assert native.crc64(b"123456789") == 0x995DC9BBDF1939FA   # CRC-64/XZ


# -- the build and the argument checks -------------------------------------------

def _fresh_build(monkeypatch, tmp_path, source=None):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    if source is not None:
        monkeypatch.setattr(native, "SOURCE", source)


def test_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" int onat_crc64( { return 0; }\n')
    _fresh_build(monkeypatch, tmp_path, str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.get_lib()
    assert "bad.cpp" in str(e.value)
    assert not os.listdir(tmp_path / "build")   # no partial library left


def test_no_compiler_means_numpy(tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None
    assert native.crc64(b"x") is None
    pinfo, stream = _clean(DUAL)()
    path = write_pcap(str(tmp_path / "c.pcap"), stream)
    native.reset_calls()
    chunks = list(fr.FrameReader(path, pinfo).iter_planar_chunks(2))
    assert sum(c[0].size for c in chunks) == 4
    assert sum(native.calls.values()) == 0


def test_build_is_keyed_and_builds_from_the_port_source(monkeypatch):
    """The library loaded is the one named by the hash of the port's own
    source and flags and by the machine; another source or machine names
    another file. (A build into a fresh directory is
    test_torch_isolation.py's.)"""
    port = os.path.dirname(os.path.abspath(pt.__file__))
    assert native.SOURCE == os.path.join(port, "native", "ouster_native.cpp")
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(port, "kernels", "_build")
    lib = native.get_lib()
    assert lib._name == path and native.get_lib() is lib
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.lib_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "_machine_tag", lambda: "other")
    assert native.lib_path() != path


def test_wrappers_check_their_arrays():
    pinfo = engine_infos(DUAL)[1]
    pf, plan = pt.PacketFormat.from_info(pinfo), pt.make_decode_plan(pinfo)
    size = pf.lidar_packet_size
    payloads = np.zeros(2 * size, np.uint8)
    offs = np.array([0, size], np.int64)

    def call(planes=None, colhdr=None, offsets=offs, fids=None, **kw):
        planes = (np.zeros((2, plan.pw, plan.h, plan.w), np.uint32)
                  if planes is None else planes)
        colhdr = (np.zeros((2, plan.schw, plan.w), np.uint32)
                  if colhdr is None else colhdr)
        fids = np.zeros(2, np.int64) if fids is None else fids
        return fr.stage_planar(payloads, offsets, None, pf, plan, planes,
                               colhdr, fids, np.zeros(2, np.uint64), **kw)

    assert call() == (2, 1)
    planes = np.zeros((2, plan.w, plan.h, plan.pw), np.uint32)
    bad = [
        dict(planes=planes.transpose(0, 3, 2, 1)),           # strided
        dict(planes=np.zeros((2, plan.pw, plan.h, plan.w), np.int32)),
        dict(colhdr=np.zeros((2, plan.schw + 1, plan.w), np.uint32)),
        dict(offsets=np.array([0, size + 1], np.int64)),     # past the end
        dict(offsets=np.array([-1], np.int64)),
        dict(fids=np.zeros(1, np.int64)),
        dict(word_sel=np.array([plan.pw])),
        dict(out_pkt_ts=np.zeros((2, plan.n_pkts), np.int64)),
        dict(io_released=np.zeros(2, np.int64)),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    frames = np.zeros((2, plan.n_pkts, plan.pkt_words), np.uint32)
    with pytest.raises(ValueError):
        native.group_frames(payloads, offs, None, size, 0, 0, 0xFFFF,
                            size, 16, plan.n_pkts, frames,
                            np.zeros(2, np.int64), np.zeros(2, np.uint64))
    with pytest.raises(ValueError):
        native.group_frames(payloads, offs, None, size, 0, 0, 0xFFFF, 8, 16,
                            plan.n_pkts, frames[:, :, ::2],
                            np.zeros(2, np.int64), np.zeros(2, np.uint64))
    with pytest.raises(TypeError):      # neither an array nor bytes-like
        native.pcap_scan("\0" * 64, False, False, 1)
    with pytest.raises(ValueError):
        native.pcap_scan(np.zeros(16, np.uint32), False, False, 1)
