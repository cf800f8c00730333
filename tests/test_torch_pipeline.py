"""The port's slices as a whole against the JAX package, on the CPU.

The planar slice: a pcap is read and staged word-planar
(FrameReader.iter_planar_chunks), decoded (ScanPipeline.decode_planar) and
projected to XYZ with and without per-column poses
(ScanPipeline.project_planar).

The packet-layout slice: the pcap is staged as whole packets
(FrameReader.iter_chunks / read_all / iteration / stream_from_packets) and
goes through ScanPipeline.__call__ / batch: every field, XYZ and XYZ2,
optional dewarp, optional destagger. Tolerance: every key bit-exact,
without and with poses (the port's dewarp repeats the rounding order of
the JAX package's compiled einsum, see ops/pose.rotate_translate).

Captures are written by either package's PacketWriter + PcapWriter with
the same code, and carry what the grouper has to handle: a straggler of
the previous frame (dropped), a missing packet (zero-filled columns),
packets out of order within a frame, and columns with status cleared."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ouster_sdk_tpu_torch as pt
from _torch_helpers import DUAL, SINGLE, infos, poses
from ouster_sdk_tpu.io.frames import FrameReader as JaxFrameReader
from ouster_sdk_tpu.io.pcap import PcapWriter as JaxPcapWriter
from ouster_sdk_tpu.ops.fused import ScanPipeline as JaxScanPipeline
from ouster_sdk_tpu.ops.packet_format import PacketWriter as JaxPacketWriter
from ouster_sdk_tpu.utils import native

N_FRAMES = 3


def write_capture(path, info, packet_writer, pcap_writer, seed=0):
    """N_FRAMES frames of random fields; frame 2 gets a straggler of
    frame 1 and its packets reversed, frame 3 loses a packet."""
    pw = packet_writer(info.format)
    fields = list(pw.fields)
    cpp, h = pw.columns_per_packet, pw.pixels_per_column
    n_pkts = info.format.columns_per_frame // cpp
    rng = np.random.default_rng(seed)
    pkts = []
    for fid in range(1, N_FRAMES + 1):
        frame = []
        for p in range(n_pkts):
            buf = pw.new_packet()
            pw.set_packet_header(buf, init_id=info.init_id, prod_sn=info.sn)
            pw.set_frame_id(buf, fid)
            m0 = p * cpp
            status = (rng.random(cpp) >= 0.1).astype(np.uint32)
            pw.set_col_headers(
                buf, np.arange(cpp, dtype=np.uint64) + m0 * 1000 + fid,
                np.arange(cpp, dtype=np.uint16) + m0, status)
            r = rng.integers(0, 1 << 19, size=(h, cpp))
            r[rng.random((h, cpp)) < 0.05] = 0
            pw.set_field(buf, "RANGE", r)
            for name in fields:
                if name == "RANGE2":
                    pw.set_field(buf, name, r // 2)
                elif name in ("SIGNAL", "NEAR_IR", "REFLECTIVITY"):
                    pw.set_field(buf, name, rng.integers(0, 256, (h, cpp)))
            frame.append(bytes(buf))
        pkts.append(frame)
    pkts[1] = pkts[1][::-1]
    pkts[1].insert(3, pkts[0][5])          # straggler of frame 1
    del pkts[2][4]                          # frame 3 misses a packet
    with pcap_writer(path) as w:
        for k, payload in enumerate(p for frame in pkts for p in frame):
            w.write(payload, "10.0.0.2", "10.0.0.1", 7502, 7502,
                    10**9 + k * 10**5)


def jax_planar_chunks(path, jinfo, chunk, words=None):
    reader = JaxFrameReader(path, jinfo)
    if native.get_lib() is None:
        it = reader._planar_from_chunks(chunk, words)
    else:
        it = reader.iter_planar_chunks(chunk, words=words)
    # the native grouper reuses its buffers: copy each chunk
    return [tuple(np.array(a) for a in c) for c in it]


def port_planar_chunks(path, pinfo, chunk, words=None):
    return list(pt.FrameReader(path, pinfo).iter_planar_chunks(
        chunk, words=words))


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("profile", [DUAL, "LEGACY"])
@pytest.mark.parametrize("words", [None, (0, 1)], ids=["all", "subset"])
def test_frame_reader_matches(tmp_path, profile, words):
    jinfo, pinfo = infos(profile)
    path = str(tmp_path / "cap.pcap")
    write_capture(path, jinfo, JaxPacketWriter, JaxPcapWriter)
    want = jax_planar_chunks(path, jinfo, 2, words)
    got = port_planar_chunks(path, pinfo, 2, words)
    assert [list(c[0]) for c in got] == [[1, 2], [3]]
    _assert_chunks_equal(got, want)
    # the missing packet left zero columns, the straggler did not land
    hdrs = got[1][2]
    assert (hdrs[0] == 0).all(axis=0).sum() == pinfo.format.columns_per_packet


def test_port_writers_read_back_through_jax(tmp_path):
    jinfo, pinfo = infos(DUAL)
    jpath, ppath = str(tmp_path / "j.pcap"), str(tmp_path / "p.pcap")
    write_capture(jpath, jinfo, JaxPacketWriter, JaxPcapWriter)
    write_capture(ppath, pinfo, pt.PacketWriter, pt.PcapWriter)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    _assert_chunks_equal(jax_planar_chunks(ppath, jinfo, 4),
                         port_planar_chunks(ppath, pinfo, 4))


def test_metadata_parse_matches():
    jinfo, pinfo = infos(DUAL, w=1024, h=64)
    jfmt, pfmt = jinfo.format, pinfo.format
    for f in dataclasses.fields(pfmt):
        a, b = getattr(pfmt, f.name), getattr(jfmt, f.name)
        if hasattr(a, "value"):
            a, b = a.value, b.value
        assert a == (list(b) if isinstance(a, list) else b), f.name
    for name in ("beam_azimuth_angles", "beam_altitude_angles"):
        assert getattr(pinfo, name) == list(getattr(jinfo, name))
    for name in ("beam_to_lidar_transform", "lidar_to_sensor_transform",
                 "extrinsic"):
        np.testing.assert_array_equal(getattr(pinfo, name),
                                      getattr(jinfo, name))
    assert (pinfo.sn, pinfo.init_id) == (jinfo.sn, jinfo.init_id)
    assert str(pinfo.config.lidar_mode) == str(jinfo.config.lidar_mode)


@pytest.mark.parametrize("profile", [DUAL, "RNG19_RFL8_SIG16_NIR16"])
def test_scan_pipeline_matches(tmp_path, profile):
    """pcap -> staging -> decode -> project (with and without poses) ->
    destagger, port against the JAX package, bit for bit."""
    jinfo, pinfo = infos(profile)
    path = str(tmp_path / "cap.pcap")
    write_capture(path, jinfo, JaxPacketWriter, JaxPcapWriter, seed=4)
    jpipe = JaxScanPipeline(jinfo)
    pipe = pt.ScanPipeline(pinfo, device="cpu")
    assert pipe.device == torch.device("cpu")
    P = poses(N_FRAMES, pinfo.format.columns_per_frame)
    for fids, planes, hdrs, _ in port_planar_chunks(path, pinfo, N_FRAMES):
        B = len(fids)
        want = jpipe.decode_planar(jnp.asarray(planes), jnp.asarray(hdrs))
        got = pipe.decode_planar(planes, hdrs)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        for pose in (None, P[:B]):
            want = jpipe.project_planar(
                jnp.asarray(planes), jnp.asarray(hdrs), engine="pallas",
                poses=None if pose is None else jnp.asarray(pose))
            got = pipe.project_planar(planes, hdrs, poses=pose)
            want = want if pipe.dual else (want,)
            got = got if pipe.dual else (got,)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy().view(np.int32),
                                              np.asarray(w).view(np.int32))
        xyz = got[0]
        dxyz = pt.destagger_torch(xyz, pipe.shifts)
        ref = np.stack([np.moveaxis(pt.destagger(
            pinfo, np.moveaxis(x, 0, -1)), -1, 0) for x in xyz.numpy()])
        np.testing.assert_array_equal(dxyz.numpy(), ref)


# -- the packet-layout slice ------------------------------------------------

def jax_chunks(path, jinfo, chunk):
    # the native grouper reuses its buffers: copy each chunk
    return [tuple(np.array(a) for a in c)
            for c in JaxFrameReader(path, jinfo).iter_chunks(chunk)]


@pytest.mark.parametrize("profile", [DUAL, "LEGACY"])
def test_packet_staging_matches(tmp_path, profile):
    """iter_chunks, iteration and read_all on a capture written by the
    port's writers, with a missing packet, a frame in reverse order and a
    straggler."""
    jinfo, pinfo = infos(profile)
    path = str(tmp_path / "cap.pcap")
    write_capture(path, pinfo, pt.PacketWriter, pt.PcapWriter, seed=2)
    want = jax_chunks(path, jinfo, 2)
    got = list(pt.FrameReader(path, pinfo).iter_chunks(2))
    assert [list(c[0]) for c in got] == [[1, 2], [3]]
    _assert_chunks_equal(got, want)
    plan = pt.make_decode_plan(pinfo)
    assert got[0][1].shape == (2, plan.n_pkts, plan.pkt_words)
    # frame 3 lost packet 4: its slot is zero; frame 2 arrived reversed
    # and still sits in slot order
    assert (got[1][1][0, 4] == 0).all() and got[1][1][0, 3].any()
    mids = got[0][1][1, :, plan.hw + plan.mid_word] & 0xFFFF
    assert list(mids) == list(range(0, plan.w, plan.cpp))

    frames = np.concatenate([c[1] for c in want])
    for k, (fid, words, ts) in enumerate(pt.FrameReader(path, pinfo)):
        assert (fid, ts) == (k + 1, int(np.concatenate(
            [c[2] for c in want])[k]))
        np.testing.assert_array_equal(words, frames[k])
    for max_frames in (0, 2):
        wb, wf = JaxFrameReader(path, jinfo).read_all(max_frames)
        gb, gf = pt.FrameReader(path, pinfo).read_all(max_frames)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gf, wf)


def test_packet_staging_of_an_empty_capture(tmp_path):
    _, pinfo = infos(DUAL)
    path = str(tmp_path / "empty.pcap")
    with pt.PcapWriter(path):
        pass
    reader = pt.FrameReader(path, pinfo)
    assert list(reader.iter_chunks(4)) == []
    batch, fids = reader.read_all()
    assert batch.shape == (0, reader.plan.n_pkts, reader.plan.pkt_words)
    assert batch.dtype == np.uint32 and fids.shape == (0,)


class _Packet:
    """What stream_from_packets needs of a packet."""

    def __init__(self, buf, kind, ts):
        self.buf, self.host_timestamp, self._kind = buf, ts, kind

    def type(self):
        class _T:
            value = self._kind
        return _T


def test_stream_from_packets_matches(tmp_path):
    jinfo, pinfo = infos(DUAL)
    path = str(tmp_path / "cap.pcap")
    write_capture(path, pinfo, pt.PacketWriter, pt.PcapWriter, seed=3)
    with pt.PcapReader(path) as reader:
        packets = [(0, _Packet(np.frombuffer(bytes(payload), np.uint8),
                               "Lidar", pi.timestamp))
                   for pi, payload in reader]
    # an IMU packet and a short lidar packet are skipped
    packets.insert(5, (0, _Packet(np.zeros(48, np.uint8), "Imu", 1)))
    packets.insert(9, (0, _Packet(np.zeros(48, np.uint8), "Lidar", 2)))
    want = list(JaxFrameReader(path, jinfo).stream_from_packets(packets))
    got = list(pt.FrameReader(path, pinfo).stream_from_packets(packets))
    # the stream splits at every id change: the straggler of frame 1 cuts
    # frame 2 in two (ids 2, 1, 2, 3), as in the JAX package
    assert [f[0] for f in got] == [f[0] for f in want] == [1, 2, 1, 2, 3]
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        assert g[1].dtype == w[1].dtype
        np.testing.assert_array_equal(g[1], w[1])


def _assert_outputs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f":
            g = g.view(np.int32 if g.dtype == np.float32 else np.uint16)
            w = w.view(g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("destagger", [True, False],
                         ids=["destagger", "staggered"])
@pytest.mark.parametrize("profile", [DUAL, SINGLE])
def test_packet_pipeline_matches(tmp_path, profile, destagger):
    """pcap -> packet staging -> ScanPipeline.batch and __call__, without
    and with poses: every key of the output bit for bit."""
    jinfo, pinfo = infos(profile)
    path = str(tmp_path / "cap.pcap")
    write_capture(path, pinfo, pt.PacketWriter, pt.PcapWriter, seed=5)
    jpipe = JaxScanPipeline(jinfo, destagger=destagger)
    pipe = pt.ScanPipeline(pinfo, destagger=destagger, device="cpu")
    assert pipe.cfg.destagger == destagger and pipe.cfg.dual == pipe.dual
    frames, fids = pt.FrameReader(path, pinfo).read_all()
    assert list(fids) == [1, 2, 3]
    P = poses(N_FRAMES, pinfo.format.columns_per_frame, seed=11)
    for pose in (None, P):
        want = jpipe.batch(jnp.asarray(frames),
                           None if pose is None else jnp.asarray(pose))
        got = pipe.batch(frames, pose)
        assert ("XYZ2" in got) == pipe.dual
        assert got["XYZ"].shape == (N_FRAMES, pipe.plan.h, pipe.plan.w, 3)
        _assert_outputs_equal(got, want)
        want = jpipe(jnp.asarray(frames[1]),
                     None if pose is None else jnp.asarray(pose[1]))
        _assert_outputs_equal(pipe(frames[1], None if pose is None
                                   else pose[1]), want)
    # with poses the points moved, and no-return pixels stayed at zero
    rng = got["RANGE"].numpy()
    assert (got["XYZ"].numpy()[rng == 0] == 0).all()
    assert not np.array_equal(got["XYZ"].numpy(),
                              pipe.batch(frames)["XYZ"].numpy())


def test_packet_pipeline_options():
    """precision='f32' within one rounding of the product (the JAX
    package's CPU lowering contracts r * dir + off); dewarp=False ignores
    poses; use_extrinsics reaches the LUT."""
    from _torch_helpers import frames_batch

    jinfo, pinfo = infos(DUAL)
    pipe = pt.ScanPipeline(pinfo, device="cpu", precision="f32")
    frames = frames_batch(jinfo, pipe.plan)
    want = JaxScanPipeline(jinfo, precision="f32").batch(jnp.asarray(frames))
    got = pipe.batch(frames)
    dir_hi = pipe.lut.dir_hi.numpy()
    for key, name in (("XYZ", "RANGE"), ("XYZ2", "RANGE2")):
        g, w = got[key].numpy(), np.asarray(want[key])
        r = pt.destagger_torch(got[name], pipe.shifts, inverse=True) \
            .numpy().astype(np.float32)[..., None]
        prod = pt.destagger_torch(torch.from_numpy(r * dir_hi), pipe.shifts)
        tol = np.spacing(np.abs(prod.numpy())) + np.spacing(np.abs(g))
        assert (np.abs(g - w) <= tol).all()
    P = poses(2, pipe.plan.w, seed=2)
    nodewarp = pt.ScanPipeline(pinfo, device="cpu", dewarp=False)
    a, b = nodewarp.batch(frames, P), nodewarp.batch(frames)
    assert all(torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
               for k in b)
    with pytest.raises(ValueError, match="poses must be"):
        pipe.batch(frames, P[:, :-1])
    pinfo.extrinsic[:3, 3] = [1000.0, 0.0, 0.0]
    ext = pt.ScanPipeline(pinfo, device="cpu", use_extrinsics=True)
    assert not torch.equal(ext.batch(frames)["XYZ"], b["XYZ"])
