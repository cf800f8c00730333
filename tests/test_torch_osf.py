"""OSF replay and recording in the PyTorch port (ouster_sdk_tpu_torch)
against the JAX package: the two Writers make byte-identical files from the
same scans, each package's Reader reads the other's files to equal scans,
the faults behave alike, OsfScanSource and open_source agree, the replay's
projector attaches the same XYZ cache as the JAX package's (JAX on the CPU,
its route forced with OUSTER_SDK_TPU_DEVICE_DECODE=1 as
tests/test_device_osf.py does), XYZLut serves it, and the file operations
of io/osf_ops agree.

Scans are made from seeds with the JAX package's LidarScan and carried
into the port with state.lidar_scan_from_jax; sensors are 32x256 dual
(a second one 32x512), one metadata string parsed by each package."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import ouster_sdk_tpu as J
import ouster_sdk_tpu.io.osf as josf
import ouster_sdk_tpu.io.osf_ops as jops
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.osf as posf
import ouster_sdk_tpu_torch.io.osf_ops as pops
from _torch_helpers import DUAL, SINGLE, assert_scans_equal, engine_metadata
from ouster_sdk_tpu.core.field import ZONE_STATE_DTYPE, FieldClass
from ouster_sdk_tpu.io import device_engine as jde
from ouster_sdk_tpu_torch.io import device_engine as pde
from ouster_sdk_tpu_torch.utils import native

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"
EXT = np.array([[0.0, -1.0, 0.0, 0.25], [1.0, 0.0, 0.0, -0.5],
                [0.0, 0.0, 1.0, 1.5], [0.0, 0.0, 0.0, 1.0]])


def _infos(profile=DUAL, w=256, **knobs):
    meta = engine_metadata(profile, w=w, **knobs)
    return (J.core.metadata.sensor_info_from_metadata(meta),
            pt.sensor_info_from_metadata(meta))


def _jscan(jinfo, k: int, seed: int, custom: bool = False):
    """A JAX LidarScan with every field random from the seed (5% of
    ranges zero), headers of frame k, a few posed columns and, with
    `custom`, fields outside the profile of every kind the codec stores."""
    rng = np.random.default_rng([seed, k])
    s = J.LidarScan(jinfo)
    for name in list(s.fields):
        a = s.field(name)
        bits = 19 if name.startswith("RANGE") else 8 * a.dtype.itemsize
        a[...] = rng.integers(0, 1 << bits, a.shape, dtype=np.uint64
                              ).astype(a.dtype)
        if name.startswith("RANGE"):
            a[rng.random(a.shape) < 0.05] = 0
    t0 = 10**9 + k * 10**8 + seed * 10**6
    s.frame_id = k + 1
    s.timestamp[:] = t0 + np.arange(s.w, dtype=np.uint64) * 1000
    s.measurement_id[:] = np.arange(s.w)
    s.status[:] = (rng.random(s.w) > 0.1).astype(np.uint32)
    s.packet_timestamp[:] = t0 + 7 + np.arange(
        len(s.packet_timestamp), dtype=np.uint64) * 16000
    s.alert_flags[:] = rng.integers(0, 256, len(s.alert_flags))
    s.frame_status, s.shutdown_countdown = 3, 9
    s.shot_limiting_countdown = 4
    s.pose[5] = EXT
    s.pose[7, :3, 3] = rng.normal(0, 1, 3)
    if custom:
        h, w = s.h, s.w
        s.add_field("CUSTOM3", rng.integers(0, 256, (h, w), dtype=np.uint8),
                    FieldClass.PIXEL_FIELD)
        s.add_field("NORMALS", rng.normal(0, 1, (h, w, 3)
                                          ).astype(np.float32),
                    FieldClass.PIXEL_FIELD)
        s.add_field("MASK16", rng.integers(0, 1 << 16, (h, w),
                                           dtype=np.uint16),
                    FieldClass.PIXEL_FIELD)
        s.add_field("COLF", rng.normal(0, 1, w), FieldClass.COLUMN_FIELD)
        s.add_field("SCANF", rng.integers(-9, 9, (4, 5)).astype(np.int16),
                    FieldClass.SCAN_FIELD)
        zs = np.zeros(16, ZONE_STATE_DTYPE)
        zs["count"] = np.arange(16)
        s.add_field("ZONE_STATES", zs, FieldClass.SCAN_FIELD)
    return s


def _pair(jinfo, pinfo, n: int, seed: int, custom: bool = False):
    js = [_jscan(jinfo, k, seed, custom) for k in range(n)]
    return js, [pt.lidar_scan_from_jax(pinfo, s) for s in js]


def _write(mod, path, infos, per_sensor, *, encoder="png", ext=None,
           async_=False, chunk_size=2 * 1024 * 1024):
    cls = mod.AsyncWriter if async_ else mod.Writer
    kw = dict(encoder=encoder, chunk_size=chunk_size)
    with cls(path, **kw) as w:
        for info in infos:
            w.add_sensor(info)
        if ext is not None:
            (w._writer if async_ else w).set_extrinsics(0, ext)
        for k in range(max(map(len, per_sensor))):
            for si, scans in enumerate(per_sensor):
                if k < len(scans):
                    w.save(si, scans[k])
    return path


def _same_bytes(a, b) -> None:
    with open(a, "rb") as f, open(b, "rb") as g:
        x, y = f.read(), g.read()
    assert len(x) == len(y) and x == y


def _decoded(mod, path, **kw):
    r = mod.Reader(path, **kw)
    return r, [m.decode() for m in r.messages() if m.is_lidar_scan()]


# -- the writers: byte-identical files, read across ---------------------------

@pytest.mark.parametrize("case", ["plain", "custom", "extrinsics", "async",
                                  "chunked"])
@pytest.mark.parametrize("encoder", ["png", "zpng"])
def test_writers_make_byte_identical_files(tmp_path, encoder, case):
    jinfo, pinfo = _infos()
    js, ps = _pair(jinfo, pinfo, 3, seed=1, custom=case == "custom")
    kw = dict(encoder=encoder, ext=EXT if case == "extrinsics" else None,
              async_=case == "async",
              chunk_size=1 if case == "chunked" else 2 * 1024 * 1024)
    jpath = _write(josf, str(tmp_path / "j.osf"), [jinfo], [js], **kw)
    ppath = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps], **kw)
    _same_bytes(jpath, ppath)
    # each package reads the other's file to the scans written
    pr, pback = _decoded(posf, jpath)
    jr, jback = _decoded(josf, ppath)
    assert len(pback) == len(jback) == 3
    for a, b, orig in zip(pback, jback, ps):
        assert_scans_equal(a, b, "port vs JAX reader")
        assert_scans_equal(a, orig, "read back vs written")
    assert pr.sensor_info[0].to_json_string() == \
        jr.sensor_info[0].to_json_string()
    want = EXT if case == "extrinsics" else np.eye(4)
    np.testing.assert_array_equal(pr.sensor_info[0].extrinsic, want)
    assert pr.chunk_offsets.tolist() == jr.chunk_offsets.tolist()
    assert (pr.start_ts, pr.end_ts, pr.version, pr.metadata_id) == \
        (jr.start_ts, jr.end_ts, jr.version, jr.metadata_id)


def _sets(jinfos, pinfos, seed):
    """Three collated sets of two sensors: the second lacks sensor 1,
    set-level fields on the first."""
    j0, p0 = _pair(jinfos[0], pinfos[0], 3, seed)
    j1, p1 = _pair(jinfos[1], pinfos[1], 2, seed + 1)
    jsets = [J.io.sources.LidarScanSet([j0[0], j1[0]]),
             J.io.sources.LidarScanSet([j0[1], None]),
             J.io.sources.LidarScanSet([j0[2], j1[1]])]
    psets = [pt.LidarScanSet([p0[0], p1[0]]), pt.LidarScanSet([p0[1], None]),
             pt.LidarScanSet([p0[2], p1[1]])]
    conf = np.arange(6, dtype=np.float32).reshape(2, 3)
    jsets[0].add_field("conf", conf)
    psets[0].add_field("conf", conf)
    return jsets, psets


@pytest.mark.parametrize("async_", [False, True])
@pytest.mark.parametrize("encoder", ["png", "zpng"])
def test_collated_save_set_byte_identical(tmp_path, monkeypatch, encoder,
                                         async_):
    monkeypatch.setenv(ENV, "0")
    jinfos, pinfos = zip(*(_infos(DUAL, sn=11), _infos(SINGLE, w=512,
                                                       sn=22)))
    jsets, psets = _sets(jinfos, pinfos, seed=3)
    for mod, infos, sets, name in ((josf, jinfos, jsets, "j.osf"),
                                   (posf, pinfos, psets, "p.osf")):
        cls = mod.AsyncWriter if async_ else mod.Writer
        with cls(str(tmp_path / name), encoder=encoder) as w:
            for info in infos:
                w.add_sensor(info)
            for s in sets:
                w.save_set(s)
    _same_bytes(tmp_path / "j.osf", tmp_path / "p.osf")
    for path in (tmp_path / "j.osf", tmp_path / "p.osf"):
        src = posf.OsfScanSource(str(path))
        jsrc = josf.OsfScanSource(str(path))
        assert src.is_collated() and jsrc.is_collated() and len(src) == 3
        got = list(src)
        for g, j, want in zip(got, jsrc, psets):
            assert g.fields == j.fields == want.fields
            for name in want.fields:
                np.testing.assert_array_equal(g.field(name), j.field(name))
            for a, b, c in zip(g, j, want):
                assert (a is None) == (b is None) == (c is None)
                if a is not None:
                    assert_scans_equal(a, b)
                    assert_scans_equal(a, c)
        assert src[1][1] is None and src[-1][0] == got[2][0]


def test_save_set_checks_like_the_jax_package(tmp_path):
    jinfo, pinfo = _infos()
    for mod, info, LS in ((josf, jinfo, J.LidarScan),
                          (posf, pinfo, pt.LidarScan)):
        with mod.Writer(str(tmp_path / "x.osf")) as w:
            w.add_sensor(info)
            with pytest.raises(ValueError, match="does not match number"):
                w.save_set([LS(info), LS(info)])
            with pytest.raises(RuntimeError, match="no valid packet"):
                w.save_set([LS(info)])
        with pytest.raises(RuntimeError, match="writer is closed"):
            w.save(0, LS(info))


# -- the reader's faults --------------------------------------------------------

def test_bad_crc_alike(tmp_path):
    jinfo, pinfo = _infos()
    _, ps = _pair(jinfo, pinfo, 3, seed=5)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps], chunk_size=1)
    r = posf.Reader(path)
    second = r._chunks_base + int(r.chunk_offsets["offset"][1])
    r.close()
    bad = str(tmp_path / "bad.osf")
    shutil.copy(path, bad)
    with open(bad, "r+b") as f:
        f.seek(second + 40)
        byte = f.read(1)
        f.seek(second + 40)
        f.write(bytes([byte[0] ^ 0xFF]))
    # the default handler raises on the ERROR
    errs = []
    for mod in (posf, josf):
        with pytest.raises(RuntimeError) as e:
            [m.decode() for m in mod.Reader(bad).messages()]
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "chunk CRC mismatch" in errs[0]
    # a handler that does not raise skips the corrupt chunk
    seen = {}
    for mod in (posf, josf):
        log = seen[mod] = []
        _, back = _decoded(mod, bad,
                           error_handler=lambda s, m: log.append((s.value,
                                                                  m)))
        assert [s.frame_id for s in back] == [1, 3]
    assert seen[posf] == seen[josf] and len(seen[posf]) == 1
    # a corrupt header is refused when the file opens
    with open(bad, "r+b") as f:
        hdr_size = int.from_bytes(f.read(4), "little")
        f.seek(4 + hdr_size - 1)
        byte = f.read(1)
        f.seek(4 + hdr_size - 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    for mod in (posf, josf):
        with pytest.raises(ValueError, match="header CRC mismatch"):
            mod.Reader(bad)


def test_empty_files_alike(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "0")
    empty = tmp_path / "empty.osf"
    empty.write_bytes(b"")
    for mod in (posf, josf):
        with pytest.raises(ValueError, match="too short"):
            mod.Reader(str(empty))
    # a finished file with a sensor and no scans
    jinfo, pinfo = _infos()
    _write(josf, str(tmp_path / "j.osf"), [jinfo], [[]])
    _write(posf, str(tmp_path / "p.osf"), [pinfo], [[]])
    _same_bytes(tmp_path / "j.osf", tmp_path / "p.osf")
    src = posf.OsfScanSource(str(tmp_path / "p.osf"))
    assert len(src) == 0 and list(src) == [] and src.scans_num == [0]
    assert list(posf.Reader(str(tmp_path / "p.osf")).messages()) == []
    # a file the writer never closed: its header still says INVALID
    w = posf.Writer(str(tmp_path / "open.osf"))
    w.add_sensor(pinfo)
    w._f.flush()
    for mod in (posf, josf):
        with pytest.raises(ValueError, match="not VALID"):
            mod.Reader(str(tmp_path / "open.osf"))
    w.close()


def test_unsupported_fields_reported_alike(tmp_path, monkeypatch):
    """A channel with an unknown CHAN_FIELD, a custom field of an unknown
    type tag and a channel that is neither PNG nor zPNG: skipped, each with
    the same WARNING through the error handler in both packages."""
    jinfo, pinfo = _infos()
    js, ps = _pair(jinfo, pinfo, 2, seed=9)
    for s in js + ps:
        s.add_field("ZZZ", np.ones((s.h, s.w), np.uint16),
                    FieldClass.PIXEL_FIELD)
        s.add_field("NEWER", np.ones(s.w, np.int8), FieldClass.COLUMN_FIELD)

    def garbled(real):
        def encode(img, level=1):
            return b"garbage!" * 4 if img.dtype == np.uint8 else \
                real(img, level)
        return encode

    for mod in (josf, posf):
        monkeypatch.setitem(mod._NAME_TO_CHAN_FIELD, "ZZZ", 200)
        monkeypatch.setitem(mod._DTYPE_TO_TYPE, np.dtype(np.int8), 99)
        monkeypatch.setattr(mod.png_codec, "encode_field_png",
                            garbled(mod.png_codec.encode_field_png))
    _write(josf, str(tmp_path / "j.osf"), [jinfo], [js])
    _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    monkeypatch.undo()
    _same_bytes(tmp_path / "j.osf", tmp_path / "p.osf")
    seen = {}
    for mod in (posf, josf):
        log = seen[mod] = []
        _, back = _decoded(mod, str(tmp_path / "p.osf"),
                           error_handler=lambda s, m: log.append((s.value,
                                                                  m)))
        assert len(back) == 2
        fields = sorted(back[0].fields)
        assert "ZZZ" not in fields and "NEWER" not in fields
        assert "REFLECTIVITY" not in fields and "RANGE" in fields
        seen[mod, "fields"] = fields
    assert seen[posf] == seen[josf]
    assert seen[posf, "fields"] == seen[josf, "fields"]
    msgs = [m for _, m in seen[posf]]
    # a scan: four u8 channels garbled, the unknown channel, the unknown tag
    assert {s for s, _ in seen[posf]} == {"WARNING"} and len(msgs) == 12
    assert any("unsupported spec (field=200" in m for m in msgs)
    assert any("unsupported type (tag=99)" in m for m in msgs)
    assert any("bad_encoding" in m for m in msgs)


def test_close_with_live_views(tmp_path):
    jinfo, pinfo = _infos()
    _, ps = _pair(jinfo, pinfo, 2, seed=2)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    for mod in (posf, josf):
        r = mod.Reader(path)
        msgs = list(r.messages())
        before = [bytes(m.buffer) for m in msgs]
        assert all(isinstance(m.buffer, np.ndarray) for m in msgs)
        r.close()
        r.close()
        assert [bytes(m.buffer) for m in msgs] == before
        del msgs


# -- OsfScanSource and open_source ---------------------------------------------

def _two_sensor_file(tmp_path, mod, infos, per_sensor, name):
    return _write(mod, str(tmp_path / name), infos, per_sensor)


def test_scan_source_agrees(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "0")
    jinfos, pinfos = zip(*(_infos(DUAL, sn=11), _infos(SINGLE, w=512,
                                                       sn=22)))
    jper = [[_jscan(jinfos[0], k, 4) for k in range(4)],
            [_jscan(jinfos[1], k, 5) for k in range(3)]]
    pper = [[pt.lidar_scan_from_jax(pinfos[i], s) for s in scans]
            for i, scans in enumerate(jper)]
    _write(josf, str(tmp_path / "j.osf"), jinfos, jper)
    path = _write(posf, str(tmp_path / "p.osf"), pinfos, pper)
    _same_bytes(tmp_path / "j.osf", path)
    src, jsrc = pt.open_source(path), J.open_source(path)
    assert isinstance(src, pt.OsfScanSource)
    assert not src.is_collated() and not jsrc.is_collated()
    assert len(src) == len(jsrc) == 4 and src.is_indexed
    assert src.scans_num == jsrc.scans_num == [4, 3]
    assert src.full_index() == jsrc.full_index()
    assert src.time_range() == jsrc.time_range()

    def ids(sets):
        return [[None if s is None else (s.frame_id, int(s.timestamp[0]))
                 for s in ls] for ls in sets]

    assert ids(src) == ids(jsrc)
    for key in (0, 3, -1, -4):
        assert ids([src[key]]) == ids([jsrc[key]])
        for a, b in zip(src[key], jsrc[key]):
            if a is not None:
                assert_scans_equal(a, b)
    for key in (slice(1, 3), slice(None, None, 2), slice(-2, None)):
        assert ids(src[key]) == ids(jsrc[key])
    for bad in (4, -5):
        with pytest.raises(IndexError):
            src[bad]
    with pytest.raises(ValueError, match="positive step"):
        src[::-1]
    single = pt.open_source(path, sensor_idx=1)
    assert [s.frame_id for s in single] == [1, 2, 3]
    with pytest.raises(pt.SourceURLException, match="not supported"):
        pt.open_source(path, meta=["x.json"])


def test_open_source_takes_the_osf_route(tmp_path, monkeypatch):
    """With the policy on (unset) and device='cpu' every scan of the
    replay carries its XYZ cache, one projector window a batch of 4."""
    monkeypatch.delenv(ENV, raising=False)
    jinfo, pinfo = _infos()
    _, ps = _pair(jinfo, pinfo, 6, seed=6)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    pde.stats.update(batches=0, scans=0, osf_batches=0)
    native.reset_calls()
    pk = pt.ops.planar_kernels
    pk.reset_launches()
    got = [ls[0] for ls in pt.open_source(path, device="cpu")]
    assert len(got) == 6 and pde.stats["osf_batches"] == 2
    assert sum(pk.launches.values()) == 0          # CPU tensors
    if native.get_lib() is not None:
        # every PNG channel of every scan went through the native unfilter
        assert native.calls["png_unfilter"] == 6 * len(pinfo_fields(pinfo))
    for s, orig in zip(got, ps):
        assert_scans_equal(s, orig)
        for ret, name in enumerate(("RANGE", "RANGE2")):
            xyz = s.cached_xyz(ret, False, s.field(name))
            assert xyz is not None and xyz.dtype == np.float32
            assert s.cached_xyz(ret, True, s.field(name)) is xyz
    # random access attaches too
    one = pt.open_source(path, device="cpu")[4][0]
    np.testing.assert_array_equal(
        one.cached_xyz(0, False, one.field("RANGE")),
        got[4].cached_xyz(0, False, got[4].field("RANGE")))
    # field_names without RANGE: no sensor is eligible, no projector
    src = pt.open_source(path, device="cpu", field_names=["SIGNAL"])
    assert src._projector() is None
    assert [sorted(ls[0].fields) for ls in src] == [["SIGNAL"]] * 6


def pinfo_fields(pinfo):
    return [ft.name for ft in pt.get_field_types(pinfo)]


@pytest.mark.parametrize("ext", [False, True], ids=["identity", "extrinsic"])
def test_projector_cache_bit_equal_to_the_jax_package(tmp_path, monkeypatch,
                                                      ext):
    monkeypatch.setenv(ENV, "1")
    jinfo, pinfo = _infos(extrinsic=EXT if ext else None)
    js, ps = _pair(jinfo, pinfo, 5, seed=7)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    jde.stats["osf_batches"] = 0
    jgot = [ls[0] for ls in J.open_source(path)]
    assert jde.stats["osf_batches"] == 2
    got = [ls[0] for ls in pt.open_source(path, device="cpu")]
    lut64 = {v: pt.make_xyz_lut(pinfo, v) for v in (False, True)}
    for a, b in zip(got, jgot):
        for ret, name in enumerate(("RANGE", "RANGE2")):
            rng = a.field(name)
            for use_ext in (False, True):
                x = a.cached_xyz(ret, use_ext, rng)
                y = b.cached_xyz(ret, use_ext, b.field(name))
                assert x.shape == y.shape == (32, 256, 3)
                np.testing.assert_array_equal(x.view(np.int32),
                                              np.asarray(y).view(np.int32))
                ref = lut64[use_ext](rng)
                ulp = np.spacing(np.abs(ref).astype(np.float32))
                assert (np.abs(x - ref) <= 0.5 * ulp + 1e-30).all()
            if not ext:
                assert a.cached_xyz(ret, True, rng) is \
                    a.cached_xyz(ret, False, rng)
    # XYZLut serves the cache in both packages
    for use_ext in (False, True):
        np.testing.assert_array_equal(
            pt.XYZLut(pinfo, use_ext)(got[2]),
            J.XYZLut(jinfo, use_ext)(jgot[2]))


def test_policy_off_attaches_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "0")
    jinfo, pinfo = _infos(extrinsic=EXT)
    js, ps = _pair(jinfo, pinfo, 3, seed=8)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    assert pde.make_osf_projector([pinfo], None) is None
    got = [ls[0] for ls in pt.open_source(path)]
    jgot = [ls[0] for ls in J.open_source(path)]
    for a, b in zip(got, jgot):
        assert a.cached_xyz(0, False, a.field("RANGE")) is None
        for use_ext in (False, True):
            x = pt.XYZLut(pinfo, use_ext)(a)
            assert x.dtype == np.float64
            np.testing.assert_array_equal(x, J.XYZLut(jinfo, use_ext)(b))
            np.testing.assert_array_equal(
                pt.XYZLutFloat(pinfo, use_ext)(a),
                J.XYZLutFloat(jinfo, use_ext)(b))


def test_policy_on_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    jinfo, pinfo = _infos()
    _, ps = _pair(jinfo, pinfo, 2, seed=10)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    # no sensor eligible: no projector, whatever the device
    assert pde.make_osf_projector([pinfo], ["SIGNAL"]) is None
    if torch.cuda.is_available():
        assert pde.make_osf_projector([pinfo], None).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pde.make_osf_projector([pinfo], None)
    src = pt.open_source(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(src)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        src[0]
    monkeypatch.setenv(ENV, "2")
    with pytest.raises(ValueError, match="expected 0 or 1"):
        list(pt.open_source(path))


# -- XYZLut --------------------------------------------------------------------

def test_xyzlut_is_the_factory(tmp_path, monkeypatch):
    """pt.XYZLut(info) is the JAX package's XYZLut(info): a callable over a
    scan or a bare range image, f64, equal to the JAX result; it serves a
    replayed scan's cache while RANGE is unchanged."""
    jinfo, pinfo = _infos(extrinsic=EXT)
    js, ps = _pair(jinfo, pinfo, 2, seed=12)
    assert pt.XYZLut is pt.XYZLutFactory and \
        pt.XYZLutFloat is pt.XYZLutFloatFactory
    assert pt.ops.xyzlut.XYZLut is not pt.XYZLut      # the dataclass stays
    for use_ext in (False, True):
        for jobj, pobj in ((js[0], ps[0]),
                           (js[1].field("RANGE"), ps[1].field("RANGE"))):
            x = pt.XYZLut(pinfo, use_ext)(pobj)
            assert x.shape == (32, 256, 3) and x.dtype == np.float64
            np.testing.assert_array_equal(x, J.XYZLut(jinfo, use_ext)(jobj))
            xf = pt.XYZLutFloat(pinfo, use_ext)(pobj)
            assert xf.dtype == np.float32
            np.testing.assert_array_equal(
                xf, J.XYZLutFloat(jinfo, use_ext)(jobj))
    # served from the cache, then recomputed once RANGE changes
    monkeypatch.setenv(ENV, "1")
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    s = pt.open_source(path, device="cpu")[0][0]
    rng = s.field("RANGE")
    lut = pt.XYZLut(pinfo)
    cache = s.cached_xyz(0, False, rng)
    np.testing.assert_array_equal(lut(s), cache.astype(np.float64))
    f64 = pt.make_xyz_lut(pinfo)(rng)
    assert not np.array_equal(lut(s), f64)     # f32 granularity: a hit
    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_XYZ", "0")
    np.testing.assert_array_equal(lut(s), f64)
    monkeypatch.delenv("OUSTER_SDK_TPU_DEVICE_XYZ")
    rng[3, 4] ^= 1
    np.testing.assert_array_equal(lut(s), pt.make_xyz_lut(pinfo)(rng))
    rng[3, 4] ^= 1
    np.testing.assert_array_equal(lut(s), cache.astype(np.float64))


# -- file operations -----------------------------------------------------------

def test_osf_ops_agree(tmp_path, capsys):
    jinfo, pinfo = _infos()
    js, ps = _pair(jinfo, pinfo, 4, seed=13)
    path = _write(posf, str(tmp_path / "p.osf"), [pinfo], [ps])
    assert pops.osf_info(path) == jops.osf_info(path)
    assert pops.dump_metadata(path) == jops.dump_metadata(path)
    # slicing by time and by index
    r = posf.Reader(path)
    ts = sorted(m.ts for m in r.messages())
    for kw in (dict(start_ts=ts[1], end_ts=ts[2]),
               dict(start_index=1, end_index=3), {}):
        a, b = str(tmp_path / "a.osf"), str(tmp_path / "b.osf")
        assert pops.osf_slice(path, a, **kw) == jops.osf_slice(path, b, **kw)
        _same_bytes(a, b)
    # metadata replaced in place, backed up and restored
    meta = json.loads(pinfo.to_json_string())
    meta["sensor_info"]["prod_sn"] = "424242"
    meta = json.dumps(meta)
    for fn in ("a", "b"):
        shutil.copy(path, tmp_path / f"{fn}.osf")
    na = pops.osf_file_modify_metadata(
        str(tmp_path / "a.osf"), [pt.sensor_info_from_metadata(meta)])
    nb = jops.osf_file_modify_metadata(
        str(tmp_path / "b.osf"),
        [J.core.metadata.sensor_info_from_metadata(meta)])
    assert na == nb
    _same_bytes(tmp_path / "a.osf", tmp_path / "b.osf")
    assert posf.Reader(str(tmp_path / "a.osf")).sensor_info[0].sn == 424242
    assert pops.backup_osf_file_metablob(path, str(tmp_path / "blob")) == \
        jops.backup_osf_file_metablob(path, str(tmp_path / "blob2"))
    _same_bytes(tmp_path / "blob", tmp_path / "blob2")
    assert pops.restore_osf_file_metablob(
        str(tmp_path / "a.osf"), str(tmp_path / "blob")) == \
        jops.restore_osf_file_metablob(str(tmp_path / "b.osf"),
                                       str(tmp_path / "blob"))
    _same_bytes(tmp_path / "a.osf", tmp_path / "b.osf")
    _same_bytes(tmp_path / "a.osf", path)
    # slice_and_cast, print
    fts = [ft for ft in pt.get_field_types(pinfo)
           if ft.name in ("RANGE", "SIGNAL")]
    jfts = [ft for ft in J.core.lidar_scan.get_field_types(jinfo)
            if ft.name in ("RANGE", "SIGNAL")]
    assert_scans_equal(pops.slice_and_cast(ps[1], fts),
                       jops.slice_and_cast(js[1], jfts))
    with pytest.raises(ValueError, match="no field"):
        pops.slice_and_cast(pt.LidarScan(pinfo, fts), pt.get_field_types(
            pinfo))
    pops.parse_and_print(path)
    mine = capsys.readouterr().out
    jops.parse_and_print(path)
    assert mine == capsys.readouterr().out and "LidarScan" in mine
