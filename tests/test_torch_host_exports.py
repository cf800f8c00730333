"""The host layer's small modules and the export surface of the PyTorch
port (ouster_sdk_tpu_torch) against the JAX package (ouster_sdk_tpu), on the
CPU: every name the JAX package's top-level, utils and io namespaces export
exists in the port (the exceptions listed below), enums and constants equal
member by member, and Packets, Scans, the core.scan_utils helpers,
ForwardSlicer, the progress bars, resolve_metadata[_multi], StreamDigest,
the packet_format aliases and add_custom_profile give equal results on the
same inputs. Captures are synthesized from a seed (tests/_torch_helpers.py)
at 32x256. Tolerance: exact (equal arrays and dtypes, equal strings and
digests)."""

import enum
import importlib
import json
import os
import types

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io as jio
import ouster_sdk_tpu.utils as jutils
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io as pio
import ouster_sdk_tpu_torch.utils as putils
from _torch_helpers import (DUAL, SINGLE, assert_scans_equal, engine_infos,
                            frame_packets, infos, lidar_stream, write_pcap)

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"

#: names of the JAX package the port does not export: JAX idiom (the jnp
#: normals; the port's device twin is normals_device). The pose optimizer,
#: the CLI and the viewer (ROADMAP §1 items 10.4-10.6) export no name
#: from these three namespaces.
NOT_PORTED = {"top": {"normals_jax"}, "utils": set(), "io": set()}


def _exports(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("ns", ["top", "utils", "io"])
def test_every_exported_name_exists(ns):
    jmod, pmod = {"top": (jx, pt), "utils": (jutils, putils),
                  "io": (jio, pio)}[ns]
    missing = _exports(jmod) - _exports(pmod) - NOT_PORTED[ns]
    assert not missing, f"{ns}: not in the port: {sorted(missing)}"
    for name in NOT_PORTED[ns]:
        assert hasattr(jmod, name), f"{name} is no longer a JAX export"


def test_enums_and_constants_equal():
    enums = [n for n in _exports(jx) if isinstance(getattr(jx, n), type)
             and issubclass(getattr(jx, n), enum.Enum)]
    assert len(enums) >= 18
    for name in enums:
        je, pe = getattr(jx, name), getattr(pt, name)
        assert [(m.name, m.value) for m in je] == \
            [(m.name, m.value) for m in pe], name
    assert pt.RANGE_UNIT == jx.RANGE_UNIT
    assert pt.__version__ == jx.__version__
    assert str(pt.INVALID_VERSION) == str(jx.INVALID_VERSION)
    assert vars(pt.ChanField).keys() == vars(jx.ChanField).keys()
    for old, new in (("version", "Version"), ("sensor_info", "SensorInfo"),
                     ("SensorCalibration", "CalibrationStatus"),
                     ("invalid_version", "INVALID_VERSION")):
        with pytest.warns(DeprecationWarning):
            assert getattr(pt, old) is getattr(pt, new)
    with pytest.raises(AttributeError):
        pt.not_a_name  # noqa: B018


def _capture(tmp_path, profile=DUAL, n=4, invalid=0.05):
    """n frames of one sensor, the last one open (three packets short)."""
    jinfo, pinfo = engine_infos(profile)
    frames = [frame_packets(jinfo, fid, invalid=invalid, alert_flags=1)
              for fid in range(1, n + 1)]
    stream = lidar_stream(frames)[:-3]
    return write_pcap(str(tmp_path / "cap.pcap"), stream), jinfo, pinfo


def _packet_sources(path, jinfo, pinfo):
    from ouster_sdk_tpu.io.pcap_source import PcapPacketSource as J

    return (J(path, sensor_infos=[jinfo]),
            pt.PcapPacketSource(path, sensor_infos=[pinfo]))


@pytest.mark.parametrize("complete", [False, True])
def test_scans_and_packets_equal(tmp_path, complete):
    path, jinfo, pinfo = _capture(tmp_path, invalid=0.0)
    jsrc, psrc = _packet_sources(path, jinfo, pinfo)
    fields = ["RANGE", "SIGNAL2"]
    got = list(pt.Scans(psrc, complete=complete, fields=fields))
    want = list(jx.Scans(jsrc, complete=complete, fields=fields))
    assert len(got) == len(want) == (3 if complete else 4)
    for a, b in zip(got, want):
        assert sorted(a.fields) == fields
        assert_scans_equal(a, b)
    jp = jx.Packets([p for _, p in jsrc], jinfo)
    pp = pt.Packets([p for _, p in psrc], pinfo)
    assert pp.metadata is pinfo and pp.sensor_info == [pinfo]
    a, b = list(pp), list(jp)
    assert [i for i, _ in a] == [i for i, _ in b] == [0] * len(b)
    assert all(bytes(x.buf) == bytes(y.buf) and
               x.host_timestamp == y.host_timestamp
               for (_, x), (_, y) in zip(a, b))


def test_scan_utils_equal(tmp_path):
    path, jinfo, pinfo = _capture(tmp_path)
    jsrc, psrc = _packet_sources(path, jinfo, pinfo)
    jfb, pfb = jx.FrameBorder(jinfo), pt.FrameBorder(pinfo)
    pred = (lambda p: p.host_timestamp % 3 != 0)
    jfp, pfp = jx.FrameBorder(jinfo, pred), pt.FrameBorder(pinfo, pred)
    for (_, jp), (_, pp) in zip(jsrc, psrc):
        assert pfb(pp) == jfb(jp) and pfb(pp) == jfb(jp)   # memo too
        assert pfp(pp) == jfp(jp)
        assert pt.packet_ts(pp) == jx.packet_ts(jp)
    jscans = [s for _, s in zip(range(3), jx.Scans(jsrc))]
    pscans = [s for _, s in zip(range(3), pt.Scans(psrc))]
    rng = np.random.default_rng(3)
    for k, (js, ps) in enumerate(zip(jscans, pscans)):
        if k == 1:
            poses = np.broadcast_to(np.eye(4), js.pose.shape).copy()
            poses[:, :3, 3] = rng.normal(size=(js.w, 3))
            js.pose[:] = poses
            ps.pose[:] = poses
        if k == 2:
            for s in (js, ps):
                s.status[:40] = 0
                s.packet_timestamp[:2] = 0
        for fn in ("first_valid_column_pose", "last_valid_column_pose",
                   "valid_packet_idxs"):
            a, b = getattr(pt, fn)(ps), getattr(jx, fn)(js)
            assert a.dtype == b.dtype and np.array_equal(a, b), fn
        assert pt.poses_present(ps) == jx.poses_present(js) == (k == 1)
    assert [c.value for c in pt.ColHeader] == [c.value for c in jx.ColHeader]
    assert pt.BufferT == jx.BufferT or \
        str(pt.BufferT).replace("ouster_sdk_tpu_torch", "") == \
        str(jx.BufferT).replace("ouster_sdk_tpu", "")


@pytest.mark.parametrize("key", [
    slice(None), slice(2, 9), slice(-7, None, 2), slice(None, None, -1),
    slice(8, 1, -3), slice(-1, -9, -2), slice(20, 3, -1), slice(3, 3)])
def test_forward_slicer_equal(key):
    from ouster_sdk_tpu.utils.forward_slicer import ForwardSlicer as J

    P = putils.ForwardSlicer
    n = 12
    a, b = P.normalize(key, n), J.normalize(key, n)
    assert (a.start, a.stop, a.step) == (b.start, b.stop, b.step)
    got = P.slice(iter(range(a.start, n)), a)
    assert got == J.slice(iter(range(b.start, n)), b)
    want = list(range(n))[key]
    assert (got[::-1] if a.step < 0 else got) == want


def test_progress_bars_equal(capsys):
    # the packages' utils export a function of the module's name
    jpb = importlib.import_module("ouster_sdk_tpu.utils.progress_bar")
    ppb = importlib.import_module("ouster_sdk_tpu_torch.utils.progress_bar")

    outs = []
    for mod in (jpb, ppb):
        mod.progressbar(3, 7, "pre", "suf")
        mod.progressbar(9, 7)
        mod.progress_bar(0.25, width=10, suffix="x")
        mod.progress_bar(1.5)
        clock = iter([0.0, 0.5, 0.75, 2.0, 2.5])
        for total in (10, 0):
            bar = mod.ProgressBar(total, alpha=0.5, unit="scans")
            bar._time = types.SimpleNamespace(monotonic=lambda: next(clock))
            bar.update(1, "p", "s")
            bar.update(4, "p", "s")
            bar.clear()
        with pytest.raises(ValueError):
            mod.progressbar(1, 0)
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    assert "scans/sec" in outs[1].out and "#" in outs[1].err


def test_resolve_metadata_equal(tmp_path):
    from ouster_sdk_tpu.utils import metadata as jm

    jinfo, _ = infos(SINGLE)
    data = tmp_path / "drive_2024.pcap"
    data.write_bytes(b"")
    meta = json.loads(jinfo.to_json_string())
    for name, sn in (("drive_2024.json", "11"), ("drive_2024.1.json", "22"),
                     ("drive.json", "33")):
        meta["sensor_info"]["prod_sn"] = sn
        (tmp_path / name).write_text(json.dumps(meta))
    for fn in ("resolve_metadata", "resolve_metadata_multi"):
        assert getattr(putils, fn)(str(data)) == getattr(jm, fn)(str(data))
    other = str(tmp_path / "drive.json")
    assert putils.resolve_metadata(str(data), other) == \
        jm.resolve_metadata(str(data), other) == other
    for args in ((str(tmp_path / "nope.pcap"),),
                 (str(data), str(tmp_path / "nope.json"))):
        with pytest.raises(ValueError) as pe:
            putils.resolve_metadata(*args)
        with pytest.raises(ValueError) as je:
            jm.resolve_metadata(*args)
        assert str(pe.value) == str(je.value)
    # two files of one sensor are refused alike
    meta["sensor_info"]["prod_sn"] = "11"
    (tmp_path / "drive_2024.1.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError) as pe:
        putils.resolve_metadata_multi(str(data))
    with pytest.raises(RuntimeError) as je:
        jm.resolve_metadata_multi(str(data))
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("profile", [DUAL, "RNG15_RFL8_NIR8"])
def test_stream_digest_equal(tmp_path, profile):
    from ouster_sdk_tpu.utils.digest import StreamDigest as J
    from ouster_sdk_tpu_torch.utils.digest import FieldDigest, StreamDigest

    path, jinfo, pinfo = _capture(tmp_path, profile)
    jsrc, psrc = _packet_sources(path, jinfo, pinfo)
    got, want = StreamDigest.from_packet_source(psrc), \
        J.from_packet_source(jsrc)
    assert got.to_json() == want.to_json()
    assert len(got.scans) == 4
    back = StreamDigest.from_json(want.to_json())
    back.check(got)
    assert back == got
    # the digest of the scans open_source makes on the engine (CPU) is the
    # packet source's
    os.environ.pop(ENV, None)
    scans = [ls[0] for ls in pt.open_source(path, sensor_info=[pinfo],
                                            device="cpu")]
    assert [FieldDigest.from_scan(s) for s in scans] == got.scans
    scans[1].field("RANGE")[0, 0] ^= 1
    with pytest.raises(AssertionError, match="RANGE"):
        FieldDigest.from_scan(scans[1]).check(got.scans[1])


def test_packet_format_aliases_and_dd_to_f32():
    from ouster_sdk_tpu.ops import packet_format as jpf
    from ouster_sdk_tpu_torch.ops import packet_format as ppf
    from ouster_sdk_tpu_torch.ops.precision import dd_to_f32
    from ouster_sdk_tpu.ops.precision import dd_to_f32 as jdd

    names = sorted(n for n in vars(jpf) if n.startswith(("_pf_", "_pw_")))
    assert len(names) == 13
    for n in names:
        assert callable(getattr(ppf, n)), n
    jinfo, pinfo = infos(DUAL)
    # the writer factories give writers, also once the reader cache holds
    # a PacketFormat of the same format
    reader = ppf.PacketFormat.from_info(pinfo)
    assert ppf.PacketFormat.from_metadata(pinfo) is reader
    for w in (ppf.PacketWriter.from_info(pinfo),
              ppf._pw_from_info(pinfo),
              ppf.PacketWriter.from_data_format(pinfo.format)):
        assert type(w) is ppf.PacketWriter
    jw, pw = jpf.PacketWriter.from_info(jinfo), ppf._pw_from_info(pinfo)
    jb, pb = jw.new_packet(), pw.new_packet()
    for b, w, mod in ((jb, jw, jpf), (pb, pw, ppf)):
        mod._pw_set_col_timestamp(w, b, 3, 123456789)
        mod._pw_set_col_measurement_id(w, b, 5, 77)
        mod._pw_set_col_status(w, b, 2, 1)
        mod._pw_set_alert_flags(w, b, 0x5A)
        mod._pw_set_shot_limiting_countdown(w, b, 9)
        mod._pw_set_shutdown_countdown(w, b, 4)
    assert jb.tobytes() == pb.tobytes()
    assert ppf._pf_field_bitness(reader, "RANGE") == \
        jpf._pf_field_bitness(jpf.PacketFormat.from_info(jinfo), "RANGE")
    hi = np.float32([1.5, -2.25, 3e-8])
    lo = np.float32([1e-8, 2e-9, -1e-15])
    assert np.array_equal(dd_to_f32(hi, lo), np.asarray(jdd(hi, lo)))


CUSTOM_NR, CUSTOM = 240, "CUSTOM_HOST_EXPORTS_12B"


@pytest.fixture
def custom_profile():
    """One custom profile registered in both packages, removed after."""
    from ouster_sdk_tpu.ops import profiles as jprof
    from ouster_sdk_tpu_torch.ops import profiles as pprof

    fields = {
        mod: [("RANGE", mod.FieldInfo(0, 20)),
              ("REFLECTIVITY", mod.FieldInfo(32, 8)),
              ("SIGNAL", mod.FieldInfo(48, 16)),
              ("CUSTOM0", mod.FieldInfo(64, 12)),
              ("RAW32_WORD1", mod.FieldInfo(0, 32))]
        for mod in (jprof, pprof)}
    for mod in (jprof, pprof):
        mod.add_custom_profile(CUSTOM_NR, CUSTOM, fields[mod], 12)
    yield
    for mod in (jprof, pprof):
        mod._custom_profiles.pop(CUSTOM, None)
        mod._custom_scan_slots.pop(CUSTOM, None)


def test_add_custom_profile_decodes_equal(tmp_path, custom_profile):
    from ouster_sdk_tpu.ops import profiles as jprof
    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.ops import profiles as pprof

    assert pprof.lookup_scan_fields(CUSTOM) == jprof.lookup_scan_fields(CUSTOM)
    assert pprof.lookup_profile_entry(CUSTOM).chan_data_size == 12
    jinfo, pinfo = infos(SINGLE)
    jinfo.format.udp_profile_lidar = CUSTOM
    pinfo.format.udp_profile_lidar = CUSTOM
    assert de.supports_device_decode(pinfo)
    assert pt.make_decode_plan(pinfo).profile == CUSTOM
    frames = [frame_packets(jinfo, fid) for fid in (1, 2, 3)]
    path = write_pcap(str(tmp_path / "custom.pcap"), lidar_stream(frames))
    os.environ[ENV] = "0"
    want = [ls[0] for ls in jx.open_source(path, sensor_info=[jinfo])]
    batcher = [ls[0] for ls in pt.open_source(path, sensor_info=[pinfo],
                                              device="cpu")]
    os.environ[ENV] = "1"
    de.stats.update(batches=0, scans=0, osf_batches=0)
    got = [ls[0] for ls in pt.open_source(path, sensor_info=[pinfo],
                                          device="cpu")]
    os.environ.pop(ENV)
    assert de.stats["scans"] == 3
    assert len(got) == len(want) == 3
    assert "CUSTOM0" in got[0].fields
    for a, b, c in zip(got, batcher, want):
        assert_scans_equal(a, c, "engine")
        assert_scans_equal(b, c, "batcher")
    with pytest.raises(ValueError):
        pprof.lookup_profile_entry("NOT_A_PROFILE")
