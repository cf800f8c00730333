"""The port's examples package (ouster_sdk_tpu_torch.examples: colormaps,
core, lidar_scan, open3d_example, osf, pcap, reference, viz,
viz_image_events and the three zone-monitor examples) against the JAX
package's, on the CPU.

Each example runs in both packages on the same inputs: the chip run's yard
(6 frames, 16x256 dual) as a pcap with its metadata json beside it and as
an OSF the port's Writer made of it (byte-identical to the JAX package's),
read by the port through its engine and OSF projector on the CPU (every
default_device binding pointed at the CPU). The sensor examples (`core`)
talk HTTP and UDP to the port's SensorEmulator on loopback, a fresh one
for each package; the live ones record the scan they were given and are
held to the JAX package's functions on that scan. open3d is not installed
here: its example is held to its import gate, and its scan conversion
runs against a stand-in of the two open3d calls it makes.

Tolerance: exact (printed text, files byte for byte, arrays element for
element), except the projection of the `reference` example, held to the
XYZ LUT within 1e-9 m as the JAX package's own test holds it."""

import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest

from _torch_helpers import on_cpu, same_files, \
    yard_pcap  # noqa: F401  (on_cpu: autouse)
import chip_smoke as cs
import ouster_sdk_tpu as jx
import ouster_sdk_tpu.viz  # noqa: F401  (jx.viz)
import ouster_sdk_tpu_torch as pt
from _torch_live_helpers import free_udp_ports, frame_packets, live_info, \
    paced
from ouster_sdk_tpu.core.metadata import \
    sensor_info_from_metadata as jax_sensor_info
from ouster_sdk_tpu_torch.core.types import UDPProfileLidar
from ouster_sdk_tpu_torch.sensor.emulator import SensorEmulator

FRAMES = 6
PKGS = {"port": "ouster_sdk_tpu_torch", "jax": "ouster_sdk_tpu"}


def example(tag: str, name: str):
    import importlib

    return importlib.import_module(f"{PKGS[tag]}.examples.{name}")


@pytest.fixture(scope="module")
def yard(tmp_path_factory):
    """(pcap, osf): the yard capture with its metadata json, and the same
    scans saved to an OSF by the port."""
    from ouster_sdk_tpu_torch.io.save import save_scans

    d = tmp_path_factory.mktemp("yard")
    pcap, _ = yard_pcap(d, FRAMES)
    osf = str(d / "yard.osf")
    sets = list(pt.open_source(pcap, device="cpu"))
    save_scans(osf, [sets[0][0].sensor_info], sets)
    return pcap, osf


def run_both(fn_of_tag, tmp_path, monkeypatch):
    """fn_of_tag(tag) in tmp_path/<tag> for the port and the JAX package;
    returns {tag: (result, printed text)}."""
    out = {}
    for tag in PKGS:
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn_of_tag(tag)
        out[tag] = (res, buf.getvalue())
    return out


# -- captures ----------------------------------------------------------------

@pytest.mark.parametrize("num", [0, 3])
def test_pcap_examples_match(yard, tmp_path, monkeypatch, num):
    pcap, _ = yard

    def run(tag):
        ex = example(tag, "pcap")
        pts = ex.pcap_3d_one_scan(pcap, num)
        paths = [ex.pcap_to_ply(pcap, num), ex.pcap_to_pcd(pcap, num),
                 ex.pcap_to_las(pcap, num), ex.pcap_to_csv(pcap, num)]
        ex.pcap_query_scan(pcap, num)
        ex.pcap_read_packets(pcap)
        return pts, paths

    got = run_both(run, tmp_path, monkeypatch)
    (pp, ppaths), ptext = got["port"]
    (jp, jpaths), jtext = got["jax"]
    assert pp.dtype == jp.dtype and pp.shape[0] > 1000
    np.testing.assert_array_equal(pp, jp)
    assert ppaths == jpaths and ptext == jtext and "lidar packet" in ptext
    assert len(same_files(tmp_path)) == 4


def test_pcap_example_xyz_from_the_osf_projector(yard):
    """On an OSF the port's XYZLut serves the projector's XYZ cache: held
    within 1 f32 ulp of the f64 host LUT that the JAX package's example
    uses."""
    _, osf = yard
    got = example("port", "pcap").pcap_3d_one_scan(osf, 2)
    want = example("jax", "pcap").pcap_3d_one_scan(osf, 2)
    assert got.shape == want.shape and got.shape[0] > 1000
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= ulp).all()


def test_osf_examples_match(yard, tmp_path, monkeypatch):
    _, osf = yard

    def run(tag):
        ex = example(tag, "osf")
        ex.osf_read_scans(osf)
        ex.osf_get_sensors_info(osf)
        return ex.osf_slice_scans(osf, "sliced.osf", start=1, stop=4)

    got = run_both(run, tmp_path, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][1].count("scan from sensor") == FRAMES
    assert same_files(tmp_path) == ["sliced.osf"]


def test_colormap_and_viz_examples_match(yard, tmp_path, monkeypatch):
    pcap, _ = yard

    def run(tag):
        strip = example(tag, "colormaps").colormap_strip(pcap, "cm.png")
        scene = example(tag, "viz").viz_scene("scene.png")
        clicks = example(tag, "viz_image_events").viz_image_events(
            "events.png")
        board = example(tag, "viz").make_checker_board(4, (2, 3))
        return strip, scene, clicks, board.tolist()

    got = run_both(run, tmp_path, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][0][2] == [(0.0, 0.0, True)]
    assert "inside the image" in got["port"][1]
    assert same_files(tmp_path) == ["cm.png", "events.png", "scene.png"]


def test_lidar_scan_example_matches(monkeypatch, tmp_path):
    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    info.config.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    info.config.udp_port_lidar = 7502
    infos = {"port": info, "jax": jax_sensor_info(info.to_json_string())}
    got = run_both(lambda tag: example(tag, "lidar_scan").lidar_scan_example(
        infos[tag]), tmp_path, monkeypatch)
    assert got["port"][1] == got["jax"][1] and "MY_CUSTOM" not in \
        got["port"][1]
    a, b = got["port"][0], got["jax"][0]
    assert list(a.fields) == list(b.fields) and "MY_CUSTOM" in a.fields
    np.testing.assert_array_equal(a.field("MY_CUSTOM"), b.field("MY_CUSTOM"))


def test_reference_example_matches(yard):
    """The manual's projections and destagger: equal in both packages, and
    held to the port's XYZ LUT and destagger."""
    pcap, _ = yard
    scan = next(iter(pt.open_source(pcap, sensor_idx=0)))
    info = scan.sensor_info
    jinfo = jax_sensor_info(info.to_json_string())
    jscan = next(iter(jx.open_source(pcap, sensor_idx=0)))
    p, j = example("port", "reference"), example("jax", "reference")
    for fn in ("xyz_proj_beam_to_sensor_transform",
               "xyz_proj_origin_to_origin_mm"):
        a, b = getattr(p, fn)(info, scan), getattr(j, fn)(jinfo, jscan)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    xyz = pt.XYZLut(info)(scan.field("RANGE"))
    np.testing.assert_allclose(
        p.xyz_proj_beam_to_sensor_transform(info, scan), xyz, rtol=0,
        atol=1e-9)
    rng = scan.field("RANGE")
    a = p.destagger(info.format.pixel_shift_by_row, rng)
    np.testing.assert_array_equal(a, j.destagger(
        jinfo.format.pixel_shift_by_row, rng))
    np.testing.assert_array_equal(a, pt.destagger(info, rng))
    with pytest.raises(ValueError, match="pixel_shift_by_row"):
        p.destagger([0, 1], rng)


# -- zone monitoring ---------------------------------------------------------

def test_zone_examples_match(yard, tmp_path, monkeypatch):
    pcap, _ = yard

    def run(tag):
        example(tag, "zone_monitor_example").zone_monitor_example(pcap)
        example(tag, "zone_monitor_zone_states_example"). \
            zone_states_example(pcap, n_scans=4)

    got = run_both(run, tmp_path, monkeypatch)
    assert got["port"][1] == got["jax"][1]
    assert "scan 4:" in got["port"][1] and "zone 2:" in got["port"][1]


def test_zone_emulation_example_matches(yard, tmp_path):
    from ouster_sdk_tpu_torch.zone import Zone, ZoneMode, ZoneSet

    pcap, _ = yard
    zones = [Zone.box(1, (6.0, 0.0, 0.0), (6.0, 6.0, 3.0)),
             Zone.box(2, (20.0, 5.0, 0.0), (8.0, 8.0, 4.0))]
    for z in zones:
        z.mode = ZoneMode.OCCUPANCY
        z.min_points = 5
    zip_path = tmp_path / "zones.zip"
    zip_path.write_bytes(ZoneSet(zones,
                                 sensor_to_body_transform=np.eye(4)).to_zip())
    runs = {tag: list(example(tag, "zone_monitor_emulation_example")
                      .emulate(pcap, str(zip_path), max_scans=4))
            for tag in PKGS}
    assert len(runs["port"]) == len(runs["jax"]) == 4
    assert any(t for _, t in runs["port"])
    for (a, ta), (b, tb) in zip(runs["port"], runs["jax"]):
        assert ta == tb
        for name in ("ZONE_OCCUPANCY", "ZONE_PACKET_TIMESTAMP"):
            np.testing.assert_array_equal(a.field(name), b.field(name))
        assert a.field("ZONE_STATES").tolist() == \
            b.field("ZONE_STATES").tolist()
    with pytest.raises(ValueError, match="ZoneSet"):
        next(example("port", "zone_monitor_emulation_example").emulate(
            pcap))


# -- open3d ------------------------------------------------------------------

def test_open3d_example_is_import_gated():
    for tag in PKGS:
        mod = example(tag, "open3d_example")
        try:
            import open3d  # type: ignore  # noqa: F401
        except ModuleNotFoundError:
            with pytest.raises(ModuleNotFoundError, match="open3d"):
                mod.require_open3d()
            with pytest.raises(ModuleNotFoundError, match="open3d"):
                mod.view("unused.pcap")


def _o3d_stand_in():
    """The two open3d calls scan_to_geometry makes, recording their
    arguments."""
    class PointCloud:
        points = colors = None

    return types.SimpleNamespace(
        geometry=types.SimpleNamespace(PointCloud=PointCloud),
        utility=types.SimpleNamespace(Vector3dVector=np.asarray))


def test_open3d_scan_conversion_matches(yard):
    pcap, _ = yard
    clouds = []
    for tag, pkg in (("port", pt), ("jax", jx)):
        scan = next(iter(pkg.open_source(pcap, sensor_idx=0)))
        pc = example(tag, "open3d_example").scan_to_geometry(
            scan.sensor_info, scan, _o3d_stand_in())
        clouds.append((pc.points, pc.colors))
    assert clouds[0][0].shape[0] > 1000
    for a, b in zip(*clouds):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the sensor examples, against the port's emulator ------------------------

@contextlib.contextmanager
def emulator(ports, frames_of=None):
    """The port's emulator of a 512x10 live test sensor on `ports` (lidar,
    imu), started, and its info; `frames_of(info)` gives the frames it
    loops."""
    info = live_info(*ports)
    frames = frames_of(info) if frames_of else []
    emu = SensorEmulator(info, paced(frames), http_port=0, lidar_port=ports[0],
                         imu_port=ports[1], rate=1.0, loop=bool(frames))
    emu.start()
    try:
        yield emu, info
    finally:
        emu.stop()


def test_sensor_config_examples_match(tmp_path, monkeypatch):
    """configure_dual_returns, configure_sensor_params and fetch_metadata
    of both packages against a fresh port emulator each: the same text,
    the same metadata files, the same configuration left on the sensor."""
    ports = free_udp_ports(2)

    def run(tag):
        ex = example(tag, "core")
        with emulator(ports) as (emu, _):
            host = f"127.0.0.1:{emu.http_port}"
            ex.configure_dual_returns(host)
            ex.configure_sensor_params(host)
            ex.fetch_metadata(host)
            cfg = pt.sensor.get_config(host)
            os.rename(f"{host}.json", "metadata.json")
            return (str(cfg.udp_profile_lidar), str(cfg.lidar_mode),
                    cfg.azimuth_window), host

    got = run_both(run, tmp_path, monkeypatch)
    for tag in PKGS:
        res, host = got[tag][0]
        assert res[0].endswith("RNG19_RFL8_SIG16_NIR16_DUAL")
        got[tag] = (res, got[tag][1].replace(host, "HOST"))
    assert got["port"] == got["jax"]
    assert same_files(tmp_path) == ["metadata.json"]


class _Recording:
    """A scan source that keeps what it yields (and closes the source the
    example leaves open)."""

    opened = []

    def __init__(self, src):
        self._src, self.scans = src, []
        _Recording.opened.append(self)

    def __getattr__(self, name):
        return getattr(self._src, name)

    def __iter__(self):
        for item in self._src:
            self.scans.append(item)
            yield item


def _jax_scan(scan, jinfo):
    """The JAX package's LidarScan with the port scan's fields and
    headers."""
    js = jx.LidarScan(jinfo)
    for name in scan.fields:
        if js.has_field(name):
            js.field(name)[:] = scan.field(name)
    for attr in ("status", "timestamp", "measurement_id",
                 "packet_timestamp", "pose"):
        getattr(js, attr)[:] = getattr(scan, attr)
    js.frame_id = scan.frame_id
    return js


def test_live_sensor_examples_match(tmp_path, monkeypatch):
    """filter_3d_by_range_and_azimuth and plot_xyz_points of the port's
    examples over a live source on the port's emulator, held to the JAX
    package's XYZ LUT and ls_show on the scan the example was given;
    record_pcap fails in both packages with the same error."""
    ex = example("port", "core")
    # the example opens the source with the default receive timeout (1 s);
    # a loaded host can take longer for the first whole frame
    monkeypatch.setattr(ex, "open_source", lambda *a, **kw: _Recording(
        pt.open_source(*a, timeout=10.0, **kw)))
    monkeypatch.chdir(tmp_path)
    with emulator(free_udp_ports(2),
                  lambda info: [frame_packets(info, f, seed=3)
                                for f in range(1, 4)]) as (emu, info):
        host = f"127.0.0.1:{emu.http_port}"
        lp = info.config.udp_port_lidar
        try:
            # the examples leave their source open; each is closed before
            # the next opens the same ports
            pts = ex.filter_3d_by_range_and_azimuth(host, lidar_port=lp)
            _Recording.opened[0]._src.close()
            ex.plot_xyz_points(host, lidar_port=lp)
        finally:
            for rec in _Recording.opened:
                rec._src.close()
        (seen,), (shown,) = [rec.scans for rec in _Recording.opened]
        jinfo = jax_sensor_info(
            _Recording.opened[1].metadata.to_json_string())
        _Recording.opened.clear()
        rng = seen.field("RANGE")
        keep = rng / 1000.0 > 2.0
        keep[:, : seen.w // 2] = False
        xyz = jx.XYZLut(jinfo, use_extrinsics=True)(rng)
        np.testing.assert_array_equal(pts, xyz[keep])
        jx.viz.ls_show(_jax_scan(shown, jinfo), jinfo, path="want.png")
        assert (tmp_path / f"{host}_scan.png").read_bytes() == \
            (tmp_path / "want.png").read_bytes()
        # neither package registers a packet source for a sensor url, so
        # record_pcap stops at open_packet_source in both, before any file
        errors = []
        for tag in PKGS:
            with pytest.raises(Exception) as e:
                example(tag, "core").record_pcap(host, lidar_port=lp,
                                                 n_seconds=1)
            errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert "Unhandled source type SENSOR" in errors[0][1]
    assert not list(tmp_path.glob("*.pcap"))
