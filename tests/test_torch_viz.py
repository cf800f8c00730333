"""The port's viewer (ouster_sdk_tpu_torch.viz: core, drawables, view_mode,
accumulators, html, gl, zone_viz, po_viz), slam.ply_to_png and the viewer
entry points of its command line (`source viz`, `source model_viz`,
`pose_optimize --viz-snapshot`) against the JAX package's, on the CPU.

The inputs are the chip run's yard (6 frames, 16x256 dual) written as a
pcap with its metadata json beside it: the port reads it through its
engine on the CPU (every default_device binding pointed at the CPU), the
JAX package as its own tests read it. Scenes are built the same way in
both packages from numpy arrays made from a seed; renders are 320x240
(the command line's, 1024x768). The GL renders run on this host's
surfaceless EGL (Mesa) and are skipped only where neither package can
make a context; every context and renderer is closed in the test that
opens it.

Tolerance: exact. Colors, frames, PNG, HTML and point files are equal
byte for byte, arrays element for element with their dtypes."""

import copy
import os

import numpy as np
import pytest

from _torch_helpers import both, on_cpu, same_files, \
    yard_pcap  # noqa: F401  (on_cpu: autouse)
import ouster_sdk_tpu as jx
import ouster_sdk_tpu.viz as jviz
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.viz as pviz

FRAMES = 6
W, H = 320, 240
BOTH = (("port", pt, pviz), ("jax", jx, jviz))


@pytest.fixture(scope="module")
def yard(tmp_path_factory):
    """(pcap path, {"port": scans, "jax": scans}): the yard read by each
    package; every scan carries its frame's ground-truth pose in every
    column, so the viewer's dewarp and the accumulators see motion."""
    pcap, truth = yard_pcap(tmp_path_factory.mktemp("yard"), FRAMES)
    scans = {"port": [ls[0] for ls in pt.open_source(pcap, device="cpu")],
             "jax": [ls[0] for ls in jx.open_source(pcap)]}
    for tag in scans:
        assert len(scans[tag]) == FRAMES
        for s, pose in zip(scans[tag], truth):
            s.pose[:] = pose
    return pcap, scans


def submodule(pkg, name: str):
    """`pkg`.`name` (a package of either side: the port, the JAX package,
    or their viz packages)."""
    from importlib import import_module

    return import_module(f"{pkg.__name__}.{name}")


def _png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return data


# -- colormaps ---------------------------------------------------------------

@pytest.mark.parametrize("palette", sorted(pviz.COLORMAPS))
def test_colorize_matches_for_every_palette(palette):
    np.testing.assert_array_equal(pviz.COLORMAPS[palette],
                                  jviz.COLORMAPS[palette])
    rng = np.random.default_rng(3)
    for x in (rng.random((16, 64)), rng.random(500).astype(np.float32),
              np.array([-1.0, 0.0, 0.5, 1.0, 2.0])):
        a, b = pviz.colorize(x, palette), jviz.colorize(x, palette)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_palette_exports_and_order_match():
    assert pviz.CLOUD_PALETTE_ORDER == jviz.CLOUD_PALETTE_ORDER
    assert sorted(pviz.COLORMAPS) == sorted(jviz.COLORMAPS)
    for name in ("calref", "spezia", "grey", "viridis", "magma"):
        np.testing.assert_array_equal(getattr(pviz, f"{name}_palette"),
                                      getattr(jviz, f"{name}_palette"))
    assert sorted(n for n in dir(pviz) if not n.startswith("_")) == \
        sorted(n for n in dir(jviz) if not n.startswith("_"))


# -- the software rasterizer -------------------------------------------------

def _scene(v, kind: str):
    """The same scene in either viz package `v`, seeded."""
    rng = np.random.default_rng(11)
    viz = v.PointViz("scene", width=W, height=H)
    pts = rng.normal(size=(4000, 3)) * 5
    if kind in ("clouds", "all"):
        pose = np.eye(4)
        pose[:3, 3] = (1.0, -2.0, 0.5)
        viz.add(v.Cloud(pts, key=np.linspace(0, 1, len(pts)),
                        palette="magma", point_size=2))
        viz.add(v.Cloud(pts[:500] * 0.5, pose=pose))
    if kind in ("drawables", "all"):
        segs = rng.normal(size=(6, 2, 3)) * 4
        viz.add(v.Lines(segs, color=(0, 255, 0)))
        box = np.eye(4)
        box[:3, 3] = (3.0, 3.0, 0.0)
        viz.add(v.Cuboid(box, (255, 0, 0)))
        viz.add(v.Label("label", (0.0, 0.0, 4.0)))
        viz.add(v.TargetDisplay(ring_size_m=3.0, rings=3))
        tri = rng.normal(size=(20, 3, 3)) * 3
        viz.add(v.Mesh(tri))
        img = v.Image()
        img.set_image(rng.random((16, 32)).astype(np.float32))
        img.set_position(-1.0, -0.4, 0.5, 1.0)
        img.set_palette("viridis")
        viz.add(img)
        v.AxisWithLabel(viz, label="O", length=2.0)
    if kind in ("panels", "all"):
        viz.add_image_panel(v.colorize(rng.random((16, 64)), "grey"))
        viz.add_image_panel(v.colorize(rng.random((8, 64)), "turbo"))
    viz.camera.orbit(30.0, 10.0)
    viz.camera.dolly(-2)
    return viz


def _range_scene(v, pkg, scan):
    """A Cloud.from_range of a yard scan through its own package's LUT,
    dewarped by the scan's column poses (relative to the first)."""
    viz = v.PointViz(width=W, height=H)
    lut = pkg.make_xyz_lut(scan.sensor_info)
    poses = np.linalg.inv(scan.pose[0]) @ scan.pose
    viz.add(v.Cloud.from_range(scan.field("RANGE"), lut,
                               key=np.linspace(0, 1, scan.h * scan.w),
                               palette="turbo", point_size=2,
                               column_poses=poses))
    viz.camera.distance = 60.0
    return viz


def test_from_range_cloud_matches(yard):
    _, scans = yard
    frames = [_range_scene(v, pkg, scans[tag][4]).render()
              for tag, pkg, v in BOTH]
    assert frames[0].any()
    np.testing.assert_array_equal(frames[0], frames[1])


@pytest.mark.parametrize("kind", ["clouds", "drawables", "panels", "all"])
def test_software_render_matches(kind):
    frames = []
    for _, _, v in BOTH:
        frames.append(_scene(v, kind).render())
    assert frames[0].shape == (H, W, 3) and frames[0].any()
    np.testing.assert_array_equal(frames[0], frames[1])


def test_render_with_drawables_and_save_png_match(tmp_path):
    out = []
    for tag, _, v in BOTH:
        viz = _scene(v, "clouds")
        drawables = [v.Lines(np.array([[[-5.0, 0, 0], [5.0, 0, 0]]]),
                             (255, 64, 64)),
                     v.Label("x", (5.0, 0.0, 0.0))]
        frame = v.render_with_drawables(viz, drawables)
        path = str(tmp_path / f"{tag}.png")
        viz.save_png(path, frame)
        out.append(_png(path))
    assert out[0] == out[1]


def test_event_registry_and_window_ctx_match():
    seen = {}
    for tag, _, v in BOTH:
        viz = v.PointViz(width=W, height=H)
        v.add_default_controls(viz)
        log = []
        viz.push_mouse_button_handler(
            lambda ctx, b, e, m, log=log: log.append((b, e, m)) or True)
        viz.push_scroll_handler(
            lambda ctx, x, y, log=log: log.append((x, y)) or True)
        for key in (ord("="), 262, 265, ord("-"), 263):
            viz.dispatch_key(key)
        viz.dispatch_mouse_button(v.MouseButton.MOUSE_BUTTON_LEFT,
                                  v.MouseButtonEvent.MOUSE_BUTTON_PRESSED)
        viz.dispatch_scroll(0.0, 1.5)
        ctx = viz.window_context()
        seen[tag] = (viz.camera.view_matrix(), log, ctx.aspect_ratio(),
                     ctx.normalized_coordinates(10.0, 20.0))
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    assert seen["port"][1:] == seen["jax"][1:]


# -- the scan viewer over both packages' scans -------------------------------

@pytest.mark.parametrize("opts", [
    {}, {"accum_num": 3, "map_enabled": True},
    {"accum_every_m": 0.5, "map_ratio": 0.5, "pause_at": 2,
     "auto_resume": True},
], ids=("plain", "accum-map", "accum-m-pause"))
def test_simple_viz_snapshots_match(yard, tmp_path, opts):
    """SimpleViz over the port's engine scans and over the JAX package's
    scans writes the same PNGs."""
    _, scans = yard
    written = {}
    for tag, _, v in BOTH:
        d = tmp_path / tag
        d.mkdir()
        sv = v.SimpleViz([scans[tag][0].sensor_info],
                         snapshot_path=str(d / "s.png"), snapshot_every=2,
                         **opts)
        sv.scan_viz.viz.width, sv.scan_viz.viz.height = W, H
        assert sv.run(iter([[s] for s in scans[tag]])) == FRAMES
        written[tag] = sorted(os.listdir(d))
    assert written["port"] == written["jax"] and len(written["port"]) >= 3
    for n in written["port"]:
        assert _png(tmp_path / "port" / n) == _png(tmp_path / "jax" / n)


def test_lidar_scan_viz_modes_palettes_and_aoi_match(yard):
    _, scans = yard
    frames = {}
    for tag, _, v in BOTH:
        lsv = v.LidarScanViz([scans[tag][0].sensor_info],
                             viz=v.PointViz(width=W, height=H))
        out, names = [], []
        sel = lsv.select_aoi((2, 10), (9, 120))
        for k in range(len(lsv.cloud_modes[0]) + 1):
            names.append((lsv.cycle_cloud_mode(), lsv.cycle_img_mode(0),
                           lsv.cycle_img_mode(1, -1),
                           lsv.cycle_cloud_palette()))
            lsv.update([scans[tag][k % FRAMES]])
            out.append(lsv.draw())
        stats = [sel.stats(s) for s in scans[tag]]
        lsv.clear_selections()
        lsv.show_imu = False
        lsv.update([scans[tag][0], None][:1])
        out.append(lsv.draw())
        frames[tag] = (out, names, stats)
    assert frames["port"][1:] == frames["jax"][1:]
    for a, b in zip(frames["port"][0], frames["jax"][0]):
        np.testing.assert_array_equal(a, b)


def test_playback_controls_match(yard):
    """_Seekable's bounded back-buffer, SimpleViz's key bindings and rates,
    and LiveConsumer, driven the same way in both packages."""
    from ouster_sdk_tpu.viz import core as jcore

    from ouster_sdk_tpu_torch.viz import core as pcore

    _, scans = yard
    seen = []
    for (tag, _, v), core in zip(BOTH, (pcore, jcore)):
        sk = core._Seekable(iter(range(10)), maxlen=4)
        log = [next(sk) for _ in range(5)]
        log += [sk.seek(2), next(sk), next(sk), sk.seek(0), sk.seek(9),
                next(sk), sk.seek(7), next(sk), sk.seek(15), sk.next_ind]
        sv = v.SimpleViz([scans[tag][0].sensor_info], rate=1.0)
        for key in " >><.,":
            sv.scan_viz.viz.dispatch_key(ord(key))
            log.append((sv.paused, sv.rate))
        with pytest.raises(ValueError, match="rate"):
            v.SimpleViz([scans[tag][0].sensor_info], rate=5.0)
        lc = core.LiveConsumer(iter([[s] for s in scans[tag]]))
        got = [ls[0].frame_id for ls in lc]
        lc.stop()
        # the last item can be left in the queue when the consumer's wait
        # times out just before the producer ends: at most FRAMES
        log.append(bool(got) and set(got) <= {s.frame_id for s in
                                              scans[tag]}
                   and len(got) + lc.dropped <= FRAMES)
        seen.append(log)
    assert seen[0] == seen[1] and seen[0][-1] is True


def test_ls_show_matches(yard, tmp_path):
    _, scans = yard
    out = [_png(v.ls_show(scans[tag][1], path=str(tmp_path / f"{tag}.png")))
           for tag, _, v in BOTH]
    assert out[0] == out[1]


def test_imu_panel_matches():
    out = []
    for _, pkg, v in BOTH:
        info = pkg.SensorInfo.from_default(pkg.LidarMode.from_string(
            "512x10"))
        info.format.udp_profile_imu = type(info.format.udp_profile_imu)(
            "ACCEL32_GYRO32_NMEA")
        info.format.imu_packets_per_frame = 10
        info.format.imu_measurements_per_packet = 8
        scan = pkg.LidarScan(info)
        t = np.linspace(0, 4 * np.pi, 80)
        scan.field("IMU_ACC")[:] = np.stack([np.sin(t), np.cos(t), t], 1)
        scan.field("IMU_GYRO")[:] = np.stack([np.cos(t), t, 0 * t], 1)
        scan.field("RANGE")[:] = 1000
        scan.status[:] = 1
        lsv = v.LidarScanViz([info], viz=v.PointViz(width=W, height=H))
        lsv.update([scan])
        out.append(lsv.draw())
    np.testing.assert_array_equal(out[0], out[1])


def test_view_modes_match(yard):
    """Every default cloud and image mode, and the RGB and normals modes,
    prepare the same keys from the same scans."""
    _, scans = yard
    keys = {}
    for tag, _, v in BOTH:
        vm = submodule(v, "view_mode")
        info = scans[tag][0].sensor_info
        s = copy.deepcopy(scans[tag][2])
        rng = np.random.default_rng(5)
        modes = vm.default_cloud_modes(info) + vm.default_image_modes(info)
        modes += [vm.ReflMode(info), vm.ReflMode(None), vm.RingMode(info),
                  vm.SimpleMode("SIGNAL", prefix="p", suffix="s")]
        got = []
        for m in modes:
            for ret in (0, 1):
                en = m.enabled(s, ret)
                got.append((m.name, en, getattr(m, "names", None),
                            vm.is_norm_reflectivity_mode(m)))
                if en:
                    key = np.asarray(m.prepare(s, ret))
                    got.append((key.dtype.str, key.shape,
                                key.tobytes()))
        extra = rng.integers(0, 255, (s.h, s.w, 3)).astype(np.uint8)
        normals = rng.normal(size=(s.h, s.w, 3)).astype(np.float32)
        for name, arr, mode in (("RGBX", extra, vm.RGBMode),
                                ("NORMX", normals, vm.NormalsMode)):
            if not s.has_field(name):
                s.add_field(name, arr)
            m = mode(name, info=info)
            got.append((m.name, m.enabled(s),
                        np.asarray(m.prepare(s)).tobytes()))
        item = vm.VizExtraMode(lambda: vm.ReflMode(None))
        got.append(item.create(info).name)
        keys[tag] = got
    assert keys["port"] == keys["jax"]


def test_accumulators_match(yard):
    _, scans = yard
    pts = {}
    for tag, _, v in BOTH:
        infos = [scans[tag][0].sensor_info]
        acc = v.ScansAccumulator(infos, accum_max_num=3,
                                 accum_min_dist_meters=0.5)
        tracks = v.TracksAccumulator()
        mp = v.MapAccumulator(infos, map_ratio=0.5, map_size=20_000)
        flags = []
        for s in scans[tag]:
            flags.append(acc.accept([s]))
            tracks.accept([s])
            mp.accept([s])
        pts[tag] = (flags, acc.points(), tracks.points(), mp.points())
    assert pts["port"][0] == pts["jax"][0]
    for a, b in zip(pts["port"][1:], pts["jax"][1:]):
        assert a.dtype == b.dtype and a.shape[0] > 0
        np.testing.assert_array_equal(a, b)


def test_export_html_matches(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3000, 3)).astype(np.float32) * 10
    key = rng.random(3000).astype(np.float32)
    segs = rng.normal(size=(4, 2, 3)).astype(np.float32)
    out = []
    for tag, _, v in BOTH:
        html = submodule(v, "html")
        a = html.export_html(str(tmp_path / f"{tag}_a.html"), pts, key,
                             palette="magma", point_size=3.0)
        b = html.export_html(str(tmp_path / f"{tag}_b.html"), pts, None,
                             title="t", lines=segs,
                             line_colors=np.full((4, 3), 0.5, np.float32))
        out.append([open(p, "rb").read() for p in (a, b)])
    assert out[0] == out[1] and all(out[0])


def _po_inputs(pkg):
    po = submodule(pkg, "slam.pose_optimizer")
    ts = np.arange(10) * 10**8
    before, after = [], []
    for i, t in enumerate(ts):
        p = np.eye(4)
        p[:3, 3] = [i * 1.0, 0.1 * i * i, 0]
        before.append(po.Node(int(t), p.copy()))
        p2 = p.copy()
        p2[:3, 3] += [0, -0.05 * i, 0.01 * i]
        after.append(po.Node(int(t), p2))
    cons = [po.AbsolutePoseConstraint(int(ts[0]), np.eye(4)),
            po.PoseToPoseConstraint(int(ts[0]), int(ts[-1]), np.eye(4))]
    return before, after, cons


def test_po_viz_matches(tmp_path):
    out = []
    for tag, pkg, v in BOTH:
        pv = submodule(v, "po_viz")
        before, after, cons = _po_inputs(pkg)
        frames = [pv.render_po_viz(before, after, cons, top_down=t)
                  for t in (False, True)]
        paths = pv.save_po_viz_snapshots(before, after, cons,
                                         str(tmp_path / f"{tag}.png"))
        html = pv.export_po_html(before, after, cons,
                                 str(tmp_path / f"{tag}.html"))
        out.append((frames, [_png(p) for p in paths],
                    open(html, "rb").read()))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    assert out[0][1:] == out[1][1:] and len(out[0][1]) == 2


def test_zone_viz_matches(yard, tmp_path):
    _, scans = yard
    out = []
    for tag, pkg, v in BOTH:
        zone = submodule(pkg, "zone")
        zv = submodule(v, "zone_viz")
        info = scans[tag][0].sensor_info
        zs = zone.ZoneSet([zone.Zone.box(1, (6.0, 0.0, 0.0),
                                         (4.0, 4.0, 2.0)),
                           zone.Zone.box(2, (12.0, 3.0, 0.0),
                                         (3.0, 3.0, 3.0))])
        frame = zv.render_zone_scene(zs, info, scans[tag][1], {1: 12},
                                     width=W, height=H)
        path = zv.save_zone_snapshot(zs, info, scans[tag][2], {2: 3},
                                     str(tmp_path / f"{tag}.png"))
        verts = zv.precompute_voxel_vertices(info)
        zrb = zone.render_zone_bounds(zs.zones[1], info)
        mesh = zv.voxel_style_mesh_from_zone_image_pair(zrb, info, verts)
        viz = v.PointViz(width=W, height=H)
        viz.camera.distance = 30.0
        out.append((frame, _png(path), verts, mesh.triangles,
                    v.render_with_drawables(viz, [mesh])))
    assert out[0][1] == out[1][1]
    for k in (0, 2, 3, 4):
        a, b = out[0][k], out[1][k]
        assert a.dtype == b.dtype and a.size
        np.testing.assert_array_equal(a, b)


def test_ply_to_png_matches(yard, tmp_path):
    """ply_to_png of a PLY that save_scans wrote from the yard scans (and
    of the JAX package's PLY of the same scans)."""
    from ouster_sdk_tpu.io.save import save_scans as jsave

    from ouster_sdk_tpu_torch.io.save import save_scans as psave
    from ouster_sdk_tpu_torch.slam import ply_to_png as pply

    _, scans = yard
    psave(str(tmp_path / "p.ply"), [scans["port"][0].sensor_info],
          [pt.LidarScanSet([s]) for s in scans["port"][:3]])
    jsave(str(tmp_path / "j.ply"), [scans["jax"][0].sensor_info],
          [jx.LidarScanSet([s]) for s in scans["jax"][:3]])
    plys = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ply"))
    assert plys and len(plys) % 2 == 0
    for f in plys:
        for res, size in ((0.1, 4096), (0.5, 64)):
            a = pply(str(tmp_path / f), str(tmp_path / "a.png"),
                     resolution_m=res, max_size_px=size)
            b = jx.slam.ply_to_png(str(tmp_path / f),
                                   str(tmp_path / "b.png"),
                                   resolution_m=res, max_size_px=size)
            assert _png(a) == _png(b), (f, res)


# -- OpenGL on this host -----------------------------------------------------

@pytest.fixture
def gl_pair():
    """Both packages' gl modules, or a skip when neither can make a
    context here (the answer must agree)."""
    from ouster_sdk_tpu.viz import gl as jgl

    from ouster_sdk_tpu_torch.viz import gl as pgl

    have = (pgl.gl_available(), jgl.gl_available())
    assert have[0] == have[1]
    if not have[0]:
        pytest.skip("no surfaceless EGL/OpenGL stack on this host")
    return pgl, jgl


def test_gl_renderer_matches(gl_pair, yard):
    """GLRenderer.render, render_offscreen and PointViz(backend="gl") of
    the same scenes: equal frames in both packages."""
    _, scans = yard
    frames = []
    for (tag, pkg, v), g in zip(BOTH, gl_pair):
        r = g.GLRenderer(W, H)
        viz = None
        try:
            got = [r.render(_scene(v, "clouds")),
                   r.render(_scene(v, "drawables"))]
            lsv = v.LidarScanViz([scans[tag][0].sensor_info],
                                 viz=v.PointViz(width=W, height=H))
            lsv.update([scans[tag][3]])
            got.append(r.render(lsv.viz))
            got.append(r.render(_range_scene(v, pkg, scans[tag][4])))
            got.append(g.render_offscreen(_scene(v, "panels")))
            viz = _scene(v, "clouds")
            viz.backend = "gl"
            got.append(viz.render())
            got.append(viz.render())
        finally:
            if viz is not None and viz._gl_renderer is not None:
                viz._gl_renderer.close()
            r.close()
        frames.append(got)
    assert frames[0][0].any() and frames[0][2].any() and frames[0][3].any()
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)


def test_gl_context_clear_and_readback_match(gl_pair):
    out = []
    for g in gl_pair:
        ctx = g.GLContext(64, 48)
        try:
            ctx.gl.glClearColor(0.25, 0.5, 1.0, 1.0)
            ctx.gl.glClear(g.GL_COLOR_BUFFER_BIT)
            out.append(ctx.read())
        finally:
            ctx.close()
    assert out[0].shape == (48, 64, 3)
    np.testing.assert_array_equal(out[0], out[1])


def test_window_is_gated_without_a_display():
    """run_window raises GLUnavailable naming glfw on a host without a
    display, in both packages, and the window event bridge drives the
    camera and the handlers the same way."""
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        pytest.skip("display present; a window would open")
    from ouster_sdk_tpu.viz import gl as jgl

    from ouster_sdk_tpu_torch.viz import gl as pgl

    cams = []
    for (_, _, v), g in zip(BOTH, (pgl, jgl)):
        viz = v.PointViz(width=64, height=48)
        with pytest.raises(g.GLUnavailable, match="glfw"):
            g.run_window(viz)
        pos = {"xy": (100.0, 100.0)}
        bridge = g.WindowEventBridge(viz, press=1,
                                     cursor_pos=lambda w: pos["xy"])
        bridge.on_mouse(None, 0, 1, 0)
        bridge.on_move(None, 130.0, 80.0)
        bridge.on_mouse(None, 0, 0, 0)
        bridge.on_move(None, 300.0, 300.0)
        bridge.on_scroll(None, 0.0, 2.0)
        bridge.on_key(None, ord("="), 0, 1, 0)
        cams.append(viz.camera.view_matrix())
    np.testing.assert_array_equal(cams[0], cams[1])


# -- the command line's viewer entry points ----------------------------------

@pytest.mark.parametrize("args", [
    ["viz", "--out", "v.png", "--every", "2"],
    ["viz", "--out", "v.png", "--every", "3", "--cloud-mode", "refl",
     "--palette", "magma"],
    ["viz", "--aoi", "2,10,9,120", "--out", "a.png", "--every", "2"],
    ["viz", "--out", "m.png", "--every", "2", "--accum-num", "3",
     "--accum-every", "2", "--map", "--map-ratio", "0.5"],
    ["viz", "--html", "v.html", "--html-field", "RANGE", "--palette",
     "spezia", "--out", "h.png", "--every", "5"],
    ["viz", "--out", "p.png", "--every", "10", "--pause-at", "2"],
    ["slice", "1:4", "viz", "--out", "s.png", "--every", "1"],
], ids=("out", "mode-palette", "aoi", "accum-map", "html", "pause-at",
        "slice"))
def test_source_viz_writes_the_jax_packages_files(yard, tmp_path,
                                                  monkeypatch, args):
    p, j = both(tmp_path, monkeypatch, ["source", yard[0], *args])
    assert p.output == j.output
    assert len(same_files(tmp_path)) >= 1


def test_source_viz_refuses_an_unknown_cloud_mode(yard, tmp_path,
                                                  monkeypatch):
    p, j = both(tmp_path, monkeypatch, ["source", yard[0], "viz",
                                        "--cloud-mode", "nope"], ok=False)
    assert p.exit_code == j.exit_code == 1
    assert p.output == j.output and "unknown cloud mode" in p.output


def test_source_viz_window_without_a_display(yard, tmp_path, monkeypatch):
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        pytest.skip("display present; a window would open")
    p, j = both(tmp_path, monkeypatch, ["source", yard[0], "viz",
                                        "--window"], ok=False)
    assert p.exit_code == j.exit_code == 1
    assert p.output == j.output and "glfw" in p.output


@pytest.fixture(scope="module")
def models(yard, tmp_path_factory):
    """A PLY the port's save_scans wrote from a yard scan, and an STL of
    two zone boxes, in one directory."""
    from ouster_sdk_tpu_torch.io.save import save_scans
    from ouster_sdk_tpu_torch.zone import zone as pz

    d = tmp_path_factory.mktemp("models")
    _, scans = yard
    save_scans(str(d / "m.ply"), [scans["port"][0].sensor_info],
               [pt.LidarScanSet([scans["port"][4]])])
    ply = [f for f in os.listdir(d) if f.endswith(".ply")]
    tris = np.concatenate([pz.Zone.box(k, c, (2.0, 2.0, 2.0)).triangles
                           for k, c in ((1, (4.0, 0, 0)), (2, (0, 5.0, 1)))])
    pz.save_stl(str(d / "m.stl"), tris)
    return str(d / ply[0]), str(d / "m.stl")


@pytest.mark.parametrize("model,args", [
    (0, ["-o", "m.png"]), (0, ["--axes", "-o", "a.png"]),
    (0, ["-o", "m.html"]), (1, ["-o", "s.png"]), (1, ["--axes"]),
], ids=("ply", "ply-axes", "ply-html", "stl", "stl-axes-default"))
def test_model_viz_writes_the_jax_packages_files(models, tmp_path,
                                                 monkeypatch, model, args):
    p, j = both(tmp_path, monkeypatch, ["source", models[model],
                                        "model_viz", *args])
    assert p.output == j.output
    assert len(same_files(tmp_path)) == 1


@pytest.mark.parametrize("snap", ["po.png", "po.html"])
def test_pose_optimize_viz_snapshot_writes_the_jax_packages_files(
        yard, tmp_path, monkeypatch, snap):
    """`pose_optimize --viz-snapshot` over the same SLAM recording (itself
    byte-equal): the before/after views are the JAX package's bytes."""
    import json

    both(tmp_path, monkeypatch, ["source", yard[0], "slam", "-v", "1.0",
                                 "save", "s.osf"])
    cfg = {"constraints": [{"type": "ABSOLUTE_POSE", "timestamp": 0,
                            "pose": np.eye(4).ravel().tolist()}]}
    for tag in ("port", "jax"):
        (tmp_path / tag / "c.json").write_text(json.dumps(cfg))
    p, j = both(tmp_path, monkeypatch, [
        "source", "s.osf", "pose_optimize", "--config", "c.json",
        "--viz-snapshot", snap, "o.osf"])
    assert p.output == j.output
    stem = os.path.splitext(snap)[0]
    views = [f"{stem}_orbit.png", f"{stem}_top.png"] \
        if snap.endswith(".png") else [snap]
    for name in ["s.osf", *views]:
        a = (tmp_path / "port" / name).read_bytes()
        assert a and a == (tmp_path / "jax" / name).read_bytes(), name
