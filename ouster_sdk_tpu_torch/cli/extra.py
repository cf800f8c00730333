"""Additional CLI commands: osf file ops, sensor config/userdata, replay,
mask (ref: plugins/source.py mask/config/userdata, plugins/source_replay.py,
CLI osf subcommands)."""

from __future__ import annotations

import json
import sys
import time

import click
import numpy as np

from .core import cli, source


@source.command("mask")
@click.argument("mask_path")
@click.pass_context
def source_mask(ctx, mask_path):
    """Zero pixels where a mask image (PNG, nonzero=keep) is zero
    (ref: plugins/source.py mask)."""
    from ..io.derived import mask_scan
    from ..utils import png as P

    img, _, _ = P.decode(open(mask_path, "rb").read())
    if img.ndim == 3:
        img = img[..., 0]
    mask = img > 0

    def stage(it):
        from ..ops.destagger import destagger

        for ls_set in it:
            for s in ls_set.valid():
                m = mask
                if m.shape != (s.h, s.w):
                    ys = np.linspace(0, m.shape[0] - 1, s.h).astype(int)
                    xs = np.linspace(0, m.shape[1] - 1, s.w).astype(int)
                    m = m[ys][:, xs]
                # the PNG is drawn in destaggered (image) coordinates;
                # apply it in the scan's staggered frame
                # (ref: plugins/source.py:1141 destagger inverse=True)
                if getattr(s, "sensor_info", None) is not None:
                    m = destagger(s.sensor_info, m, inverse=True)
                mask_scan(s, m)
            yield ls_set

    ctx.obj.add_stage(stage)


@source.command("replay")
@click.option("--rate", type=float, default=1.0,
              help="playback rate multiple (0 = as fast as possible)")
@click.option("--serve", is_flag=True, default=False,
              help="serve the stream as a live sensor (HTTP control plane "
              "+ paced UDP packets) instead of pacing the pipeline")
@click.option("--loop", is_flag=True, default=False,
              help="with --serve: restart playback when the stream ends")
@click.option("--udp-dest", default="127.0.0.1", show_default=True,
              help="with --serve: packet destination address")
@click.option("--lidar-port", type=int, default=None,
              help="with --serve: lidar UDP port (default from metadata)")
@click.option("--imu-port", type=int, default=None,
              help="with --serve: IMU UDP port (default from metadata)")
@click.option("--http-port", type=int, default=8080, show_default=True,
              help="with --serve: sensor HTTP API port (0 = ephemeral)")
@click.pass_context
def source_replay(ctx, rate, serve, loop, udp_dest, lidar_port, imu_port,
                  http_port):
    """Pace the stream at sensor rate, or with --serve act as a sensor
    emulator: HTTP metadata/config endpoints + paced UDP republish
    (ref: plugins/source_replay.py)."""
    if serve:
        pipeline = ctx.obj

        def consumer(it):
            from ..sensor.emulator import (SensorEmulator,
                                           looping_packets_factory)

            sets = list(it)  # buffer so --loop can replay
            info = pipeline.infos[0]
            emu = SensorEmulator(
                info, looping_packets_factory(sets, info),
                udp_dest=udp_dest, lidar_port=lidar_port,
                imu_port=imu_port, http_port=http_port, rate=rate,
                loop=loop)
            emu.start()
            click.echo(
                f"serving sensor at http://127.0.0.1:{emu.http_port} "
                f"(lidar udp {udp_dest}:{emu.lidar_port}, rate {rate}x"
                f"{', looping' if loop else ''}); ctrl-c to stop")
            try:
                while loop or emu._send_thread.is_alive():
                    emu.join(0.5)
            except KeyboardInterrupt:
                pass
            finally:
                emu.stop()
            click.echo(f"sent {emu.packets_sent} packets "
                       f"({emu.passes_completed} passes)")

        pipeline.consumers.append(consumer)
        return

    def stage(it):
        last_ts = None
        last_wall = None
        for ls_set in it:
            ts = ls_set.combined_timestamp()
            if rate > 0 and last_ts is not None and ts > last_ts:
                dt = (ts - last_ts) * 1e-9 / rate
                elapsed = time.monotonic() - last_wall
                if dt > elapsed:
                    time.sleep(dt - elapsed)
            last_ts, last_wall = ts, time.monotonic()
            yield ls_set

    ctx.obj.add_stage(stage)


@source.command("pcap_info")
@click.option("-n", type=int, default=-1, help="read only N packets")
@click.pass_context
def pcap_info(ctx, n):
    """Print pcap stream analysis: encapsulation, capture window, and a
    per-(src, dst, size) UDP stream table (ref: plugins/source_pcap.py:53
    pcap_info; os_pcap.h:89-178 StreamInfo)."""
    import os as _os
    from collections import Counter
    from datetime import datetime

    from ..io.pcap import PcapReader

    path = ctx.obj.url
    size = _os.path.getsize(path)
    streams: Counter = Counter()
    ts_min, ts_max = None, None
    total = 0
    for pi, payload in PcapReader(path):
        total += 1
        t = pi.timestamp / 1e9  # PacketInfo.timestamp is nanoseconds
        ts_min = t if ts_min is None else min(ts_min, t)
        ts_max = t if ts_max is None else max(ts_max, t)
        streams[(pi.src_ip, pi.src_port, pi.dst_ip, pi.dst_port,
                 len(payload))] += 1
        if 0 <= n <= total:
            break
    click.echo(f"File size:     {size / 2**20:.2f}M")
    click.echo(f"Packets read:  {total}")
    if ts_min is not None:
        start = datetime.fromtimestamp(ts_min)
        end = datetime.fromtimestamp(ts_max)
        click.echo(f"Capture start: {start}")
        click.echo(f"Capture end:   {end}")
        click.echo(f"Duration:      {end - start}")
    click.echo("UDP Streams:")
    click.echo(f"  {'Src':<21} {'Dst':<21} {'Size':>6} {'Count':>8}")
    for (sip, sp, dip, dp, sz), cnt in sorted(streams.items()):
        click.echo(f"  {sip}:{sp:<5} {dip}:{dp:<5} {sz:>6} {cnt:>8}")
    ctx.obj.standalone = True


@source.command("bag_info")
@click.pass_context
def bag_info(ctx):
    """Print bag container info: time window, message count, topics
    (ref: plugins/source_bag.py:19 bag_info)."""
    from ..io.bag import open_bag_reader

    reader = open_bag_reader(ctx.obj.url)
    msgs = list(reader.messages())
    times = [m.timestamp for m in msgs]
    click.echo(f"Filename: {ctx.obj.url}")
    if times:
        t0, t1 = min(times), max(times)
        click.echo(f"Start: {t0 / 1e9}")
        click.echo(f"End: {t1 / 1e9}")
        click.echo(f"Duration: {(t1 - t0) / 1e9}")
    click.echo(f"Message Count: {len(msgs)}")
    click.echo("\nTopics:")
    from collections import Counter

    counts = Counter((m.connection.topic, m.connection.msgtype)
                     for m in msgs)
    for (topic, msgtype), cnt in sorted(counts.items()):
        click.echo(f"  {topic} ({msgtype}): {cnt}")
    ctx.obj.standalone = True


@source.command("emulate_zones")
@click.option("-c", "--config", default=None, type=click.Path(exists=True),
              help="zone configuration zip (default: zone set embedded in "
                   "the source metadata)")
@click.option("-l", "--live", default=None,
              help="comma-separated zone ids to make live")
@click.pass_context
def source_emulate_zones(ctx, config, live):
    """Emulate zone monitoring off-sensor: writes per-pixel ZONE_MASK bits
    and (16,) ZONE_STATES records into each scan
    (ref: plugins/source.py:1158 source_emulate_zones,
    sdk/zone_monitor/zone_common.py EmulatedZoneMon)."""
    from ..core.constants import ChanField
    from ..core.field import ZONE_STATE_DTYPE, FieldClass, FieldType
    from ..zone.monitor import EmulatedZoneMon
    from ..zone.zone import ZoneSet

    pipeline = ctx.obj
    if config is not None:
        zone_set = ZoneSet.from_zip(open(config, "rb").read())
    else:
        # zone set embedded in the sensor metadata
        # (ref: metadata.cpp:871-875)
        zone_set = next(
            (i.zone_set for i in pipeline.infos
             if getattr(i, "zone_set", None) is not None), None)
        if zone_set is None:
            raise click.ClickException(
                "no zone configuration: pass --config <zones.zip> or use "
                "a source whose metadata embeds a zone_set")
    live_ids = [int(v) for v in live.split(",")] if live else None
    infos = pipeline.infos  # this stage's scans' (see reduce)

    def stage(it):
        mons = None
        for ls_set in it:
            if mons is None:
                mons = [EmulatedZoneMon(zone_set, info)
                        for info in infos]
                if live_ids is not None:
                    for m in mons:
                        m.set_live_zones(live_ids)
            for k, s in enumerate(ls_set):
                if s is None:
                    continue
                # sources that already carry sensor-produced zone fields
                # (e.g. a ZM-profile OSF) expose them read-only — replace
                # them with writable emulated ones
                for name, ftype in (
                        (ChanField.ZONE_MASK,
                         FieldType(ChanField.ZONE_MASK, np.uint16,
                                   (), FieldClass.PIXEL_FIELD)),
                        (ChanField.ZONE_STATES,
                         FieldType(ChanField.ZONE_STATES,
                                   ZONE_STATE_DTYPE, (16,),
                                   FieldClass.SCAN_FIELD))):
                    if s.has_field(name) and \
                            not s.field(name).flags.writeable:
                        s.del_field(name)
                    if not s.has_field(name):
                        s.add_field(ftype)
                mask = s.field(ChanField.ZONE_MASK)
                mask[:] = 0
                mons[k].calc_triggers(s.field(ChanField.RANGE), mask)
                s.field(ChanField.ZONE_STATES)[:] = mons[k].get_packet()
            yield ls_set

    ctx.obj.add_stage(stage)


@source.command("model_viz")
@click.option("--axes", is_flag=True, help="draw the coordinate axes")
@click.option("-o", "--output", default="model_viz.png", show_default=True,
              help="snapshot path (offscreen renderer; .html writes a "
                   "self-contained interactive WebGL viewer)")
@click.pass_context
def model_viz(ctx, axes, output):
    """View a pointcloud (.ply/.pcd/.las) or .stl file — offscreen
    snapshot (ref: plugins/source.py:1039 model_viz)."""
    from ..viz.core import Cloud, PointViz
    from ..viz.drawables import Lines, Mesh, render_with_drawables

    url = ctx.obj.url
    ext = url.rsplit(".", 1)[-1].lower()
    if output.lower().endswith(".html") and ext in ("ply", "pcd", "las",
                                                    "csv"):
        from ..io.cloud_io import read_pointcloud
        from ..viz.html import export_html

        pts, attrs = read_pointcloud(url)
        key = next((np.asarray(attrs[n], np.float32) for n in
                    ("reflectivity", "intensity", "signal") if n in attrs),
                   None)
        export_html(output, np.asarray(pts, np.float32), key)
        click.echo(f"wrote {output}")
        ctx.obj.standalone = True
        return
    viz = PointViz("Model Viewer")
    drawables = []
    if ext == "stl":
        from ..zone.zone import load_stl

        drawables.append(Mesh(load_stl(url)))
    elif ext in ("ply", "pcd", "las", "csv"):
        from ..io.cloud_io import read_pointcloud

        pts, attrs = read_pointcloud(url)
        key = None
        for name in ("reflectivity", "intensity", "signal"):
            if name in attrs:
                key = np.asarray(attrs[name], np.float32)
                break
        viz.add(Cloud(np.asarray(pts, np.float32), key=key, point_size=3))
    else:
        raise click.ClickException(
            "unsupported file type: only .stl/.ply/.pcd/.las/.csv")
    if axes:
        segs = np.array([[[0, 0, 0], [1, 0, 0]], [[0, 0, 0], [0, 1, 0]],
                         [[0, 0, 0], [0, 0, 1]]], np.float32)
        drawables.append(Lines(segs, (255, 64, 64)))
    if drawables:
        frame = render_with_drawables(viz, drawables)
        viz.save_png(output, frame)
    else:
        viz.save_png(output)
    click.echo(f"wrote {output}")
    ctx.obj.standalone = True


@source.command("model_save")
@click.argument("filename")
@click.option("-d", "--downsample", type=float, default=None,
              help="voxel size in meters")
@click.option("--overwrite", is_flag=True, default=False)
@click.pass_context
def model_save(ctx, filename, downsample, overwrite):
    """Resave a pointcloud file, optionally voxel-downsampled
    (ref: plugins/source.py:1082 model_save)."""
    import os as _os

    from ..io.cloud_io import read_pointcloud, write_pointcloud
    from ..ops.downsample import voxel_downsample

    if not overwrite and _os.path.isfile(filename):
        raise click.ClickException(
            f"'{filename}' exists; pass --overwrite to replace it")
    pts, _attrs = read_pointcloud(ctx.obj.url)
    if downsample is not None:
        pts, _ = voxel_downsample(pts, downsample)
    write_pointcloud(filename, np.asarray(pts, np.float32))
    click.echo(f"wrote {filename} ({len(pts)} points)")
    ctx.obj.standalone = True


@source.command("normals")
@click.option("--backend", type=click.Choice(["numpy", "device"]),
              default="numpy", show_default=True,
              help="device = float32 PyTorch on the GPU "
                   "(ops/normals_device.py)")
@click.pass_context
def source_normals(ctx, backend):
    """Compute NORMALS fields for each scan (ref: processing.cpp normals).
    The device backend runs on CUDA."""
    from ..ops.normals import scan_normals

    def stage(it):
        for ls_set in it:
            for s in ls_set.valid():
                scan_normals(s, backend=backend)
            yield ls_set

    ctx.obj.add_stage(stage)


@source.command("convert")
@click.argument("path")
@click.pass_context
def source_convert(ctx, path):
    """Convert the source to another container (alias of save;
    ref: plugins/source_mapping.py convert)."""
    from ..io.save import save_scans

    pipeline = ctx.obj

    def consumer(it):
        n = save_scans(path, pipeline.infos, it)
        click.echo(f"converted {n} scans to {path}")

    pipeline.consumers.append(consumer)


@cli.group()
def osf() -> None:
    """OSF file operations."""


@osf.command("info")
@click.argument("path")
def osf_info_cmd(path):
    from ..io.osf_ops import osf_info

    click.echo(json.dumps(osf_info(path), indent=2))


@osf.command("dump")
@click.argument("path")
@click.option("-s", "--short", is_flag=True, help="omit entry payloads")
def osf_dump_cmd(path, short):
    """Dump all metadata entries as JSON (ref: plugins/source_osf.py:20
    osf_dump / operations.cpp dump_metadata)."""
    from ..io.osf import Reader

    r = Reader(path)
    out = {
        "metadata_id": r.metadata_id,
        "start_ts": r.start_ts,
        "end_ts": r.end_ts,
        "chunk_count": len(r.chunk_offsets),
        "entries": {},
    }
    for eid, ent in sorted(r.entries.items()):
        item = {"type": ent.type, "size": len(ent.buffer)}
        if not short and ent.type.endswith("LidarSensor"):
            # LidarSensor entries hold the sensor_info json verbatim
            try:
                from ..utils import flatbuf as fb

                tbl = fb.root_auto(ent.buffer)
                item["metadata"] = json.loads(tbl.string(0))
            except Exception:
                pass
        out["entries"][eid] = item
    click.echo(json.dumps(out, indent=2))


@osf.command("slice")
@click.argument("src")
@click.argument("dst")
@click.option("--start-index", type=int, default=None)
@click.option("--end-index", type=int, default=None)
def osf_slice_cmd(src, dst, start_index, end_index):
    from ..io.osf_ops import osf_slice

    n = osf_slice(src, dst, start_index=start_index, end_index=end_index)
    click.echo(f"wrote {n} scans to {dst}")


@osf.command("metadata")
@click.argument("path")
def osf_metadata_cmd(path):
    from ..io.osf_ops import osf_get_sensor_metadata

    for m in osf_get_sensor_metadata(path):
        click.echo(m)


@osf.command("parse")
@click.argument("path")
@click.option("--decode", is_flag=True, default=False,
              help="also decode each scan message")
def osf_parse_cmd(path, decode):
    """Print message types, timestamps and counts
    (ref: source_osf.py osf_parse / _osf.cpp parse_and_print)."""
    from ..io.osf_ops import parse_and_print

    parse_and_print(path, with_decoding=decode)


@cli.group()
def sensor() -> None:
    """Live sensor control-plane commands."""


@sensor.command("config")
@click.argument("hostname")
@click.argument("keyval", nargs=-1)
@click.option("--persist", is_flag=True, default=False)
def sensor_config(hostname, keyval, persist):
    """Get or set sensor configuration (ref: plugins/source_sensor.py)."""
    from ..sensor.http import SensorHttp

    http_client = SensorHttp.create(hostname)
    if not keyval:
        click.echo(json.dumps(http_client.active_config_params(), indent=2))
        return
    for kv in keyval:
        if "=" not in kv:
            raise click.UsageError(f"expected key=value, got {kv!r}")
        k, v = kv.split("=", 1)
        http_client.set_config_param(k, v)
    http_client.reinitialize()
    if persist:
        http_client.save_config_params()
    click.echo("config applied")


@sensor.command("userdata")
@click.argument("hostname")
@click.option("--set", "set_value", default=None)
@click.option("--delete", is_flag=True, default=False)
def sensor_userdata(hostname, set_value, delete):
    from ..sensor.http import SensorHttp

    http_client = SensorHttp.create(hostname)
    if delete:
        http_client.delete_user_data()
        click.echo("deleted")
    elif set_value is not None:
        http_client.set_user_data(set_value)
        click.echo("set")
    else:
        click.echo(http_client.get_user_data())


@sensor.command("metadata")
@click.argument("hostname")
def sensor_metadata(hostname):
    from ..sensor.http import SensorHttp

    click.echo(SensorHttp.create(hostname).metadata())


@sensor.command("network")
@click.argument("hostname")
def sensor_network(hostname):
    """Print the sensor's network configuration
    (ref: source_sensor.py sensor_network)."""
    from ..sensor.http import SensorHttp

    click.echo(json.dumps(SensorHttp.create(hostname).network(),
                          indent=2))


@sensor.command("diagnostics")
@click.argument("hostname")
@click.option("-o", "--output", default="diagnostics.bin",
              show_default=True)
def sensor_diagnostics(hostname, output):
    """Download the sensor diagnostics dump
    (ref: source_sensor.py sensor_diagnostics)."""
    from ..sensor.http import SensorHttp

    blob = SensorHttp.create(hostname).diagnostics_dump()
    with open(output, "wb") as f:
        f.write(blob)
    click.echo(f"wrote {len(blob)} bytes to {output}")


@sensor.command("restart")
@click.argument("hostname")
def sensor_restart(hostname):
    """Restart the sensor (ref: source_sensor.py sensor_restart)."""
    from ..sensor.http import SensorHttp

    SensorHttp.create(hostname).restart()
    click.echo("restart requested")


@sensor.command("live_zones")
@click.argument("hostname")
@click.argument("zones", nargs=-1, type=int)
@click.option("--set", "do_set", is_flag=True, default=False,
              help="set the given zone ids live instead of printing")
def sensor_live_zones(hostname, zones, do_set):
    """Get or set the live zone-monitor zone ids
    (ref: source_sensor.py sensor_live_zones)."""
    from ..sensor.http import SensorHttp

    http_client = SensorHttp.create(hostname)
    if do_set:
        http_client.set_zone_monitor_live_ids(list(zones))
        click.echo(f"live zones set to {list(zones)}")
    else:
        click.echo(json.dumps(http_client.get_zone_monitor_live_ids()))


@sensor.command("firmware")
@click.argument("hostname")
@click.argument("image", required=False,
                type=click.Path(exists=True, dir_okay=False))
def sensor_firmware(hostname, image):
    """Print the firmware version, or upload a firmware image
    (ref: source_sensor.py sensor_firmware / update_fw: POST
    api/v1/system/firmware)."""
    from ..sensor.http import SensorHttp

    http_client = SensorHttp.create(hostname)
    if image is None:
        click.echo(str(http_client.firmware_version()))
        return
    with open(image, "rb") as f:
        blob = f.read()
    http_client._request("POST", "/api/v1/system/firmware", body=blob,
                         content_type="application/octet-stream",
                         timeout=300.0)
    click.echo(f"uploaded {len(blob)} bytes; sensor will re-flash "
               f"and restart")


def _register_benchmark_sensor():
    from .core import cli as _cli

    util_grp = _cli.commands.get("util")
    if util_grp is None:
        return

    @util_grp.command("benchmark-sensor")
    @click.argument("hostname")
    @click.option("--frames", type=int, default=30)
    @click.option("--scan-batch/--no-scan-batch", default=True)
    @click.option("--xyz/--no-xyz", default=True)
    def benchmark_sensor(hostname, frames, scan_batch, xyz):
        """Live pipeline stage timing (ref: cli/core/util.py:368
        benchmark-sensor)."""
        import time as _time

        import numpy as _np

        from ..ops.xyzlut import make_xyz_lut
        from ..sensor.scan_source import SensorScanSource

        src = SensorScanSource([hostname])
        info = src.sensor_info[0]
        lut = make_xyz_lut(info) if xyz else None
        t_recv = t_xyz = 0.0
        n = 0
        t0 = _time.perf_counter()
        try:
            for idx, scan in iter(lambda: src.get_scan(timeout_sec=5.0),
                                  (None, None)):
                if scan is None:
                    break
                t_recv += _time.perf_counter() - t0
                if lut is not None:
                    t1 = _time.perf_counter()
                    from ..core.constants import ChanField

                    lut(scan.field(ChanField.RANGE))
                    t_xyz += _time.perf_counter() - t1
                n += 1
                if n >= frames:
                    break
                t0 = _time.perf_counter()
        finally:
            src.close()
        click.echo(json.dumps({
            "frames": n,
            "recv_ms_per_frame": round(t_recv / max(n, 1) * 1e3, 3),
            "xyz_ms_per_frame": round(t_xyz / max(n, 1) * 1e3, 3),
        }, indent=2))


_register_benchmark_sensor()
del _register_benchmark_sensor


@cli.group()
def testing() -> None:
    """Test/validation utilities (ref: plugins/testing.py)."""


@testing.command("digest")
@click.argument("path")
@click.option("-m", "--meta", default=None, help="metadata json path")
@click.option("-s", "--save", is_flag=True, default=False,
              help="write <path>_digest.json next to the file")
@click.option("-c", "--check", default=None,
              help="compare against an existing digest json")
def testing_digest(path, meta, save, check):
    """Compute (and optionally check) the md5 stream digest of a pcap —
    the bit-exactness contract used by the conformance tests
    (ref: plugins/testing.py digest, sdk/core/_digest.py)."""
    import os

    from ..io.pcap_source import PcapPacketSource
    from ..utils.digest import StreamDigest

    src = PcapPacketSource(path, metadata_paths=[meta] if meta else None)
    digest = StreamDigest.from_packet_source(src)
    if check:
        with open(check) as f:
            digest.check(StreamDigest.from_json(f.read()))
        click.echo("digest OK")
        return
    out = digest.to_json()
    if save:
        dst = os.path.splitext(path)[0] + "_digest.json"
        with open(dst, "w") as f:
            f.write(out)
        click.echo(f"wrote {dst}")
    else:
        click.echo(out)


@testing.command("time")
@click.argument("path")
@click.option("-m", "--meta", default=None)
@click.option("--frames", type=int, default=0, help="0 = whole file")
def testing_time(path, meta, frames):
    """Wall-clock timing of common pcap operations (read, batch, project)
    for quick regression checks (ref: plugins/testing.py time)."""
    from ..core.batcher import ScanBatcher
    from ..core.lidar_scan import LidarScan
    from ..io.pcap_source import PcapPacketSource
    from ..ops.xyzlut import make_xyz_lut

    src = PcapPacketSource(path, metadata_paths=[meta] if meta else None)
    info = src.sensor_info[0]

    t0 = time.perf_counter()
    pkts = list(src)
    t_read = time.perf_counter() - t0
    click.echo(f"read {len(pkts)} packets in {t_read:.3f}s")

    batcher = ScanBatcher(info)
    scan = LidarScan(info)
    scans = []
    t0 = time.perf_counter()
    for idx, p in pkts:
        if batcher(p, scan):
            scans.append(scan)
            scan = LidarScan(info)
            if frames and len(scans) >= frames:
                break
    if scan.frame_id != -1 and not (frames and len(scans) >= frames):
        scans.append(scan)
    t_batch = time.perf_counter() - t0
    click.echo(f"batched {len(scans)} scans in {t_batch:.3f}s")

    lut = make_xyz_lut(info)
    t0 = time.perf_counter()
    for s in scans:
        lut(s.field("RANGE"))
    t_xyz = time.perf_counter() - t0
    click.echo(f"projected {len(scans)} scans in {t_xyz:.3f}s")
    click.echo(f"total {t_read + t_batch + t_xyz:.3f}s")


@testing.command("synthesize")
@click.argument("out_pcap")
@click.option("--profile", default="RNG19_RFL8_SIG16_NIR16",
              help="UDP lidar profile name")
@click.option("--mode", default="1024x10", help="lidar mode WxF")
@click.option("--frames", type=int, default=1)
@click.option("--seed", type=int, default=0)
def testing_synthesize(out_pcap, profile, mode, frames, seed):
    """Generate a synthetic pcap + metadata json for a profile — test data
    without hardware (built on PacketWriter, the reference's
    scan_to_packets round-trip machinery)."""
    import os

    from ..core.types import LidarMode, SensorInfo, UDPProfileLidar
    from ..io.pcap import PcapWriter
    from ..ops.packet_format import PacketWriter

    info = SensorInfo.from_default(LidarMode.from_string(mode))
    info.format.udp_profile_lidar = UDPProfileLidar(profile)
    info.config.udp_port_lidar = 7502
    pw = PacketWriter(info.format)
    rng = np.random.default_rng(seed)
    cpp = pw.columns_per_packet
    n_pkts = info.format.columns_per_frame // cpp

    meta_path = os.path.splitext(out_pcap)[0] + ".json"
    with open(meta_path, "w") as f:
        f.write(info.to_json_string())

    n = 0
    with PcapWriter(out_pcap) as w:
        for fid in range(1, frames + 1):
            for p in range(n_pkts):
                buf = pw.new_packet()
                pw.set_packet_header(buf, init_id=info.init_id,
                                     prod_sn=info.sn)
                pw.set_frame_id(buf, fid)
                m0 = p * cpp
                ts = fid * 100_000_000 + m0 * 1000
                pw.set_col_headers(
                    buf, np.arange(cpp, dtype=np.uint64) + ts,
                    np.arange(cpp, dtype=np.uint16) + m0,
                    np.ones(cpp, dtype=np.uint32))
                from ..ops.profiles import lookup_profile_entry

                fi = lookup_profile_entry(
                    info.format.udp_profile_lidar).fields["RANGE"]
                vals = rng.integers(0, 1 << fi.bit_size,
                                    size=(pw.pixels_per_column, cpp))
                pw.set_field(buf, "RANGE", vals << fi.upshift
                             if fi.upshift else vals)
                w.write(buf.tobytes(), "127.0.0.1", "127.0.0.1",
                        7502, 7502, ts)
                n += 1
    click.echo(f"wrote {n} packets ({frames} frames) to {out_pcap} "
               f"+ {meta_path}")


@source.command("config")
@click.argument("keyval", nargs=-1)
@click.option("--persist", is_flag=True, default=False)
@click.pass_context
def source_config(ctx, keyval, persist):
    """Get or set the source sensor's configuration — the reference
    registers config as a SENSOR-source chained command
    (ref: plugins/source_sensor.py:235-266, source.commands[SENSOR])."""
    from ..io.sources import IoType, io_type

    url = ctx.obj.url
    if io_type(url) != IoType.SENSOR:
        raise click.ClickException("config requires a sensor source")

    # control-plane only: run immediately — never open the scan source
    # (a live data stream) just to discard it
    sensor_config.callback(url, keyval, persist)
    ctx.obj.standalone = True


@source.command("userdata")
@click.option("--set", "set_value", default=None)
@click.option("--delete", is_flag=True, default=False)
@click.pass_context
def source_userdata(ctx, set_value, delete):
    """Retrieve or set the source sensor's userdata
    (ref: plugins/source_sensor.py:180-185)."""
    from ..io.sources import IoType, io_type

    url = ctx.obj.url
    if io_type(url) != IoType.SENSOR:
        raise click.ClickException("userdata requires a sensor source")
    sensor_userdata.callback(url, set_value, delete)
    ctx.obj.standalone = True


@source.command("save_raw")
@click.argument("path")
@click.option("--overwrite", is_flag=True, default=False)
@click.option("--duration", "-D", type=float, default=None,
              help="seconds of packets to record")
@click.option("--ros2", is_flag=True, default=False,
              help="write bags as ROS2 (rosbag2 sqlite3) storage")
@click.pass_context
def source_save_raw(ctx, path, overwrite, duration, ros2):
    """Save the source's ORIGINAL packets (lidar + imu, no
    re-packetization) to .pcap/.bag/.db3/.mcap
    (ref: plugins/source_save.py source_save_raw). Does not chain."""
    import os as _os

    from ..io.sources import open_packet_source

    if _os.path.exists(path) and not overwrite:
        raise click.ClickException(
            f"{path} already exists; use --overwrite to replace it")
    ext = _os.path.splitext(path)[1].lower()
    if ext not in (".pcap", ".bag", ".db3", ".mcap"):
        raise click.BadParameter(f"cannot save raw file of type {ext}")

    pipeline = ctx.obj
    url = pipeline.url
    # standalone: recording raw packets must NOT also open the scan
    # source — on a live sensor that would bind the same UDP ports twice
    pipeline.standalone = True

    def record_raw():
        packets = open_packet_source(url)
        infos = packets.sensor_info
        n = 0
        t0_ns = None
        if ext == ".pcap":
            from ..io.pcap import PcapWriter

            w = PcapWriter(path)
            # metadata json(s) beside the capture, like the reference's
            # pcap recorder
            stem = _os.path.splitext(path)[0]
            for idx, info in enumerate(infos):
                suffix = f"_{idx}" if len(infos) > 1 else ""
                with open(f"{stem}{suffix}.json", "w") as f:
                    f.write(info.to_json_string())

            def write(idx, pkt, kind):
                info = infos[idx]
                port = (info.config.udp_port_lidar if kind == "lidar"
                        else info.config.udp_port_imu) or 7502
                w.write(bytes(pkt.buf), "127.0.0.1",
                        info.config.udp_dest or "127.0.0.1", 7502, port,
                        pkt.host_timestamp)
        else:
            from ..io.bag import (McapBagWriter, Ros1BagWriter,
                                  Ros2BagWriter)

            if ext == ".mcap":
                w = McapBagWriter(path)
            elif ext == ".db3" or ros2:
                w = Ros2BagWriter(path if ext == ".db3" else
                                  _os.path.splitext(path)[0] + ".db3")
            else:
                w = Ros1BagWriter(path)
            for idx, info in enumerate(infos):
                w.write_string(f"/os{idx}/metadata", info.to_json_string(),
                               1)

            def write(idx, pkt, kind):
                w.write_packet(f"/os{idx}/{kind}_packets", bytes(pkt.buf),
                               pkt.host_timestamp)

        try:
            for idx, pkt in packets:
                kind = pkt.type().value.lower()
                if kind not in ("lidar", "imu"):
                    continue
                ts = pkt.host_timestamp
                if duration is not None:
                    if t0_ns is None:
                        t0_ns = ts
                    elif ts - t0_ns > duration * 1e9:
                        break
                write(idx, pkt, kind)
                n += 1
        finally:
            w.close()
        click.echo(f"saved {n} raw packets to {path}")

    record_raw()


@osf.command("set-metadata")
@click.argument("src")
@click.argument("dst")
@click.argument("metadata_json")
@click.option("--sensor-idx", type=int, default=0)
def osf_set_metadata_cmd(src, dst, metadata_json, sensor_idx):
    """Rewrite an OSF with replacement sensor metadata
    (ref: ouster_osf/src/operations.cpp update metadata)."""
    from ..io.osf_ops import (osf_get_sensor_metadata,
                              osf_update_sensor_metadata)

    metas = osf_get_sensor_metadata(src)
    if not 0 <= sensor_idx < len(metas):
        raise click.ClickException(
            f"sensor index {sensor_idx} out of range (file has "
            f"{len(metas)} sensors)")
    with open(metadata_json) as f:
        metas[sensor_idx] = f.read()
    osf_update_sensor_metadata(src, dst, metas)
    click.echo(f"wrote {dst} with updated metadata for sensor "
               f"{sensor_idx}")
