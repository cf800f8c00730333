"""ouster-cli equivalent: chained `source <url> cmd1 cmd2 ...` pipeline.

Rebuild of the reference CLI (ref: python/src/ouster/cli/core/__init__.py:72,
plugins/source.py, plugins/source_util.py:16-66): commands are typed
processors composed over a scan iterator, so `source x.pcap slice --start 1
clip --max-range 50 save out.osf` chains lazily. Run it with
`python -m ouster_sdk_tpu_torch`.

The device stages run on the GPU: a pcap or OSF source decodes or projects
on CUDA, `slam`/`localize --backend device` register with DeviceICP (the
icp_nn kernel), and `util benchmark` times the planar projection kernel
(cli/util.py). The viewer commands (`source viz`, `source model_viz`,
`pose_optimize --viz-snapshot`) render on the host (ouster_sdk_tpu_torch.viz)
from the scans the device stages give.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Iterator, List, Optional

import click
import numpy as np

from .. import __version__
from ..core.constants import ChanField
from ..io.sources import LidarScanSet, open_source

class SourcePipeline:
    """Holds the scan-set iterator being transformed by chained commands."""

    def __init__(self, url: str, **opts):
        self.url = url
        self._opts = opts
        self._source = None  # lazy: model_viz/model_save never open a
        # scan source (the url may be a bare .stl/.ply model file)
        self._infos = None  # set by reduce: the infos from there on
        self._stages: List[Callable[[Iterator], Iterator]] = []
        self.consumers: List[Callable[[Iterator], None]] = []
        self.standalone = False  # set by commands that already did all
        # their work on the raw url (model_viz/model_save)

    @property
    def source(self):
        if self._source is None:
            self._source = open_source(self.url, **self._opts)
        return self._source

    @property
    def infos(self):
        """The sensor infos of the scans at the end of the chain as built
        so far (a command reads them when it is set up; a consumer, at the
        end of the chain)."""
        if self._infos is not None:
            return self._infos
        return self.source.sensor_info

    def set_infos(self, infos) -> None:
        self._infos = list(infos)

    def add_stage(self, fn: Callable[[Iterator], Iterator]) -> None:
        self._stages.append(fn)

    def scan_iter(self) -> Iterator[LidarScanSet]:
        it: Iterator = iter(self.source)
        for stage in self._stages:
            it = stage(it)
        return it

    def run(self) -> None:
        if self.standalone:
            return
        it = self.scan_iter()
        if not self.consumers:
            for _ in it:
                pass
            return
        if len(self.consumers) == 1:
            self.consumers[0](it)
            return
        # CoupledTee (ref: source_util.py:85): fan one stream to N
        # consumers in LOCKSTEP — each consumer runs in its own thread
        # over a bounded queue, so no consumer can fall arbitrarily
        # behind and buffer the whole stream in memory
        import queue
        import threading

        _END = object()
        qs = [queue.Queue(maxsize=4) for _ in self.consumers]
        failed = [None] * len(self.consumers)

        def drain(k, consumer, q):
            saw_end = [False]

            def gen():
                while True:
                    item = q.get()
                    if item is _END:
                        saw_end[0] = True
                        return
                    yield item

            try:
                consumer(gen())
            except BaseException as e:  # noqa: BLE001
                failed[k] = e
            # keep draining so the producer never blocks on this
            # consumer's bounded queue after an early exit or failure
            while not saw_end[0]:
                if q.get() is _END:
                    break

        threads = [threading.Thread(target=drain, args=(k, c, q),
                                    daemon=True)
                   for k, (c, q) in enumerate(zip(self.consumers, qs))]
        for t in threads:
            t.start()
        try:
            for item in it:
                for q in qs:
                    q.put(item)
        finally:
            # a failing stage ends the consumers too: each one drains its
            # queue up to the end marker, so no put blocks for good
            for q in qs:
                q.put(_END)
            for t in threads:
                t.join()
        for e in failed:
            if e is not None:
                raise e


def _print_version(ctx, param, value):
    """Eager -v/--version: version plus discovered plugins (ref:
    cli/core/__init__.py:61-69)."""
    if not value or ctx.resilient_parsing:
        return
    click.echo(f"ouster-cli, version {__version__}")
    from .runner import find_plugins
    click.echo("\nPlugins provided:")
    for plugin in find_plugins():
        click.echo(plugin.name)
    ctx.exit()


@click.group(name="ouster-cli")
@click.option("-v", "--version", is_flag=True, callback=_print_version,
              expose_value=False, is_eager=True)
@click.option("--traceback", "trace", is_flag=True, default=False,
              help="Turn on the tracebacks on errors")
@click.option("--sdk-log-level",
              type=click.Choice(["trace", "debug", "info", "warning",
                                 "error", "critical", "off"],
                                case_sensitive=False),
              help="Set Ouster SDK logging level")
@click.pass_context
def cli(ctx, trace: bool, sdk_log_level: Optional[str]) -> None:
    """Ouster SDK command-line tool (PyTorch/CUDA port)."""
    from . import runner
    runner.TRACEBACK = trace
    ctx.ensure_object(dict)
    ctx.obj["TRACEBACK"] = trace
    if sdk_log_level:
        from ..core.logging import init_logger
        ctx.obj["SDK_LOG_LEVEL"] = sdk_log_level.lower()
        init_logger(ctx.obj["SDK_LOG_LEVEL"])


@cli.group(chain=True)
@click.argument("url")
@click.option("--meta", "-m", multiple=True, help="metadata json path(s)")
@click.option("--soft-id-check", is_flag=True, default=False)
@click.option("--extrinsics-file", default=None)
@click.option("--allow-major-version-mismatch", is_flag=True, default=False,
              help="read files from newer SDK major versions best-effort "
                   "instead of refusing")
@click.pass_context
def source(ctx, url, meta, soft_id_check, extrinsics_file,
           allow_major_version_mismatch):
    """Operate on a sensor / pcap / osf / bag source with chained
    commands."""
    opts = {}
    if meta:
        opts["meta"] = list(meta)
    if soft_id_check:
        opts["soft_id_check"] = True
    if extrinsics_file:
        opts["extrinsics_file"] = extrinsics_file
    if allow_major_version_mismatch:
        # downgrade fatal version errors to printed warnings
        # (ref: plugins/source.py:1588 allow_major_version_mismatch)
        def error_handler(severity, msg):
            click.echo(f"{severity.value}: {msg}", err=True)

        opts["error_handler"] = error_handler
    ctx.obj = SourcePipeline(url, **opts)


@source.result_callback()
@click.pass_context
def _run_pipeline(ctx, results, **kwargs):
    ctx.obj.run()


@source.command("info")
@click.pass_context
def source_info(ctx):
    """Print sensor metadata summary (ref: plugins/source.py metadata)."""
    for i, info in enumerate(ctx.obj.infos):
        fmt = info.format
        click.echo(f"sensor {i}: {info.prod_line} sn={info.sn} "
                   f"fw={info.fw_rev or info.image_rev}")
        click.echo(f"  profile={fmt.udp_profile_lidar.value} "
                   f"{fmt.pixels_per_column}x{fmt.columns_per_frame}"
                   f"@{fmt.fps}fps cols/packet={fmt.columns_per_packet}")


@source.command("metadata")
@click.pass_context
def source_metadata(ctx):
    """Dump full metadata json."""
    for info in ctx.obj.infos:
        click.echo(info.to_json_string())


def _parse_slice_spec(value: str):
    """[start]:[stop][:step], optionally with time units on start/stop
    (h/min/s/ms, decimals allowed) selecting time-based slicing
    (ref: plugins/source.py:310-353 extract_slice_indices)."""
    import re

    m = re.findall(r"^(?:(\d+(?:\.\d+)?)(h|min|s|ms)?)?"
                   r":(?:(\d+(?:\.\d+)?)(h|min|s|ms)?)?(?::(-?\d*))?$",
                   value)
    if not m or len(m[0]) != 5:
        raise click.BadParameter(
            "slice indices must be of the form [start]:[stop][:step]")
    g = m[0]
    mult = {"": 1, "ms": 0.001, "s": 1.0, "min": 60, "h": 3600}
    has_units = g[1] != "" or g[3] != ""
    has_decimals = ("." in g[0]) or ("." in g[2])
    frame_based = not (has_units or has_decimals)
    start = float(g[0]) * mult[g[1]] if g[0] else 0
    stop = float(g[2]) * mult[g[3]] if g[2] else None
    step = int(g[4]) if g[4] else None
    if stop is not None and not stop > start:
        raise click.BadParameter(
            "slice stop index must be greater than start")
    if step is not None and not step > 0:
        raise click.BadParameter("slice step index must be greater than 0")
    cast = int if frame_based else float
    return (cast(start), cast(stop) if stop is not None else None, step,
            frame_based)


@source.command("slice")
@click.argument("spec")
@click.pass_context
def source_slice(ctx, spec):
    """Take a [start]:[stop][:step] slice of the scan stream. start/stop
    may carry time units relative to the start of the file — h, min, s or
    ms, e.g. `10s:20s:2` (ref: plugins/source.py source_slice)."""
    start, stop, step, frame_based = _parse_slice_spec(spec)

    if frame_based:
        def stage(it):
            import itertools

            return itertools.islice(it, start, stop, step)
    else:
        def stage(it):
            # time-based slice (ref: plugins/source.py:356 tslice)
            start_time = None
            counter = 0
            for ls_set in it:
                t = None
                for s in ls_set:
                    if s is not None:
                        t = s.first_valid_packet_timestamp()
                        break
                if not t:
                    click.secho("WARNING: scan missing packet timestamps; "
                                "yielding anyway", fg="yellow", err=True)
                    yield ls_set
                    continue
                t = t / 1e9
                if start_time is None:
                    start_time = t
                dt = t - start_time
                if dt < start:
                    continue
                if stop is not None and dt > stop:
                    return
                if not step or counter % step == 0:
                    yield ls_set
                counter += 1

    ctx.obj.add_stage(stage)


@source.command("clip")
@click.option("--min-range", type=float, default=0.0, help="meters")
@click.option("--max-range", type=float, default=float("inf"), help="meters")
@click.option("--fields", default="RANGE,RANGE2")
@click.pass_context
def source_clip(ctx, min_range, max_range, fields):
    """Zero returns outside a range band
    (ref: sdk/core/clipped_scan_source.py)."""
    from ..io.derived import clip_scan

    names = fields.split(",")

    def stage(it):
        for ls_set in it:
            for s in ls_set.valid():
                clip_scan(s, min_range, max_range, names)
            yield ls_set

    ctx.obj.add_stage(stage)


def _parse_filter_bounds(spec: str):
    """Parse 'lo:hi' where either side is optional and values may carry a
    unit suffix mm/cm/dm/m (returned as (value, factor_mm) pairs;
    factor None = unitless) — ref: plugins/source.py extract_clip_indices."""
    units = (("mm", 1.0), ("cm", 10.0), ("dm", 100.0), ("m", 1000.0))
    if ":" not in spec:
        raise click.BadParameter(f"indices {spec!r} must look like lo:hi")
    lo_s, hi_s = spec.split(":", 1)

    def one(s):
        s = s.strip()
        if not s:
            return None, None
        for suf, fac in units:  # mm/cm/dm before m: first match wins
            if s.endswith(suf):
                return float(s[:-len(suf)]), fac
        return float(s), None

    return one(lo_s), one(hi_s)


@source.command("filter")
@click.argument("axis_field")
@click.argument("indices")
@click.option("--filtered-fields", default=None,
              help="comma-separated fields to apply the filter to "
                   "(default: all pixel fields)")
@click.option("--invalid-value", type=float, default=0,
              show_default=True,
              help="value written to pixels that match the filter")
@click.option("--coord-frame", default="BODY", show_default=True,
              type=click.Choice(["SENSOR", "BODY", "WORLD"],
                                case_sensitive=False),
              help="coordinate frame for X/Y/Z filtering (SENSOR=no "
                   "extrinsics, BODY=extrinsics, WORLD=dewarped)")
@click.pass_context
def source_filter(ctx, axis_field, indices, filtered_fields, invalid_value,
                  coord_frame):
    """Invalidate pixels by spatial axis (X/Y/Z), image coordinate (U/V)
    or any pixel field's value band (ref: plugins/source.py:601
    source_filter; ops in sdk/core/scan_ops.py:47-190).

    Examples: `filter REFLECTIVITY 0:100`, `filter X -10m:10m`,
    `filter U :62` (X/Y/Z values without a unit suffix are millimeters;
    U/V values in [0, 1] are fractions of the image size).
    """
    from ..io.derived import filter_field, filter_uv, filter_xyz
    from ..ops.xyzlut import make_xyz_lut

    (lo, lo_fac), (hi, hi_fac) = _parse_filter_bounds(indices)
    names = filtered_fields.split(",") if filtered_fields else None
    ax = axis_field.strip().lower()
    frame = coord_frame.strip().lower()
    invalid = int(invalid_value) if invalid_value == int(invalid_value) \
        else invalid_value
    if ax not in ("x", "y", "z") and frame != "body":
        raise click.BadParameter(
            "--coord-frame only applies when filtering by X, Y, or Z")

    if ax in ("x", "y", "z"):
        axis_idx = "xyz".index(ax)

        def to_m(v, fac):
            if v is None:
                return None
            return v * (fac if fac is not None else 1.0) / 1000.0

        lo_m = to_m(lo, lo_fac)
        hi_m = to_m(hi, hi_fac)
        lo_m = float("-inf") if lo_m is None else lo_m
        hi_m = float("inf") if hi_m is None else hi_m

        infos = ctx.obj.infos  # this stage's scans' (see reduce)

        def stage(it):
            luts = None
            for ls_set in it:
                if luts is None:
                    luts = [make_xyz_lut(
                        info, use_extrinsics=(frame != "sensor"))
                        for info in infos]
                for k, s in enumerate(ls_set):
                    if s is not None:
                        filter_xyz(s, luts[k], axis_idx, lo_m, hi_m,
                                   invalid, names,
                                   dewarp_points=(frame == "world"))
                yield ls_set
    elif ax in ("u", "v"):
        # values strictly inside (0, 1) are fractions of the image size
        lo_uv = float("-inf") if lo is None else (
            lo if 0 < lo < 1 else int(lo))
        hi_uv = float("inf") if hi is None else (
            hi if 0 < hi < 1 else int(hi))

        def stage(it):
            for ls_set in it:
                for s in ls_set.valid():
                    filter_uv(s, ax, lo_uv, hi_uv, invalid, names)
                yield ls_set
    else:
        lo_f = float("-inf") if lo is None else lo
        hi_f = float("inf") if hi is None else hi

        def stage(it):
            for ls_set in it:
                for s in ls_set.valid():
                    filter_field(s, axis_field.strip(), lo_f, hi_f,
                                 invalid, names)
                yield ls_set

    ctx.obj.add_stage(stage)


@source.command("plumb")
@click.option("--sensor-idx", type=int, default=None,
              help="compute for one sensor only")
@click.pass_context
def source_plumb(ctx, sensor_idx):
    """Compute the extrinsic matrix aligning each sensor's Z axis with
    gravity from its IMU data, print it, and apply it to the chained
    pipeline (ref: plugins/source.py:719-830 source_plumb)."""
    from ..core.packets import ImuPacket
    from ..core.types import UDPProfileIMU
    from ..io.sources import open_packet_source
    from ..ops.packet_format import PacketFormat
    from ..utils.pose_util import get_rot_matrix_to_align_to_gravity

    infos = ctx.obj.infos
    n = len(infos)
    sums = np.zeros((n, 3))
    counts = np.zeros(n, dtype=int)
    pfs = [PacketFormat.from_info(i) for i in infos]

    def legacy(idx):
        return infos[idx].format.udp_profile_imu == UDPProfileIMU.LEGACY

    # early-exit predicate: only the sensors being averaged need to
    # reach 100 samples — with --sensor-idx (or sensors that carry no
    # IMU data at all) requiring (counts > 100).all() would scan the
    # whole capture for nothing
    tracked = ([sensor_idx] if sensor_idx is not None
               else list(range(n)))

    def enough() -> bool:
        return bool(tracked) and bool(counts[tracked].min() > 100)

    try:
        psrc = open_packet_source(ctx.obj.url)
    except Exception:
        psrc = None
    if psrc is not None:
        try:
            for idx, pkt in psrc:
                if enough():
                    break
                if sensor_idx is not None and idx != sensor_idx:
                    continue
                if not isinstance(pkt, ImuPacket):
                    continue
                pf = pfs[idx]
                if legacy(idx):
                    sums[idx] += (pf.imu_la_x(pkt.buf),
                                  pf.imu_la_y(pkt.buf),
                                  pf.imu_la_z(pkt.buf))
                    counts[idx] += 1
                else:
                    acc = pf.parse_accel(pkt.buf)
                    _, _, status = pf.imu_measurement_headers(pkt.buf)
                    ok = status.astype(bool)
                    sums[idx] += acc[ok].sum(axis=0)
                    counts[idx] += int(ok.sum())
        finally:
            psrc.close()
    if not counts.any():
        # packetless containers (e.g. OSF): average the scans' IMU_ACC
        # SCAN fields instead
        from ..io.sources import open_source as _open

        src2 = _open(ctx.obj.url)
        try:
            for ls_set in src2:
                if enough():
                    break
                for idx, s in enumerate(ls_set):
                    if s is None or not s.has_field(ChanField.IMU_ACC):
                        continue
                    acc = np.asarray(s.field(ChanField.IMU_ACC))
                    ok = np.ones(acc.shape[0], bool)
                    if s.has_field(ChanField.IMU_STATUS):
                        st = np.asarray(s.field(ChanField.IMU_STATUS))
                        ok = st.astype(bool)[: acc.shape[0]]
                    sums[idx] += acc[ok].sum(axis=0)
                    counts[idx] += int(ok.sum())
        finally:
            src2.close()
    active = range(n) if sensor_idx is None else [sensor_idx]
    if not all(counts[i] > 0 for i in active):
        raise click.ClickException(
            f"no IMU data found in {ctx.obj.url}")
    for i in active:
        avg = sums[i] / counts[i]
        click.echo(f"Average ax: {avg[0]}, ay: {avg[1]}, az: {avg[2]}")
        T = np.eye(4)
        T[:3, :3] = get_rot_matrix_to_align_to_gravity(*avg)
        click.echo("Transformation Matrix to Correct Sensor Orientation:")
        click.echo(T)
        click.echo("Flatten Transformation Matrix:")
        click.echo(" ".join(
            "0" if v == 0 else ("1" if v == 1 else f"{v:.8f}")
            for row in T for v in row))
        infos[i].extrinsic = T

    def stage(it):
        yield from it

    ctx.obj.add_stage(stage)


@source.command("reduce")
@click.option("--beams", type=int, required=True,
              help="target number of beams")
@click.pass_context
def source_reduce(ctx, beams):
    """Decimate beams (ref: sdk/core/reduced_scan_source.py). The
    commands after it see the reduced sensor infos, so `save` writes
    metadata that matches the scans."""
    from ..io.derived import reduce_info, reduce_scan

    ctx.obj.set_infos([reduce_info(info, beams) for info in ctx.obj.infos])

    def stage(it):
        for ls_set in it:
            yield LidarScanSet([
                reduce_scan(s, beams) if s is not None else None
                for s in ls_set])

    ctx.obj.add_stage(stage)


@source.command("stats")
@click.pass_context
def source_stats(ctx):
    """Print per-scan statistics (ref: plugins/source.py stats)."""
    def consumer(it):
        n = 0
        for ls_set in it:
            for idx, s in enumerate(ls_set):
                if s is None:
                    continue
                line = (f"scan {n} sensor {idx}: frame_id={s.frame_id} "
                        f"complete={s.complete()}")
                if s.has_field(ChanField.RANGE):
                    rng = s.field(ChanField.RANGE)
                    valid = rng[rng > 0]
                    lo = valid.min() * 1e-3 if valid.size else 0
                    hi = valid.max() * 1e-3 if valid.size else 0
                    line += (f" valid_px={valid.size} "
                             f"range[m] min={lo:.2f} max={hi:.2f}")
                else:
                    # lidar-stream-off sources carry IMU/zone data only
                    line += " (no lidar fields)"
                click.echo(line)
            n += 1
        click.echo(f"total scan sets: {n}")

    ctx.obj.consumers.append(consumer)


@source.command("save")
@click.argument("path")
@click.option("--fields", default=None, help="subset of fields to write")
@click.option("-p", "--prefix", default="", help="output filename prefix")
@click.option("-d", "--dir", "out_dir", default="", help="output directory")
@click.option("--overwrite", is_flag=True, default=False,
              help="overwrite an existing output file")
@click.option("--ts", "ts_mode", default="packet",
              type=click.Choice(["packet", "lidar"]),
              help="message timestamp source for OSF indexing")
@click.option("--compression-level", default=1, type=int,
              help="OSF field compression level")
@click.option("--png/--zpng", "use_png", default=True,
              help="OSF field codec (PNG default; zPNG = zstd)")
@click.option("--chunk-size", default=2 * 1024 * 1024, type=int,
              help="OSF chunk size in bytes")
@click.option("--split", "split_mb", default=None, type=int,
              help="start a new output file every SPLIT megabytes")
@click.option("--ros2", is_flag=True, default=False,
              help="write bags as ROS2 (rosbag2 sqlite3) storage")
@click.option("--field", "cloud_field", default="REFLECTIVITY",
              show_default=True,
              type=click.Choice(["SIGNAL", "NEAR_IR", "REFLECTIVITY",
                                 "NONE"], case_sensitive=False),
              help="cloud formats: key attribute column (NONE omits it)")
@click.option("--decimate/--no-decimate", default=False,
              help="cloud formats: voxel-downsample the output")
@click.option("--voxel-size", default=0.1, type=float, show_default=True,
              help="cloud formats: decimation voxel size (m)")
@click.option("--min-z", default=None, type=float,
              help="cloud formats: min z threshold (m)")
@click.option("--max-z", default=None, type=float,
              help="cloud formats: max z threshold (m)")
@click.option("-f", "--pts-per-file", default=100_000_000, type=int,
              show_default=True,
              help="cloud formats: points per output file")
@click.option("--ascii", "ascii_out", is_flag=True, default=False,
              help="cloud formats: ASCII instead of binary")
@click.pass_context
def source_save(ctx, path, fields, prefix, out_dir, overwrite, ts_mode,
                compression_level, use_png, chunk_size, split_mb, ros2,
                cloud_field, decimate, voxel_size, min_z, max_z,
                pts_per_file, ascii_out):
    """Save the stream to .osf/.pcap/.bag/.db3/.mcap/.csv/.ply/.pcd/.las,
    or .png for a per-scan/per-field 8-bit image series
    (ref: plugins/source_save.py option surface, :454 source_save_png)."""
    if prefix or out_dir:
        path = os.path.join(out_dir or ".", prefix + os.path.basename(path))
    ext = os.path.splitext(path)[1].lower()
    # .png is a per-scan/per-field image SERIES: `path` is the name stem,
    # never written itself — per-file existence is checked at write time
    if ext != ".png" and os.path.exists(path) and not overwrite:
        raise click.ClickException(
            f"{path} already exists; use --overwrite to replace it")
    pipeline = ctx.obj

    def consumer(it):
        from ..io.save import save_scans

        n = save_scans(path, pipeline.infos, it,
                       fields=fields and fields.split(","),
                       chunk_size=chunk_size,
                       compression_level=compression_level,
                       encoder="png" if use_png else "zpng",
                       ts_mode=ts_mode, ros2=ros2, split_mb=split_mb,
                       overwrite=overwrite,
                       cloud_opts=dict(
                           field=cloud_field, decimate=decimate,
                           voxel_size=voxel_size, min_z=min_z,
                           max_z=max_z, pts_per_file=pts_per_file,
                           ascii_out=ascii_out)
                       if ext in (".csv", ".ply", ".pcd", ".las")
                       else None)
        click.echo(f"wrote {n} scans to {path} ({ext})")

    pipeline.consumers.append(consumer)


@source.command("slam")
@click.option("--voxel-size", "-v", type=float, default=-1.0)
@click.option("--min-range", type=float, default=5.0)
@click.option("--max-range", type=float, default=100.0)
@click.option("--deskew-method", default="auto", show_default=True,
              type=click.Choice(["auto", "none", "constant_velocity",
                                 "imu_deskew"]),
              help="motion compensation (auto = IMU integration when the "
                   "scans carry IMU fields, else constant velocity)")
@click.option("--dump-map", "-d", default=None,
              help="write the final SLAM map points to this .ply file")
@click.option("--trajectory", default=None,
              help="write KITTI poses to this file")
@click.option("--backend", default="host", show_default=True,
              type=click.Choice(["host", "device"]),
              help="registration backend: host voxel-hash ICP or the "
                   "Gauss-Newton ICP on the GPU (slam/device_icp.py)")
@click.pass_context
def source_slam(ctx, voxel_size, min_range, max_range, deskew_method,
                dump_map, trajectory, backend):
    """Run KISS-ICP SLAM over the stream, updating scan poses
    (ref: plugins/source_mapping.py:298 source_slam)."""
    from ..slam.engine import SlamConfig, SlamEngine

    engine = SlamEngine(ctx.obj.infos, SlamConfig(
        min_range=min_range, max_range=max_range, voxel_size=voxel_size,
        deskew=deskew_method, backend=backend))
    poses: List[np.ndarray] = []

    def stage(it):
        for ls_set in it:
            engine.update(ls_set)
            poses.append(engine.last_pose.copy())
            yield ls_set

    ctx.obj.add_stage(stage)

    if dump_map:
        def map_consumer(it):
            for _ in it:
                pass
            from ..io.cloud_io import write_pointcloud

            pts = engine.get_point_cloud()
            write_pointcloud(dump_map, pts)
            click.echo(f"map was dumped to {dump_map} "
                       f"({len(pts)} points)")

        ctx.obj.consumers.append(map_consumer)

    if trajectory:
        def consumer(it):
            for _ in it:
                pass
            with open(trajectory, "w") as f:
                for p in poses:
                    f.write(" ".join(f"{v:.18e}"
                                     for v in p[:3, :].reshape(-1)) + "\n")
            click.echo(f"wrote {len(poses)} poses to {trajectory}")

        ctx.obj.consumers.append(consumer)


@source.command("pose_optimize")
@click.argument("output_osf")
@click.option("--config", "config_path", default=None,
              help="constraint config json (ref: constraint_config.cpp)")
@click.option("--key-frame-distance", type=float, default=None)
@click.option("--viz-snapshot", default=None,
              help="write before/after trajectory PNG snapshots (headless "
              "equivalent of the pose-optimizer viewer, ref: "
              "plugins/source_po_viz.py)")
@click.pass_context
def source_pose_optimize(ctx, output_osf, config_path, key_frame_distance,
                         viz_snapshot):
    """Refine the recording's SLAM trajectory against constraints and
    write a new OSF (ref: plugins/source.py:856 pose_optimize)."""
    from ..slam.pose_optimizer import optimize_osf_trajectory

    url = ctx.obj.url
    if not url.lower().endswith(".osf"):
        raise click.ClickException("pose_optimize requires an OSF source")
    cfg_text = None
    if config_path:
        with open(config_path) as f:
            cfg_text = f.read()

    def consumer(it):
        for _ in it:
            pass
        n = optimize_osf_trajectory(url, output_osf, cfg_text,
                                    key_frame_distance,
                                    viz_snapshot=viz_snapshot)
        click.echo(f"wrote {n} pose-optimized scans to {output_osf}")

    ctx.obj.consumers.append(consumer)


@source.command("localize")
@click.option("--map", "map_path", required=True,
              help="prior map point cloud (.ply/.pcd/.csv/.las)")
@click.option("--min-range", type=float, default=5.0)
@click.option("--max-range", type=float, default=100.0)
@click.option("--voxel-size", type=float, default=-1.0)
@click.option("--trajectory", default=None,
              help="write KITTI poses to this file")
@click.option("--backend", default="host", show_default=True,
              type=click.Choice(["host", "device"]),
              help="registration backend (see slam --backend)")
@click.pass_context
def source_localize(ctx, map_path, min_range, max_range, voxel_size,
                    trajectory, backend):
    """Localize against a prior map — registration without map updates
    (ref: plugins/source_mapping.py localize, kiss_localization.cpp)."""
    from ..io.cloud_io import read_pointcloud
    from ..slam.engine import LocalizationEngine, SlamConfig

    points, _ = read_pointcloud(map_path)
    engine = LocalizationEngine(ctx.obj.infos, points, SlamConfig(
        min_range=min_range, max_range=max_range, voxel_size=voxel_size,
        backend=backend))
    poses: List[np.ndarray] = []

    def stage(it):
        for ls_set in it:
            engine.update(ls_set)
            poses.append(engine.last_pose.copy())
            yield ls_set

    ctx.obj.add_stage(stage)

    if trajectory:
        def consumer(it):
            for _ in it:
                pass
            with open(trajectory, "w") as f:
                for p in poses:
                    f.write(" ".join(f"{v:.18e}"
                                     for v in p[:3, :].reshape(-1)) + "\n")
            click.echo(f"wrote {len(poses)} poses to {trajectory}")

        ctx.obj.consumers.append(consumer)


@source.command("viz")
@click.option("--out", default=None,
              help="render PNG snapshot(s) to this path instead of a window")
@click.option("--every", type=int, default=10, help="snapshot every N scans")
@click.option("--cloud-mode", default=None,
              help="cloud coloring mode name (e.g. RANGE, SIGNAL, "
              "REFLECTIVITY, NEAR_IR, RING)")
@click.option("--palette", default=None,
              type=click.Choice(["calref", "spezia", "grey", "viridis",
                                 "magma", "rainbow"]),
              help="cloud color palette")
@click.option("--aoi", default=None,
              help="2D selection rectangle r0,c0,r1,c1 on the first image "
              "panel; prints range stats per scan")
@click.option("--accum-num", type=int, default=0,
              help="accumulate key-frame clouds (ref: --accum-num)")
@click.option("--accum-every", type=int, default=0,
              help="key frame every N scans")
@click.option("--accum-every-m", type=float, default=0.0,
              help="key frame every M meters of travel")
@click.option("--map", "map_enabled", is_flag=True, default=False,
              help="accumulate a global map overlay (ref: --map)")
@click.option("--map-ratio", type=float, default=1.0,
              help="fraction of points added to the map per scan")
@click.option("--html", "html_out", default=None,
              help="also export an interactive WebGL viewer (accumulated "
                   "world-frame points) to this self-contained HTML file")
@click.option("--html-field", default="REFLECTIVITY", show_default=True,
              help="point color key field for --html")
@click.option("-r", "--rate", default="max",
              type=click.Choice(["0.25", "0.5", "0.75", "1", "1.5", "2",
                                 "3", "max"]),
              help="playback rate (wall-clock pacing; ref: source.py "
                   "viz -r). Headless default: max (no pacing)")
@click.option("--pause-at", type=int, default=-1,
              help="lidar scan number to pause at (resume with "
                   "SPACE via dispatch_key; ref: source.py --pause-at)")
@click.option("--backend", type=click.Choice(["software", "gl"]),
              default="software", show_default=True,
              help="renderer: numpy rasterizer, or real OpenGL on a "
              "headless EGL context (viz/gl.py)")
@click.option("--window", is_flag=True, default=False,
              help="open an interactive GLFW window (needs pip glfw + "
              "a display; ref: point_viz.h:207 run())")
@click.pass_context
def source_viz(ctx, out, every, cloud_mode, palette, aoi, accum_num,
               accum_every, accum_every_m, map_enabled, map_ratio,
               html_out, html_field, rate, pause_at, backend, window):
    """Visualize scans (offscreen renderer; ref: plugins/source.py viz,
    sdk/viz/model.py view modes / palettes / AOI). With --html, writes a
    single-file interactive WebGL orbit viewer of the (pose-dewarped)
    accumulated cloud — open it in any browser."""
    from ..viz.core import SimpleViz

    if html_out:
        from ..ops.xyzlut import make_xyz_lut

        pipeline = ctx.obj

        def html_consumer(it):
            luts = [make_xyz_lut(i, use_extrinsics=True)
                    for i in pipeline.infos]
            pts_acc, key_acc = [], []
            for ls_set in it:
                for k, s in enumerate(ls_set):
                    if s is None:
                        continue
                    rng = s.field(ChanField.RANGE)
                    xyz = luts[k](rng)
                    valid = rng > 0
                    from ..utils.pose_util import dewarp as _dewarp

                    world = _dewarp(xyz, s.pose)
                    pts_acc.append(world[valid].astype(np.float32))
                    if s.has_field(html_field.upper()):
                        key_acc.append(
                            s.field(html_field.upper())[valid])
            from ..viz.html import export_html

            pts = np.concatenate(pts_acc) if pts_acc else np.zeros((0, 3))
            key = (np.concatenate(key_acc)
                   if key_acc and len(key_acc) == len(pts_acc) else None)
            export_html(html_out, pts, key,
                        palette=palette or "viridis")
            click.echo(f"wrote interactive viewer {html_out} "
                       f"({len(pts)} points)")

        pipeline.consumers.append(html_consumer)

    def consumer(it):
        if window:
            from ..viz.core import LidarScanViz
            from ..viz.gl import GLUnavailable, run_window

            lsv_w = LidarScanViz(ctx.obj.infos)

            def step():
                for ls_set in it:
                    lsv_w.update(list(ls_set))
                    yield

            try:
                run_window(lsv_w.viz, scan_iter=step())
            except GLUnavailable as e:
                raise click.ClickException(str(e))
            return
        viz = SimpleViz(ctx.obj.infos, snapshot_path=out,
                        snapshot_every=every, accum_num=accum_num,
                        accum_every=accum_every,
                        accum_every_m=accum_every_m,
                        map_enabled=map_enabled, map_ratio=map_ratio,
                        rate=0.0 if rate == "max" else float(rate),
                        pause_at=pause_at, auto_resume=True,
                        backend=backend)
        lsv = viz.scan_viz
        if cloud_mode:
            names = [m.name for m in lsv.cloud_modes[0]]
            matches = [i for i, n in enumerate(names)
                       if cloud_mode.upper() in n.upper()]
            if not matches:
                raise click.ClickException(
                    f"unknown cloud mode {cloud_mode!r}; "
                    f"available: {names}")
            lsv._cloud_mode_ind = matches[0]
        if palette:
            from ..viz.core import CLOUD_PALETTE_ORDER

            lsv._palette_ind = CLOUD_PALETTE_ORDER.index(palette)
        sel = None
        if aoi:
            r0, c0, r1, c1 = (int(x) for x in aoi.split(","))
            sel = lsv.select_aoi((r0, c0), (r1, c1))
        if sel is not None:
            n = 0
            for ls_set in it:
                scans = list(ls_set)
                lsv.update(scans)
                for s in ls_set.valid():
                    st = sel.stats(s)
                    click.echo(
                        f"aoi scan {n}: {st['num_points']} pts, range "
                        f"{st['min_range_m']:.2f}-{st['max_range_m']:.2f} m"
                        f" (mean {st['mean_range_m']:.2f})")
                if out and n % max(every, 1) == 0:
                    stem, ext = os.path.splitext(out)
                    lsv.viz.save_png(f"{stem}_{n:04d}{ext or '.png'}")
                n += 1
        else:
            viz.run(it, live=ctx.obj.source.is_live)

    ctx.obj.consumers.append(consumer)


@cli.group()
def util() -> None:
    """Utilities."""


@util.command("system-info")
@click.option("--devices", is_flag=True,
              help="include the CUDA device inventory")
def util_system_info(devices) -> None:
    """Print system information as a json blob
    (ref: cli/core/util.py:140-142)."""
    from .util import system_info

    click.echo(json.dumps(system_info(devices), indent=4))


@util.command("validate-metadata")
@click.argument("file", required=True,
                type=click.Path(exists=True, dir_okay=False))
def util_validate_metadata(file) -> None:
    """Validate a metadata json file (ref: cli/core/util.py:145-169 —
    same issue-tier sections and no-issues message)."""
    from ..core.metadata import parse_and_validate_metadata

    with open(file) as f:
        _, issues = parse_and_validate_metadata(f.read())
    have_issues = False
    for title, items in (("CRITICAL ISSUES:", issues.critical),
                         ("WARNING ISSUES:", issues.warning),
                         ("INFORMATION ISSUES:", issues.information)):
        if items:
            have_issues = True
            click.echo(title)
            for item in items:
                click.echo(item.to_string())
    if not have_issues:
        click.echo("No issues found")


@util.command("benchmark")
@click.argument("url")
@click.option("--frames", type=int, default=10)
@click.option("--report-dir", default=None,
              help="write the JSON report here, keyed by data md5 + host "
              "+ sdk version (ref: cli/core/util.py report files)")
@click.option("--trace-dir", default=None,
              help="capture a torch.profiler trace of the device pipeline "
              "stage into this directory (a Chrome trace: Perfetto or "
              "chrome://tracing)")
def util_benchmark(url, frames, report_dir, trace_dir):
    """Time read/write/batch/destagger/cartesian per frame, the planar
    projection on the GPU and host against device ICP, and gather system
    info into the reference's report shape (ref: cli/core/util.py:180-310;
    the body is cli/util.run_benchmark)."""
    from .util import run_benchmark

    run_benchmark(url, frames, report_dir, trace_dir, echo=click.echo)


@cli.command("discover")
@click.option("--timeout", type=float, default=3.0)
@click.option("--output", type=click.Choice(["text", "json"]),
              default="text", show_default=True)
@click.option("--probe/--no-probe", default=True, show_default=True,
              help="query each sensor's HTTP API for prod line / fw / "
              "mode")
@click.option("--host", multiple=True,
              help="probe these host[:port]s directly instead of mDNS")
@click.option("--target", multiple=True, metavar="HOST[:PORT]",
              help="additional unicast mDNS query destinations (e.g. an "
              "emulator's responder port; default port 5353)")
def discover(timeout, output, probe, host, target):
    """Discover sensors via mDNS and probe their HTTP control plane
    (ref: plugins/discover.py — text/json output with per-sensor prod
    line, firmware, serial, mode and udp destination). mDNS is
    implemented on raw UDP sockets (sensor/mdns.py) — no zeroconf
    dependency. With --host, skips mDNS and probes the given hosts
    directly."""
    found = []
    txts = {}
    if host:
        found = [(h, [h.rsplit(":", 1)[0]]) for h in host]
    else:
        from ..sensor.mdns import discover_sensors

        targets = []
        for t in target:
            # host:port split that survives IPv6: [::1]:5353 or a bare
            # IPv6 address (multiple colons, no brackets -> no port)
            if t.startswith("["):
                th, _, rest = t[1:].partition("]")
                tp = rest.lstrip(":") or "5353"
                targets.append((th, int(tp)))
            elif t.count(":") == 1:
                th, tp = t.rsplit(":", 1)
                targets.append((th, int(tp)))
            else:
                targets.append((t, 5353))
        for rec in discover_sensors(timeout=timeout, targets=targets):
            found.append((rec.instance, rec.addresses))
            txts[rec.instance] = {"port": rec.port, "host": rec.host,
                                  **rec.txt}

    results = []
    for name, addrs in found:
        entry = {"name": name, "addresses": addrs}
        if name in txts:
            entry["mdns"] = txts[name]
        if probe:
            from ..sensor.http import SensorHttp

            if host:
                probe_target = name
            else:
                probe_target = addrs[0] if addrs else name
                port = entry.get("mdns", {}).get("port", 0)
                if port and port != 80:  # SRV advertises the HTTP port
                    if ":" in probe_target:  # IPv6 literal needs []
                        probe_target = f"[{probe_target}]:{port}"
                    else:
                        probe_target = f"{probe_target}:{port}"
            try:
                http = SensorHttp.create(probe_target, timeout=3.0)
                si = http.sensor_info()
                cfg = http.active_config_params()
                entry.update({
                    "prod_line": si.get("prod_line", ""),
                    "prod_sn": si.get("prod_sn", ""),
                    "image_rev": si.get("image_rev", ""),
                    "lidar_mode": cfg.get("lidar_mode", ""),
                    "udp_dest": cfg.get("udp_dest", ""),
                    "udp_port_lidar": cfg.get("udp_port_lidar", ""),
                })
            except Exception as e:  # noqa: BLE001
                entry["error"] = str(e)[:120]
        results.append(entry)

    if output == "json":
        click.echo(json.dumps(results, indent=2))
        return
    for e in results:
        line = f"{e['name']}: {', '.join(e['addresses'])}"
        if "prod_line" in e:
            line += (f"  {e['prod_line']} sn={e['prod_sn']} "
                     f"fw={e['image_rev']} mode={e['lidar_mode']} "
                     f"dest={e['udp_dest']}:{e['udp_port_lidar']}")
        elif "error" in e:
            line += f"  (probe failed: {e['error']})"
        click.echo(line)
    if not results:
        click.echo("no sensors discovered")


def main() -> None:
    # register the extra command set (osf/sensor groups, convert, mask,
    # replay, ...) regardless of which entry point was used
    from . import extra  # noqa: F401

    cli()


if __name__ == "__main__":
    main()
