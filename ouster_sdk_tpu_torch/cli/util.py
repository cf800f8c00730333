"""Bodies of `util system-info` and `util benchmark`, as plain functions
(ref: python/src/ouster/cli/core/util.py:50-96 get_system_info, :180-310
benchmark). They import no click, so a program without it (a benchmark
harness, a smoke run on a GPU host) calls them directly; the click
commands of cli/core.py print what they return.

The device work runs on the GPU: `system_info(devices=True)` lists the
torch.cuda devices, `run_benchmark`'s device stage times
ScanPipeline.project_planar (the planar_project kernel on CUDA tensors)
and its ICP stage times the host KissICP against DeviceICP (the icp_nn
kernel). Both stages run on `device`, CUDA when none is named, and
neither catches its own failure.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import tempfile
import time
from typing import Callable, Optional

import numpy as np

#: the distribution that ships the package (pyproject.toml's name)
PACKAGE = "ouster-sdk-tpu"


def cpu_brand() -> str:
    """The CPU's model name from /proc/cpuinfo, "UNKNOWN" elsewhere."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "UNKNOWN"


def system_info(devices: bool = False) -> dict:
    """Reference report shape (ref: cli/core/util.py:50-96
    get_system_info): platform attrs with an md5-hashed node id,
    cpuinfo, package versions; with `devices`, the CUDA devices torch
    sees (kind: the device name, platform "gpu", id: the ordinal)."""
    import torch

    from .. import __version__ as sdk_version

    res = {"platform": {
        attr: getattr(platform, attr)()
        for attr in ("machine", "platform", "processor", "python_version",
                     "python_build", "python_compiler", "release",
                     "system")}}
    # hash of the hostname crudely identifies systems without leaking it
    res["platform"]["node"] = hashlib.md5(
        platform.node().encode()).hexdigest()[:7]
    res["cpuinfo"] = {"brand_raw": cpu_brand()}
    res["packages"] = {PACKAGE: sdk_version, "torch": torch.__version__}
    if devices:
        res["devices"] = [
            {"kind": torch.cuda.get_device_name(i), "platform": "gpu",
             "id": i}
            for i in range(torch.cuda.device_count())]
    return res


def run_benchmark(url: str, frames: int = 10,
                  report_dir: Optional[str] = None,
                  trace_dir: Optional[str] = None,
                  echo: Callable[[str], None] = print,
                  device=None) -> dict:
    """Time read/write/batch/destagger/cartesian per frame, the device
    projection and ICP registration, and gather system info into the
    reference's report shape (ref: cli/core/util.py:180-310); prints each
    stage through `echo` and returns the report. `trace_dir` records a
    torch.profiler trace of the device stage there. The device stage (a
    pcap file only) and icp_device run on `device`: CUDA when none is
    named, an error without a GPU."""
    import torch

    from .. import __version__ as sdk_version
    from ..core.batcher import ScanBatcher
    from ..core.constants import ChanField
    from ..core.lidar_scan import LidarScan
    from ..core.packets import LidarPacket
    from ..io.save import save_scans, scan_to_packets
    from ..io.sources import open_source
    from ..ops.destagger import destagger
    from ..ops.xyzlut import make_xyz_lut

    report = {"pcap": {}, "sys_info": {}, "times": {}}
    report["sys_info"] = {
        "platform": {"platform": platform.platform(),
                     "python_version": platform.python_version(),
                     "machine": platform.machine(),
                     "node": platform.node()},
        "cpuinfo": {"brand_raw": cpu_brand()},
        "packages": {PACKAGE: sdk_version, "torch": torch.__version__},
    }
    echo(f"  cpu: {report['sys_info']['cpuinfo']['brand_raw']}")
    echo(f"  platform: {platform.platform()}")
    echo(f"  python: {platform.python_version()}")
    echo(f"  {PACKAGE}: {sdk_version}")

    data_md5 = ""
    if os.path.isfile(url):
        h = hashlib.md5()
        with open(url, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        data_md5 = h.hexdigest()
        echo(f"  md5: {data_md5}")
    report["pcap"]["filename"] = os.path.basename(url)
    report["pcap"]["md5"] = data_md5

    # a named device goes to the source; unnamed, each source takes its own
    # default (the engine and the OSF projector: CUDA)
    src = open_source(url, **({} if device is None else {"device": device}))
    info = src.sensor_info[0]
    report["pcap"]["metadata"] = json.loads(info.to_json_string())
    lut = make_xyz_lut(info)

    def report_dur(key, dur, n_frames):
        report["times"][key] = {"total": dur,
                                "per_frame": dur / max(n_frames, 1)}
        echo(f"  {key:<12} {dur / max(n_frames, 1) * 1e3:8.2f} "
             f"ms/frame ({dur:.3f}s total)")

    # read
    t0 = time.perf_counter()
    sets = []
    for ls_set in src:
        sets.append(ls_set)
        if len(sets) >= frames:
            break
    report_dur("read", time.perf_counter() - t0, len(sets))
    scans = [s for ls in sets for s in ls.valid()]
    n = len(scans)
    report["pcap"]["n_frames"] = n
    report["pcap"]["n_packets"] = sum(
        len(scan_to_packets(s, info)) for s in scans[:1]) * n

    # write (re-record to a scratch pcap)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        save_scans(os.path.join(td, "bench.pcap"), src.sensor_info, sets)
        report_dur("write", time.perf_counter() - t0, n)

    # batch (re-packetize + rebatch)
    pkt_sets = [[LidarPacket(p.tobytes(), 0) for p in
                 scan_to_packets(s, info)] for s in scans]
    t0 = time.perf_counter()
    for pkts in pkt_sets:
        b = ScanBatcher(info)
        out = LidarScan(info)
        for p in pkts:
            b(p, out)
    report_dur("batch", time.perf_counter() - t0, n)

    # destagger
    t0 = time.perf_counter()
    for s in scans:
        for name in s.fields:
            f = s.field(name)
            if f.ndim >= 2 and f.shape[:2] == (s.h, s.w):
                destagger(info, f)
    report_dur("destagger", time.perf_counter() - t0, n)

    # cartesian
    t0 = time.perf_counter()
    for s in scans:
        lut(s.field(ChanField.RANGE))
    report_dur("cartesian", time.perf_counter() - t0, n)

    # device pipeline: the planar projection of the first chunk of 4
    # frames, copied to the device once (+ optional torch.profiler trace)
    if os.path.isfile(url) and url.lower().endswith(".pcap"):
        from ..io.frames import FrameReader
        from ..ops.fused import ScanPipeline
        from ..ops.planar_kernels import words_tensor
        from ..utils.profiling import device_trace

        reader = FrameReader(url, info=info)
        pipe = ScanPipeline(info, device=device)
        chunk = next(iter(reader.iter_planar_chunks(4)), None)
        if chunk is not None:
            fids, pls, hds, _ = chunk
            dp = words_tensor(pls, pipe.device)
            dh = words_tensor(hds, pipe.device)
            pipe.project_planar(dp, dh)  # warm
            _synchronize(pipe.device)
            trace_cm = device_trace(trace_dir) if trace_dir \
                else contextlib.nullcontext()
            with trace_cm:   # its start and stop stay out of the time
                t0 = time.perf_counter()
                pipe.project_planar(dp, dh)
                _synchronize(pipe.device)
                dur = time.perf_counter() - t0
            report_dur("device_xyz", dur, fids.size)
            if trace_dir:
                echo(f"torch profiler trace written to {trace_dir}")

    # ICP registration: host voxel-hash vs the Gauss-Newton loop on the
    # device around the icp_nn kernel
    from ..slam.device_icp import DeviceICP
    from ..slam.kiss_icp import KissConfig, KissICP

    lut64 = make_xyz_lut(info)
    rng0 = scans[0].field(ChanField.RANGE)
    pts = lut64(rng0)[rng0 > 0]
    for tag, make in (
            ("icp_host", KissICP),
            ("icp_device", lambda cfg: DeviceICP(cfg, device=device))):
        icp = make(KissConfig(voxel_size=1.0, min_range=1.0))
        icp.register_frame(pts, np.eye(4))   # builds the map
        icp.register_frame(pts, np.eye(4))   # warm (builds the kernels)
        t0 = time.perf_counter()
        icp.register_frame(pts, np.eye(4), update_map=False)
        report_dur(tag, time.perf_counter() - t0, 1)

    echo(json.dumps(report["times"], indent=2))
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
        name = (f"{data_md5 or 'live'}_"
                f"{platform.node() or 'host'}_{sdk_version}.json")
        out_path = os.path.join(report_dir, name)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        echo(f"report written to {out_path}")
    return report


def _synchronize(device) -> None:
    """Wait for the work queued on a CUDA device; CPU work is already
    done when its call returns."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
