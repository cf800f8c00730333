#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and the native host library (g++, the port's own
C++ copy) from the sources in this checkout, synthesizes captures with the
port's own packet and pcap writers, and drives the port's ten paths and
its host layer through the entry points a user calls. Every path stages
its packets through the native library: its call counts are read after
each path and the run fails unless each path made a capture scan and
grouper calls.

The planar path: pcap -> FrameReader.iter_planar_chunks -> ScanPipeline
(decode_planar, project_planar without and with per-column poses) ->
destagger_torch. The packet-layout path: pcap -> FrameReader.iter_chunks
-> ScanPipeline.batch (every field, XYZ, XYZ2, destaggered; without and
with poses) and unpack_project_packet_batched / unpack_project (XYZ alone,
straight from the packet words). The LUT-free path: pcap ->
FrameReader.iter_chunks -> FactorTables -> unpack_project_lutfree_dd (both
returns on the dual captures) and unpack_project_lutfree, and pcap ->
iter_planar_chunks -> unpack_project_lutfree_planar: XYZ with the
directions synthesized in the kernel from per-row and per-column factor
tables instead of a per-pixel LUT. The engine path: pcap ->
DeviceScanIterator (capture scan, admission replay, instance staging,
decode on the card, LidarScan) at batch 4 and 32, DeviceScanIndex.scan_at,
LiveDeviceBatcher.push packet by packet (scans stay deferred: a
torch.profiler trace of the pushes must show no device->host copy) and
OsfDeviceProjector.attach (XYZ through the planar kernel), every scan
held equal to the port's ScanBatcher over the same packets; its capture is
the main capture plus three frames with a lost packet, a straggler and an
open last frame. The scan-source path: open_source(pcap) -> PcapScanSource
-> the engine (one DeviceScanIterator a sensor, merged in packet order) ->
LidarScans, held equal to the same ScanBatcher with the same release
points, indexed (len and random lookups), and on a two-sensor capture
held equal to the same source on the numpy batcher
(OUSTER_SDK_TPU_DEVICE_DECODE=0), yield order included. The OSF path: the
engine capture's 35 scans, the same scans under a sensor with an extrinsic
(two LUT variants) and the two-sensor capture's collated sets are written
with the port's OSF Writer (PNG), then read back through open_source(osf)
-> OsfScanSource (mmap, host PNG decode with the native unfilter) ->
OsfDeviceProjector (planar_project, one launch a window of 4 scans and
frame) -> LidarScans with XYZ caches: iteration, random lookups and the
collated sets, every scan equal to what was written, every cache bit-equal
to the plain _proj_lean on the card and within 1 f32 ulp of the f64 LUT,
XYZLut(info)(scan) serving the cache and recomputing for a mutated RANGE;
its write and read times, the read's split (open, inflate, unfilter,
stagger, the rest of the decode, the projector) and the projector window's
split (gather, copy in, kernel, copy back, attach) are printed, and its
frames/s in turns with the policy off and with the pcap engine. The live
path: the port's SensorEmulator on loopback serves 40 frames of the main
cell, paced at 1x, 2x and 4x real time, to open_source("127.0.0.1:<port>")
-> SensorScanSource (each socket drained by one recvmmsg, a batcher thread
pushing packets into a LiveDeviceBatcher on the card) -> LidarScans,
every scan touched on the main thread and held equal (headers included) to
the ScanBatcher over the packets received; the run fails unless every
frame arrives whole with no drop at 1x. The device and numpy engines run
in turns at 2x, two sensors (1024x10 dual, 2048x10 single) run through one
source, collated, and the planar ingest (SensorPacketSource ->
PlanarStreamAssembler -> decode_planar + project_planar -> destagger)
launches planar_project once a released frame, held bit-equal to the plain
version and within 1 f32 ulp of the f64 LUT; scans/s, drops, real time x,
the effective SO_RCVBUF and the ingest's ms a frame are printed. The wire
replay path, the JAX bench's e2e_run: pcap -> FrameReader.iter_bp64_chunks
(a ray-cast room scene, BP64-coded by the native encoder) or
iter_packed_chunks (white noise, 19-bit streams) -> fused_pipelined (the
ChunkFuser packs each chunk of 8 on the staging thread) -> one pageable
copy a chunk -> unfuse_words -> project_bp64_batched /
project_packed_batched (decode in PyTorch, planar_project once a chunk)
-> a sum on the card, no readback in a pass; four cells (128x2048 dual,
32 frames; 128x1024 single, 64 frames; scene and noise), every chunk held
bit-equal to the planar path and to the plain version, one chunk with
poses bit-equal between the card and the CPU, bits/px, MB a frame,
native calls, host, copy, decode and projection ms/frame and frames/s
(best, min, median of 5 passes) printed. The multi-device path:
ScanPipeline.sharded on a mesh of the one card and of the card listed
twice, project bit-equal to project_planar (dual; with poses, the first
return), map_source over the main capture with its tail padded,
sharded_multi_sensor_step on two sensors (XYZ bit-equal to
ScanPipeline.batch, the centroid within rtol 1e-5 of a float64 sum) and
fuse_multi_sensor_clouds against the CPU. The SLAM path: a 30-frame
capture of an outdoor yard (ground, buildings, a fence, parked cars, poles;
surfaces 5-80 m away) at 128x2048 dual, every column ray-cast from the
sensor's pose at its own time while a vehicle speeds up from rest to 1 m
and 1 degree a frame, written with io/save.scan_to_packets and the pcap
writer -> open_source -> SlamEngine(SlamConfig(backend="device")) (the
Gauss-Newton loop on the card around the icp_nn kernels: the map's voxel
index built once a registration, one search an iteration) -> per-column
poses in each scan, and the host backend in turns; the device trajectory
is held to the ground truth (translation delta <= 0.05 m a frame once the
vehicle cruises) and to the host one (<= 0.05 m), a run with TF32 allowed
to the same bits, the run's search launches to its Gauss-Newton
iterations and its index builds to its registrations; scans/s of both
backends and the layers (gather, preprocess, voxelize, map copy, icp_nn
search and index, Gauss-Newton step and syncs, map update) are printed.
Then icp_nn is held bit-equal (indices and distances), with a prebuilt
index and in the one call, to its plain version at the SLAM run's largest
map, at 8192 x 524288 yard points and on dense, tied, masked, empty and
saturated inputs, its search, index build and one call timed on the
card, with torch.cdist + min timed beside it as context;
scan_normals(backend="device") against the numpy normals on yard scans;
and voxel_downsample_device against the numpy voxel_downsample. Then the
zone phase renders 16 box zones at 128x2048 with the port's zone model
and holds zone_occupancy_device on the card to the numpy zone_occupancy
over the yard's range images, and times it a scan. Last, the host layer
phase takes 8 frames of the main cell: open_source(pcap) on the engine,
then .reduce([64]), .clip([RANGE, RANGE2]) and .mask(...) held bit-equal,
StreamDigest included, to the same views over the numpy ScanBatcher;
save_scans of the card's scans to OSF, pcap, ROS1 bag, rosbag2 .db3,
MCAP, PLY, PCD, LAS, CSV and a PNG series, each file read back (OSF
through the projector, launches counted; pcap through the engine; bags
through BagScanSource; point clouds through CloudScanSource, held to the
f64 host projection the writer stored) and held to what was saved;
filter_xyz(scan, XYZLut(info), ...) on the OSF scans, without and with
dewarp, served from the XYZ cache (hits counted) and equal to the f64
host LUT, and missing the cache for RANGE once clip changed it; a custom
profile (add_custom_profile) decoded by the engine on the card bit-equal
to the ScanBatcher; ms/scan of each view, writer and reader and MB/scan
of each writer printed. Then the command line and the pose optimizer,
through ouster_sdk_tpu_torch.cli.util (no click):
run_benchmark over 10 frames of the main capture (read, write, batch,
destagger, cartesian, the planar projection on the card and host against
device ICP, which must launch planar_project and icp_nn and agree within
0.05 m), system_info(devices=True) naming the card, and
optimize_osf_trajectory over the SLAM run's 30 scans saved to an OSF with
the device backend's poses (an ABSOLUTE_POSE at the last scan from the
ground truth: every scan written, each corrected rigidly, the last closer
to the truth, the OSF projector's launches counted); and, since the card's
machine has click, `python3 -m ouster_sdk_tpu_torch source <yard> slice
:12 slam --backend device save <osf>` and `util benchmark --frames 4
<main capture>` in processes of their own. Last, the viewer (host code
over the card's scans): SimpleViz snapshots of 8 frames of the main cell
at 1024x768 through `source <pcap> slice :8 viz --out` (click's runner in
this process, the engine on the card), over the numpy ScanBatcher and over
an OSF of the same frames (the projector on the card), byte-equal across
the three, with ms a snapshot, the device syncs each snapshot made on the
viewer's thread and each route's planar_project launches checked; the
same over OpenGL where the host has a surfaceless EGL (else the reason is
printed); `pose_optimize --viz-snapshot` (PNG pair and .html) over 8 SLAM
scans, projector on and off; `ply_to_png` and `source <ply> model_viz`
on a PLY of yard scans read by the engine and by the batcher; and the
examples package (pcap_3d_one_scan, pcap_to_ply, pcap_to_csv,
colormap_strip, zone_states_example, osf_read_scans, viz_scene,
viz_image_events) over the card's sources, held byte-equal to the
batcher's, the OSF XYZ within 1 f32 ulp of the f64 host LUT.

The main cell is an OS-2-128 in 2048x10 mode with the dual-return
profile RNG19_RFL8_SIG16_NIR16_DUAL, 32 frames in kernel batches of 32;
a single-return capture, an odd-words dual capture (128x1024, to save
time) and, for the packet-layout path, a capture of a sensor with
per-pixel angle tables (128x512) drive the other kernel cases through the
same entry points; that last sensor does not factorize, so the LUT-free
path refuses it (checked) and it runs through the packet-layout kernel.

Then it holds every kernel case against the plain PyTorch version on the
same inputs on the card (bit-exact, the planar dewarp cases too: the plain
version's fused multiply-add is correctly rounded) and against the f64
host LUT (<= 1 f32 ulp), traces one wrapper call with poses under
torch.profiler and fails unless the planar kernel is all that ran on the
device, holds the packet-layout kernel against the
planar kernel on the same frames (bit-exact), the planar LUT-free kernel
against the packet-layout one (bit-exact), counts the elements in which
the LUT-free kernels differ from the LUT kernels (both are within 1 f32
ulp of f64, neither is the other's bits), checks that each path's run
launched every case of its kernel and no kernel of another family, and
times kernel, plain version and host staging at B=32 and B=128. No single
PyTorch call computes a double-single projection, so `library_ms` is null
in every entry. The engine path's stage times, its frames/s from pcap
to LidarScan, the live path's time a push and a flush and the projector's
time a window are printed on lines of their own, and so are the host
staging stages with the native library beside the numpy versions it
replaces (io/frames.py keeps them: the route on a host without g++) on the
same bytes, held byte-equal, and the frames/s of the six paths.

Prints the card's name and power limit, a `kernels` JSON line of thirteen
entries (the last, icp_nn, replaces an XLA-fused search that has no Pallas
kernel; its entry adds the index build's time, bound and launches), and
last
a JSON object with "ok". Exits non-zero, with no result, when CUDA is
unavailable or any phase fails.
"""

from __future__ import annotations

import json
import os
from contextlib import nullcontext
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_PROFILE = "RNG19_RFL8_SIG16_NIR16_DUAL"
SINGLE_PROFILE = "RNG19_RFL8_SIG16_NIR16"
SPLIT_PROFILE = "RNG19_RFL8_SIG16_NIR16_RGB16_DUAL"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# that figure counts a fused multiply-add as two operations; a chain of
# error-free transforms has none, so it runs at half of that rate
PEAK_F32_NO_FMA_PER_S = PEAK_F32_PER_S / 2
KERNEL_SOURCE = "ouster_sdk_tpu_torch/kernels/csrc/planar_project.cu"
PACKET_SOURCE = "ouster_sdk_tpu_torch/kernels/csrc/packet_project.cu"
LUTFREE_SOURCE = "ouster_sdk_tpu_torch/kernels/csrc/lutfree_project.cu"
DF_PROFILE = SINGLE_PROFILE   # the capture with per-pixel angle tables
PALLAS = "ouster_sdk_tpu/ops/pallas_kernels.py"
PALLAS_LUTFREE = "ouster_sdk_tpu/ops/pallas_lutfree.py"
REPLACES = {
    "planar": f"{PALLAS}:289",
    "planar_dual": f"{PALLAS}:346",
    "planar_dual_split": f"{PALLAS}:361",
    "planar_dewarp": f"{PALLAS}:296",
    "planar_dual_dewarp": f"{PALLAS}:308",
    "planar_dual_split_dewarp": f"{PALLAS}:327",
    "packet": f"{PALLAS}:92",
    "packet_dual": f"{PALLAS}:102",
    "lutfree": f"{PALLAS_LUTFREE}:231",
    "lutfree_dd": f"{PALLAS_LUTFREE}:328",
    "lutfree_dd_dual": f"{PALLAS_LUTFREE}:346",
    "lutfree_dd_planar": f"{PALLAS_LUTFREE}:453",
}


CARD = ""    # the card's name and power limit, as nvidia-smi gives them
FPS = {}     # frames/s end to end of each path's main cell, cold


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def native_staged(what: str, scans: int, **groupers: int) -> None:
    """Fail unless the path just run staged through the native library:
    `scans` capture scans and at least the given count of calls of each
    grouper since the counts were last reset."""
    from ouster_sdk_tpu_torch.utils import native

    calls = dict(native.calls)
    check(calls["pcap_scan"] == scans
          and all(calls[g] >= n for g, n in groupers.items()),
          f"{what}: native calls {calls}, expected {scans} capture scans "
          f"and at least {groupers}")
    print(f"{what}: native staging calls {calls}")


class numpy_staging:
    """Inside the block the staging takes the numpy route, as on a host
    without g++: native.get_lib reads None."""

    def __enter__(self):
        from ouster_sdk_tpu_torch.utils import native

        self.native, self.get_lib = native, native.get_lib
        native.get_lib = lambda: None
        return self

    def __exit__(self, *exc):
        self.native.get_lib = self.get_lib


# -- synthetic sensors and captures (numpy + the port's writers) ------------

def synth_info(profile: str, w: int = 2048, h: int = 128):
    """A synthetic sensor: the default OS-1 metadata with a (h, w) frame,
    16 columns per packet, a 4-row stagger and evenly spread beams."""
    from ouster_sdk_tpu_torch.core.metadata import default_sensor_info
    from ouster_sdk_tpu_torch.core.types import (DataFormat, LidarMode,
                                                 UDPProfileLidar)

    info = default_sensor_info(LidarMode(1024, 10))
    info.format = DataFormat(
        pixels_per_column=h, columns_per_packet=16, columns_per_frame=w,
        pixel_shift_by_row=[int(x) for x in np.tile([12, 8, 4, 0], h // 4)],
        column_window=(0, w - 1),
        udp_profile_lidar=UDPProfileLidar(profile), fps=10)
    info.config.lidar_mode = LidarMode(w, 10)
    info.beam_azimuth_angles = list(np.tile([3.164, 1.055, -1.055, -3.164],
                                            h // 4))
    info.beam_altitude_angles = list(np.linspace(22.5, -22.5, h))
    return info


def synth_df_info(profile: str, w: int = 512, h: int = 128, seed: int = 9):
    """synth_info with per-pixel (w * h) azimuth and altitude tables made
    from a seed, as a sensor without a spinning encoder carries them: its
    LUT does not factorize into per-row and per-column tables."""
    info = synth_info(profile, w=w, h=h)
    rng = np.random.default_rng(seed)
    info.beam_azimuth_angles = list(rng.uniform(-60.0, 60.0, h * w))
    info.beam_altitude_angles = list(rng.uniform(-35.0, 35.0, h * w))
    return info


def synth_packets(info, fids, seed: int = 1, ts0: int = 10**9):
    """Lidar packets of the frames `fids` as (payload bytes, host_ts):
    random ranges (about 5% zero), RANGE2 = RANGE // 2 where the profile
    has it, random SIGNAL/REFLECTIVITY/NEAR_IR, and about 3% of columns
    with their status bit cleared. Frames are 100 ms apart from ts0."""
    from ouster_sdk_tpu_torch.ops.packet_format import PacketWriter

    pw = PacketWriter(info.format)
    fields = set(pw.fields)
    cpp, h = pw.columns_per_packet, pw.pixels_per_column
    n_pkts = info.format.columns_per_frame // cpp
    rng = np.random.default_rng(seed)
    ts = ts0
    for fid in fids:
        for p in range(n_pkts):
            buf = pw.new_packet()
            pw.set_packet_header(buf, init_id=info.init_id,
                                 prod_sn=info.sn)
            pw.set_frame_id(buf, fid)
            m0 = p * cpp
            status = (rng.random(cpp) >= 0.03).astype(np.uint32)
            pw.set_col_headers(
                buf, np.arange(cpp, dtype=np.uint64) + m0 * 1000 + ts,
                np.arange(cpp, dtype=np.uint16) + m0, status)
            r = rng.integers(1, 1 << 19, size=(h, cpp))
            r[rng.random((h, cpp)) < 0.05] = 0
            pw.set_field(buf, "RANGE", r)
            if "RANGE2" in fields:
                pw.set_field(buf, "RANGE2", r // 2)
            for name, bits in (("SIGNAL", 16), ("REFLECTIVITY", 8),
                               ("NEAR_IR", 16)):
                if name in fields:
                    pw.set_field(buf, name,
                                 rng.integers(0, 1 << bits, (h, cpp)))
            yield bytes(buf), ts + p * 1000
        ts += 100_000_000


def write_capture(path: str, packets) -> None:
    """Write (payload, host_ts) lidar packets as a fragmented-Ethernet
    pcap, to port 7502."""
    from ouster_sdk_tpu_torch.io.pcap import PcapWriter

    with PcapWriter(path) as writer:
        for payload, ts in packets:
            writer.write(payload, "10.0.0.2", "10.0.0.1", 7502, 7502, ts)


def synth_capture(path: str, info, n_frames: int, seed: int = 1) -> None:
    """Write n_frames lidar frames (ids 1..n_frames) of synth_packets."""
    write_capture(path, synth_packets(info, range(1, n_frames + 1), seed))


def engine_capture(path: str, main_path: str, info, n_main: int) -> int:
    """The main capture followed by three more frames with faults: frame
    n_main + 1 loses a packet, that packet arrives as a straggler while
    frame n_main + 2 builds (the batcher drops it), and frame n_main + 3
    stops after 5/16 of its packets (40 of 128) and stays open at the end
    of the capture.
    The first n_main frames are the main capture's bytes. Returns the
    number of scans the capture holds."""
    n = info.format.columns_per_frame // info.format.columns_per_packet
    extra = list(synth_packets(info, range(n_main + 1, n_main + 4), seed=7,
                               ts0=10**9 + n_main * 100_000_000))
    f1, f2, f3 = (extra[:n], extra[n:2 * n],
                  extra[2 * n:2 * n + n * 5 // 16])
    lost = f1.pop(5)
    f2.insert(3, (lost[0], f2[2][1] + 500_000))
    tail = path + ".tail"
    write_capture(tail, f1 + f2 + f3)
    with open(path, "wb") as out:
        for part, skip in ((main_path, 0), (tail, 24)):  # one file header
            with open(part, "rb") as f:
                out.write(f.read()[skip:])
    os.remove(tail)
    return n_main + 3


def capture_packets(port, info, path: str):
    """[(datagram index, LidarPacket)] of the sensor's lidar stream in
    capture order, classified packet by packet: by size, and by the
    configured port where the metadata names one."""
    size = port.PacketFormat.from_info(info).lidar_packet_size
    want = info.config.udp_port_lidar or 0
    out = []
    with port.PcapReader(path) as reader:
        for k, (pi, payload) in enumerate(reader):
            if len(payload) == size and want in (0, pi.dst_port):
                out.append((k, port.LidarPacket(bytes(payload),
                                                pi.timestamp)))
    return out


EOF_RELEASE = 1 << 62


def batcher_scans(port, info, packets, trailing_flush: bool = True):
    """[(released_at, LidarScan)] as the port's ScanBatcher releases them,
    packet by packet; the scan left open at the end is emitted when it
    has a valid column (the scan sources' trailing flush)."""
    batcher, cur, out = port.ScanBatcher(info), port.LidarScan(info), []
    for k, pkt in packets:
        if batcher(pkt, cur):
            out.append((k, cur))
            cur = port.LidarScan(info)
    if trailing_flush and cur.frame_id != -1 and np.any(cur.status & 1):
        out.append((EOF_RELEASE, cur))
    return out


def scans_differ(a, b) -> int:
    """Count of differing elements between two LidarScans over every
    field and header array; a missing field, or another dtype or shape,
    or another scalar header fails the run."""
    check(sorted(a.fields) == sorted(b.fields),
          f"fields {sorted(a.fields)} != {sorted(b.fields)}")
    n = 0
    pairs = [(name, a.field(name), b.field(name)) for name in b.fields]
    pairs += [(attr, getattr(a, attr), getattr(b, attr))
              for attr in ("timestamp", "measurement_id", "status",
                           "packet_timestamp", "alert_flags", "pose")]
    for name, x, y in pairs:
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"{name}: {x.dtype}{x.shape} != {y.dtype}{y.shape}")
        n += int((x != y).sum())
    for attr in ("frame_id", "frame_status", "shutdown_countdown",
                 "shot_limiting_countdown"):
        check(getattr(a, attr) == getattr(b, attr),
              f"{attr}: {getattr(a, attr)} != {getattr(b, attr)}")
    return n


def hold_scans(got, want, what: str) -> None:
    """[(released_at, scan)] against the oracle's: same release points in
    order, 0 differing elements, and equal by `==`."""
    check([(r, s.frame_id) for r, s in got]
          == [(r, s.frame_id) for r, s in want],
          f"{what}: released {[(r, s.frame_id) for r, s in got]}, the "
          f"batcher {[(r, s.frame_id) for r, s in want]}")
    check([r for r, _ in got] == sorted(r for r, _ in got),
          f"{what}: released_at out of order")
    n = sum(scans_differ(a, b) for (_, a), (_, b) in zip(got, want))
    check(n == 0 and all(a == b for (_, a), (_, b) in zip(got, want)),
          f"{what}: {n} elements differ from the ScanBatcher's scans")
    print(f"{what}: {len(got)} scans, {n} elements differ from the port's "
          f"ScanBatcher in every field and header, released_at equal")


def random_poses(B: int, w: int, seed: int) -> np.ndarray:
    """(B, w, 4, 4) float32 SE(3) poses: random rotations (Rodrigues) and
    translations of a few meters."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (B, w, 3))
    theta = np.linalg.norm(v, axis=-1)[..., None, None]
    k = v / np.linalg.norm(v, axis=-1, keepdims=True)
    K = np.zeros((B, w, 3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    T = np.zeros((B, w, 4, 4))
    T[..., :3, :3] = (np.eye(3) + np.sin(theta) * K
                      + (1 - np.cos(theta)) * (K @ K))
    T[..., :3, 3] = rng.normal(0, 3, (B, w, 3))
    T[..., 3, 3] = 1
    return T.astype(np.float32)


# -- measurement helpers ----------------------------------------------------

def cuda_ms(fn, iters: int = 50, windows: int = 7, warm: int = 5):
    """Median, min and max over `windows` CUDA-event windows of `iters`
    back-to-back calls, in ms per call. A call whose host-side issue takes
    longer than its device work is timed at its issue rate."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), min(times), max(times)


def device_ms(fn, iters: int = 20, windows: int = 5, warm: int = 3):
    """Median, min and max over `windows` of the device time of `iters`
    back-to-back calls, in ms per call, with the host's issue taken out: a
    spin kernel (torch.cuda._sleep) holds the stream while the host issues
    the calls, so the card runs them without a gap. Each window checks that
    the issue ended before the spin did, and doubles the spin if not."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22                          # ~2 ms at the card's clock
    times = []
    while len(times) < windows:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event(enable_timing=True)
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        torch.cuda._sleep(cycles)
        spun.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issue_ms >= 0.8 * first.elapsed_time(spun):
            cycles *= 2                       # the card waited on the host
            if cycles > 1 << 34:
                raise RuntimeError("device_ms: the host never got ahead")
            continue
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), min(times), max(times)


def host_issue_ms(fn, iters: int = 50, windows: int = 5) -> float:
    """Host time to issue one call, without waiting for the device: the
    least of `windows` windows of `iters` calls (the host's cores are
    shared, so the least is the call's own cost)."""
    import torch

    best = float("inf")
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize()
    return best


def copy_bandwidth() -> float:
    """Device-to-device copy rate of this card, bytes/s (read + write)."""
    import torch

    src = torch.empty(256 << 20, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), iters=20, windows=3)[0]
    return 2 * src.numel() * 4 / (ms * 1e-3)


def ulp_check(xyz: np.ndarray, ref: np.ndarray):
    """Worst error in units of the f32 ulp of the f64 value (floor 1e-7 m,
    as the reference's own parity gate)."""
    ulp = np.maximum(np.spacing(np.abs(ref).astype(np.float32))
                     .astype(np.float64), 1e-7)
    return float((np.abs(xyz.astype(np.float64) - ref) / ulp).max())


def f64_reference(lut64, r: np.ndarray) -> np.ndarray:
    """(B, h, w) integer ranges -> (B, 3, h, w) f64 XYZ."""
    return np.moveaxis(lut64(r), -1, 1)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(got, want, what: str):
    """Hold the wrapper's output against the plain version's, bit for bit
    (projection and dewarp alike: both sides round once an operation, the
    dewarp once a fused multiply-add). Returns max |d|, the count of
    differing elements and the worst difference in f32 ulp of the point
    norm."""
    max_err, n_diff, worst = 0.0, 0, 0.0
    for g, p in zip(as_tuple(got), as_tuple(want)):
        g, p = g.cpu().numpy(), p.cpu().numpy()
        check(g.shape == p.shape, f"{what}: shape {g.shape} != {p.shape}")
        max_err = max(max_err, float(np.abs(g - p).max()))
        n_diff += int((g.view(np.int32) != p.view(np.int32)).sum())
        norm = np.linalg.norm(p.astype(np.float64), axis=1, keepdims=True)
        ulp = np.maximum(np.spacing(norm.astype(np.float32)), 1e-30)
        worst = max(worst, float(
            (np.abs(g.astype(np.float64) - p) / ulp).max()))
    check(n_diff == 0, f"{what}: {n_diff} elements differ from the plain "
          f"version (max |d| {max_err:.3g} m, {worst:.3f} ulp of the point "
          f"norm)")
    return max_err, n_diff, worst


def range_ints(planes, hdrs, plan, names) -> list:
    """Each named range field as (B, h, w) int64, zeroed where the column's
    status bit is clear (numpy, from the int32 word tensors)."""
    by_name = {f.name: f for f in plan.fields}
    st = hdrs[:, plan.staged_status_word].cpu().numpy().view(np.uint32)
    valid = ((st >> np.uint32(plan.status_bit)) & 1) != 0
    out = []
    for name in names:
        f = by_name[name]
        w = planes[:, f.word].cpu().numpy().view(np.uint32).astype(np.int64)
        r = ((w >> f.bit) & ((1 << f.size) - 1)) << f.upshift
        out.append(np.where(valid[:, None, :], r, 0))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import ouster_sdk_tpu_torch as port
    from ouster_sdk_tpu_torch.kernels import build
    from ouster_sdk_tpu_torch.ops import planar_kernels as pk

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    global CARD
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # 2. build: the kernels (one nvcc a source) and the native host library
    # (g++), all at once
    from concurrent.futures import ThreadPoolExecutor

    from ouster_sdk_tpu_torch.utils import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        lib = pool.submit(native.get_lib)
        build.build_all()
        lib = lib.result()
    build_s = time.perf_counter() - t0
    check(lib is not None, "the native host library did not load (no g++)")
    print(f"kernels and native library built in {build_s:.1f} s")
    for src, (log, secs) in build.build_log.items():
        print(f"  {src}: nvcc {secs:.1f} s\n"
              + "\n".join("    " + ln for ln in log.strip().splitlines()
                          if "registers" in ln or "spill" in ln))
    print(f"  {os.path.relpath(native.SOURCE, HERE)}: g++ "
          + ("loaded from disk" if native.build_seconds is None
             else f"{native.build_seconds:.1f} s")
          + f" -> {os.path.relpath(native.lib_path(), HERE)}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _run(torch, port, pk, dev, tmp)
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)


def _run(torch, port, pk, dev, tmp) -> int:
    # 3. captures
    cells = [  # (profile, w, frames, chunk)
        (MAIN_PROFILE, 2048, 32, 32),
        (SINGLE_PROFILE, 2048, 4, 4),
        (SPLIT_PROFILE, 1024, 4, 4),
    ]
    captures = {}
    for profile, w, n, _ in cells:
        t0 = time.perf_counter()
        info = synth_info(profile, w=w)
        path = os.path.join(tmp, f"{profile}_{w}.pcap")
        synth_capture(path, info, n)
        captures[profile] = (info, path)
        print(f"synthesized {profile} 128x{w} x{n} frames "
              f"({os.path.getsize(path) / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s")

    # 4. the main path, through the entry points, counts from zero
    from ouster_sdk_tpu_torch.utils import native

    pk.reset_launches()
    native.reset_calls()
    staged = {}
    t_main = time.perf_counter()
    for profile, w, n, chunk in cells:
        info, path = captures[profile]
        pipe = port.ScanPipeline(info)
        check(pipe.device.type == "cuda", "ScanPipeline did not pick cuda")
        t0 = time.perf_counter()
        chunks = list(port.FrameReader(path, info).iter_planar_chunks(chunk))
        stage_s = time.perf_counter() - t0
        check(sum(c[0].size for c in chunks) == n,
              f"{profile}: staged {sum(c[0].size for c in chunks)} of {n}")
        runs = []
        for fids, planes, hdrs, _ in chunks:
            B = fids.size
            fields = pipe.decode_planar(planes, hdrs)
            out = pipe.project_planar(planes, hdrs)
            poses = torch.from_numpy(random_poses(B, w, seed=3)).to(dev)
            outw = pipe.project_planar(planes, hdrs, poses=poses)
            xyz = out[0] if pipe.dual else out
            xyz_d = port.destagger_torch(xyz, pipe.shifts)
            rng_d = port.destagger_torch(fields["RANGE"], pipe.shifts)
            runs.append((fids, planes, hdrs, fields, out, outw, poses))
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        print(f"{profile} 128x{w}: {n} frames pcap -> XYZ (staging, decode, "
              f"project without and with poses, destagger) in {e2e_s:.3f} s"
              f" = {n / e2e_s:.2f} frames/s")
        FPS.setdefault("planar", n / e2e_s)
        staged[profile] = (info, pipe, runs, stage_s)
        check(xyz_d.shape == (B, 3, 128, w) and rng_d.shape == (B, 128, w),
              f"{profile}: destagger shapes {xyz_d.shape} {rng_d.shape}")
    main_s = time.perf_counter() - t_main
    native_staged("planar path", len(cells), group_frames_planar=len(cells))
    launches = dict(pk.launches)
    print(f"main path (stage + decode + project x2 + destagger, 3 captures)"
          f" in {main_s:.2f} s; launches {launches}")
    for case in pk.CASES:
        check(launches[case] > 0, f"main path never launched {case}")

    # the main path's XYZ, every capture and chunk, against the plain
    # version on the same device tensors
    for profile, (info, pipe, runs, _) in staged.items():
        for fids, planes, hdrs, _, out, outw, poses in runs:
            planes_d = pk.words_tensor(planes, dev)
            hdrs_d = pk.words_tensor(hdrs, dev)
            lut = pipe.planar_lut.stack
            for p, got, dewarp in ((None, out, False), (poses, outw, True)):
                want = pk.unpack_project_planar_batched_plain(
                    planes_d, hdrs_d, lut, pipe.plan, dual=pipe.dual,
                    poses=p)
                err, n_diff, worst = compare(
                    got, want, f"main path {profile}"
                    f"{' with poses' if dewarp else ''}")
                print(f"main path {profile} frames {fids[0]}-{fids[-1]}"
                      f"{' with poses' if dewarp else ''}: {n_diff} elements"
                      f" differ from plain, max |d| {err:.3g} m, worst "
                      f"{worst:.3f} ulp of the point norm")

    # outputs of the main cell are right: decode vs the written values,
    # XYZ finite, zero where the range is zero, within 1 ulp of f64
    info, pipe, runs, stage_s = staged[MAIN_PROFILE]
    fids, planes, hdrs, fields, out, outw, poses = runs[0]
    check(list(fids) == list(range(1, 33)), f"frame ids {list(fids)}")
    rng1 = fields["RANGE"].cpu().numpy().astype(np.int64)
    rng2 = fields["RANGE2"].cpu().numpy().astype(np.int64)
    check(((rng2 == rng1 // 2)).all(), "decoded RANGE2 != RANGE // 2")
    status = fields["status"].cpu().numpy()
    check(0 < (status == 0).sum() < status.size, "no cleared columns")
    check((rng1[np.broadcast_to((status == 0)[:, None], rng1.shape)] == 0)
          .all(), "invalid columns not zeroed")
    lut64 = port.make_xyz_lut(info)
    for k, r in ((0, rng1), (1, rng2)):
        x = out[k].cpu().numpy()
        xw = outw[k].cpu().numpy()
        check(np.isfinite(x).all() and np.isfinite(xw).all(),
              "non-finite XYZ")
        zero = np.broadcast_to((r == 0)[:, None], x.shape)
        check((x[zero] == 0).all() and (xw[zero] == 0).all(),
              "zero range not at the origin")
        worst = ulp_check(x[:4], f64_reference(lut64, r[:4]))
        check(worst <= 1.0, f"main cell XYZ {worst} ulp from f64")
        print(f"main cell return {k + 1}: XYZ within {worst:.3f} f32 ulp "
              f"of the f64 LUT (4 frames)")

    # 5. each kernel case, through the wrapper, against the plain version
    results = {}
    bw = copy_bandwidth()
    print(f"device copy bandwidth {bw / 1e9:.1f} GB/s (read + write)")
    case_inputs = {}
    for profile in (SINGLE_PROFILE, MAIN_PROFILE, SPLIT_PROFILE):
        info, pipe, runs, _ = staged[profile]
        planes = np.concatenate([r[1] for r in runs])
        hdrs = np.concatenate([r[2] for r in runs])
        case_inputs[profile] = (pipe, pk.words_tensor(planes, dev),
                                pk.words_tensor(hdrs, dev))

    def run_case(profile, dewarp, B):
        """The wrapper and the plain version on the same B-frame inputs."""
        pipe, planes, hdrs = case_inputs[profile]
        reps = -(-B // planes.shape[0])
        planes = planes.repeat(reps, 1, 1, 1)[:B].contiguous()
        hdrs = hdrs.repeat(reps, 1, 1)[:B].contiguous()
        poses = (torch.from_numpy(random_poses(B, pipe.plan.w, seed=5))
                 .to(dev) if dewarp else None)
        lut = pipe.planar_lut.stack

        def kernel():
            return pk.unpack_project_planar_batched(
                planes, hdrs, lut, pipe.plan, dual=pipe.dual, poses=poses)

        def plain_fn():
            return pk.unpack_project_planar_batched_plain(
                planes, hdrs, lut, pipe.plan, dual=pipe.dual, poses=poses)

        return kernel, plain_fn, (planes, hdrs, pipe)

    case_profile = {"planar": SINGLE_PROFILE, "planar_dual": MAIN_PROFILE,
                    "planar_dual_split": SPLIT_PROFILE}
    for case in pk.CASES:
        dewarp = case.endswith("_dewarp")
        profile = case_profile[case.replace("_dewarp", "")]
        kernel, plain_fn, (planes, hdrs, pipe) = run_case(profile, dewarp, 32)
        pk.reset_launches()
        got = kernel()
        check(pk.launches[case] == 1 and sum(pk.launches.values()) == 1,
              f"{case}: the wrapper launched {dict(pk.launches)}")
        want = plain_fn()
        max_err, n_diff, worst_ulp = compare(got, want, case)
        names = ("RANGE", "RANGE2")[:len(as_tuple(got))]
        rs = range_ints(planes, hdrs, pipe.plan, names)
        if not dewarp:
            lut64 = port.make_xyz_lut(pipe.info)
            for g, r in zip(as_tuple(got), rs):
                worst = ulp_check(g[:2].cpu().numpy(),
                                  f64_reference(lut64, r[:2]))
                check(worst <= 1.0, f"{case}: {worst} ulp from f64")
        tol = ("bit-exact vs plain" if dewarp else
               "bit-exact vs plain; <= 1 f32 ulp vs f64 LUT")
        print(f"{case}: {n_diff} elements differ from plain, max |d| "
              f"{max_err:.3g} m ({tol}); worst {worst_ulp:.3f} ulp")
        results[case] = dict(max_abs_err=max_err, n_diff=n_diff,
                             nonzero=sum(int((r != 0).sum()) for r in rs),
                             profile=profile, dewarp=dewarp, plan=pipe.plan,
                             n_ret=len(rs))

    # 6. what one warm wrapper call puts on the device (torch.profiler):
    # with float32 contiguous poses, the planar kernel and nothing else
    from ouster_sdk_tpu_torch.kernels.bench_planar import kernel_profile

    def device_events(what, fn):
        for _ in range(5):      # the profiler at times returns no record
            rows = kernel_profile(fn)
            if rows:
                break
        for name, count, us in rows:
            print(f"profile {what}: {count} x {name[:96]} {us:.1f} us")
        return rows

    for dewarp in (True, False):
        what = (f"wrapper call {'with' if dewarp else 'without'} poses "
                f"({MAIN_PROFILE}, B=32)")
        rows = device_events(what, run_case(MAIN_PROFILE, dewarp, 32)[0])
        check(len(rows) == 1 and rows[0][1] == 1
              and "planar_project" in rows[0][0],
              f"{what} ran {[(n[:60], c) for n, c, _ in rows]} on the "
              f"device, not the planar kernel alone")
    # for the record: the packing into (B, 12, w) planes that the wrapper
    # ran in front of the kernel before the kernel read (B, w, 4, 4) itself
    # (the plain version still packs)
    poses32 = torch.from_numpy(
        random_poses(32, case_inputs[MAIN_PROFILE][0].plan.w, seed=5)).to(dev)
    rows = device_events("packing poses into planes, plain version only",
                         lambda: pk._pose_planes(poses32).contiguous())
    print(f"profile packing: {sum(c for _, c, _ in rows)} launches, "
          f"{sum(us for _, _, us in rows):.1f} us a call, no longer part of "
          f"the wrapper call")

    # 7. timings at B=32 and B=128, of the wrapper call
    def bytes_ops(res, B, nonzero_per_frame):
        plan = res["plan"]
        hw = plan.h * plan.w
        n_ret = res["n_ret"]
        nbytes = (n_ret * B * hw * 4          # range words
                  + B * plan.w * 4            # status words
                  + 18 * hw * 4               # LUT stack
                  + n_ret * B * 3 * hw * 4)   # XYZ out
        if res["dewarp"]:
            nbytes += B * plan.w * 16 * 4
        # nonzero ranges take the double-single chain (60 flops) and the
        # dewarp (9 fma = 18 flops); zero ranges short-circuit
        flops = nonzero_per_frame * B * (60 + (18 if res["dewarp"] else 0))
        return nbytes, flops

    timings = {}
    for case in pk.CASES:
        res = results[case]
        per_frame = res["nonzero"] / 32
        for B in (32, 128):
            kernel, plain_fn, _ = run_case(res["profile"], res["dewarp"], B)
            ms, lo, hi = cuda_ms(kernel)
            issue = host_issue_ms(kernel)
            plain_ms = cuda_ms(plain_fn, iters=3, windows=3, warm=1)[0]
            nbytes, flops = bytes_ops(res, B, per_frame)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_PER_S * 1e3
            timings[(case, B)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_copy_ms=nbytes / bw * 1e3, mbytes=nbytes / 1e6)
            t = timings[(case, B)]
            print(f"time {case} B={B}: wrapper {ms:.4f} ms (median of 7 x "
                  f"50 calls; min {lo:.4f}, max {hi:.4f}; host issue "
                  f"{issue:.4f} ms/call), plain {plain_ms:.3f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{t['mbytes']:.1f} MB; at the measured copy rate "
                  f"{t['bound_copy_ms']:.4f} ms), "
                  f"{B * 128 * res['plan'].w / ms / 1e6:.1f} Gpx/s")

    # where the time goes in the main cell, per stage, warm, B=32
    info, pipe, runs, stage_s = staged[MAIN_PROFILE]
    _, planes_np, hdrs_np, *_ = runs[0]
    n = planes_np.shape[0]
    print(f"host staging {MAIN_PROFILE} 128x{pipe.plan.w}: "
          f"{stage_s / n * 1e3:.2f} ms/frame (pcap read + reassembly "
          f"+ planar scatter, {n} frames)")
    planes_d = pk.words_tensor(planes_np, dev)
    hdrs_d = pk.words_tensor(hdrs_np, dev)
    poses_d = torch.from_numpy(random_poses(n, pipe.plan.w, seed=3)).to(dev)
    xyz_pair = pipe.project_planar(planes_d, hdrs_d)
    stages = {
        "host->device copy (planes + col_hdrs)": lambda: (
            pk.words_tensor(planes_np, dev), pk.words_tensor(hdrs_np, dev)),
        "decode_planar (plain PyTorch)": lambda: pipe.decode_planar(
            planes_d, hdrs_d),
        "project_planar (kernel)": lambda: pipe.project_planar(
            planes_d, hdrs_d),
        "project_planar with poses (kernel)": lambda: pipe.project_planar(
            planes_d, hdrs_d, poses=poses_d),
        "destagger_torch (both returns' XYZ)": lambda: [
            port.destagger_torch(x, pipe.shifts) for x in xyz_pair],
    }
    for name, fn in stages.items():
        ms = cuda_ms(fn, iters=10, windows=3, warm=2)[0]
        print(f"stage {name} B={n}: {ms / n:.4f} ms/frame")

    kernels = []
    for case in pk.CASES:
        t = timings[(case, 32)]
        kernels.append({
            "name": f"planar_project<{case}>", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[case],
            "launches": launches[case],
            "max_abs_err": results[case]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    entries, packet_runs = _run_packet(torch, port, pk, dev, tmp, captures,
                                       staged, bw)
    kernels += entries
    kernels += _run_lutfree(torch, port, pk, dev, captures, staged,
                            packet_runs, bw)
    engine_launches, oracle = _run_engine(torch, port, pk, dev, tmp,
                                          captures, staged)
    # row 1's kernel also serves the engine path's projector
    kernels[0]["launches"] += engine_launches
    print(f"planar_project<planar>: {launches['planar']} launches on the "
          f"planar path + {engine_launches} on the engine path")
    two_sensor = _run_sources(torch, port, tmp, captures[MAIN_PROFILE][0],
                              oracle)
    osf_launches = _run_osf(torch, port, pk, dev, tmp,
                            captures[MAIN_PROFILE][0], oracle, two_sensor)
    kernels[0]["launches"] += osf_launches
    print(f"planar_project<planar>: {osf_launches} more launches on the OSF "
          f"path; {kernels[0]['launches']} in all")
    for case, n in _run_live(torch, port, pk, dev,
                             captures[MAIN_PROFILE][0]).items():
        entry = kernels[pk.CASES.index(case)]
        entry["launches"] += n
        print(f"planar_project<{case}>: {n} more launches on the live "
              f"planar ingest; {entry['launches']} in all")
    for phase, run in (
            ("wire replay", lambda: _run_wire(torch, port, pk, dev, tmp,
                                              *captures[MAIN_PROFILE])),
            ("multi-device", lambda: _run_multi(
                torch, port, pk, dev, *captures[MAIN_PROFILE],
                staged[MAIN_PROFILE][2]))):
        t0 = time.perf_counter()
        launched = run()
        print(f"{phase} phase: {time.perf_counter() - t0:.1f} s")
        for case, n in launched.items():
            entry = kernels[pk.CASES.index(case)]
            entry["launches"] += n
            print(f"planar_project<{case}>: {n} more launches on the "
                  f"{phase} path; {entry['launches']} in all")
    t0 = time.perf_counter()
    slam = _run_slam(torch, port, dev, tmp)
    kernels.append(_run_icp_nn(torch, port, dev, slam))
    _run_normals(torch, port, dev, slam["info"], slam["scans"])
    _run_downsample(torch, port, dev, slam["info"], slam["scans"])
    print(f"slam, icp nn, normals and voxel downsample phases: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _run_zone(torch, port, dev, slam["info"], slam["scans"])
    print(f"zone phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pk.reset_launches()
    host_launches = _run_host_layer(torch, port, pk, dev, tmp,
                                    captures[MAIN_PROFILE][0])
    kernels[0]["launches"] += host_launches
    print(f"host layer phase: {time.perf_counter() - t0:.1f} s; "
          f"planar_project<planar>: {host_launches} more launches (the OSF "
          f"projector); {kernels[0]['launches']} in all")
    t0 = time.perf_counter()
    made = _run_cli(torch, port, pk, dev, tmp, *captures[MAIN_PROFILE], slam)
    for case in pk.CASES:
        kernels[pk.CASES.index(case)]["launches"] += made.get(case, 0)
    kernels[-1]["launches"] += made["icp_nn"]
    kernels[-1]["index_launches"] += made["icp_nn_index"]
    print(f"cli and pose optimizer phase: {time.perf_counter() - t0:.1f} s; "
          f"more launches: planar_project<planar> {made['planar']}, "
          f"<planar_dual> {made['planar_dual']}, icp_nn {made['icp_nn']}")
    t0 = time.perf_counter()
    viz_launches = _run_viz(torch, port, pk, dev, tmp,
                            *captures[MAIN_PROFILE], slam)
    kernels[0]["launches"] += viz_launches
    print(f"viz phase: {time.perf_counter() - t0:.1f} s; "
          f"planar_project<planar>: {viz_launches} more launches (the OSF "
          f"projector under the viewer, pose_optimize and the examples); "
          f"{kernels[0]['launches']} in all")
    print("frames/s end to end, main cell, cold, native staging: "
          + ", ".join(f"{k} {v:.2f}" for k, v in FPS.items()) + f" [{CARD}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_packet(torch, port, pk, dev, tmp, captures, staged, bw):
    """The packet-layout path and its kernel; returns its entries of the
    `kernels` line and its runs by capture. `staged` holds the planar
    path's runs of the same captures, the other staging this one is held
    against."""
    from ouster_sdk_tpu_torch.ops import packet_kernels as pkt

    t0 = time.perf_counter()
    df_info = synth_df_info(DF_PROFILE)
    df_path = os.path.join(tmp, "df_512.pcap")
    synth_capture(df_path, df_info, 4, seed=2)
    print(f"synthesized per-pixel-angle capture {DF_PROFILE} 128x512 x4 "
          f"frames in {time.perf_counter() - t0:.1f} s")
    cells = [  # (key, info, path, frames, chunk)
        (MAIN_PROFILE, *captures[MAIN_PROFILE], 32, 32),
        (SINGLE_PROFILE, *captures[SINGLE_PROFILE], 4, 4),
        (SPLIT_PROFILE, *captures[SPLIT_PROFILE], 4, 4),
        ("per-pixel angles", df_info, df_path, 4, 4),
    ]

    # 1. the path through the entry points, counts from zero
    from ouster_sdk_tpu_torch.utils import native

    pkt.reset_launches()
    pk.reset_launches()
    native.reset_calls()
    runs = {}
    for key, info, path, n, chunk in cells:
        pipe = port.ScanPipeline(info)
        plan, w = pipe.plan, pipe.plan.w
        planes = port.lut_planes(pipe.planar_lut)
        poses = torch.from_numpy(random_poses(chunk, w, seed=3)).to(dev)
        t0 = time.perf_counter()
        chunks = list(port.FrameReader(path, info).iter_chunks(chunk))
        stage_s = time.perf_counter() - t0
        check(sum(c[0].size for c in chunks) == n,
              f"{key}: staged {sum(c[0].size for c in chunks)} of {n}")
        fids, frames, _ = chunks[0]
        check(frames.shape == (chunk, plan.n_pkts, plan.pkt_words)
              and frames.dtype == np.uint32, f"{key}: frames {frames.shape}")
        out = pipe.batch(frames)
        outw = pipe.batch(frames, poses)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        frames_d = pk.words_tensor(frames, dev)
        xyz = pkt.unpack_project_packet_batched(frames_d, *planes, plan,
                                                dual=pipe.dual)
        one = port.unpack_project(frames_d[0], pipe.lut, plan)
        torch.cuda.synchronize()
        print(f"{key} 128x{w}: {n} frames pcap -> packet staging -> batch "
              f"without and with poses in {e2e_s:.3f} s = "
              f"{n / e2e_s:.2f} frames/s")
        FPS.setdefault("packet layout", n / e2e_s)
        runs[key] = dict(info=info, pipe=pipe, frames=frames,
                         frames_d=frames_d, planes=planes, out=out,
                         outw=outw, xyz=as_tuple(xyz), one=one, poses=poses,
                         stage_s=stage_s, fids=fids)
    native_staged("packet-layout path", len(cells), group_frames=len(cells))
    launches = dict(pkt.launches)
    print(f"packet-layout path: launches {launches}")
    # per capture: one batched call, plus the single-frame unpack_project
    check(launches == {"packet": 2 + 4, "packet_dual": 2},
          f"packet-layout path launched {launches}")
    check(sum(pk.launches.values()) == 0,
          f"packet-layout path launched planar kernels {dict(pk.launches)}")

    # 2. the outputs are right, by the port's own means
    for key, r in runs.items():
        pipe, plan, out, outw = r["pipe"], r["pipe"].plan, r["out"], r["outw"]
        B = r["frames"].shape[0]
        names = ("RANGE", "RANGE2")[:len(r["xyz"])]
        check(out["XYZ"].shape == (B, plan.h, plan.w, 3)
              and out["RANGE"].shape == (B, plan.h, plan.w)
              and out["status"].shape == (B, plan.w),
              f"{key}: batch shapes")
        check(("XYZ2" in out) == pipe.dual, f"{key}: XYZ2 presence")
        fields = port.decode_frame_batch(r["frames_d"], plan)
        lut64 = port.make_xyz_lut(r["info"])

        def stag(x):   # back to the staggered frame
            return port.destagger_torch(x, pipe.shifts, inverse=True)

        # decoded fields of batch == decode_frame_batch (and, below, the
        # planar decode of the same capture)
        for k, v in fields.items():
            g = out[k] if v.ndim == 2 else stag(out[k])
            check(g.dtype == v.dtype and torch.equal(
                g.view(torch.uint8), v.view(torch.uint8)), f"{key}: {k}")
        for name, key_xyz, kx in zip(names, ("XYZ", "XYZ2"), r["xyz"]):
            rng = fields[name].cpu().numpy().astype(np.int64)
            # batch's XYZ, staggered and moved to planar order, is the
            # kernel's XYZ bit for bit
            bx = stag(out[key_xyz]).movedim(-1, 1)
            n_diff = int((bx.contiguous().view(torch.int32)
                          != kx.view(torch.int32)).sum())
            check(n_diff == 0, f"{key}: batch {key_xyz} differs from the "
                  f"kernel in {n_diff} elements")
            x = kx.cpu().numpy()
            xw = stag(outw[key_xyz]).movedim(-1, 1).cpu().numpy()
            check(np.isfinite(x).all() and np.isfinite(xw).all(),
                  f"{key}: non-finite XYZ")
            zero = np.broadcast_to((rng == 0)[:, None], x.shape)
            check((x[zero] == 0).all() and (xw[zero] == 0).all(),
                  f"{key}: zero range not at the origin")
            check(0 < zero.sum() < zero.size, f"{key}: no zero ranges")
            worst = ulp_check(x[:4], f64_reference(lut64, rng[:4]))
            check(worst <= 1.0, f"{key} {key_xyz}: {worst} ulp from f64")
            # with poses: the f64 LUT point moved by the pose in f64,
            # within 3 f32 ulp of |point| + |translation|, the size of the
            # dewarp's intermediates (the projection's half ulp a
            # component, rotated, plus four roundings of half an ulp)
            P = r["poses"][:2].cpu().numpy().astype(np.float64)
            ref = f64_reference(lut64, rng[:2])
            t = np.moveaxis(P[:, :, :3, 3], -1, 1)[:, :, None, :]
            size = np.linalg.norm(ref, axis=1, keepdims=True) \
                + np.linalg.norm(t, axis=1, keepdims=True)
            ref = np.where(zero[:2], 0.0, np.einsum(
                "bwij,bjhw->bihw", P[:, :, :3, :3], ref) + t)
            ulp = np.spacing(size.astype(np.float32))
            worst_w = float((np.abs(xw[:2] - ref) / ulp).max())
            check(worst_w <= 3.0, f"{key} {key_xyz} with poses: {worst_w} "
                  f"ulp from the f64 dewarp")
            print(f"packet-layout {key} {key_xyz}: batch == kernel (0 "
                  f"elements differ); kernel within {worst:.3f} f32 ulp of "
                  f"the f64 LUT; batch with poses within {worst_w:.3f} ulp "
                  f"(of |point| + |translation|) of the f64 dewarp")
        check(torch.equal(r["one"].view(torch.int32),
                          r["xyz"][0][0].movedim(0, -1).contiguous()
                          .view(torch.int32)),
              f"{key}: unpack_project differs from the batched call")

    # 3. across stagings: the same frames through the planar path
    for key in (MAIN_PROFILE, SINGLE_PROFILE, SPLIT_PROFILE):
        r = runs[key]
        _, ppipe, pruns, _ = staged[key]
        pfids, _, _, pfields, pout, _, _ = pruns[0]
        check(list(pfids) == list(r["fids"]), f"{key}: frame ids differ "
              f"between stagings")
        for kx, px in zip(r["xyz"], as_tuple(pout)):
            n_diff = int((kx.view(torch.int32)
                          != px.view(torch.int32)).sum())
            check(n_diff == 0, f"{key}: packet kernel differs from the "
                  f"planar kernel in {n_diff} elements")
        fields = port.decode_frame_batch(r["frames_d"], r["pipe"].plan)
        check(sorted(fields) == sorted(pfields), f"{key}: field names")
        for k, v in pfields.items():
            check(torch.equal(fields[k].view(torch.uint8),
                              v.view(torch.uint8)),
                  f"{key}: field {k} differs between stagings")
        print(f"across stagings {key}: packet kernel == planar kernel (0 "
              f"elements differ, {len(r['xyz'])} returns); "
              f"{len(pfields)} decoded fields equal")

    # 4. each case through the wrapper against its plain version, dd and
    # f32, on the card
    def run_case(key, B, precision="dd"):
        r = runs[key]
        pipe, f = r["pipe"], r["frames_d"]
        f = f.repeat(-(-B // f.shape[0]), 1, 1)[:B].contiguous()

        def kernel():
            return pkt.unpack_project_packet_batched(
                f, *r["planes"], pipe.plan, dual=pipe.dual,
                precision=precision)

        def plain_fn():
            return pkt.unpack_project_packet_batched_plain(
                f, *r["planes"], pipe.plan, dual=pipe.dual,
                precision=precision)

        return kernel, plain_fn

    results = {}
    for case, key in (("packet", SINGLE_PROFILE),
                      ("packet_dual", MAIN_PROFILE),
                      ("packet", "per-pixel angles"),
                      ("packet_dual", SPLIT_PROFILE)):
        res = {}
        for precision in ("dd", "f32"):
            kernel, plain_fn = run_case(key, 32, precision)
            pkt.reset_launches()
            got = kernel()
            check(pkt.launches[case] == 1
                  and sum(pkt.launches.values()) == 1,
                  f"{case}: the wrapper launched {dict(pkt.launches)}")
            err, n_diff, _ = compare(got, plain_fn(),
                                     f"{case} {key} {precision}")
            res[precision] = (err, n_diff)
        print(f"{case} ({key}): dd {res['dd'][1]} and f32 {res['f32'][1]} "
              f"elements differ from plain (bit-exact), max |d| "
              f"{max(res['dd'][0], res['f32'][0]):.3g} m")
        results.setdefault(case, dict(
            key=key, max_abs_err=max(res["dd"][0], res["f32"][0])))

    # 5. timings at B=32 and B=128, of the wrapper call
    timings = {}
    for case, res in results.items():
        r = runs[res["key"]]
        plan, n_ret = r["pipe"].plan, len(r["xyz"])
        hw = plan.h * plan.w
        fields = port.decode_frame_batch(r["frames_d"], plan)
        nonzero = sum(int((fields[n].view(torch.int32) != 0).sum())
                      for n in ("RANGE", "RANGE2")[:n_ret]) \
            / r["frames_d"].shape[0]
        for B in (32, 128):
            kernel, plain_fn = run_case(res["key"], B)
            ms, lo, hi = cuda_ms(kernel)
            issue = host_issue_ms(kernel)
            plain_ms = cuda_ms(plain_fn, iters=3, windows=3, warm=1)[0]
            # the whole pixel region (every 32-byte sector of it holds a
            # range word), a status word per column, the 12 LUT planes
            # once, XYZ out
            nbytes = (B * hw * plan.pw * 4 + B * plan.w * 4 + 12 * hw * 4
                      + n_ret * B * 3 * hw * 4)
            # a nonzero range takes the generic double-single chain: 4
            # flops to split r, 30 per component
            flops = nonzero * B * 94
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_PER_S * 1e3
            timings[(case, B)] = t = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            print(f"time {case} B={B}: wrapper {ms:.4f} ms (median of 7 x "
                  f"50 calls; min {lo:.4f}, max {hi:.4f}; host issue "
                  f"{issue:.4f} ms/call), plain {plain_ms:.3f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{nbytes / 1e6:.1f} MB; at the measured copy rate "
                  f"{nbytes / bw * 1e3:.4f} ms), "
                  f"{B * hw / ms / 1e6:.1f} Gpx/s")

    # where the time goes in the main cell, per stage, warm, B=32
    r = runs[MAIN_PROFILE]
    pipe, n = r["pipe"], r["frames"].shape[0]
    print(f"host packet staging {MAIN_PROFILE} 128x{pipe.plan.w}: "
          f"{r['stage_s'] / n * 1e3:.2f} ms/frame (pcap read + reassembly "
          f"+ packets to slots, {n} frames)")
    stages = {
        "host->device copy (frames)": lambda: pk.words_tensor(
            r["frames"], dev),
        "batch (plain PyTorch: decode, XYZ, XYZ2, destagger)":
            lambda: pipe.batch(r["frames_d"]),
        "batch with poses": lambda: pipe.batch(r["frames_d"], r["poses"]),
        "unpack_project_packet_batched (kernel)":
            lambda: pkt.unpack_project_packet_batched(
                r["frames_d"], *r["planes"], pipe.plan, dual=True),
    }
    for name, fn in stages.items():
        ms = cuda_ms(fn, iters=5, windows=3, warm=1)[0]
        print(f"stage {name} B={n}: {ms / n:.4f} ms/frame")

    return [{
        "name": f"packet_project<{'dual' if case == 'packet_dual' else 'single'}>",
        "route": "cuda", "source": PACKET_SOURCE,
        "replaces": REPLACES[case], "launches": launches[case],
        "max_abs_err": results[case]["max_abs_err"],
        "ms": timings[(case, 32)]["ms"],
        "plain_ms": timings[(case, 32)]["plain_ms"],
        "bound_ms": timings[(case, 32)]["bound_ms"],
        "bound_by": timings[(case, 32)]["bound_by"],
        "library_ms": None} for case in pkt.CASES], runs


LUTFREE_NAMES = {"lutfree": "lutfree_packet<f32>",
                 "lutfree_dd": "lutfree_packet<dd>",
                 "lutfree_dd_dual": "lutfree_packet<dd, dual>",
                 "lutfree_dd_planar": "lutfree_planar"}


def _run_lutfree(torch, port, pk, dev, captures, staged, packet_runs,
                 bw) -> list:
    """The LUT-free path and its kernels; returns its entries of the
    `kernels` line. `staged` and `packet_runs` hold the planar and the
    packet-layout path's runs of the same captures: the LUT kernels'
    XYZ of the same frames."""
    from ouster_sdk_tpu_torch.ops import lutfree_kernels as lf
    from ouster_sdk_tpu_torch.ops import packet_kernels as pkt

    # 0. a sensor with per-pixel angle tables does not factorize
    df_info = packet_runs["per-pixel angles"]["info"]
    check(not port.lutfree_supported(df_info),
          "lutfree_supported accepted per-pixel angle tables")
    try:
        port.FactorTables(df_info)
    except ValueError as e:
        print(f"per-pixel angles: lutfree_supported is False and "
              f"FactorTables raises ({e}); served by packet_project")
    else:
        raise SmokeFailure("FactorTables accepted per-pixel angle tables")

    # 1. the path through the entry points, counts from zero
    from ouster_sdk_tpu_torch.utils import native

    lf.reset_launches()
    pkt.reset_launches()
    pk.reset_launches()
    native.reset_calls()
    runs = {}
    for key, n in ((MAIN_PROFILE, 32), (SINGLE_PROFILE, 4),
                   (SPLIT_PROFILE, 4)):
        info, path = captures[key]
        check(port.lutfree_supported(info), f"{key}: not lutfree_supported")
        tables = port.FactorTables(info)
        check(tables.rows.device.type == "cuda",
              "FactorTables did not pick cuda")
        plan = port.make_decode_plan(info)
        dual = any(f.name == "RANGE2" for f in plan.fields)
        t0 = time.perf_counter()
        fids, frames, _ = next(port.FrameReader(path, info).iter_chunks(n))
        stage_s = time.perf_counter() - t0
        check(fids.size == n, f"{key}: staged {fids.size} of {n}")
        frames_d = pk.words_tensor(frames, dev)
        dd = port.unpack_project_lutfree_dd(frames_d, tables, plan,
                                            dual=dual)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        f32 = port.unpack_project_lutfree(frames_d, tables, plan)
        # dual=False on a dual-return profile projects RANGE alone; a 2-D
        # frame is one frame
        first = port.unpack_project_lutfree_dd(frames_d, tables, plan)
        one = port.unpack_project_lutfree_dd(frames_d[0], tables, plan,
                                             dual=dual)
        t1 = time.perf_counter()
        pfids, planes, hdrs, _ = next(
            port.FrameReader(path, info).iter_planar_chunks(n))
        pstage_s = time.perf_counter() - t1
        check(list(pfids) == list(fids), f"{key}: frame ids differ between "
              f"stagings")
        planes_d, hdrs_d = pk.words_tensor(planes, dev), pk.words_tensor(
            hdrs, dev)
        planar = port.unpack_project_lutfree_planar(planes_d, hdrs_d, tables,
                                                    plan)
        torch.cuda.synchronize()
        print(f"{key} {plan.h}x{plan.w}: {n} frames pcap -> packet staging -> "
              f"copy -> unpack_project_lutfree_dd"
              f"{' (both returns)' if dual else ''} in {e2e_s:.3f} s = "
              f"{n / e2e_s:.2f} frames/s")
        FPS.setdefault("LUT-free", n / e2e_s)
        runs[key] = dict(info=info, plan=plan, dual=dual, tables=tables,
                         frames=frames, frames_d=frames_d, planes_d=planes_d,
                         hdrs_d=hdrs_d, dd=as_tuple(dd), f32=f32,
                         first=first, one=as_tuple(one), planar=planar,
                         fids=fids, stage_s=stage_s, pstage_s=pstage_s)
    # a packet-layout and a planar reader a capture
    native_staged("LUT-free path", 2 * len(runs), group_frames=len(runs),
                  group_frames_planar=len(runs))
    launches = dict(lf.launches)
    print(f"LUT-free path: launches {launches}")
    # per capture: the dd call (dual on two captures), the f32 call, the
    # RANGE-alone dd call, the single-frame call, the planar call
    check(launches == {"lutfree": 3, "lutfree_dd": 1 + 3 + 1,
                       "lutfree_dd_dual": 2 + 2, "lutfree_dd_planar": 3},
          f"LUT-free path launched {launches}")
    check(sum(pk.launches.values()) + sum(pkt.launches.values()) == 0,
          f"LUT-free path launched LUT kernels {dict(pk.launches)} "
          f"{dict(pkt.launches)}")

    # 2. the outputs are right, by the port's own means
    def n_diff(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    for key, r in runs.items():
        plan, B = r["plan"], r["frames"].shape[0]
        names = ("RANGE", "RANGE2")[:len(r["dd"])]
        fields = port.decode_frame_batch(r["frames_d"], plan)
        lut64 = port.make_xyz_lut(r["info"])
        for name, x in zip(names, r["dd"]):
            rng = fields[name].cpu().numpy().astype(np.int64)
            xn = x.cpu().numpy()
            check(xn.shape == (B, 3, plan.h, plan.w), f"{key}: {xn.shape}")
            check(np.isfinite(xn).all(), f"{key} {name}: non-finite XYZ")
            zero = np.broadcast_to((rng == 0)[:, None], xn.shape)
            check(0 < zero.sum() < zero.size, f"{key}: no zero ranges")
            check((xn[zero] == 0).all(),
                  f"{key} {name}: zero range not at the origin")
            worst = ulp_check(xn[:4], f64_reference(lut64, rng[:4]))
            check(worst <= 1.0, f"{key} {name}: dd {worst} ulp from f64")
            print(f"LUT-free {key} {name}: dd within {worst:.3f} f32 ulp of "
                  f"the f64 LUT (4 frames)")
        rng = fields["RANGE"].cpu().numpy().astype(np.int64)[:4]
        ref = f64_reference(lut64, rng)
        # planar == packet layout, bit for bit; the RANGE-alone call and
        # the single-frame call carry the batched call's bits
        check(n_diff(r["planar"], r["dd"][0]) == 0, f"{key}: planar LUT-free "
              f"differs from packet-layout LUT-free")
        check(n_diff(r["first"], r["dd"][0]) == 0,
              f"{key}: dual=False differs from the first return")
        for one, x in zip(r["one"], r["dd"]):
            check(one.shape == (3, plan.h, plan.w)
                  and n_diff(one, x[0]) == 0,
                  f"{key}: single-frame call differs from the batched call")
        worst = ulp_check(r["planar"][:4].cpu().numpy(), ref)
        check(worst <= 1.0, f"{key}: planar dd {worst} ulp from f64")
        # f32: the budget the reference states for it, ~r * 3e-7 (twice
        # that, floor 2e-6 m)
        f32 = r["f32"][:4].cpu().numpy()
        r_m = rng.astype(np.float64)[:, None] * 1e-3
        budget = np.maximum(3e-7 * np.maximum(r_m, 1.0) * 2, 2e-6)
        err = np.abs(f32 - ref)
        check(torch.isfinite(r["f32"]).all().item()
              and (err <= budget).all(),
              f"{key}: f32 {err.max()} m from f64, over its budget")
        print(f"LUT-free {key}: planar == packet layout (0 elements "
              f"differ); f32 max {err.max():.3g} m from the f64 LUT "
              f"(budget max(6e-7 r, 2e-6) m; worst share "
              f"{(err / budget).max():.3f})")
        # against the LUT kernels on the same frames: not the same bits
        check(list(r["fids"]) == list(packet_runs[key]["fids"])
              and list(r["fids"]) == list(staged[key][2][0][0]),
              f"{key}: frame ids differ between paths")
        lut_packet = packet_runs[key]["xyz"]
        lut_planar = as_tuple(staged[key][2][0][4])
        for name, x, a, b in zip(names, r["dd"], lut_packet, lut_planar):
            check(n_diff(a, b) == 0, f"{key}: the LUT kernels differ")
            d = n_diff(x, a)
            worst = float((x - a).abs().max())
            print(f"LUT-free {key} {name}: {d} of {x.numel()} elements "
                  f"differ from packet_project / planar_project (max |d| "
                  f"{worst:.3g} m); both within 1 f32 ulp of f64")

    # 3. each case through its wrapper against its plain version, on the
    # card, and 4. timings at B=32 and B=128 of the wrapper call
    case_key = {"lutfree": SINGLE_PROFILE, "lutfree_dd": SINGLE_PROFILE,
                "lutfree_dd_dual": MAIN_PROFILE,
                "lutfree_dd_planar": SINGLE_PROFILE}

    def rep(t, B):
        reps = (-(-B // t.shape[0]),) + (1,) * (t.ndim - 1)
        return t.repeat(*reps)[:B].contiguous()

    def run_case(case, B):
        r = runs[case_key[case]]
        plan, t = r["plan"], r["tables"]
        if case == "lutfree_dd_planar":
            args = (rep(r["planes_d"], B), rep(r["hdrs_d"], B), t, plan)
            return (lambda: lf.unpack_project_lutfree_planar(*args),
                    lambda: lf.unpack_project_lutfree_planar_plain(*args))
        args = (rep(r["frames_d"], B), t, plan)
        if case == "lutfree":
            return (lambda: lf.unpack_project_lutfree(*args),
                    lambda: lf.unpack_project_lutfree_plain(*args))
        dual = case == "lutfree_dd_dual"
        return (lambda: lf.unpack_project_lutfree_dd(*args, dual=dual),
                lambda: lf.unpack_project_lutfree_dd_plain(*args, dual=dual))

    results, timings = {}, {}
    for case in lf.CASES:
        r = runs[case_key[case]]
        plan, hw = r["plan"], r["plan"].h * r["plan"].w
        n_ret = 2 if case == "lutfree_dd_dual" else 1
        kernel, plain_fn = run_case(case, 32)
        lf.reset_launches()
        got = kernel()
        check(lf.launches[case] == 1 and sum(lf.launches.values()) == 1,
              f"{case}: the wrapper launched {dict(lf.launches)}")
        max_err, nd, _ = compare(got, plain_fn(), case)
        check(sum(lf.launches.values()) == 1,
              f"{case}: the plain version launched a kernel")
        print(f"{case} ({case_key[case]}): {nd} elements differ from plain "
              f"(bit-exact), max |d| {max_err:.3g} m")
        results[case] = max_err
        fields = port.decode_frame_batch(r["frames_d"], plan)
        nonzero = sum(int((fields[n].view(torch.int32) != 0).sum())
                      for n in ("RANGE", "RANGE2")[:n_ret]) \
            / r["frames_d"].shape[0]
        is_dd = case != "lutfree"
        for B in (32, 128):
            kernel, plain_fn = run_case(case, B)
            ms, lo, hi = cuda_ms(kernel)
            issue = host_issue_ms(kernel)
            plain_ms = cuda_ms(plain_fn, iters=3, windows=3, warm=1)[0]
            # in: the whole pixel region (every 32-byte sector of it holds
            # a range word) or the one range plane, a status word per
            # column, the tables once; out: XYZ
            words_in = hw if case == "lutfree_dd_planar" else hw * plan.pw
            tables_b = ((36 * plan.h + 4 * plan.w) if is_dd
                        else (18 * plan.h + 2 * plan.w)) * 4
            nbytes = (B * words_in * 4 + B * plan.w * 4 + tables_b
                      + n_ret * B * 3 * hw * 4)
            # the least arithmetic: one synthesis a position and call
            # (dd: 2 dd_mul + 2 dd_add = 70 operations for dir, 70 for
            # off, a component; f32: 8), one projection a nonzero pixel
            # and return (dd: dd_mul_f + dd_add + 1 = 34 a component;
            # f32: 2); none of them a fused multiply-add
            ops = ((420 * hw + 102 * nonzero * B) if is_dd
                   else (24 * hw + 6 * nonzero * B))
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_F32_NO_FMA_PER_S * 1e3
            timings[(case, B)] = t = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            print(f"time {case} B={B}: wrapper {ms:.4f} ms (median of 7 x "
                  f"50 calls; min {lo:.4f}, max {hi:.4f}; host issue "
                  f"{issue:.4f} ms/call), plain {plain_ms:.3f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB = {t_bytes:.4f} ms, "
                  f"{ops / 1e9:.3f} G operations = {t_ops:.4f} ms; at the "
                  f"measured copy rate {nbytes / bw * 1e3:.4f} ms), "
                  f"{B * hw / ms / 1e6:.1f} Gpx/s")

    # where the time goes in the main cell, per stage, warm, B=32
    r = runs[MAIN_PROFILE]
    plan, t, n = r["plan"], r["tables"], r["frames"].shape[0]
    print(f"host staging for the LUT-free path {MAIN_PROFILE} "
          f"{plan.h}x{plan.w}: packet layout {r['stage_s'] / n * 1e3:.2f} "
          f"ms/frame, planar {r['pstage_s'] / n * 1e3:.2f} ms/frame "
          f"({n} frames)")
    stages = {
        "host->device copy (frames)": lambda: pk.words_tensor(
            r["frames"], dev),
        "unpack_project_lutfree_dd, both returns (kernel)":
            lambda: lf.unpack_project_lutfree_dd(r["frames_d"], t, plan,
                                                 dual=True),
        "unpack_project_lutfree (kernel)":
            lambda: lf.unpack_project_lutfree(r["frames_d"], t, plan),
        "unpack_project_lutfree_planar (kernel)":
            lambda: lf.unpack_project_lutfree_planar(
                r["planes_d"], r["hdrs_d"], t, plan),
    }
    for name, fn in stages.items():
        ms = cuda_ms(fn, iters=10, windows=3, warm=2)[0]
        print(f"stage {name} B={n}: {ms / n:.4f} ms/frame")

    return [{
        "name": LUTFREE_NAMES[case], "route": "cuda",
        "source": LUTFREE_SOURCE, "replaces": REPLACES[case],
        "launches": launches[case], "max_abs_err": results[case],
        "ms": timings[(case, 32)]["ms"],
        "plain_ms": timings[(case, 32)]["plain_ms"],
        "bound_ms": timings[(case, 32)]["bound_ms"],
        "bound_by": timings[(case, 32)]["bound_by"],
        "library_ms": None} for case in lf.CASES]


def device_trace(torch, fn):
    """Run `fn` under torch.profiler and return what ran on the device as
    {name: count}, kernels and copies alike. Late in a long process the
    profiler has been seen to lose records (6 of 8 copies, 1 of 3
    kernels), so a count is a lower bound: what it shows did run, and
    `count_calls` and the wrappers' launch counts are the exact witnesses
    beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: int(e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


class count_calls:
    """Count the calls of `module.name` while the block runs, the host time
    spent in them and the CPU time of the calling thread spent in them
    (`cpu`): a witness of device->host copies that does not depend on the
    profiler, and a split of a host-side step."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n, self.seconds = module, name, 0, 0.0
        self.times, self.cpu = [], 0.0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.n += 1
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.fn(*args, **kwargs)
            finally:
                self.times.append(time.perf_counter() - t0)
                self.seconds += self.times[-1]
                self.cpu += time.thread_time() - c0

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def synced(torch, fn, sink: list):
    """fn() with torch's sync debug mode at "warn": appends to `sink` the
    places (file:line) of the device syncs made on this thread while it
    ran, and returns its result. The first such window in a process
    counts one sync of its own (at torch/cuda/__init__.py): open an empty
    one first."""
    import gc
    import warnings

    me, seen = threading.get_ident(), []

    def show(message, category, filename, lineno, *rest):
        if threading.get_ident() == me and "synchroniz" in str(message):
            where = os.path.join(*os.path.normpath(filename)
                                 .split(os.sep)[-2:])
            seen.append(f"{where}:{lineno}")

    # no collection inside the window: a tensor freed by the collector is
    # not the window's
    gc.collect()
    gc.disable()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            gc.enable()
            sink.append(seen)


def copies(trace, direction: str) -> int:
    return sum(n for name, n in trace.items()
               if name.startswith(f"Memcpy {direction}"))


def _run_engine(torch, port, pk, dev, tmp, captures, staged) -> int:
    """The engine path: pcap -> DeviceScanIterator / DeviceScanIndex /
    LiveDeviceBatcher -> LidarScan and OsfDeviceProjector -> XYZ cache,
    against the port's ScanBatcher over the same packets. Returns the
    launches of planar_project<planar> on this path. `staged` holds the
    planar path's runs: the XYZ of the main capture's frames."""
    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.ops.unpack import decode_frame_planar_batch
    from ouster_sdk_tpu_torch.utils import native

    info, main_path = captures[MAIN_PROFILE]
    h, w = info.format.pixels_per_column, info.format.columns_per_frame
    n_pkts = w // info.format.columns_per_packet
    path = os.path.join(tmp, "engine.pcap")
    t0 = time.perf_counter()
    n_scans = engine_capture(path, main_path, info, 32)
    print(f"engine capture: the main capture + 3 frames (a lost packet, a "
          f"straggler, an open last frame), {os.path.getsize(path) / 1e6:.1f}"
          f" MB in {time.perf_counter() - t0:.1f} s")
    check(de.supports_device_decode(info), "main profile not eligible")

    # 0. the oracle: the port's ScanBatcher, packet by packet
    t0 = time.perf_counter()
    packets = capture_packets(port, info, path)
    read_s = time.perf_counter() - t0
    oracle = batcher_scans(port, info, packets)
    batcher_s = time.perf_counter() - t0 - read_s
    n_open = n_pkts * 5 // 16
    check(len(oracle) == n_scans and len(packets) == 34 * n_pkts + n_open,
          f"oracle: {len(oracle)} scans of {len(packets)} packets")
    # frame 33 lacks packet 5 and is released by frame 34's first packet;
    # the straggler is dropped; frame 35 is flushed at the end
    check(oracle[32][1].packet_timestamp[5] == 0
          and oracle[32][0] == 33 * n_pkts - 1
          and oracle[33][1].packet_timestamp.all()
          and oracle[33][0] == 34 * n_pkts - 1
          and oracle[34][0] == EOF_RELEASE
          and np.count_nonzero(oracle[34][1].packet_timestamp) == n_open,
          "the faults did not land")
    print(f"oracle: ScanBatcher over {len(packets)} packets -> "
          f"{len(oracle)} scans in {batcher_s:.2f} s = "
          f"{batcher_s / n_scans * 1e3:.1f} ms/frame (+ {read_s:.2f} s "
          f"reading the capture packet by packet) [{CARD}]")

    # 1. DeviceScanIterator on the card, batch 4 (the default) and 32
    pk.reset_launches()
    runs = {}
    for batch in (4, 32):
        de.stats.update(batches=0, scans=0, osf_batches=0)
        native.reset_calls()
        t0 = time.perf_counter()
        it = de.DeviceScanIterator(path, info, batch=batch)
        check(it.device.type == "cuda", "DeviceScanIterator did not pick "
              "cuda")
        got = list(it.iter_released())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(de.stats["batches"] == -(-n_scans // batch)
              and de.stats["scans"] == n_scans,
              f"batch {batch}: stats {de.stats}")
        # one single-frame grouper call a scan
        native_staged(f"engine path batch={batch}", 1,
                      group_frames_planar=n_scans)
        hold_scans(got, oracle, f"DeviceScanIterator batch={batch}")
        print(f"engine end to end, cold, batch={batch}: {n_scans} frames "
              f"pcap -> LidarScan in {secs:.3f} s = {n_scans / secs:.2f} "
              f"frames/s [{CARD}]")
        FPS.setdefault("engine", n_scans / secs)
        runs[batch] = (it, got)
    it, scans = runs[4]
    s0 = scans[0][1]
    check(s0.field("RANGE").dtype == np.uint32
          and s0.field("RANGE").shape == (h, w)
          and (s0.field("RANGE2") == s0.field("RANGE") // 2).all()
          and 0 < int((s0.status & 1).sum()) < w,
          "the first scan is not what was written")

    # 2. DeviceScanIndex: random access equals iteration
    index = de.DeviceScanIndex(it)
    check(len(index) == n_scans
          and index.frame_ids == [s.frame_id for _, s in scans],
          f"index: {len(index)} scans, ids {index.frame_ids}")
    t0 = time.perf_counter()
    picks = (n_scans - 1, 0, 17, 33, 32, 5)
    n = sum(scans_differ(index.scan_at(i), scans[i][1]) for i in picks)
    check(n == 0 and all(index.scan_at(i) == scans[i][1] for i in picks),
          f"DeviceScanIndex.scan_at differs from iteration in {n} elements")
    print(f"DeviceScanIndex.scan_at {picks}: {n} elements differ from "
          f"iteration; {(time.perf_counter() - t0) / len(picks) * 1e3:.1f} "
          f"ms a lookup (stage + copy + decode + copy back one frame) "
          f"[{CARD}]")

    # 3. the live twin: every packet pushed; scans stay deferred
    def push_all(live, pkts, timed=None):
        out = []
        for _, pkt in pkts:
            before = de.stats["batches"]
            t = time.perf_counter()
            out.extend(live.push(pkt.buf, pkt.host_timestamp))
            if timed is not None:
                timed[de.stats["batches"] > before].append(
                    time.perf_counter() - t)
        return out

    timed = {False: [], True: []}
    native.reset_calls()
    with count_calls(de, "stage_planar") as grouper, \
            count_calls(de, "decode_frame_planar_batch") as decode, \
            count_calls(de, "materialize_scan_deferred") as headers:
        live_scans = push_all(de.LiveDeviceBatcher(info), packets, timed)
        torch.cuda.synchronize()
    # one grouper call a flush, no capture scan
    native_staged("live path", 0, group_frames_planar=len(timed[True]))
    check(len(live_scans) == n_scans - 1
          and all(s.fields_deferred for s in live_scans),
          f"live: {len(live_scans)} scans, deferred "
          f"{[s.fields_deferred for s in live_scans]}")
    print(f"live path: a push {np.median(timed[False]) * 1e3:.4f} ms (median "
          f"of {len(timed[False])}), a push that flushes a frame "
          f"{np.median(timed[True]) * 1e3:.2f} ms (median of "
          f"{len(timed[True])}: group + pinned copy + decode issued, nothing "
          f"awaited); a flush on average: grouper "
          f"{grouper.seconds / grouper.n * 1e3:.2f} ms, copy + decode issued "
          f"{decode.seconds / decode.n * 1e3:.2f} ms, deferred scan "
          f"{headers.seconds / headers.n * 1e3:.2f} ms [{CARD}]")
    # the same pushes through the numpy grouper, the route without g++
    ntimed = {False: [], True: []}
    with numpy_staging():
        numpy_live = push_all(de.LiveDeviceBatcher(info), packets, ntimed)
        torch.cuda.synchronize()
    print(f"live path with the numpy grouper: a push that flushes a frame "
          f"{np.median(ntimed[True]) * 1e3:.2f} ms (median of "
          f"{len(ntimed[True])}) [{CARD}]")
    hold_scans(list(zip((r for r, _ in oracle), numpy_live)), oracle[:-1],
               "LiveDeviceBatcher, numpy grouper")
    # the trace: a second batcher, the last five frames' pushes under the
    # profiler
    split = 30 * n_pkts
    for _ in range(3):          # a trace that lost every record is retaken
        live = de.LiveDeviceBatcher(info)
        held = push_all(live, packets[:split])
        traced = []
        with count_calls(de, "_to_host") as readbacks:
            trace = device_trace(torch, lambda: traced.extend(
                push_all(live, packets[split:])))
        check(len(held) == 30 and len(traced) == 4 and readbacks.n == 0
              and all(s.fields_deferred for s in held + traced),
              f"live pushes read {readbacks.n} decoded frames back")
        if trace:
            break
    h2d, d2h = copies(trace, "HtoD"), copies(trace, "DtoH")
    n_kernels = sum(n for name, n in trace.items()
                    if not name.startswith(("Memcpy", "Memset")))
    print(f"profile live pushes ({len(packets) - split} packets, "
          f"{len(traced)} scans released, none touched): {h2d} host->device "
          f"copies (2 a flush issued), {d2h} device->host copies, "
          f"{n_kernels} kernels; {readbacks.n} readbacks of a decoded frame")
    check(d2h == 0 and 0 < h2d <= 2 * len(traced) and n_kernels > 0,
          f"live pushes copied back to the host, or copied nothing in: "
          f"{trace}")
    # the detectors see a readback when there is one: touch one scan
    for ls in traced[:3]:
        with count_calls(de, "_to_host") as readbacks:
            trace = device_trace(torch, lambda: ls.field("RANGE"))
        check(readbacks.n == 1 and not ls.fields_deferred
              and traced[3].fields_deferred,
              "touching a field did not copy that scan back, or copied more")
        if copies(trace, "DtoH"):
            break
    print(f"profile first field access of one live scan: "
          f"{copies(trace, 'DtoH')} device->host copies, {readbacks.n} "
          f"readback of a decoded frame")
    check(copies(trace, "DtoH") > 0,
          "the profiler saw no device->host copy of a first field access")
    t0 = time.perf_counter()
    for ls in live_scans:
        ls.field("RANGE")
    touch_s = time.perf_counter() - t0
    print(f"live path: first field access "
          f"{touch_s / len(live_scans) * 1e3:.2f} ms/scan (copy back + fill) "
          f"[{CARD}]")
    # a live scan carries no release point: borrow the oracle's
    hold_scans(list(zip((r for r, _ in oracle), live_scans)),
               oracle[:-1], "LiveDeviceBatcher")
    n = sum(scans_differ(a, b) for a, (_, b) in zip(live_scans, scans))
    check(n == 0, f"live scans differ from the iterator's in {n} elements")

    # 4. OsfDeviceProjector: XYZ through the planar kernel, attached
    de.stats.update(batches=0, scans=0, osf_batches=0)
    pk.reset_launches()
    proj = de.OsfDeviceProjector([info], batch=4)
    check(proj.device.type == "cuda", "OsfDeviceProjector did not pick cuda")
    entries = [(0, s) for _, s in scans]
    window_s = []
    for base in range(0, n_scans, 4):
        t0 = time.perf_counter()
        proj.attach(entries[base:base + 4])
        window_s.append(time.perf_counter() - t0)
    n_windows = -(-n_scans // 4)
    check(pk.launches["planar"] == n_windows
          and sum(pk.launches.values()) == n_windows
          and de.stats["osf_batches"] == n_windows,
          f"projector: launches {dict(pk.launches)}, stats {de.stats}")
    print(f"projector: {n_windows} windows of 4 dual scans (8 range images "
          f"a launch), {np.median(window_s[1:]) * 1e3:.2f} ms a window "
          f"(median; the first, with the LUT built, "
          f"{window_s[0] * 1e3:.1f} ms) [{CARD}]")
    for attempt in range(3):    # a trace that lost every record is retaken
        trace = device_trace(torch, lambda: [
            proj.attach(entries[base:base + 4]) for base in (4, 8, 12)])
        if trace:
            break
    for name, count in trace.items():
        print(f"profile 3 projector windows: {count} x {name[:96]}")
    ran = [name for name in trace if not name.startswith("Memcpy")]
    check(len(ran) == 1 and "planar_project" in ran[0]
          and 1 <= trace[ran[0]] <= 3,
          f"projector windows ran {ran}, not planar_project alone")
    check(pk.launches["planar"] == n_windows + 3 * (attempt + 1),
          f"traced windows launched {pk.launches['planar'] - n_windows}")
    launches = n_windows        # on the path's run; the traced ones apart
    # a sensor with an extrinsic: one launch more a window, for its frame
    import copy
    info_ext = copy.deepcopy(info)
    info_ext.extrinsic = np.array(
        [[0.0, -1.0, 0.0, 500.0], [1.0, 0.0, 0.0, -250.0],
         [0.0, 0.0, 1.0, 1500.0], [0.0, 0.0, 0.0, 1.0]])
    ext_scan = port.LidarScan(scans[1][1])
    before = pk.launches["planar"]
    de.OsfDeviceProjector([info_ext], batch=4).attach([(0, ext_scan)])
    check(pk.launches["planar"] == before + 2,
          f"extrinsic window launched {pk.launches['planar'] - before}")
    launches += 2
    # does a window's time follow the scans it is given? The iterator's
    # scans and the ScanBatcher's in turns, warm, then the window's steps
    times = {"iterator's": [], "ScanBatcher's": []}
    for base in (4, 8, 12, 16):
        for name, group in (("iterator's", scans), ("ScanBatcher's", oracle)):
            t0 = time.perf_counter()
            proj.attach([(0, s) for _, s in group[base:base + 4]])
            times[name].append((time.perf_counter() - t0) * 1e3)
    split = osf_window_split(torch, pk, dev, proj._sensor_ctx(0)[2][0],
                             [s for _, s in scans[:4]])
    print("projector window, warm, in turns, ms: " + "; ".join(
        f"on the {name} scans {', '.join(f'{v:.2f}' for v in vals)}"
        for name, vals in times.items()) + "; steps on the iterator's "
        "scans, best of 5: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in split.items())
        + f" [{CARD}]")

    # XYZ: against the planar path's kernel on the same frames, the plain
    # version on the card and the f64 LUT
    _, pipe, pruns, _ = staged[MAIN_PROFILE]
    pfids, _, _, _, pout, _, _ = pruns[0]
    check(list(pfids) == [s.frame_id for _, s in scans[:32]],
          "the engine capture's first 32 frames are not the main capture's")
    lut64 = port.make_xyz_lut(info)
    n_diff = n_plain = 0
    worst = 0.0
    for k, (_, ls) in enumerate(scans):
        for ret, name in enumerate(("RANGE", "RANGE2")):
            rng = ls.field(name)
            xyz = ls.cached_xyz(ret, False, rng)
            check(xyz is not None and xyz.shape == (h, w, 3)
                  and xyz.dtype == np.float32
                  and ls.cached_xyz(ret, True, rng) is xyz,
                  f"scan {k}: no cached XYZ for return {ret}")
            check(np.isfinite(xyz).all() and (xyz[rng == 0] == 0).all(),
                  f"scan {k}: XYZ not finite, or not 0 at zero range")
            if k < 32:
                want = pout[ret][k].movedim(0, -1).contiguous().cpu().numpy()
                n_diff += int((xyz.view(np.int32)
                               != want.view(np.int32)).sum())
            if k % 8 == 2:
                r_dev = torch.from_numpy(rng.astype(np.int64)).to(dev)
                plain = pk._proj_lean(r_dev[None], pipe.planar_lut.stack,
                                      precision="dd")[0]
                n_plain += int((xyz.view(np.int32) != plain.movedim(0, -1)
                                .contiguous().cpu().numpy()
                                .view(np.int32)).sum())
                worst = max(worst, ulp_check(
                    np.moveaxis(xyz, -1, 0)[None],
                    f64_reference(lut64, rng.astype(np.int64)[None])))
    check(n_diff == 0 and n_plain == 0 and worst <= 1.0,
          f"projector XYZ: {n_diff} elements differ from the planar path, "
          f"{n_plain} from _proj_lean, {worst} ulp from f64")
    print(f"projector XYZ: {n_diff} elements differ from project_planar's "
          f"XYZ of the same 32 frames, {n_plain} from the plain _proj_lean "
          f"on the card (5 scans), within {worst:.3f} f32 ulp of the f64 "
          f"LUT")
    ls = scans[2][1]
    rng = ls.field("RANGE")
    rng[7, 9] ^= 1
    check(ls.cached_xyz(0, False, rng) is None
          and ls.cached_xyz(1, False, ls.field("RANGE2")) is not None,
          "cached_xyz served a mutated RANGE")
    rng[7, 9] ^= 1
    check(ls.cached_xyz(0, False, rng) is not None, "cached_xyz lost")

    # 5. where the time goes, per frame. The host staging stages run with
    # the native library and with the numpy versions it replaces, on the
    # same bytes (best of 3 each), and their outputs are held byte-equal.
    def best_of(fn, n: int = 3):
        best, out = float("inf"), None
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return best, out

    def scanned(p):
        reader = port.FrameReader(p, info, strict_ports=True)
        reader._scan()
        return reader

    reader = scanned(path)
    t0 = time.perf_counter()
    lidar_ev, aux_ev = reader.hybrid_streams()
    inst = de._AuxRouter(de._AuxApplier(info), reader.plan, reader.pf,
                         lidar_ev, aux_ev).instances
    replay_s = time.perf_counter() - t0
    groups = [i.pkt_idx for i in inst]
    check(len(groups) == n_scans, f"replay: {len(groups)} instances")
    main_reader = scanned(main_path)
    stages = {  # name: (frames, timed call, call whose output is compared)
        "capture scan (pcap read + reassembly, every datagram)": (
            n_scans, lambda: port.FrameReader(path, info)._scan(), None),
        "instance staging (single-frame grouper a scan, scan headers)": (
            n_scans, lambda: [None for _ in reader.iter_instance_batches(
                groups, 4)],
            lambda: [[a.copy() for a in (b.frame_ids, b.planes, b.col_hdrs,
                                         b.host_ts, b.pkt_ts, b.pkt_hdrs,
                                         b.first_hdr)]
                     for b in reader.iter_instance_batches(groups, 4)]),
        "planar grouping (iter_planar_chunks(32), scan cached)": (
            32, lambda: list(main_reader.iter_planar_chunks(32)), None),
        "packet-layout grouping (iter_chunks(32), scan cached)": (
            32, lambda: list(main_reader.iter_chunks(32)), None),
    }
    per_frame, outputs = {}, {}
    for route in ("native", "numpy"):
        with numpy_staging() if route == "numpy" else nullcontext():
            # the cached scans are the route's own
            for r in (reader, main_reader):
                r._pools.pop("scan_cache", None)
                r._scan()
            for name, (frames, fn, out_fn) in stages.items():
                secs, out = best_of(fn)
                per_frame[route, name] = secs / frames * 1e3
                outputs[route, name] = out if out_fn is None else out_fn()
    for name in stages:
        a, b = outputs["native", name], outputs["numpy", name]
        flat_a = [x for item in a for x in (item if isinstance(
            item, (tuple, list)) else (item,))]
        flat_b = [x for item in b for x in (item if isinstance(
            item, (tuple, list)) else (item,))]
        check(len(flat_a) == len(flat_b) and all(
            x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
            for x, y in zip(flat_a, flat_b)),
            f"{name}: the native staging differs from the numpy one")
        print(f"engine stage {name}: native {per_frame['native', name]:.3f} "
              f"ms/frame, numpy {per_frame['numpy', name]:.2f} ms/frame, "
              f"{per_frame['numpy', name] / per_frame['native', name]:.1f}x; "
              f"outputs byte-equal [{CARD}]")
    scan = next(iter(stages))
    for name in list(stages)[2:]:
        both = {route: per_frame[route, scan] + per_frame[route, name]
                for route in ("native", "numpy")}
        print(f"host staging, {name.split(' (')[0]} = capture scan + "
              f"grouping: native {both['native']:.2f} ms/frame, numpy "
              f"{both['numpy']:.2f} ms/frame [{CARD}]")
    print(f"engine stage admission replay (hybrid_streams + _AuxRouter): "
          f"{replay_s / n_scans * 1e3:.3f} ms/frame [{CARD}]")
    plan, pf = reader.plan, reader.pf
    for B in (4, 32):
        batch = next(reader.iter_instance_batches(groups[:B], B))
        planes_d = pk.words_tensor(batch.planes, dev)
        hdrs_d = pk.words_tensor(batch.col_hdrs, dev)
        decoded = decode_frame_planar_batch(planes_d, hdrs_d, plan, True)
        ms = cuda_ms(lambda: (pk.words_tensor(batch.planes, dev),
                              pk.words_tensor(batch.col_hdrs, dev)),
                     iters=10, windows=3, warm=2)[0]
        print(f"engine stage host->device copy (planes + col_hdrs, "
              f"pageable) B={B}: {ms / B:.4f} ms/frame [{CARD}]")
        ms = cuda_ms(lambda: decode_frame_planar_batch(planes_d, hdrs_d,
                                                       plan, True),
                     iters=10, windows=3, warm=2)[0]
        print(f"engine stage decode (plain PyTorch, every field) B={B}: "
              f"{ms / B:.4f} ms/frame [{CARD}]")
        best, best_m = float("inf"), float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = de._to_host(decoded)
            best = min(best, time.perf_counter() - t0)
            t0 = time.perf_counter()
            for k in range(B):
                de.materialize_scan(info, pf, plan, host, k,
                                    int(batch.frame_ids[k]), batch.pkt_ts[k],
                                    batch.pkt_hdrs[k], batch.first_hdr[k])
            best_m = min(best_m, time.perf_counter() - t0)
        mb = sum(v.nbytes for v in host.values()) / B / 1e6
        print(f"engine stage device->host copy (every decoded field, "
              f"{mb:.2f} MB a frame, pageable) B={B}: {best / B * 1e3:.4f} "
              f"ms/frame [{CARD}]")
        print(f"engine stage materialization (LidarScan + field copies + "
              f"headers) B={B}: {best_m / B * 1e3:.3f} ms/frame [{CARD}]")
    return launches, oracle


def _run_sources(torch, port, tmp, info, oracle):
    """The scan-source path: open_source(pcap) -> PcapScanSource -> the
    engine -> LidarScans, on the engine path's capture, held against the
    port's ScanBatcher over the same packets (`oracle`, with its release
    points); then the index, the same path staged by the numpy versions,
    and a two-sensor capture against the same source on the numpy batcher
    (OUSTER_SDK_TPU_DEVICE_DECODE=0). Returns the two sensors' infos and
    the engine route's collated sets of that capture."""
    import copy

    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.utils import native

    env = "OUSTER_SDK_TPU_DEVICE_DECODE"
    os.environ.pop(env, None)     # unset: the engine, on CUDA
    path = os.path.join(tmp, "engine.pcap")
    n_scans = len(oracle)

    # 1. iteration, cold, at the engine's default batch of 4; the release
    # points the merge orders by are recorded as they pass
    iter_released = de.DeviceScanIterator.iter_released
    released, devices = [], set()

    def recorded(it):
        devices.add(it.device.type)
        for r, scan in iter_released(it):
            released.append(r)
            yield r, scan

    def run():
        de.stats.update(batches=0, scans=0, osf_batches=0)
        native.reset_calls()
        released.clear()
        de.DeviceScanIterator.iter_released = recorded
        try:
            t0 = time.perf_counter()
            sets = list(port.open_source(path, sensor_info=[info]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            de.DeviceScanIterator.iter_released = iter_released
        check(all(len(ls) == 1 for ls in sets), "a set of more than one scan")
        hold_scans(list(zip(released, (ls[0] for ls in sets))), oracle,
                   "open_source")
        check(devices == {"cuda"} and de.stats["batches"] == -(-n_scans // 4)
              and de.stats["scans"] == n_scans,
              f"open_source: the engine ran on {devices}, stats {de.stats}")
        return sets, secs

    sets, secs = run()
    native_staged("scan-source path", 1, group_frames_planar=n_scans)
    FPS["open_source"] = n_scans / secs
    print(f"open_source end to end, cold, batch 4 (the default): {n_scans} "
          f"frames pcap -> LidarScan in {secs:.3f} s = {n_scans / secs:.2f} "
          f"frames/s; {de.stats['batches']} engine batches [{CARD}]")
    with numpy_staging():
        _, numpy_secs = run()
    check(sum(native.calls.values()) == 0, "numpy staging called the library")
    print(f"open_source with the numpy staging (the route without g++): "
          f"{n_scans / numpy_secs:.2f} frames/s [{CARD}]")
    # the spread: the engine's iterator and open_source, each cold, in turns
    turns = {"DeviceScanIterator": [], "open_source": []}
    for _ in range(3):
        for name, make in (
                ("DeviceScanIterator", lambda: de.DeviceScanIterator(
                    path, info)),
                ("open_source", lambda: port.open_source(
                    path, sensor_info=[info]))):
            t0 = time.perf_counter()
            n = sum(1 for _ in make())
            torch.cuda.synchronize()
            turns[name].append(n / (time.perf_counter() - t0))
    print("in turns, cold, batch 4, frames/s: " + "; ".join(
        f"{name} {', '.join(f'{v:.2f}' for v in vals)}"
        for name, vals in turns.items()) + f" [{CARD}]")

    # 2. the index: length and random lookups equal to the iteration
    t0 = time.perf_counter()
    src = port.open_source(path, sensor_info=[info], index=True)
    index_s = time.perf_counter() - t0
    check(len(src) == n_scans and src.scans_num == [n_scans]
          and src._lazy is not None,
          f"index: {len(src)} sets, scans_num {src.scans_num}")
    picks = [int(i) for i in
             np.random.default_rng(4).choice(n_scans, 6, replace=False)]
    t0 = time.perf_counter()
    n = sum(scans_differ(src[i][0], sets[i][0]) for i in picks)
    check(n == 0, f"open_source(index=True): lookups differ from the "
          f"iteration in {n} elements")
    print(f"open_source(index=True): len {len(src)}, lookups {picks}: {n} "
          f"elements differ from the iteration; index built in "
          f"{index_s:.3f} s, {(time.perf_counter() - t0) / 6 * 1e3:.1f} ms a "
          f"lookup [{CARD}]")

    # 3. two sensors on distinct ports, packets interleaved one by one:
    # the engine (one iterator a sensor, merged) against the batcher
    infos = [copy.deepcopy(info), copy.deepcopy(info)]
    for k, (port_k, init_id, sn) in enumerate(((7502, 11, 1001),
                                               (7512, 22, 2002))):
        infos[k].config.udp_port_lidar = port_k
        infos[k].init_id, infos[k].sn = init_id, sn
    n_pkts = info.format.columns_per_frame // info.format.columns_per_packet
    streams = [list(synth_packets(infos[0], range(1, 7), seed=11)),
               list(synth_packets(infos[1], range(40, 45), seed=12))
               + list(synth_packets(infos[1], [45], seed=13))[:n_pkts // 3]]
    two = os.path.join(tmp, "two_sensors.pcap")
    with port.PcapWriter(two) as writer:
        ts = 10**9
        for k in range(max(map(len, streams))):
            for s, sinfo in zip(streams, infos):
                if k < len(s):
                    port_k = sinfo.config.udp_port_lidar
                    writer.write(s[k][0], "10.0.0.2", "10.0.0.1", port_k,
                                 port_k, ts)
                    ts += 1000
    got = {}
    for value in ("1", "0"):
        os.environ[env] = value
        de.stats.update(batches=0, scans=0, osf_batches=0)
        t0 = time.perf_counter()
        src = port.open_source(two, sensor_info=infos)
        order = list(src._iter_scans())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sets = list(src)
        got[value] = (order, de.stats["batches"],
                      [[None if s is None else s.frame_id for s in ls]
                       for ls in sets], sets)
        print(f"open_source, two sensors, {env}={value}: {len(order)} scans "
              f"in {secs:.3f} s, {de.stats['batches']} engine batches "
              f"[{CARD}]")
    os.environ.pop(env)
    dev_order, dev_batches, dev_sets, sets = got["1"]
    ref_order, ref_batches, ref_sets, _ = got["0"]
    seq = [i for i, _ in ref_order]
    check(dev_batches > 0 and ref_batches == 0,
          f"two sensors: engine batches {dev_batches} / {ref_batches}")
    dev_ids = [(i, s.frame_id) for i, s in dev_order]
    ref_ids = [(i, s.frame_id) for i, s in ref_order]
    check(dev_ids == ref_ids and dev_sets == ref_sets,
          f"two sensors: the engine yields {dev_ids}, the batcher {ref_ids}")
    check(set(seq) == {0, 1} and seq != sorted(seq) and len(seq) == 6 + 6,
          f"two sensors: yield order {seq} does not interleave the sensors")
    n = sum(scans_differ(a, b) for (_, a), (_, b) in zip(dev_order, ref_order))
    check(n == 0, f"two sensors: {n} elements differ between the routes")
    print(f"open_source, two sensors on ports 7502 and 7512: yield order "
          f"{seq}, {n} elements differ between the engine and the numpy "
          f"batcher, collated sets equal")
    return infos, sets


# -- the OSF path -------------------------------------------------------------

OSF_EXTRINSIC = np.array(
    [[0.0, -1.0, 0.0, 500.0], [1.0, 0.0, 0.0, -250.0],
     [0.0, 0.0, 1.0, 1500.0], [0.0, 0.0, 0.0, 1.0]])
RETURNS = ("RANGE", "RANGE2")


def write_osf(path: str, infos, items, collated: bool = False) -> float:
    """Write with the port's OSF Writer (PNG, the default): `items` are one
    sensor's scans, or LidarScanSets with `collated`. Returns the seconds
    the writer took, its close included."""
    from ouster_sdk_tpu_torch.io.osf import Writer

    t0 = time.perf_counter()
    with Writer(path) as writer:
        for info in infos:
            writer.add_sensor(info)
        for item in items:
            if collated:
                writer.save_set(item)
            else:
                writer.save(0, item)
    return time.perf_counter() - t0


def hold_osf_xyz(torch, port, pk, dev, info, scans, f64_every: int = 4):
    """Every XYZ cache the replay attached to `scans` (both returns; the
    sensor frame and, where the extrinsic is not the identity, the
    extrinsics frame) against the plain _proj_lean on the same ranges on
    `dev`, bit for bit, and every `f64_every`-th scan against the f64 LUT.
    Returns (differing elements, worst f32 ulp from f64, images held)."""
    ident = np.allclose(info.extrinsic, np.eye(4))
    variants = (False,) if ident else (False, True)
    luts = {v: port.PlanarLut(port.make_xyz_lut(info, v), dev).stack
            for v in variants}
    n_diff, worst, n_img = 0, 0.0, 0
    for k, ls in enumerate(scans):
        for ret, name in enumerate(RETURNS):
            rng = ls.field(name)
            r_dev = torch.from_numpy(rng.astype(np.int64)).to(dev)[None]
            for v in variants:
                xyz = ls.cached_xyz(ret, v, rng)
                check(xyz is not None and xyz.dtype == np.float32
                      and xyz.shape == (info.h, info.w, 3),
                      f"scan {k}: no XYZ cache for return {ret + 1}, "
                      f"extrinsics frame {v}")
                check(not ident or ls.cached_xyz(ret, True, rng) is xyz,
                      f"scan {k}: the extrinsics frame is not served")
                check(np.isfinite(xyz).all() and (xyz[rng == 0] == 0).all(),
                      f"scan {k}: XYZ not finite, or not 0 at zero range")
                plain = pk._proj_lean(r_dev, luts[v], precision="dd")[0]
                plain = plain.movedim(0, -1).contiguous().cpu().numpy()
                n_diff += int((xyz.view(np.int32)
                               != plain.view(np.int32)).sum())
                n_img += 1
                if k % f64_every == 0:
                    worst = max(worst, ulp_check(
                        np.moveaxis(xyz, -1, 0)[None],
                        f64_reference(port.make_xyz_lut(info, v),
                                      rng.astype(np.int64)[None])))
    return n_diff, worst, n_img


def osf_window_split(torch, pk, dev, lut_stack, scans) -> dict:
    """OsfDeviceProjector.attach on one window of `scans`, step by step
    with the same calls, warm, ms (best of 5; the kernel by CUDA events):
    gather the range images, copy in, the kernel, copy back, attach the
    caches (both frames' keys, as for an identity extrinsic)."""
    items = [(ls, ret, np.asarray(ls.field(name), np.uint32))
             for ls in scans for ret, name in enumerate(RETURNS)]

    def timed(fn):
        best, out = float("inf"), None
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3, out

    def attach():
        for k, (ls, ret, r) in enumerate(items):
            xyz = np.moveaxis(out[k], 0, -1)
            ls.attach_xyz_cache(ret, False, xyz, r)
            ls.attach_xyz_cache(ret, True, xyz, r)

    split = {}
    split["gather"], rngs = timed(
        lambda: np.stack([r for _, _, r in items]))
    split["copy in"], rngs_d = timed(lambda: pk.words_tensor(rngs, dev))
    split["kernel"] = cuda_ms(lambda: pk.project_ranges(rngs_d, lut_stack),
                              iters=20, windows=5, warm=2)[0]
    out_d = pk.project_ranges(rngs_d, lut_stack)
    split["copy back"], out = timed(lambda: out_d.cpu().numpy())
    split["attach"], _ = timed(attach)
    return split


def _run_osf(torch, port, pk, dev, tmp, info, oracle, two_sensor) -> int:
    """The OSF path: the engine capture's scans (`oracle`), the same scans
    under a sensor with an extrinsic, and the scan-source path's collated
    two-sensor sets (`two_sensor`: infos, sets) written with the port's
    Writer, then read back through open_source -> OsfScanSource -> host
    PNG decode -> OsfDeviceProjector (planar_project) -> XYZ caches, each
    scan held equal to what was written and each cache bit-equal to the
    plain _proj_lean on the card. Returns the launches of
    planar_project<planar> on this path."""
    import copy

    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.io import osf as osf_mod
    from ouster_sdk_tpu_torch.utils import native
    from ouster_sdk_tpu_torch.utils import png as png_mod

    env = "OUSTER_SDK_TPU_DEVICE_DECODE"
    os.environ.pop(env, None)     # unset: the projector, on CUDA
    scans = [s for _, s in oracle]
    n, windows = len(scans), -(-len(scans) // 4)
    channels = len(list(scans[0].fields))
    info_ext = copy.deepcopy(info)
    info_ext.extrinsic = OSF_EXTRINSIC.copy()
    two_infos, two_sets = two_sensor
    files = {
        "main": (os.path.join(tmp, "engine.osf"), [info], scans, False),
        "extrinsic": (os.path.join(tmp, "extrinsic.osf"), [info_ext],
                      scans, False),
        "two sensors": (os.path.join(tmp, "two_sensors.osf"), two_infos,
                        two_sets, True)}

    # 1. the files, written by the port's Writer
    for name, (path, infos, items, collated) in files.items():
        secs = write_osf(path, infos, items, collated)
        k = sum(len(ls.valid()) for ls in items) if collated else len(items)
        print(f"OSF write, {name} file: {k} scans of {info.h}x{info.w} dual "
              f"in {secs:.2f} s = {secs / k * 1e3:.1f} ms/scan, "
              f"{os.path.getsize(path) / k / 1e6:.2f} MB/scan (PNG) [{CARD}]")

    def replay(path):
        de.stats.update(batches=0, scans=0, osf_batches=0)
        native.reset_calls()
        pk.reset_launches()
        t0 = time.perf_counter()
        src = port.open_source(path)
        sets = list(src)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(src._projector() is not None
              and src._projector().device.type == "cuda",
              "the OSF replay's projector is not on cuda")
        return src, sets, secs

    # 2. replay of the single-sensor files, cold, counts from zero
    launches = 0
    for name, variants in (("main", 1), ("extrinsic", 2)):
        path, (sinfo,), _, _ = files[name]
        src, sets, secs = replay(path)
        got = [ls[0] for ls in sets]
        check(len(got) == n and all(len(ls) == 1 for ls in sets),
              f"{name}: {len(got)} sets read back of {n}")
        check(pk.launches["planar"] == windows * variants
              and sum(pk.launches.values()) == windows * variants
              and de.stats["osf_batches"] == windows,
              f"{name}: launches {dict(pk.launches)}, stats {de.stats}, "
              f"expected {windows} windows x {variants} frames")
        check(native.calls["png_unfilter"] == n * channels,
              f"{name}: {native.calls['png_unfilter']} native PNG unfilter "
              f"calls, expected {n * channels}")
        launches += windows * variants
        d = sum(scans_differ(a, b) for a, b in zip(got, scans))
        check(d == 0, f"{name}: {d} elements differ from the scans written")
        n_diff, worst, n_img = hold_osf_xyz(torch, port, pk, dev, sinfo, got)
        check(n_diff == 0 and worst <= 1.0,
              f"{name}: XYZ caches differ from _proj_lean in {n_diff} "
              f"elements, {worst} f32 ulp from f64")
        print(f"OSF replay, {name} file, open_source cold: {n} scans in "
              f"{secs:.3f} s = {n / secs:.2f} frames/s; {d} elements differ "
              f"from the scans written; {pk.launches['planar']} launches of "
              f"planar_project<planar> ({windows} windows x {variants} "
              f"frames); {native.calls['png_unfilter']} native PNG unfilter "
              f"calls; XYZ caches ({n_img} images) {n_diff} elements from "
              f"the plain _proj_lean on the card, within {worst:.3f} f32 ulp "
              f"of the f64 LUT [{CARD}]")
        if name == "main":
            FPS["osf"] = n / secs
            main_src, main_got = src, got

    # random access equals the iteration, one window a lookup
    picks = [int(i) for i in np.random.default_rng(5).choice(n, 5, False)]
    pk.reset_launches()
    t0 = time.perf_counter()
    for i in picks:
        s, want = main_src[i][0], main_got[i]
        check(scans_differ(s, want) == 0 and np.array_equal(
            s.cached_xyz(0, False, s.field("RANGE")).view(np.int32),
            want.cached_xyz(0, False, want.field("RANGE")).view(np.int32)),
            f"OSF src[{i}] differs from the iteration")
    lookup_s = (time.perf_counter() - t0) / len(picks)
    check(pk.launches["planar"] == len(picks),
          f"lookups launched {pk.launches['planar']}")
    launches += len(picks)
    print(f"OSF src[i] for i in {picks}: equal to the iteration, caches "
          f"included; {lookup_s * 1e3:.1f} ms a lookup [{CARD}]")

    # XYZLut serves the cache, and recomputes once RANGE changes
    lut = port.XYZLut(info)
    t0 = time.perf_counter()
    hits = sum(int(np.array_equal(lut(ls), ls.cached_xyz(
        0, False, ls.field("RANGE")).astype(np.float64))) for ls in main_got)
    hit_s = (time.perf_counter() - t0) / n
    check(hits == n, f"XYZLut served {hits} of {n} caches")
    ls = main_got[3]
    rng = ls.field("RANGE")
    cache = ls.cached_xyz(0, False, rng)
    rng[7, 9] ^= 1
    t0 = time.perf_counter()
    served = lut(ls)
    miss_s = time.perf_counter() - t0
    check(np.array_equal(served, port.make_xyz_lut(info)(rng))
          and not np.array_equal(served, cache.astype(np.float64)),
          "XYZLut served a cache for a mutated RANGE")
    rng[7, 9] ^= 1
    check(np.array_equal(lut(ls), cache.astype(np.float64)),
          "XYZLut lost the cache")
    print(f"XYZLut(info)(scan): {hits} of {n} scans served from the cache "
          f"({hit_s * 1e3:.2f} ms a scan); a mutated RANGE recomputed in f64 "
          f"({miss_s * 1e3:.2f} ms) [{CARD}]")

    # 3. the collated two-sensor file: the sets as written
    path = files["two sensors"][0]
    src, sets, secs = replay(path)
    check(src.is_collated() and len(sets) == len(two_sets),
          f"two sensors: {len(sets)} sets of {len(two_sets)}, collated "
          f"{src.is_collated()}")
    d, present = 0, 0
    for got_set, want_set in zip(sets, two_sets):
        check([s is None for s in got_set] == [s is None for s in want_set],
              "two sensors: a set's slots differ")
        for a, b in zip(got_set, want_set):
            if a is not None:
                d += scans_differ(a, b)
                present += 1
    check(d == 0 and pk.launches["planar"] == present
          and de.stats["osf_batches"] == present,
          f"two sensors: {d} elements differ; launches {dict(pk.launches)}"
          f", stats {de.stats}, expected {present} launches")
    launches += present
    n_diff = n_img = 0
    worst = 0.0
    for si, sinfo in enumerate(two_infos):
        mine = [ls[si] for ls in sets if ls[si] is not None]
        nd, wst, ni = hold_osf_xyz(torch, port, pk, dev, sinfo, mine, 2)
        n_diff, worst, n_img = n_diff + nd, max(worst, wst), n_img + ni
    check(n_diff == 0 and worst <= 1.0,
          f"two sensors: XYZ caches {n_diff} elements from _proj_lean, "
          f"{worst} ulp from f64")
    print(f"OSF replay, collated two-sensor file: {len(sets)} sets "
          f"({present} scans) as written, {d} elements differ; {present} "
          f"launches (one a sensor and set); XYZ caches ({n_img} images) "
          f"{n_diff} elements from _proj_lean, within {worst:.3f} f32 ulp "
          f"of f64; {secs:.3f} s [{CARD}]")

    # 4. where the read time goes: the main file once more, warm
    path = files["main"][0]
    pk.reset_launches()
    with count_calls(osf_mod, "decode_lidar_scan_msg") as decode, \
            count_calls(png_mod.zlib, "decompress") as inflate, \
            count_calls(png_mod, "_unfilter") as unfilter, \
            count_calls(osf_mod, "_stagger") as stagger, \
            count_calls(de.OsfDeviceProjector, "attach") as attach:
        t0 = time.perf_counter()
        src = port.open_source(path)
        open_s = time.perf_counter() - t0
        k = sum(1 for _ in src)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    check(k == n and inflate.n == unfilter.n == stagger.n == n * channels
          and attach.n == windows and pk.launches["planar"] == windows,
          f"read split: {k} sets, {inflate.n} inflates, {unfilter.n} "
          f"unfilters, {stagger.n} staggers, {attach.n} windows")
    launches += windows
    rest = decode.seconds - inflate.seconds - unfilter.seconds \
        - stagger.seconds
    other = total_s - open_s - decode.seconds - attach.seconds
    per = {"open (mmap, chunk CRC, message index)": open_s,
           "decode: inflate (zlib)": inflate.seconds,
           "decode: PNG unfilter (native)": unfilter.seconds,
           "decode: stagger": stagger.seconds,
           "decode: flatbuffer, PNG chunks, LidarScan": rest,
           "projector windows (attach)": attach.seconds,
           "the rest (source iteration, sets)": other}
    for name, secs in per.items():
        print(f"OSF read stage {name}: {secs / n * 1e3:.3f} ms/scan "
              f"({secs / total_s * 100:.1f} %)")
    host = decode.seconds + open_s
    print(f"OSF read, warm: {total_s / n * 1e3:.2f} ms/scan = "
          f"{n / total_s:.2f} frames/s; host decode {host / n * 1e3:.2f} "
          f"ms/scan, of which stagger "
          f"{stagger.seconds / max(host, 1e-9) * 100:.1f} %, inflate "
          f"{inflate.seconds / max(host, 1e-9) * 100:.1f} % [{CARD}]")

    # the projector's window, step by step, on the first window
    real = sorted(attach.times[1:]) or attach.times
    split = osf_window_split(torch, pk, dev, port.PlanarLut(
        port.make_xyz_lut(info), dev).stack, main_got[:4])
    print(f"OSF projector window (4 dual scans, 8 range images): "
          f"attach {real[len(real) // 2] * 1e3:.2f} ms (median of "
          f"{len(real)}; the first, with the LUT built, "
          f"{attach.times[0] * 1e3:.2f} ms); its steps, best of 5: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" (kernel by CUDA events) [{CARD}]")
    # the same call on windows of the scans written (the ScanBatcher's) and
    # of the scans read back, in turns, warm (the LUT built before): does a
    # window's time follow the scans it is given?
    proj = de.OsfDeviceProjector([info], batch=4)
    proj.attach([(0, s) for s in main_got[:4]])
    times = {"read back": [], "written": []}
    for base in (4, 8, 12, 16):
        for name, group in (("read back", main_got), ("written", scans)):
            t0 = time.perf_counter()
            proj.attach([(0, s) for s in group[base:base + 4]])
            times[name].append((time.perf_counter() - t0) * 1e3)
    print("OSF projector window, warm, in turns, ms: " + "; ".join(
        f"on the scans {name} {', '.join(f'{v:.2f}' for v in vals)}"
        for name, vals in times.items()) + f" [{CARD}]")

    # 5. replay frames/s in turns: OSF with the projector, OSF with the
    # policy off (no XYZ), the same scans from the pcap through the engine
    pcap = os.path.join(tmp, "engine.pcap")
    runs = (("OSF, projector", "1", lambda: port.open_source(path)),
            ("OSF, policy off (no XYZ)", "0", lambda: port.open_source(path)),
            ("pcap, engine", "1", lambda: port.open_source(
                pcap, sensor_info=[info])))
    turns = {name: [] for name, _, _ in runs}
    pk.reset_launches()
    for _ in range(3):
        for name, value, make in runs:
            os.environ[env] = value
            t0 = time.perf_counter()
            k = sum(1 for _ in make())
            torch.cuda.synchronize()
            turns[name].append(k / (time.perf_counter() - t0))
    os.environ.pop(env)
    check(pk.launches["planar"] == 3 * windows,
          f"turns: {pk.launches['planar']} launches")
    launches += 3 * windows
    print("OSF replay in turns, frames/s: " + "; ".join(
        f"{name} {', '.join(f'{v:.2f}' for v in vals)}"
        for name, vals in turns.items()) + f" [{CARD}]")
    return launches



# -- the host layer ------------------------------------------------------------

HOST_FRAMES = 8        # frames of the main capture the host layer takes
HOST_CSV_SCANS = 2     # scans saved as CSV (np.savetxt writes ~7 us a point)
HOST_FORMATS = ("osf", "pcap", "bag", "db3", "mcap", "ply", "pcd", "las",
                "csv", "png")
CUSTOM_PROFILE = (250, "CHIP_SMOKE_CUSTOM_12B")   # number, name


def host_views(mask):
    """The derived views the host layer holds, by the name it prints: beam
    reduction, a RANGE band (mm) on both returns, a destaggered mask."""
    return {
        "reduce([64])": lambda s: s.reduce([64]),
        "clip(RANGE, RANGE2, 20 m, 300 m)": lambda s: s.clip(
            ["RANGE", "RANGE2"], 20000, 300000),
        "mask(RANGE, SIGNAL, REFLECTIVITY)": lambda s: s.mask(
            ["RANGE", "SIGNAL", "REFLECTIVITY"], [mask]),
    }


def saved_points(port, info, scans) -> np.ndarray:
    """What save_scans' point-cloud writers store for `scans`: RANGE
    through the f64 host LUT with the extrinsic, dewarped by the scan's
    poses, the points with a range, as float32 (io/save._save_points)."""
    from ouster_sdk_tpu_torch.utils.pose_util import dewarp

    lut = port.make_xyz_lut(info, use_extrinsics=True)
    return np.concatenate([
        dewarp(lut(s.field("RANGE")), s.pose)[s.field("RANGE") > 0]
        for s in scans]).astype(np.float32)


def las_points(p32: np.ndarray) -> np.ndarray:
    """The points a LAS file of `p32` holds: 1 mm steps from the per-axis
    minimum (io/cloud_io._write_las), read back in float64."""
    mins = p32.min(axis=0)
    coded = np.round((p32 - mins) / 0.001).astype(np.int32)
    return coded.astype(np.float64) * 0.001 + mins.astype(np.float64)


def hold_saved(got, want, what: str, ts_unit: int) -> None:
    """Scans read back from a saved file against the scans saved, every
    field and header. With a `ts_unit` (ns), a file of re-packetized scans
    (pcap, bags): its packets carry new receive times, the first valid one
    plus the packet's index, stored in that unit; they are checked as such
    and then set aside."""
    check(len(got) == len(want),
          f"{what}: {len(got)} scans read back of {len(want)}")
    n = 0
    for a, b in zip(got, want):
        if ts_unit:
            base = int(b.first_valid_packet_timestamp())
            new = base + np.arange(len(a.packet_timestamp), dtype=np.uint64)
            check(np.array_equal(a.packet_timestamp,
                                 new // ts_unit * ts_unit),
                  f"{what}: frame {a.frame_id} receive times")
            a.packet_timestamp[:] = b.packet_timestamp
        n += scans_differ(a, b)
    check(n == 0, f"{what}: {n} elements differ from the scans saved")


class xyz_cache_calls:
    """Count LidarScan.cached_xyz calls that found a cache (hits) and that
    did not (misses) while the block runs."""

    def __init__(self, cls):
        self.cls, self.hits, self.misses = cls, 0, 0

    def __enter__(self):
        self.fn = self.cls.cached_xyz
        outer = self

        def counted(scan, *args):
            out = outer.fn(scan, *args)
            if out is None:
                outer.misses += 1
            else:
                outer.hits += 1
            return out

        self.cls.cached_xyz = counted
        return self

    def __exit__(self, *exc):
        self.cls.cached_xyz = self.fn


def _run_host_layer(torch, port, pk, dev, tmp, info) -> int:
    """The host layer over the card's scans, on HOST_FRAMES frames of the
    main cell: derived views of open_source(pcap) (the engine on the card)
    held bit-equal to the same views on the numpy ScanBatcher, digests
    included; save_scans of the card's scans to every format, each file
    read back (OSF through the projector, pcap through the engine, bags
    through BagScanSource, point clouds through CloudScanSource) and held
    to what was saved; filter_xyz served from the OSF replay's XYZ cache
    and held to the f64 host LUT, missing the cache once clip changed
    RANGE; a custom profile decoded on the card bit-equal to the
    ScanBatcher. Returns the launches of planar_project<planar>."""
    import copy
    import shutil

    from ouster_sdk_tpu_torch.io import derived
    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.io.save import save_scans
    from ouster_sdk_tpu_torch.ops import profiles
    from ouster_sdk_tpu_torch.ops.packet_format import PacketWriter
    from ouster_sdk_tpu_torch.utils.digest import FieldDigest, StreamDigest

    env = "OUSTER_SDK_TPU_DEVICE_DECODE"
    launches0 = pk.launches["planar"]
    # the lidar stream's port and destination configured, as a sensor's
    # metadata has them: a bag carries the metadata as json, and its
    # parser reads a sensor without them as one whose lidar stream is off
    info = copy.deepcopy(info)
    info.config.udp_port_lidar, info.config.udp_dest = 7502, "10.0.0.1"
    work = os.path.join(tmp, "host")
    os.makedirs(work)
    try:
        path = os.path.join(work, "host.pcap")
        synth_capture(path, info, HOST_FRAMES)
        packets = StreamDigest.from_packet_source(
            port.PcapPacketSource(path, sensor_infos=[info])).packet_hash
        iter_released = de.DeviceScanIterator.iter_released
        devices = set()

        def recorded(it):
            devices.add(it.device.type)
            yield from iter_released(it)

        def read(make, value, what, engine):
            """Every set of make() with the variable at `value` (None:
            unset) and its seconds; fails unless the engine decoded on the
            card exactly when `engine`."""
            if value is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = value
            de.stats.update(batches=0, scans=0, osf_batches=0)
            devices.clear()
            de.DeviceScanIterator.iter_released = recorded
            try:
                t0 = time.perf_counter()
                sets = list(make())
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                de.DeviceScanIterator.iter_released = iter_released
                os.environ.pop(env, None)
            ran = devices == {"cuda"} and de.stats["scans"] > 0
            check(ran == engine and devices <= {"cuda"},
                  f"{what}: the engine ran on {devices}, stats {de.stats}")
            return sets, secs

        # 1. derived views, the engine on the card against the batcher
        card, secs = read(lambda: port.open_source(path, sensor_info=[info]),
                          None, "open_source", True)
        scans = [ls[0] for ls in card]
        check(len(scans) == HOST_FRAMES, f"{len(scans)} scans")
        print(f"host layer: open_source {HOST_FRAMES} frames of "
              f"{info.h}x{info.w} dual, the engine on the card: "
              f"{secs / HOST_FRAMES * 1e3:.2f} ms/scan [{CARD}]")
        mask = np.random.default_rng(12).random((info.h, info.w)) > 0.25
        for name, view in host_views(mask).items():
            got, secs = read(lambda: view(port.open_source(
                path, sensor_info=[info])), None, name, True)
            want, bsecs = read(lambda: view(port.open_source(
                path, sensor_info=[info])), "0", name + " (batcher)", False)
            check(len(got) == len(want) == HOST_FRAMES,
                  f"{name}: {len(got)} and {len(want)} sets")
            n = sum(scans_differ(a[0], b[0]) for a, b in zip(got, want))
            digests = [StreamDigest(packets, [FieldDigest.from_scan(ls[0])
                                              for ls in sets])
                       for sets in (got, want)]
            check(n == 0 and digests[0].to_json() == digests[1].to_json(),
                  f"{name}: {n} elements differ from the batcher's view, "
                  f"digests equal {digests[0] == digests[1]}")
            print(f"host layer view {name}: {HOST_FRAMES} scans of "
                  f"{got[0][0].h}x{got[0][0].w}, 0 elements differ from the "
                  f"same view on the numpy ScanBatcher, StreamDigest equal; "
                  f"{secs / HOST_FRAMES * 1e3:.2f} ms/scan over the engine "
                  f"({bsecs / HOST_FRAMES * 1e3:.2f} over the batcher) "
                  f"[{CARD}]")

        # 2. save_scans of the card's scans, and each file read back
        want_pts = saved_points(port, info, scans)
        csv_pts = saved_points(port, info, scans[:HOST_CSV_SCANS])
        outs = {}
        for ext in HOST_FORMATS:
            out = os.path.join(work, f"saved.{ext}")
            k = HOST_CSV_SCANS if ext == "csv" else HOST_FRAMES
            before = set(os.listdir(work))
            t0 = time.perf_counter()
            n = save_scans(out, [info], card[:k])
            secs = time.perf_counter() - t0
            new = sorted(set(os.listdir(work)) - before)
            check(n == k and new, f"save_scans {ext}: {n} scans, files {new}")
            size = sum(os.path.getsize(os.path.join(work, f)) for f in new)
            outs[ext] = (out, k, new)
            print(f"host layer write .{ext}: {k} scans in {secs:.3f} s = "
                  f"{secs / k * 1e3:.2f} ms/scan, {size / k / 1e6:.3f} "
                  f"MB/scan ({len(new)} file{'s' * (len(new) > 1)}) [{CARD}]")
        _, _, pngs = outs["png"]
        check(len(pngs) == HOST_FRAMES * len(list(scans[0].fields)),
              f"png: {len(pngs)} files")

        before = pk.launches["planar"]
        got, secs = read(lambda: port.open_source(outs["osf"][0]), None,
                         "OSF read", False)
        # save_scans records each set as a collation: the projector takes
        # one window a set, as for the OSF phase's two-sensor file
        windows = HOST_FRAMES
        check(pk.launches["planar"] - before == windows,
              f"OSF read: {pk.launches['planar'] - before} launches of "
              f"planar_project, expected {windows}")
        osf_scans = [ls[0] for ls in got]
        hold_saved(osf_scans, scans, "OSF read", 0)
        readers = {"osf": secs}
        for ext in ("pcap", "bag", "db3", "mcap"):
            kw = {"sensor_info": [info]} if ext == "pcap" else {}
            got, secs = read(lambda: port.open_source(outs[ext][0], **kw),
                             None, f"{ext} read", ext == "pcap")
            # a pcap stores microseconds
            hold_saved([ls[0] for ls in got], scans, f"{ext} read",
                       1000 if ext == "pcap" else 1)
            readers[ext] = secs
        for ext in ("ply", "pcd", "las", "csv"):
            pts = csv_pts if ext == "csv" else want_pts
            want = las_points(pts) if ext == "las" else pts
            t0 = time.perf_counter()
            src = port.open_source(outs[ext][0])
            sets = list(src)
            readers[ext] = time.perf_counter() - t0
            check(type(src).__name__ == "CloudScanSource" and len(sets) == 1,
                  f"{ext}: {type(src).__name__}, {len(sets)} sets")
            xyz = sets[0][0].field("XYZ").transpose(1, 0, 2).reshape(
                -1, 3)[:len(pts)]
            n = int((xyz != want.astype(np.float32)).sum())
            check(n == 0, f"{ext}: {n} coordinates differ from the host "
                  f"projection saved")
        for ext, secs in readers.items():
            k = outs[ext][1]
            print(f"host layer read .{ext}: {secs * 1e3:.1f} ms for {k} "
                  f"scans = {secs / k * 1e3:.2f} ms/scan, equal to what was "
                  f"saved ({'CloudScanSource: the points of the f64 host '
                   'projection' if ext in ('ply', 'pcd', 'las', 'csv') else
                   'every field and header'}) [{CARD}]")

        # 3. filter_xyz on the OSF replay's scans: the XYZ cache, then a
        # clip that changes RANGE
        lut, host_lut = port.XYZLut(info), port.make_xyz_lut(info)
        poses = random_poses(HOST_FRAMES, info.w, seed=21)
        times = {"cache": 0.0, "host LUT": 0.0}
        for dewarp in (False, True):
            with xyz_cache_calls(port.LidarScan) as calls:
                for k, s in enumerate(osf_scans):
                    a, b = copy.deepcopy(s), copy.deepcopy(s)
                    if dewarp:
                        a.pose[:] = poses[k]
                        b.pose[:] = poses[k]
                    for x, lt, key in ((a, lut, "cache"),
                                       (b, host_lut, "host LUT")):
                        t0 = time.perf_counter()
                        derived.filter_xyz(x, lt, 2, -1.0, 0.5,
                                           dewarp_points=dewarp)
                        times[key] += time.perf_counter() - t0
                    check(scans_differ(a, b) == 0,
                          f"filter_xyz frame {s.frame_id}: the cache and "
                          f"the f64 host LUT disagree")
            check(calls.hits == 2 * HOST_FRAMES and calls.misses == 0,
                  f"filter_xyz: {calls.hits} cache hits, {calls.misses} "
                  f"misses")
        before = pk.launches["planar"]
        clipped, _ = read(lambda: port.open_source(outs["osf"][0]).clip(
            ["RANGE"], 30000, 2**32), None, "OSF read, clip", False)
        check(pk.launches["planar"] - before == windows,
              "the clipped OSF view did not project through the kernel")
        with xyz_cache_calls(port.LidarScan) as calls:
            for ls in clipped:
                a, b = ls[0], copy.deepcopy(ls[0])
                derived.filter_xyz(a, lut, 2, -1.0, 0.5)
                derived.filter_xyz(b, host_lut, 2, -1.0, 0.5)
                check(scans_differ(a, b) == 0, "filter_xyz after clip")
        check(calls.misses == HOST_FRAMES and calls.hits == HOST_FRAMES,
              f"filter_xyz after clip(RANGE): {calls.misses} misses, "
              f"{calls.hits} hits; expected RANGE to miss, RANGE2 to hit")
        print(f"host layer filter_xyz(scan, XYZLut(info), z in [-1, 0.5] m)"
              f" on {HOST_FRAMES} OSF scans, without and with dewarp: "
              f"{4 * HOST_FRAMES} cache hits, 0 misses, equal to the f64 "
              f"host LUT; {times['cache'] / (2 * HOST_FRAMES) * 1e3:.2f} "
              f"ms/scan from the cache, "
              f"{times['host LUT'] / (2 * HOST_FRAMES) * 1e3:.2f} ms/scan "
              f"through the host LUT; after clip(RANGE): RANGE missed "
              f"{HOST_FRAMES} of {HOST_FRAMES}, RANGE2 hit [{CARD}]")

        # 4. a custom profile, on the card against the batcher
        nr, name = CUSTOM_PROFILE
        profiles.add_custom_profile(nr, name, [
            ("RANGE", profiles.FieldInfo(0, 20)),
            ("REFLECTIVITY", profiles.FieldInfo(32, 8)),
            ("SIGNAL", profiles.FieldInfo(48, 16)),
            ("CUSTOM0", profiles.FieldInfo(64, 12)),
            ("RAW32_WORD1", profiles.FieldInfo(0, 32))], 12)
        try:
            cinfo = copy.deepcopy(info)
            cinfo.format.udp_profile_lidar = name
            check(de.supports_device_decode(cinfo),
                  "the custom profile is not on the device route")
            pw = PacketWriter(cinfo.format)
            rng = np.random.default_rng(13)
            pkts = []
            for payload, ts in synth_packets(cinfo, range(1, 5), seed=14):
                buf = np.frombuffer(payload, np.uint8).copy()
                pw.set_field(buf, "CUSTOM0", rng.integers(
                    0, 1 << 12, (cinfo.h, pw.columns_per_packet)))
                pkts.append((bytes(buf), ts))
            cpath = os.path.join(work, "custom.pcap")
            write_capture(cpath, pkts)
            got, secs = read(lambda: port.open_source(
                cpath, sensor_info=[cinfo]), None, "custom profile", True)
            want, _ = read(lambda: port.open_source(
                cpath, sensor_info=[cinfo]), "0", "custom profile (batcher)",
                False)
            check(len(got) == len(want) == 4
                  and "CUSTOM0" in got[0][0].fields
                  and (got[0][0].field("CUSTOM0") != 0).any(),
                  f"custom profile: {len(got)} and {len(want)} scans")
            n = sum(scans_differ(a[0], b[0]) for a, b in zip(got, want))
            check(n == 0, f"custom profile: {n} elements differ")
            print(f"host layer add_custom_profile({nr}, {name!r}): 4 frames "
                  f"of {cinfo.h}x{cinfo.w} decoded by the engine on the "
                  f"card, 0 elements differ from the ScanBatcher "
                  f"({len(list(got[0][0].fields))} fields, CUSTOM0 "
                  f"included); {secs / 4 * 1e3:.2f} ms/scan [{CARD}]")
        finally:
            profiles._custom_profiles.pop(name, None)
            profiles._custom_scan_slots.pop(name, None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return pk.launches["planar"] - launches0



# -- the live path -----------------------------------------------------------

LIVE_FRAMES = 40       # a paced run of the scan path
INGEST_FRAMES = 20     # a paced run of the planar ingest


def free_udp_ports(n: int):
    """n distinct free loopback UDP ports."""
    import socket

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def live_sensor(profile: str, w: int, sn: int, n_frames: int, seed: int,
                h: int = 128):
    """A live sensor (synth_info with a serial and an init id) and its
    frames 1..n_frames as lists of packet payloads (synth_packets)."""
    info = synth_info(profile, w=w, h=h)
    info.sn, info.init_id = sn, 7
    n = w // info.format.columns_per_packet
    pkts = [p for p, _ in synth_packets(info, range(1, n_frames + 1), seed)]
    return info, [pkts[k * n:(k + 1) * n] for k in range(n_frames)]


def paced(frames, period_ns: int = 100_000_000):
    """A SensorEmulator packets factory: the frames in order, a frame a
    period, its packets spread evenly over the period, as a sensor sends
    them."""
    def make():
        for f, pkts in enumerate(frames):
            for p, payload in enumerate(pkts):
                yield f * period_ns + p * period_ns // len(pkts), "lidar", \
                    payload
    return make


def record_lidar(packets) -> list:
    """Wrap a SensorPacketSource's classifier: every lidar packet it
    passes on is appended to the returned list as (sensor, payload,
    host_ts), in arrival order: what the batcher thread was fed."""
    seen = []
    classify = packets._classify

    def record(idx, data, ts):
        pkt = classify(idx, data, ts)
        if pkt is not None and pkt.type().value == "Lidar":
            seen.append((idx, data, ts))
        return pkt

    packets._classify = record
    return seen


def recorded_oracle(port, info, seen, idx: int = 0) -> dict:
    """{frame_id: scan} of the port's ScanBatcher over one sensor's
    recorded packets, with their receive timestamps."""
    batcher, cur, out = port.ScanBatcher(info), port.LidarScan(info), {}
    for i, data, ts in seen:
        if i == idx and batcher(port.LidarPacket(data, ts), cur):
            out[cur.frame_id] = cur
            cur = port.LidarScan(info)
    return out


def whole(scan) -> bool:
    """Whether every packet of the scan's frame arrived."""
    return int(np.count_nonzero(scan.packet_timestamp)) == \
        scan.packet_timestamp.size


def hold_live(port, infos, got, seen, what: str) -> int:
    """Every received scan against the port's ScanBatcher over the same
    received packets: 0 differing elements, headers included. Returns the
    count of scans whose every packet arrived."""
    oracles = [recorded_oracle(port, info, seen, k)
               for k, info in enumerate(infos)]
    n = n_whole = 0
    for k, scan in got:
        check(scan.frame_id in oracles[k],
              f"{what}: sensor {k} frame {scan.frame_id} not released by "
              f"the ScanBatcher")
        n += scans_differ(scan, oracles[k][scan.frame_id])
        n_whole += whole(scan)
    check(n == 0, f"{what}: {n} elements differ from the ScanBatcher's scans")
    return n_whole


def thread_cpu_s(native_id: int) -> float:
    """CPU seconds (user + system) one thread of this process has used,
    from /proc (10 ms ticks)."""
    with open(f"/proc/self/task/{native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def live_run(port, infos, frames, rate: float, engine: str = "auto",
             touch: bool = True, record: bool = True, device=None):
    """Emulators for `infos` serving `frames` paced at `rate` x real time
    -> one SensorScanSource (open_source for the auto engine, the class
    with its engine option otherwise) on `device` (None: CUDA) ->
    LidarScanSets on the main thread, every scan touched unless `touch` is
    False (a field read: the deferred readback). Returns the
    scans as (sensor, scan), their arrival times by sensor, the sets, the
    source (closed; its first lidar socket's effective SO_RCVBUF in
    `src.rcvbuf`; in `src.cpu` the CPU seconds a second of the run that
    the consumer, the batcher thread and the emulators' senders used) and
    the recorded packets."""
    import socket

    from ouster_sdk_tpu_torch.sensor import ClientTimeout, SensorScanSource
    from ouster_sdk_tpu_torch.sensor.emulator import SensorEmulator

    emus, hosts = [], []
    for info, fr in zip(infos, frames):
        lp, ip = free_udp_ports(2)
        info.config.udp_port_lidar, info.config.udp_port_imu = lp, ip
        emus.append(SensorEmulator(info, paced(fr), lidar_port=lp,
                                   imu_port=ip, rate=rate))
        hosts.append(f"127.0.0.1:{emus[-1].http_port}")
    kw = dict(sensor_info=infos, timeout=1.0, queue_size=2 * len(infos),
              device=device)
    if engine == "auto" and len(infos) == 1:
        src = port.open_source(hosts[0], **kw)
    else:
        src = SensorScanSource(hosts, engine=engine, **kw)
    seen = record_lidar(src._packets) if record else []
    src.rcvbuf = src._packets._clients[0].lidar_sock.getsockopt(
        socket.SOL_SOCKET, socket.SO_RCVBUF)
    got, times, sets = [], [[] for _ in infos], []
    n_want = sum(len(fr) for fr in frames)
    threads = {"consumer": threading.get_native_id(),
               "batcher": src._thread.native_id}
    done = threading.Event()
    try:
        for emu in emus:
            emu.start()
        threads.update({f"sender {k}": emu._send_thread.native_id
                        for k, emu in enumerate(emus)})
        cpu0 = {k: thread_cpu_s(t) for k, t in threads.items()}
        last = dict(cpu0)

        def sample():       # a sender's /proc entry goes when it ends
            while not done.wait(0.05):
                for k, t in threads.items():
                    try:
                        last[k] = thread_cpu_s(t)
                    except OSError:
                        pass

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t_start = time.perf_counter()
        it = iter(src)
        while len(got) < n_want:
            try:
                ls = next(it)
            except ClientTimeout:
                break           # the stream ended with scans missing
            now = time.perf_counter()
            for k, scan in enumerate(ls):
                if scan is None:
                    continue
                if touch:
                    scan.field("RANGE")
                got.append((k, scan))
                times[k].append(now)
            sets.append(ls)
        wall = time.perf_counter() - t_start
        done.set()
        sampler.join()
        src.cpu = {k: (last[k] - cpu0[k]) / wall for k in threads}
    finally:
        done.set()
        src.close()
        for emu in emus:
            emu.stop()
    return got, times, sets, src, seen


def live_rate(times, n_frames: int, rate: float, drops: int,
              fps: float = 10.0):
    """(scans/s between the first and the last scan, real time x): a
    complete zero-drop stream at pace R proves >= R x real time, so the
    figure is capped at the pace then (bench.py's rule)."""
    sps = ((len(times) - 1) / (times[-1] - times[0])
           if len(times) > 1 and times[-1] > times[0] else 0.0)
    complete = len(times) >= n_frames and drops == 0
    return sps, (min(sps / fps, rate) if complete else sps / fps)


def _run_live(torch, port, pk, dev, main_info) -> dict:
    """The live path: the port's SensorEmulator on loopback serving the
    main cell (128x2048 dual, 10 Hz) -> open_source("127.0.0.1:<port>") ->
    SensorScanSource (recvmmsg, batcher thread, LiveDeviceBatcher on the
    card) -> LidarScans touched on the main thread, at 1x, 2x and 4x real
    time; the device and numpy engines in turns at 2x; two sensors through
    one source, collated; and the planar ingest (SensorPacketSource ->
    PlanarStreamAssembler -> decode_planar + project_planar -> destagger)
    of the main cell and of a single-return sensor. Returns the planar
    kernel's launches on the ingest by case."""
    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.utils import native

    os.environ.pop("OUSTER_SDK_TPU_DEVICE_DECODE", None)
    t0 = time.perf_counter()
    info, frames = live_sensor(MAIN_PROFILE, 2048, 992240000040,
                               LIVE_FRAMES, seed=21)
    check(main_info.format.udp_profile_lidar == info.format.udp_profile_lidar,
          "the live sensor is not the main cell's")
    print(f"live: synthesized {LIVE_FRAMES} frames of 128x2048 "
          f"{MAIN_PROFILE} ({sum(len(p) for p in frames[0]) / 1e6:.2f} MB "
          f"a frame in {len(frames[0])} packets) in "
          f"{time.perf_counter() - t0:.1f} s [{CARD}]")

    # 1. the scan path, one sensor, at 1x, 2x, 4x real time; the batcher
    # thread's CPU split into the receive (select, recvmmsg, a copy and
    # the id check a packet) and the pushes (of which the flushes)
    from ouster_sdk_tpu_torch.sensor import SensorPacketSource

    for rate in (1.0, 2.0, 4.0):
        native.reset_calls()
        before = de.stats["batches"]
        with count_calls(SensorPacketSource, "_poll_once") as recv, \
                count_calls(de.LiveDeviceBatcher, "push") as push, \
                count_calls(de.LiveDeviceBatcher, "_flush") as flush:
            got, times, _, src, seen = live_run(port, [info], [frames], rate)
        batches = de.stats["batches"] - before
        n_whole = hold_live(port, [info], got, seen, f"live {rate}x")
        sps, rt = live_rate(times[0], LIVE_FRAMES, rate, src.dropped_scans)
        print(f"live scan path 128x2048 dual paced at {rate}x: received "
              f"{len(got)} of {LIVE_FRAMES} frames ({n_whole} with every "
              f"packet), {max(len(got) - 1, 0)} of {LIVE_FRAMES - 1} "
              f"intervals, {sps:.2f} scans/s = {rt:.2f}x real time, "
              f"dropped_scans {src.dropped_scans}, engine {src.engine_used}, "
              f"{batches} engine batches, udp_recv_batch calls "
              f"{native.calls['udp_recv_batch']}, SO_RCVBUF {src.rcvbuf}; "
              f"every scan touched on the main thread, 0 elements from the "
              f"ScanBatcher over the packets received; CPU s a second of "
              f"the run: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in src.cpu.items())
              + f"; batcher thread CPU a scan: receive "
              f"{recv.cpu / len(got) * 1e3:.2f} ms ({recv.n} polls), pushes "
              f"{push.cpu / len(got) * 1e3:.2f} ms, of which flushes "
              f"{flush.cpu / len(got) * 1e3:.2f} ms (wall "
              f"{flush.seconds / max(flush.n, 1) * 1e3:.2f} ms a flush) "
              f"[{CARD}]")
        check(src.engine_used == ["device"] and src.device.type == "cuda",
              f"live {rate}x: engine {src.engine_used} on {src.device}")
        check(native.calls["udp_recv_batch"] > 0,
              "live: the sockets were not drained by recvmmsg")
        check(batches == len(got), f"live {rate}x: {batches} engine batches "
              f"for {len(got)} scans")
        if rate == 1.0:
            check(len(got) == LIVE_FRAMES and n_whole == LIVE_FRAMES
                  and src.dropped_scans == 0,
                  f"live 1x: {len(got)} scans, {n_whole} whole, "
                  f"{src.dropped_scans} dropped of {LIVE_FRAMES}")

    # 2. the device engine and the numpy ScanBatcher in turns at 2x
    turns = {"device": [], "numpy": []}
    for _ in range(3):
        for engine in turns:
            got, times, _, src, _ = live_run(
                port, [info], [frames[:INGEST_FRAMES]], 2.0, engine=engine,
                record=False)
            sps, rt = live_rate(times[0], INGEST_FRAMES, 2.0,
                                src.dropped_scans)
            turns[engine].append((sps, len(got), src.dropped_scans))
    print("live in turns at 2x, 20 frames, scans/s (received, dropped): "
          + "; ".join(f"{e} " + ", ".join(f"{v:.2f} ({n}, {d})"
                                          for v, n, d in vals)
                      for e, vals in turns.items()) + f" [{CARD}]")

    # 3. two sensors through one source, collated, at 1x
    two = [live_sensor(MAIN_PROFILE, 1024, 992240000001, LIVE_FRAMES, 31),
           live_sensor(SINGLE_PROFILE, 2048, 992240000002, LIVE_FRAMES, 32)]
    got, times, sets, src, seen = live_run(
        port, [i for i, _ in two], [f for _, f in two], 1.0, engine="device")
    n_whole = hold_live(port, [i for i, _ in two], got, seen, "live two")
    full = sum(all(s is not None for s in ls) for ls in sets)
    per = [live_rate(t, LIVE_FRAMES, 1.0, src.dropped_scans) for t in times]
    print(f"live two sensors (1024x10 dual + 2048x10 single) at 1x: "
          f"{len(got)} scans ({n_whole} whole), {full} full sets of "
          f"{len(sets)}, per sensor "
          + ", ".join(f"{len(t)} scans {sps:.2f} scans/s ({rt:.2f}x)"
                      for t, (sps, rt) in zip(times, per))
          + f", dropped_scans {src.dropped_scans}, engines "
          f"{src.engine_used}; 0 elements from the ScanBatcher; CPU s a "
          f"second of the run: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in src.cpu.items())
          + f" [{CARD}]")
    check(src.engine_used == ["device", "device"] and full > 0
          and all(len(t) > 0 for t in times),
          f"live two sensors: {full} full sets, engines {src.engine_used}")

    # 4. the planar ingest, main cell and a single-return sensor
    single, sframes = live_sensor(SINGLE_PROFILE, 2048, 992240000003,
                                  INGEST_FRAMES // 2, 41)
    launched = {}
    for sinfo, fr in ((info, frames[:INGEST_FRAMES]), (single, sframes)):
        launched.update(_live_planar_ingest(torch, port, pk, dev, sinfo, fr))
    return launched


def _live_planar_ingest(torch, port, pk, dev, info, frames) -> dict:
    """emulator -> SensorPacketSource -> PlanarStreamAssembler ->
    ScanPipeline(cuda).decode_planar + project_planar -> destagger, paced
    at 1x: one planar_project launch a released frame, XYZ bit-equal to
    the plain version on the card and within 1 f32 ulp of the f64 LUT,
    RANGE equal to PacketFormat's read of the packets."""
    from ouster_sdk_tpu_torch.sensor import SensorPacketSource
    from ouster_sdk_tpu_torch.sensor.emulator import SensorEmulator

    lp, ip = free_udp_ports(2)
    info.config.udp_port_lidar, info.config.udp_port_imu = lp, ip
    emu = SensorEmulator(info, paced(frames), lidar_port=lp, imu_port=ip)
    src = SensorPacketSource([f"127.0.0.1:{emu.http_port}"],
                             sensor_info=[info])
    asm = port.PlanarStreamAssembler(info)
    pipe = port.ScanPipeline(info, device=dev)
    case = "planar_dual" if pipe.dual else "planar"
    counts, out, ms, last = {}, [], [], []

    def project(rel):
        fid, planes, hdrs, _ = rel
        last[:] = [planes.copy(), hdrs.copy()]    # for the split below
        t0 = time.perf_counter()
        planes_d = pk.words_tensor(planes[None], dev)
        hdrs_d = pk.words_tensor(hdrs[None], dev)
        fields = pipe.decode_planar(planes_d, hdrs_d)
        xyz = pipe.project_planar(planes_d, hdrs_d)
        xyz_d = [port.destagger_torch(x, pipe.shifts)
                 for x in (xyz if pipe.dual else (xyz,))]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        # kept for the checks below: a CPU tensor would be a view of the
        # assembler's pool, which the next-but-one release rewrites
        out.append((fid, planes_d.clone(), hdrs_d.clone(), fields, xyz,
                    xyz_d))

    pk.reset_launches()
    try:
        emu.start()
        deadline = time.monotonic() + len(frames) / 10 + 10
        while time.monotonic() < deadline:
            _, pkt = src.get_packet(timeout_sec=0.5)
            if pkt is None:
                if emu.passes_completed:
                    break
                continue
            fid = asm.pf.frame_id(pkt.buf)
            counts[fid] = counts.get(fid, 0) + 1
            rel = asm.push(pkt)
            if rel is not None:
                project(rel)
        rel = asm.flush()
        if rel is not None:
            project(rel)
    finally:
        src.close()
        emu.stop()
    launches = dict(pk.launches)
    n_pkts = len(frames[0])
    check(launches[case] == len(out) and sum(launches.values()) == len(out)
          and len(out) > 0,
          f"planar ingest: {launches} for {len(out)} released frames")
    pf = port.PacketFormat.from_info(info)
    lut64 = port.make_xyz_lut(info)
    names = ("RANGE", "RANGE2") if pipe.dual else ("RANGE",)
    n_diff = n_whole = 0
    worst = 0.0
    for fid, planes_d, hdrs_d, fields, xyz, xyz_d in out:
        want = pk.unpack_project_planar_batched_plain(
            planes_d, hdrs_d, pipe.planar_lut.stack, pipe.plan,
            dual=pipe.dual)
        n_diff += compare(xyz, want, f"planar ingest frame {fid}")[1]
        check(all(x.shape == (1, 3, pipe.plan.h, pipe.plan.w) for x in xyz_d),
              "planar ingest: destaggered XYZ shape")
        if counts.get(fid) != n_pkts:
            continue
        n_whole += 1
        bufs = np.stack([np.frombuffer(p, np.uint8) for p in frames[fid - 1]])
        valid = np.concatenate([pf.col_status(b) for b in bufs]) & 1
        for k, name in enumerate(names):
            r = fields[name].cpu().numpy().astype(np.int64)
            host = np.concatenate(list(pf.packet_field_all(name, bufs)),
                                  axis=1).astype(np.int64)
            check(np.array_equal(r[0], np.where(valid[None, :] != 0, host,
                                                0)),
                  f"planar ingest frame {fid}: decoded {name} differs from "
                  f"PacketFormat's read of the packets")
            worst = max(worst, ulp_check(as_tuple(xyz)[k].cpu().numpy(),
                                         f64_reference(lut64, r)))
    check(n_whole > 0 and worst <= 1.0,
          f"planar ingest: {n_whole} whole frames, {worst} ulp from f64")
    # the same steps on the last frame, warm, with the stream stopped
    planes, hdrs = last
    planes_d, hdrs_d = (pk.words_tensor(planes[None], dev),
                        pk.words_tensor(hdrs[None], dev))
    xyz = pipe.project_planar(planes_d, hdrs_d)
    steps = {
        "copy in": lambda: (pk.words_tensor(planes[None], dev),
                            pk.words_tensor(hdrs[None], dev)),
        "decode": lambda: pipe.decode_planar(planes_d, hdrs_d),
        "project": lambda: pipe.project_planar(planes_d, hdrs_d),
        "destagger": lambda: [port.destagger_torch(x, pipe.shifts)
                              for x in as_tuple(xyz)]}
    split = {}
    for name, fn in steps.items():
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        split[name] = best * 1e3
    med = float(np.median(ms))
    print(f"live planar ingest {info.format.udp_profile_lidar.value} "
          f"128x{pipe.plan.w} at 1x: {len(out)} frames released "
          f"({n_whole} with every packet) -> {launches[case]} launches of "
          f"planar_project<{case}>, {n_diff} elements from the plain version "
          f"on the card, within {worst:.3f} f32 ulp of the f64 LUT, RANGE "
          f"equal to PacketFormat's read; release -> XYZ (copy in, decode, "
          f"project, destagger) {med:.3f} ms a frame (median of {len(ms)}, "
          f"min {min(ms):.3f}, max {max(ms):.3f}); the steps warm with the "
          f"stream stopped, best of 5: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" [{CARD}]")
    return {case: launches[case]}


# -- wire replay: packed and BP64 staging -> one fused upload -> decode ----

E2E_BATCH = 8        # frames a chunk, the JAX bench's E2E_BATCH
WIRE_PASSES = 5      # timed passes a cell, after two warm passes


def scene_ranges(info) -> np.ndarray:
    """Ray-cast the sensor's beam grid against a box room (12 x 8 x 4 m,
    sensor at 1 m) with two cylindrical pillars -> (h, w) f64 range in mm
    (0 where no geometry): piecewise-smooth surfaces with edges, what real
    captures look like (a numpy copy of the JAX bench's scene)."""
    h = info.format.pixels_per_column
    w = info.format.columns_per_frame
    az = np.deg2rad(np.asarray(info.beam_azimuth_angles, float))
    alt = np.deg2rad(np.asarray(info.beam_altitude_angles, float))
    theta = 2 * np.pi * (np.arange(w) / w)[None, :] + az[:, None]
    phi = alt[:, None]
    d = np.stack([np.cos(phi) * np.cos(theta),
                  np.cos(phi) * np.sin(theta),
                  np.broadcast_to(np.sin(phi), (h, w))], axis=-1)
    o = np.array([0.0, 0.0, 1.0])
    bounds = ((-6.0, 6.0), (-4.0, 4.0), (0.0, 4.0))
    t = np.full((h, w), np.inf)
    for axis in range(3):
        for b in bounds[axis]:
            denom = d[..., axis]
            tt = np.where(np.abs(denom) > 1e-9,
                          (b - o[axis]) / np.where(np.abs(denom) > 1e-9,
                                                   denom, 1.0), np.inf)
            tt = np.where(tt > 0.05, tt, np.inf)
            p = o[None, None] + d * tt[..., None]
            ok = np.isfinite(tt)
            for a2 in range(3):
                if a2 == axis:
                    continue
                lo, hi = bounds[a2]
                ok &= (p[..., a2] >= lo - 1e-6) & (p[..., a2] <= hi + 1e-6)
            t = np.where(ok, np.minimum(t, tt), t)
    for cx, cy, r in ((2.5, 1.0, 0.3), (-1.5, -2.0, 0.5)):
        dx, dy = d[..., 0], d[..., 1]
        ox, oy = -cx, -cy
        A = np.maximum(dx * dx + dy * dy, 1e-12)
        B = 2 * (ox * dx + oy * dy)
        C = ox * ox + oy * oy - r * r
        disc = B * B - 4 * A * C
        tt = np.where(disc > 0,
                      (-B - np.sqrt(np.maximum(disc, 0))) / (2 * A), np.inf)
        tt = np.where(tt > 0.05, tt, np.inf)
        z = o[2] + d[..., 2] * tt
        t = np.minimum(t, np.where((z >= 0) & (z <= 4), tt, np.inf))
    return np.where(np.isfinite(t), t * 1000.0, 0.0)


def synth_scene_packets(info, n_frames: int, dual: bool, seed: int = 2):
    """Lidar packets of a scene capture (frame ids 1..n_frames) as (payload
    bytes, host_ts): scene_ranges with sensor noise (sigma 3 mm) and 4 %
    dropouts a frame, and where dual, second returns 300 mm behind on 15 %
    of the valid pixels; every column valid (the JAX bench's scene
    capture)."""
    from ouster_sdk_tpu_torch.ops.packet_format import PacketWriter

    base = scene_ranges(info)
    pw = PacketWriter(info.format)
    cpp = pw.columns_per_packet
    rng = np.random.default_rng(seed)
    ts = 10**9
    for fid in range(1, n_frames + 1):
        noise = rng.normal(0, 3.0, size=base.shape)
        v = np.clip(base + noise, 0, (1 << 19) - 1).astype(np.uint64)
        v[base == 0] = 0
        v[rng.random(base.shape) < 0.04] = 0
        if dual:
            second = (v + 300 + rng.normal(0, 3.0, size=base.shape)
                      .astype(np.int64)).astype(np.uint64)
            second[v == 0] = 0
            second[rng.random(base.shape) >= 0.15] = 0
            second = np.minimum(second, (1 << 19) - 1)
        for p in range(info.format.columns_per_frame // cpp):
            buf = pw.new_packet()
            pw.set_packet_header(buf, init_id=info.init_id, prod_sn=info.sn)
            pw.set_frame_id(buf, fid)
            m0 = p * cpp
            pw.set_col_headers(
                buf, np.arange(cpp, dtype=np.uint64) + m0 * 1000,
                np.arange(cpp, dtype=np.uint16) + m0,
                np.ones(cpp, dtype=np.uint32))
            pw.set_field(buf, "RANGE", v[:, m0:m0 + cpp])
            if dual:
                pw.set_field(buf, "RANGE2", second[:, m0:m0 + cpp])
            yield bytes(buf), ts
            ts += 10**5
        ts += 10**7


def _run_wire(torch, port, pk, dev, tmp, main_info, main_path) -> dict:
    """Wire replay, the JAX bench's e2e_run: pcap -> FrameReader.
    iter_bp64_chunks / iter_packed_chunks -> fused_pipelined (ChunkFuser on
    the staging thread) -> one pageable host->device copy a chunk ->
    unfuse_words -> project_bp64_batched / project_packed_batched
    (planar_project once a chunk) -> a sum on the device, no readback in a
    pass. Four cells: 128x2048 dual (32 frames) and 128x1024 single (64
    frames), a scene through BP64 and white noise through packed staging.
    Returns the hold passes' launches by case."""
    single_info = synth_info(SINGLE_PROFILE, w=1024)
    noise_single = os.path.join(tmp, "wire_noise_128x1024.pcap")
    synth_capture(noise_single, single_info, 64)
    cells = []
    for tag, info, n, noise in (("128x2048_dual", main_info, 32, main_path),
                                ("128x1024_single", single_info, 64,
                                 noise_single)):
        scene = os.path.join(tmp, f"wire_scene_{tag}.pcap")
        t0 = time.perf_counter()
        write_capture(scene, synth_scene_packets(
            info, n, info.format.udp_profile_lidar.value == MAIN_PROFILE))
        print(f"synthesized the {tag} scene ({n} frames, "
              f"{os.path.getsize(scene) / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s")
        cells.append((tag, "scene", "bp64", info, scene, n))
        cells.append((tag, "noise", "packed", info, noise, n))
    launched = {}
    for cell in cells:
        for case, k in _wire_cell(torch, port, pk, dev, *cell).items():
            launched[case] = launched.get(case, 0) + k
    return launched


def _wire_cell(torch, port, pk, dev, tag, kind, codec, info, path,
               n_frames) -> dict:
    from ouster_sdk_tpu_torch.ops import bp64 as bp
    from ouster_sdk_tpu_torch.ops import packed as pa
    from ouster_sdk_tpu_torch.utils import native

    B = E2E_BATCH
    what = f"wire replay [{tag}/{kind}/{codec}]"
    pipe = port.ScanPipeline(info)
    plan, lut, dual = pipe.plan, pipe.planar_lut.stack, pipe.dual
    fields, nbits, ups = pa.packed_range_fields(plan, dual)
    reader = port.FrameReader(path, info)

    def chunks():
        it = (reader.iter_bp64_chunks if codec == "bp64"
              else reader.iter_packed_chunks)
        return it(B, fields=fields, nbits=nbits, pool_depth=2)

    def select(item):
        # on the staging thread: pad the tail chunk to the batch
        fids, arrs = item[0], list(item[1:-1])
        n = fids.size
        if n < B:
            arrs = [np.concatenate([a, np.broadcast_to(
                a[-1:], (B - n,) + a.shape[1:])]) for a in arrs]
        return fids, arrs

    def ranges(parts):
        if codec == "bp64":
            return bp.bp64_ranges(*parts[:3], plan, ups, dual)
        return pa.packed_ranges(parts[0], plan, nbits, ups, dual)

    def project(parts, poses=None):
        fn = (bp.project_bp64_batched if codec == "bp64"
              else pa.project_packed_batched)
        return fn(*parts, lut.to(parts[0].device), plan, nbits,
                  upshifts=ups, dual=dual, poses=poses)

    def one_pass(limit=None, keep=None):
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        n = 0
        for fids, fused, layout in port.fused_pipelined(chunks, select,
                                                        depth=2):
            n += fids.size
            parts = pa.unfuse_words(
                torch.from_numpy(fused.view(np.int32)).to(dev), layout)
            out = as_tuple(project(parts))
            for o in out:
                acc = acc + o.sum()
            if keep is not None:
                keep.append((fids, parts, out, fused.nbytes))
            if limit is not None and n >= limit:
                break
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0, acc

    # the hold pass: launches counted from zero, outputs kept
    native.reset_calls()
    pk.reset_launches()
    kept = []
    n, _, _ = one_pass(keep=kept)
    launches = {k: v for k, v in pk.launches.items() if v}
    case = "planar_dual" if dual else "planar"
    check(n == n_frames and launches == {case: len(kept)},
          f"{what}: {n} of {n_frames} frames, launches {launches} for "
          f"{len(kept)} chunks")
    calls = dict(native.calls)
    want_calls = {"bp64_encode": n_frames} if codec == "bp64" else {
        "group_frames_packed": len(kept)}
    check(calls["pcap_scan"] == 1
          and all(calls[k] == v for k, v in want_calls.items()),
          f"{what}: native calls {calls}, expected {want_calls}")

    # every chunk's XYZ against the planar path on the same frames
    planar = {}
    for fids, planes, hdrs, _ in port.FrameReader(path, info) \
            .iter_planar_chunks(B):
        out = as_tuple(pk.unpack_project_planar_batched(
            pk.words_tensor(planes, dev), pk.words_tensor(hdrs, dev), lut,
            plan, dual=dual))
        for i, f in enumerate(fids):
            planar[int(f)] = [o[i] for o in out]
    check(sorted(planar) == sorted(int(f) for c in kept for f in c[0]),
          f"{what}: frame ids differ from the planar path's")
    n_planar = n_plain = 0
    for fids, parts, out, _ in kept:
        for i, f in enumerate(fids):
            for o, p in zip(out, planar[int(f)]):
                n_planar += int((o[i].view(torch.int32)
                                 != p.view(torch.int32)).sum())
        # the kernel against the plain version on the same device tensors
        plain = as_tuple(pk.project_ranges_batched_plain(
            ranges(parts), parts[-1], lut, plan))
        n_plain += sum(int((o.view(torch.int32) != q.view(torch.int32))
                           .sum()) for o, q in zip(out, plain))
    check(n_planar == 0 and n_plain == 0,
          f"{what}: {n_planar} elements differ from the planar path, "
          f"{n_plain} from the plain version")
    # one chunk with poses, on the card against the CPU's plain route
    parts = kept[0][1]
    poses = torch.from_numpy(random_poses(B, plan.w, seed=8))
    got = as_tuple(project(parts, poses.to(dev)))
    want = as_tuple(project([p.cpu() for p in parts], poses))
    n_poses = sum(int((g.cpu().view(torch.int32) != w.view(torch.int32))
                      .sum()) for g, w in zip(got, want))
    check(n_poses == 0, f"{what}: with poses {n_poses} elements differ "
          f"between the card and the CPU")
    check(all(torch.isfinite(o).all() for c in kept for o in c[2]),
          f"{what}: non-finite XYZ")

    # bytes shipped
    px = plan.h * plan.w * len(fields)
    if codec == "bp64":
        used = []
        for fids, parts, _, _ in kept:
            wid = parts[1][:fids.size].cpu().numpy().reshape(fids.size, -1)
            used += list(((wid & 0x1F).astype(np.int64) * 2
                          + (wid >> 7) * 2).sum(axis=1))
        pay_bits = float(np.mean(used)) * 32 / px
        bits = (f"{pay_bits:.2f} bits/px of payload, "
                f"{pay_bits + 40 / 64:.2f} with widths and anchors")
    else:
        bits = f"{nbits} bits/px"
    mb = kept[0][3] / B / 1e6

    # passes: two warm, one cheap chunk, then the timed ones
    one_pass()
    one_pass()
    one_pass(limit=B)
    native.reset_calls()
    passes = [one_pass()[:2] for _ in range(WIRE_PASSES)]
    calls = {k: v for k, v in native.calls.items() if v}
    rates = sorted(n / dt for n, dt in passes)

    # stages, warm: host staging alone, the encoder alone, copy in, decode,
    # projection
    def host_only():
        for _ in chunks():
            pass

    host_ms = min(_host_s(host_only) for _ in range(3)) / n_frames * 1e3
    encode = ""
    if codec == "bp64":
        planes = next(port.FrameReader(path, info).iter_planar_chunks(
            B, words=tuple(f[0] for f in fields)))[1]
        nb = plan.w // 64
        bits_ = np.asarray([f[1] for f in fields], np.int64)
        cap = len(fields) * plan.h * nb * (2 * (nbits + 1) + 2) + 2
        pay = np.zeros(cap, np.uint32)
        wid = np.zeros(len(fields) * plan.h * nb, np.uint8)
        anc = np.zeros(len(fields) * plan.h * nb, np.uint32)

        def encode_all():
            for fr in planes:
                native.bp64_encode(fr, bits_, nbits, pay, wid, anc)

        enc_ms = min(_host_s(encode_all) for _ in range(3)) / B * 1e3
        encode = f"native encode {enc_ms:.3f} ms/frame, "
    fids, parts, _, nbytes = kept[0]
    fused_np = np.zeros(nbytes // 4, np.int32)
    rs = ranges(parts)
    copy_ms = cuda_ms(lambda: torch.from_numpy(fused_np).to(dev), iters=10,
                      windows=3, warm=2)[0]
    dec_ms = cuda_ms(lambda: ranges(parts), iters=10, windows=3, warm=2)[0]
    proj_ms = cuda_ms(lambda: pk.project_ranges_batched(rs, parts[-1], lut,
                                                        plan),
                      iters=10, windows=3, warm=2)[0]
    print(f"{what}: {n_frames} frames in chunks of {B}, {len(kept)} "
          f"launches of planar_project<{case}> (1 a chunk), 0 elements "
          f"differ from the planar path and from the plain version, with "
          f"poses 0 between the card and the CPU; {bits}, {mb:.3f} MB a "
          f"frame shipped (fused buffer); native calls in {WIRE_PASSES} "
          f"passes {calls}")
    print(f"{what}: host staging {host_ms:.3f} ms/frame ({encode}best of "
          f"3), copy in {copy_ms / B:.4f} ms/frame (pageable), device "
          f"decode {dec_ms / B:.4f} ms/frame, projection {proj_ms / B:.4f} "
          f"ms/frame; {rates[-1]:.2f} frames/s best of {WIRE_PASSES} (min "
          f"{rates[0]:.2f}, median {rates[len(rates) // 2]:.2f}; "
          + "/".join(f"{n / dt:.2f}" for n, dt in passes) + f") [{CARD}]")
    return launches


def _host_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# -- the multi-device face ---------------------------------------------------

def _run_multi(torch, port, pk, dev, info, path, runs) -> dict:
    """ScanPipeline.sharded on a mesh of the one card and on the card
    listed twice (the split and the join run on it): project bit-equal to
    project_planar (dual, and with poses the first return), map_source
    over the main capture (every frame once, the tail padded),
    sharded_multi_sensor_step (XYZ bit-equal to ScanPipeline.batch, the
    centroid within rtol 1e-5 of a float64 sum) and
    fuse_multi_sensor_clouds (against the CPU). Returns the launches of
    project and map_source by case."""
    import copy

    pipe = port.ScanPipeline(info)
    fids, planes, hdrs, _, out, outw, poses = runs[0]
    n_frames = planes.shape[0]
    meshes = (("one card", port.make_mesh()),
              ("the card twice", port.make_mesh(devices=[dev, dev])))
    check(meshes[0][1].devices.size == torch.cuda.device_count(),
          "make_mesh() did not take every CUDA device")
    launched = {}
    for name, mesh in meshes:
        sp = pipe.sharded(mesh)
        k = sp.n_shards
        pk.reset_launches()
        got = sp.project(sp.shard(planes), sp.shard(hdrs))
        gotw = sp.project(sp.shard(planes), sp.shard(hdrs), sp.shard(poses))
        torch.cuda.synchronize()
        launches = {c: v for c, v in pk.launches.items() if v}
        check(launches == {"planar_dual": k, "planar_dewarp": k},
              f"multi-device {name}: launches {launches}")
        n_diff = sum(int((g.join().view(torch.int32)
                          != r.view(torch.int32)).sum())
                     for g, r in zip(got, out))
        n_diff += int((gotw.join().view(torch.int32)
                       != pipe.project_planar(planes, hdrs, poses=poses)[0]
                       .view(torch.int32)).sum())
        check(n_diff == 0, f"multi-device {name}: {n_diff} elements differ "
              f"from project_planar")
        ms = cuda_ms(lambda: sp.project(sp.shard(planes), sp.shard(hdrs)),
                     iters=5, windows=3, warm=1)[0]
        # map_source: chunks of 6, so the last of the 32 frames are padded
        pk.reset_launches()
        seen = []
        for cf, xyz in sp.map_source(port.FrameReader(path, info), chunk=6):
            check(xyz[0].shape == (6, 3, pipe.plan.h, pipe.plan.w),
                  f"multi-device {name}: map_source shape {xyz[0].shape}")
            joined = [x.join() for x in xyz]
            for i, f in enumerate(cf):
                seen.append(int(f))
                for j, r in zip(joined, out):
                    n_diff += int((j[i].view(torch.int32)
                                   != r[int(f) - 1].view(torch.int32)).sum())
            for i in range(cf.size, 6):     # the padding repeats the last
                n_diff += int((joined[0][i] != joined[0][cf.size - 1])
                              .sum())
        chunks = -(-n_frames // 6)
        launches = {c: v for c, v in pk.launches.items() if v}
        check(seen == list(range(1, n_frames + 1)) and n_diff == 0
              and launches == {"planar_dual": chunks * k},
              f"multi-device {name}: map_source frames {seen}, {n_diff} "
              f"elements differ, launches {launches}")
        for c, v in (("planar_dual", k + chunks * k), ("planar_dewarp", k)):
            launched[c] = launched.get(c, 0) + v
        print(f"multi-device {name} ({k} shards): project bit-equal to "
              f"project_planar ({n_frames} frames, dual, and with poses the "
              f"first return), map_source {len(seen)} frames once in "
              f"{chunks} chunks of 6 (the last padded), 0 elements differ; "
              f"project {ms:.3f} ms a call of {n_frames} frames [{CARD}]")

    # two sensors of one rig on a (sensor, frame) mesh
    info2 = copy.deepcopy(info)
    info2.beam_altitude_angles = list(np.linspace(21.5, -23.5,
                                                  info.format
                                                  .pixels_per_column))
    pipes = [pipe, port.ScanPipeline(info2)]
    frames = next(port.FrameReader(path, info).iter_chunks(4))[1]
    frames = np.stack([frames, frames])
    P_ = np.stack([random_poses(4, info.format.columns_per_frame, seed=s)
                   for s in (21, 22)])
    for name, mesh in (("one card", port.make_mesh_2d(1, 1)),
                       ("the card twice",
                        port.make_mesh_2d(2, 1, devices=[dev, dev]))):
        step, luts = port.parallel.sharded_multi_sensor_step(pipes, mesh)
        xyz, centroid = step(frames, luts, P_)
        xyz = xyz.join()
        total, count, n_diff = np.zeros(3), 0, 0
        for s in range(2):
            ref = pipes[s].batch(frames[s], torch.from_numpy(P_[s]))
            n_diff += int((xyz[s].view(torch.int32)
                           != ref["XYZ"].view(torch.int32)).sum())
            total += ref["XYZ"].double().sum(dim=(0, 1, 2)).cpu().numpy()
            count += int((ref["RANGE"].view(torch.int32) != 0).sum())
        rel = float(np.abs(centroid.cpu().numpy() - total / count).max()
                    / np.abs(total / count).max())
        check(n_diff == 0 and rel <= 1e-5,
              f"multi-sensor step on {name}: {n_diff} elements differ from "
              f"ScanPipeline.batch, centroid {rel:.3g} from the f64 sum")
        print(f"multi-sensor step on {name}: 2 sensors x 4 frames, XYZ 0 "
              f"elements from ScanPipeline.batch, centroid within "
              f"{rel:.3g} (rtol 1e-5) of the float64 sum")
    clouds = xyz.reshape(2, -1, 3)
    ext = np.stack([random_poses(1, 1, seed=s)[0, 0] for s in (31, 32)])
    got = port.parallel.fuse_multi_sensor_clouds(
        port.make_mesh(axis_name="sensor", devices=[dev, dev]), clouds, ext)
    want = port.parallel.fuse_multi_sensor_clouds(
        port.make_mesh(axis_name="sensor", devices=["cpu", "cpu"]),
        clouds.cpu(), ext)
    got = got.cpu().numpy()
    want = want.numpy()
    c64 = clouds.cpu().numpy()
    mag = np.concatenate([np.abs(c64[i]) @ np.abs(ext[i, :3, :3]).T
                          + np.abs(ext[i, :3, 3]) for i in range(2)])
    err = np.abs(got - want)
    check(got.shape == want.shape
          and (err <= 2 * np.spacing(mag.astype(np.float32))).all(),
          f"fuse_multi_sensor_clouds: card and CPU differ by {err.max()}")
    print(f"fuse_multi_sensor_clouds on the card twice: {got.shape[0]} "
          f"points, {int((err > 0).sum())} elements differ from the CPU, "
          f"max |d| {err.max():.3g} m (within 2 f32 ulp of the terms)")
    return launched



# -- SLAM on the card, the ICP's kernel, normals, voxel downsampling ---------

SLAM_VOXEL = 1.0      # m: KISS-ICP's voxel for a vehicle (max range / 100)
ICP_NN_SOURCE = "ouster_sdk_tpu_torch/kernels/csrc/icp_nn.cu"
ICP_NN_REPLACES = "ouster_sdk_tpu/slam/jax_icp.py:75 _chunked_nn " \
    "(XLA-fused, no Pallas)"
ICP_NN_LARGE = (8192, 524288)   # queries, map points


def _run_slam(torch, port, dev, tmp) -> dict:
    """The SLAM path: the yard capture (SLAM_FRAMES frames at 128x2048
    dual) -> open_source -> SlamEngine(SlamConfig(backend="device")) ->
    per-column poses in each scan, and the same with the host backend, in
    turns (device, host, device with TF32 allowed, host). Holds the device
    trajectory to the ground truth (per-frame translation delta <= 0.05 m
    once the vehicle cruises) and to the host one (<= 0.05 m), and the TF32
    run to the first device run bit for bit. Returns what the icp nn phase
    needs: the launches of the first device run, the inputs of the
    largest registration and the scene's world points; and what the cli
    phase needs: the first device run's scans with the poses it wrote
    (`run`), the ground truth relative to the first frame (`truth`) and
    the capture (`path`)."""
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.slam import device_icp as di
    from ouster_sdk_tpu_torch.slam import engine as se
    from ouster_sdk_tpu_torch.slam import kiss_icp as ki

    info = synth_info(MAIN_PROFILE)
    path = os.path.join(tmp, "yard.pcap")
    t0 = time.perf_counter()
    truth = yard_capture(port, path, info, SLAM_FRAMES)
    gt = np.linalg.inv(truth[0]) @ truth
    print(f"synthesized the yard ({SLAM_FRAMES} frames "
          f"{info.format.pixels_per_column}x{info.format.columns_per_frame} "
          f"dual, "
          f"{os.path.getsize(path) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")
    mid = (info.format.columns_per_frame - 1) // 2

    def drive(backend, keep=()):
        eng = se.SlamEngine([info], se.SlamConfig(backend=backend,
                                                  voxel_size=SLAM_VOXEL))
        if backend == "device":
            check(eng.device.type == "cuda", "SlamEngine did not pick cuda")
        poses, frames, written = [], [], True
        t0 = time.perf_counter()
        for k, scans in enumerate(port.open_source(path,
                                                   sensor_info=[info])):
            if k in keep:
                kept.append(scans[0])
            eng.update(scans)
            poses.append(eng.last_pose.copy())
            # the per-column poses written back: the middle column's is
            # the registered pose
            written &= bool(np.allclose(scans[0].pose[mid], poses[-1],
                                        atol=1e-9))
            if backend == "device":
                frames.append(dict(eng._kiss.last_frame))
        if backend == "device":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(len(poses) == SLAM_FRAMES, f"{backend}: {len(poses)} scans")
        check(written, f"{backend}: poses not written back into the scans")
        return np.stack(poses), frames, secs

    # the layers of a device run: host-clock timers around the host steps,
    # CUDA events around each icp_nn launch (no added sync)
    layer_fns = (("gather", se.SlamEngine, "_gather_frame"),
                 ("preprocess", ki.KissICP, "preprocess"),
                 ("voxelize", ki.KissICP, "voxelize"),
                 ("map pointcloud", ki.VoxelHashMap, "pointcloud"),
                 ("register_points_device", di, "register_points_device"),
                 ("map update", ki.VoxelHashMap, "update"))
    events, index_events, largest, gathered = [], [], {}, []

    def timed(fn, into):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            into.append((start, end))
            return out
        return call

    searches = {}      # id(index) -> (index, the queries of its searches)

    def timed_nn(src, *args, index=None, **kwargs):
        out = timed(nn.icp_nn, events)(src, *args, index=index, **kwargs)
        if index is not None:
            searches.setdefault(id(index), (index, []))[1].append(
                src.clone())
        map_pts = index.map_pts if index is not None else args[0]
        if map_pts.shape[0] > largest.get("m", -1):
            largest.update(m=map_pts.shape[0], src=src.clone(),
                           map=map_pts, voxel=index.voxel_size
                           if index is not None else args[2])
        return out

    gather = se.SlamEngine._gather_frame

    def kept_gather(self, scans, mid_pose_inv):
        out = gather(self, scans, mid_pose_inv)
        gathered.append((out, np.linalg.inv(mid_pose_inv)))
        return out

    # the host syncs of each registration as torch's sync debug mode counts
    # them (a read back, a pageable copy in) on the registering thread (the
    # engine's staging thread runs beside it), and where they were made:
    # the sync figure of the SLAM phase
    register = di.DeviceICP.register_frame
    frame_syncs = []

    def sync_window(fn):
        return synced(torch, fn, frame_syncs)

    # the first window in a process counts one sync of its own (at
    # torch/cuda/__init__.py), the next ones none: open one uncounted
    sync_window(lambda: None)
    frame_syncs.clear()

    def sync_counted(self, *args, **kwargs):
        return sync_window(lambda: register(self, *args, **kwargs))

    runs = {"device": [], "host": []}
    kept = []
    nn.reset_launches()
    dev_poses, frames, secs = drive("device", keep=range(SLAM_FRAMES))
    launches = nn.launches["icp_nn"]
    index_launches = nn.launches["icp_nn_index"]
    runs["device"].append(secs)
    host_poses, _, secs = drive("host")
    runs["host"].append(secs)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    counters = [count_calls(m, n) for _, m, n in layer_fns]
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        di.icp_nn = timed_nn
        di.build_icp_index = timed(nn.build_icp_index, index_events)
        se.SlamEngine._gather_frame = kept_gather
        for c in counters:
            c.__enter__()
        di.DeviceICP.register_frame = sync_counted
        tf32_poses, _, secs = drive("device")
    finally:
        di.DeviceICP.register_frame = register
        for c in counters:
            c.__exit__()
        se.SlamEngine._gather_frame = gather
        di.icp_nn = nn.icp_nn
        di.build_icp_index = nn.build_icp_index
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    runs["device"].append(secs)
    _, _, secs = drive("host")
    runs["host"].append(secs)

    check(launches > 0, "the SLAM path never launched icp_nn")
    check(launches == sum(f["iterations"] for f in frames),
          f"icp_nn launches {launches} != GN iterations")
    registrations = sum(1 for f in frames if f["m"] > 0)
    check(index_launches == registrations,
          f"icp_nn index builds {index_launches} != registrations "
          f"{registrations}")
    check(np.array_equal(tf32_poses, dev_poses),
          "the device trajectory changed with allow_tf32 = True")
    check(len(frame_syncs) == SLAM_FRAMES,
          f"{len(frame_syncs)} registrations in the sync-counted run")
    syncs = [len(w) for w in frame_syncs]
    print(f"slam: host syncs by torch's sync debug mode (the registering "
          f"thread, the TF32 run) {sum(syncs)} in {SLAM_FRAMES} frames; "
          f"where, frame 10: {sorted(set(frame_syncs[10]))}")
    for k, f in enumerate(frames):
        d_err = np.linalg.norm((dev_poses[k, :3, 3] - dev_poses[k - 1, :3, 3])
                               - (gt[k, :3, 3] - gt[k - 1, :3, 3])) \
            if k else 0.0
        h_err = np.linalg.norm((host_poses[k, :3, 3]
                                - host_poses[k - 1, :3, 3])
                               - (gt[k, :3, 3] - gt[k - 1, :3, 3])) \
            if k else 0.0
        apart = np.linalg.norm(dev_poses[k, :3, 3] - host_poses[k, :3, 3])
        print(f"slam frame {k}: N {f['n']} M {f['m']} iterations "
              f"{f['iterations']} icp_nn launches {f['iterations']} syncs "
              f"{syncs[k]}; delta error device {d_err:.4f} host "
              f"{h_err:.4f} m; device - host {apart:.5f} m; absolute error "
              f"device "
              f"{np.linalg.norm(dev_poses[k, :3, 3] - gt[k, :3, 3]):.4f} m")
        if k >= YARD_RAMP:
            check(d_err <= 0.05 and h_err <= 0.05,
                  f"frame {k}: delta error {d_err:.4f} (device), "
                  f"{h_err:.4f} (host) > 0.05 m")
    worst = float(np.linalg.norm(dev_poses[:, :3, 3] - host_poses[:, :3, 3],
                                 axis=1).max())
    check(worst <= 0.05, f"device trajectory {worst} m from the host one")
    print(f"slam: device trajectory within {worst:.5f} m of the host one; "
          f"TF32 run bit-equal; {launches} icp_nn launches, "
          f"{index_launches} index builds ({registrations} registrations), "
          f"{sum(syncs)} host syncs in "
          f"{SLAM_FRAMES} frames")
    for name, vals in runs.items():
        print(f"slam {name} backend: scans/s "
              + ", ".join(f"{SLAM_FRAMES / s:.2f}" for s in vals)
              + f" (open_source -> SlamEngine.update, {SLAM_FRAMES} frames, "
              f"in turns; the second device run with the layer timers and "
              f"torch's sync debug mode on) "
              f"[{CARD}]")
        FPS[f"slam {name}"] = SLAM_FRAMES / vals[0]
    nn_ms = sum(s.elapsed_time(e) for s, e in events)
    index_ms = sum(s.elapsed_time(e) for s, e in index_events)
    reg = counters[[n for n, _, _ in layer_fns].index(
        "register_points_device")]
    upload = sum(f["upload_s"] for f in frames) * 1e3
    for (name, _, _), c in zip(layer_fns, counters):
        print(f"slam layer {name}: {c.seconds * 1e3 / SLAM_FRAMES:.3f} "
              f"ms/frame ({c.n} calls)")
    print(f"slam layer map upload (pointcloud + copy, first device run): "
          f"{upload / SLAM_FRAMES:.3f} ms/frame")
    # the same searches and builds replayed with the host's issue taken out:
    # the card's own time a frame
    replay_ms = sum(device_ms(
        lambda ix=ix, qs=qs: [nn.build_icp_index(ix.map_pts, ix.map_valid,
                                                 ix.voxel_size)]
        + [nn.icp_nn(q, index=ix) for q in qs], iters=1, windows=3,
        warm=1)[0] for ix, qs in searches.values())
    print(f"slam layer icp_nn, device time (the run's {len(searches)} index "
          f"builds and {sum(len(q) for _, q in searches.values())} searches "
          f"replayed, device_ms): {replay_ms / SLAM_FRAMES:.4f} ms/frame "
          f"[{CARD}]")
    print(f"slam layer icp_nn (CUDA events around each call, host issue "
          f"included): search "
          f"{nn_ms / SLAM_FRAMES:.4f} ms/frame over {len(events)} launches, "
          f"index {index_ms / SLAM_FRAMES:.4f} ms/frame over "
          f"{len(index_events)} builds, together "
          f"{(nn_ms + index_ms) / SLAM_FRAMES:.4f} ms/frame; GN step and "
          f"syncs (register_points_device - icp_nn - index): "
          f"{(reg.seconds * 1e3 - nn_ms - index_ms) / SLAM_FRAMES:.3f} "
          f"ms/frame")
    return dict(launches=launches, index_launches=index_launches,
                largest=largest, gathered=gathered, frames=frames,
                info=info, scans=[kept[YARD_RAMP], kept[-1]], run=kept,
                truth=gt, path=path)


def _candidate_pairs(torch, nn, src, map_pts, voxel):
    """The (query, map point) pairs whose voxels lie within Chebyshev
    distance 1: the pairs the function needs to look at on these inputs,
    whatever the search (the kernel reads these alone); and the most of
    them any one query has."""
    sv = nn._voxels(src, voxel)
    per_query = torch.zeros(src.shape[0], dtype=torch.int64,
                            device=src.device)
    for k in range(0, map_pts.shape[0], 8192):
        mv = nn._voxels(map_pts[k:k + 8192], voxel)
        per_query += ((sv[:, None] - mv[None]).abs() <= 1).all(dim=-1) \
            .sum(dim=1)
    most = int(per_query.max()) if per_query.numel() else 0
    return int(per_query.sum()), most


def _icp_nn_times(torch, nn, src, map_pts, voxel):
    """The kernels against the plain version on the card, in both forms (a
    prebuilt index, and the one call that builds its own): equal indices
    and bit-equal distances; then three times (median of 7 CUDA-event
    windows): the search with a prebuilt index (what a Gauss-Newton
    iteration pays), the index build (once a registration) and the one
    call; the plain version's time; and the bounds. The search's bound is
    the function's: the larger of the bytes (each point read once, each
    result written once) over the HBM rate and 17 operations (8 for d2, 9
    for the voxel test) for each candidate pair over the no-FMA f32 rate.
    Times are device times (device_ms), the host's issue taken out.
    The build's bound is its bytes: the points read once, the
    packed points, the table and its starts written once. The brute-force
    figure, N x M pairs, is returned beside them."""
    n, m = src.shape[0], map_pts.shape[0]
    want = nn.icp_nn_reference(src, map_pts, None, voxel)
    index = nn.build_icp_index(map_pts, None, voxel)
    for form, got in (("prebuilt index", nn.icp_nn(src, index=index)),
                      ("one call", nn.icp_nn(src, map_pts, None, voxel))):
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]),
              f"icp_nn N={n} M={m} ({form}): "
              f"{int((got[1] != want[1]).sum())} indices differ from the "
              f"plain version")
        check(torch.equal(got[0].view(torch.int32),
                          want[0].view(torch.int32)),
              f"icp_nn N={n} M={m} ({form}): distances not bit-equal")
    fin = torch.isfinite(got[0])
    err = float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    ms, lo, hi = device_ms(lambda: nn.icp_nn(src, index=index))
    index_ms, index_lo, index_hi = device_ms(
        lambda: nn.build_icp_index(map_pts, None, voxel))
    one_ms = device_ms(lambda: nn.icp_nn(src, map_pts, None, voxel))[0]
    issue_ms = cuda_ms(lambda: nn.icp_nn(src, index=index), iters=20)[0]
    plain_ms = cuda_ms(lambda: nn.icp_nn_reference(src, map_pts, None,
                                                   voxel),
                       iters=1, windows=3, warm=1)[0]
    pairs, most = _candidate_pairs(torch, nn, src, map_pts, voxel)
    nbytes = n * 12 + m * 12 + n * 12
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = pairs * 17 / PEAK_F32_NO_FMA_PER_S * 1e3
    slots = nn.table_slots(m)
    index_bytes = m * 12 + m * 16 + slots * 20
    cells = int((index.cells[:, 3] > 0).sum()) if index.cells is not None \
        else -1                               # (a rehearsal on the CPU)
    return dict(max_abs_err=err, ms=ms, lo=lo, hi=hi, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                pairs=pairs, most=most,
                brute_ms=n * m * 17 / PEAK_F32_NO_FMA_PER_S * 1e3,
                with_candidate=int(fin.sum()), index_ms=index_ms,
                index_lo=index_lo, index_hi=index_hi,
                index_bound_ms=index_bytes / PEAK_BYTES_PER_S * 1e3,
                one_ms=one_ms, slots=slots, cells=cells, issue_ms=issue_ms)


def _icp_nn_line(n, m, t) -> str:
    return (f"icp_nn N={n} M={m} (device time, median of 5 windows of 20 "
            f"calls): search (prebuilt index) {t['ms']:.4f} ms (min "
            f"{t['lo']:.4f}, max {t['hi']:.4f}; {t['issue_ms']:.4f} ms a "
            f"call back to back, host issue included), "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}; {t['pairs']} "
            f"candidate pairs, {t['pairs'] / max(n, 1):.0f} a query, at "
            f"most {t['most']}), "
            f"{t['bound_ms'] / t['ms']:.2%} of bound; index build "
            f"{t['index_ms']:.4f} ms (min {t['index_lo']:.4f}, max "
            f"{t['index_hi']:.4f}; {t['cells']} voxels in {t['slots']} slots)"
            f", bytes bound {t['index_bound_ms']:.5f} ms, "
            f"{t['index_bound_ms'] / t['index_ms']:.2%} of it; one call "
            f"(build + search) {t['one_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.3f} ms; the brute-force N x M operation "
            f"figure {t['brute_ms']:.4f} ms; indices equal, distances "
            f"bit-equal in both forms ({t['with_candidate']} of {n} with a "
            f"candidate) [{CARD}]")


def icp_nn_cases(seed: int = 0):
    """Inputs (name, src, map_pts, map_valid, voxel) at which icp_nn must
    equal icp_nn_reference bit for bit: dense cells (500 points in one
    voxel), duplicated map points at equal distance under several indices,
    masked points, queries with no candidate, voxels saturated at the int32
    limits and at a wrapped distance of 2**31 (the reference's int32
    |a - b| <= 1 pairs them), voxel sizes of 0.05 and 2.0 m, N = 0, M = 0
    and an all-invalid map. numpy f32 arrays; map_valid bool or None."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    world = rng.uniform(-6, 6, (3000, 3)).astype(f32)
    src = (world[rng.integers(0, 3000, 700)]
           + rng.normal(0, 0.4, (700, 3))).astype(f32)
    dense = (0.05 + rng.uniform(0, 0.9, (500, 3))).astype(f32)
    dense = np.concatenate([dense, dense[:40] + f32(1.0)])
    dup = np.repeat(rng.uniform(-2, 2, (40, 3)).astype(f32), 6, axis=0)
    dup = dup[rng.permutation(len(dup))]
    sym = np.array([[1.5, .5, .5], [-.5, .5, .5], [.5, 1.5, .5],
                    [.5, -.5, .5], [.5, .5, 1.5], [.5, .5, -.5]], f32)
    sym = np.concatenate([sym, sym[::-1]])
    big = np.array([[3e9, .5, .5], [-3e9, .5, .5], [-3e9, -3e9, 3e9],
                    [2**30, .5, .5], [2**30, 2**30, .5], [.5, -3e9, .5],
                    [1e12, 1e12, -1e12]], f32)
    big_q = np.array([[.5, .5, .5], [3e9, .4, .5], [-3e9, .5, .6],
                      [-2**30, .5, .5], [-2**30, -2**30, .5],
                      [1e12, 1e12, -1e12], [-1e12, .5, .5], [.5, .5, 9]],
                     f32)
    fine = (world[rng.integers(0, 3000, 700)]
            + rng.normal(0, 0.03, (700, 3))).astype(f32)
    return [
        ("random, voxel 0.05", fine, world, None, 0.05),
        ("random, voxel 2.0", src, world, None, 2.0),
        ("masked", src, world, rng.random(3000) > 0.35, 1.0),
        ("dense cell", rng.uniform(-0.5, 2.5, (300, 3)).astype(f32), dense,
         None, 1.0),
        ("ties", np.concatenate([dup[:60], dup[:60] + f32(0.25)]), dup,
         None, 1.0),
        ("symmetric ties", np.full((3, 3), 0.5, f32), sym, None, 1.0),
        ("no candidate", rng.uniform(-1, 1, (50, 3)).astype(f32),
         np.full((5, 3), 100, f32), None, 1.0),
        ("saturated and wrapped voxels", big_q, big, None, 1.0),
        ("wrapped voxels alone", big_q[:5], big[[1, 2, 4]], None, 1.0),
        ("N = 0", np.zeros((0, 3), f32), world, None, 1.0),
        ("M = 0", src[:20], np.zeros((0, 3), f32), None, 1.0),
        ("all invalid", src[:20], world, np.zeros(3000, bool), 1.0),
    ]


def _icp_nn_cases_on_card(torch, nn, dev) -> str:
    """Every icp_nn_cases input on the card, both forms, against the plain
    version on the card: equal indices and bit-equal distances."""
    held = []
    for name, src, mp, valid, voxel in icp_nn_cases():
        s = torch.from_numpy(src).to(dev)
        m = torch.from_numpy(mp).to(dev)
        v = None if valid is None else torch.from_numpy(valid).to(dev)
        want = nn.icp_nn_reference(s, m, v, voxel)
        for form, got in (
                ("prebuilt index",
                 nn.icp_nn(s, index=nn.build_icp_index(m, v, voxel))),
                ("one call", nn.icp_nn(s, m, v, voxel))):
            torch.cuda.synchronize()
            check(torch.equal(got[1], want[1])
                  and torch.equal(got[0].view(torch.int32),
                                  want[0].view(torch.int32)),
                  f"icp_nn case {name!r} ({form}): differs from the plain "
                  f"version")
        held.append(f"{name} ({int(torch.isfinite(want[0]).sum())}/"
                    f"{src.shape[0]})")
    return "; ".join(held)


def _gn_split(torch, src, map_pts, voxel) -> None:
    """What one Gauss-Newton iteration of register_points_device costs on
    the card beside its icp_nn launch: the iteration whole (host clock,
    with its one sync; best of 5), and its parts, each the larger of its
    device time and its host issue time (cuda_ms)."""
    from ouster_sdk_tpu_torch.slam import device_icp as di

    dev = src.device
    eye = torch.eye(4, device=dev)

    def one():
        di.register_points_device(src, None, map_pts, None, eye, 3.0, 1.0,
                                  voxel_size=voxel, max_iters=1)
        torch.cuda.synchronize()

    it_ms = min(_host_s(one) for _ in range(5)) * 1e3
    n = src.shape[0]
    r = torch.randn(n, 3, device=dev) * 0.1
    w = torch.rand(n, device=dev)
    corr = w > 0.1
    A = torch.eye(6, dtype=torch.float64, device=dev) * 4 + 0.1
    b = torch.ones(6, dtype=torch.float64, device=dev)
    dx = torch.full((6,), 1e-3, device=dev)
    index = di.build_icp_index(map_pts, None, voxel)
    parts = {
        "icp_nn search (prebuilt index)": lambda: di.icp_nn(src,
                                                            index=index),
        "icp_nn index build": lambda: di.build_icp_index(map_pts, None,
                                                         voxel),
        "normal terms (stack + one sum)": lambda: di._normal_terms(
            src, r, w, corr),
        "6x6 solve_ex (float64)": lambda: torch.linalg.solve_ex(A, b),
        "_se3_exp_kiss": lambda: di._se3_exp_kiss(dx),
    }
    print(f"slam Gauss-Newton iteration at N={n} M={map_pts.shape[0]}: "
          f"{it_ms:.3f} ms whole (one sync) [{CARD}]; parts: " + "; ".join(
              f"{name} {cuda_ms(fn, iters=20, windows=3)[0]:.4f} ms"
              for name, fn in parts.items()))


def _run_icp_nn(torch, port, dev, slam) -> dict:
    """icp_nn against icp_nn_reference on the card at the largest
    registration of the SLAM run, at ICP_NN_LARGE (queries and map points
    from the yard, voxel 1.0 m) and on icp_nn_cases; torch.cdist + min on
    the large points as context (not the same function: no voxel mask).
    Returns the kernel's entry of the `kernels` line: `ms` is the search
    with a prebuilt index at the SLAM run's largest map, `index_ms` the
    build's, `launches` and `index_launches` the SLAM run's."""
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn

    big = slam["largest"]
    at = _icp_nn_times(torch, nn, big["src"], big["map"], big["voxel"])
    n, m = big["src"].shape[0], big["m"]
    print(_icp_nn_line(n, m, at) + " (the SLAM run's largest map)")
    _gn_split(torch, big["src"], big["map"], big["voxel"])
    # the large case: the yard's world points as the map
    world = np.concatenate([p @ P[:3, :3].T + P[:3, 3]
                            for p, P in slam["gathered"]])
    qn, mn = ICP_NN_LARGE
    check(world.shape[0] >= mn, f"only {world.shape[0]} yard points")
    rng = np.random.default_rng(12)
    map_pts = torch.from_numpy(world[:mn].astype(np.float32)).to(dev)
    q = world[rng.choice(world.shape[0], qn, replace=False)]
    q = q + rng.normal(0.0, 0.05, q.shape)
    src = torch.from_numpy(q.astype(np.float32)).to(dev)
    large = _icp_nn_times(torch, nn, src, map_pts, SLAM_VOXEL)
    print(_icp_nn_line(qn, mn, large)
          + f"; {qn * mn / large['ms'] / 1e9:.2f} T brute-force pairs/s "
          f"equivalent")
    print("icp_nn cases, both forms equal to the plain version on the card "
          "(queries with a candidate): "
          + _icp_nn_cases_on_card(torch, nn, dev) + f" [{CARD}]")

    def cdist_min():
        return min(torch.cdist(src, map_pts[k:k + 65536]).min(dim=1).values
                   .min() for k in range(0, mn, 65536))

    cd_ms = cuda_ms(cdist_min, iters=1, windows=3, warm=1)[0]
    print(f"context: torch.cdist + min over the same {qn} x {mn} points "
          f"(8 calls of 65536 map points, no voxel mask, not the same "
          f"function): {cd_ms:.3f} ms [{CARD}]")
    return {"name": "icp_nn", "route": "cuda", "source": ICP_NN_SOURCE,
            "replaces": ICP_NN_REPLACES, "launches": slam["launches"],
            "max_abs_err": max(at["max_abs_err"], large["max_abs_err"]),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": None, "index_ms": at["index_ms"],
            "index_bound_ms": at["index_bound_ms"],
            "index_launches": slam["index_launches"],
            "large_ms": large["ms"], "large_bound_ms": large["bound_ms"],
            "large_index_ms": large["index_ms"]}


def _angles(a: np.ndarray, b: np.ndarray):
    """Per-pixel angle in degrees between normals a and b where both are
    non-zero, and the pixels where exactly one is."""
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    both = (na > 0.5) & (nb > 0.5)
    one = (na > 0.5) != (nb > 0.5)
    cos = np.sum(a * b, axis=-1) / np.maximum(na * nb, 1e-300)
    return np.degrees(np.arccos(np.clip(cos[both], -1, 1))), int(one.sum())


def _run_normals(torch, port, dev, info, scans) -> None:
    """scan_normals(backend="device") (float32 on the card) against the
    numpy normals (float64) on yard scans, both returns: at most 1 % of the
    pixels with a normal in either may disagree (f32 rounding flips a
    neighbour or case decision), and the rest within 0.1 degree."""
    import copy

    from ouster_sdk_tpu_torch.ops.normals import scan_normals

    worst, p99, flips, n_px = 0.0, 0.0, 0, 0
    for scan in scans:
        a, b = copy.deepcopy(scan), copy.deepcopy(scan)
        scan_normals(a, info, backend="numpy")
        scan_normals(b, info, backend="device")
        for field in ("NORMALS", "NORMALS2"):
            ang, one = _angles(a.field(field).astype(np.float64),
                               b.field(field).astype(np.float64))
            n_px += ang.size + one
            flips += int((ang > 0.1).sum()) + one
            p99 = max(p99, float(np.percentile(ang, 99)))
            if (ang <= 0.1).any():
                worst = max(worst, float(ang[ang <= 0.1].max()))
    check(flips <= 0.01 * n_px, f"normals: {flips} of {n_px} pixels differ")
    scan = copy.deepcopy(scans[0])

    def device_call():
        scan_normals(scan, info, backend="device")
        torch.cuda.synchronize()

    host_s = min(_host_s(device_call) for _ in range(3))
    numpy_s = min(_host_s(lambda: scan_normals(scan, info, backend="numpy"))
                  for _ in range(2))
    from ouster_sdk_tpu_torch.ops.destagger import destagger
    from ouster_sdk_tpu_torch.ops.normals_device import normals_device

    lut = port.make_xyz_lut(info)
    r1, r2 = scan.field("RANGE"), scan.field("RANGE2")
    xyz1 = torch.from_numpy(destagger(info, lut(r1)).astype(np.float32)) \
        .to(dev)
    xyz2 = torch.from_numpy(destagger(info, lut(r2)).astype(np.float32)) \
        .to(dev)
    rd1 = torch.from_numpy(destagger(info, r1).astype(np.int64)).to(dev)
    rd2 = torch.from_numpy(destagger(info, r2).astype(np.int64)).to(dev)
    origins = torch.zeros((info.format.columns_per_frame, 3), device=dev)
    ms = cuda_ms(lambda: normals_device(xyz1, rd1, origins, xyz2, rd2),
                 iters=5, windows=5)[0]
    print(f"normals: {len(scans)} yard scans {info.format.pixels_per_column}x"
          f"{info.format.columns_per_frame} dual, device (f32) "
          f"against numpy (f64): {flips} of {n_px} pixels disagree (> 0.1 "
          f"deg or a normal in one only, limit 1 %), the rest within "
          f"{worst:.2e} deg, 99th percentile of all {p99:.2e} deg; "
          f"scan_normals device {host_s * 1e3:.2f}"
          f" ms/scan (numpy {numpy_s * 1e3:.1f}), normals_device alone "
          f"{ms:.3f} ms/scan [{CARD}]")


def _run_downsample(torch, port, dev, info, scans) -> None:
    """voxel_downsample_device on a yard scan's points (float32 on the
    card) against the numpy voxel_downsample (float64) at 0.25 m: the same
    voxels (a power of two, so both assign every point the same cell), the
    centroids within 2e-5 m, no voxel past the capacity."""
    from ouster_sdk_tpu_torch.ops.downsample import (voxel_downsample,
                                                     voxel_downsample_device)

    lut = port.make_xyz_lut(info)
    r = scans[-1].field("RANGE")
    pts = lut(r)[r > 0].astype(np.float32)
    cent, _ = voxel_downsample(pts, 0.25)
    capacity = 1 << int(np.ceil(np.log2(cent.shape[0] + 1)))
    pts_d = torch.from_numpy(pts).to(dev)
    got, mask = voxel_downsample_device(pts_d, 0.25, capacity)
    got = got[mask].cpu().numpy()
    check(got.shape == cent.shape,
          f"voxel downsample: {got.shape[0]} voxels, numpy {cent.shape[0]}")
    err = float(np.abs(got - cent).max())
    check(err <= 2e-5, f"voxel downsample centroids {err} m from numpy")
    again, _ = voxel_downsample_device(pts_d, 0.25, capacity)
    n_var = int((again[mask].cpu().numpy() != got).any(axis=1).sum())
    ms = cuda_ms(lambda: voxel_downsample_device(pts_d, 0.25, capacity),
                 iters=5, windows=5)[0]
    numpy_ms = min(_host_s(lambda: voxel_downsample(pts, 0.25))
                   for _ in range(2)) * 1e3
    print(f"voxel downsample: {pts.shape[0]} points of a yard scan -> "
          f"{cent.shape[0]} voxels of 0.25 m, same set as numpy, centroids "
          f"within {err:.2e} m (limit 2e-5); {n_var} centroids differ "
          f"between two runs (atomics); device {ms:.3f} ms, numpy "
          f"{numpy_ms:.1f} ms [{CARD}]")


# -- zone monitoring: occupancy of rendered zones on the card ------------------

ZONES = 16      # MAX_ACTIVE_ZONES: every zone a sensor evaluates at once


def zone_boxes(mod, n: int = ZONES):
    """n box zones on a ring around the sensor, 6-30 m out, 1-4 m wide and
    2-3 m tall, alternating occupancy and vacancy, in the zone model of
    `mod` (the port's ouster_sdk_tpu_torch.zone)."""
    zones = []
    for k in range(n):
        a = 2 * np.pi * k / n
        d = 6.0 + 24.0 * ((k * 7) % n) / n
        z = mod.Zone.box(k + 1, center=(d * np.cos(a), d * np.sin(a), -0.5),
                         size=(1.0 + k % 4, 1.0 + (k * 3) % 4, 2.0 + k % 2))
        z.mode = mod.ZoneMode.OCCUPANCY if k % 2 == 0 \
            else mod.ZoneMode.VACANCY
        z.min_points = 1
        zones.append(z)
    return mod.ZoneSet(zones, sensor_to_body_transform=np.eye(4))


def _run_zone(torch, port, dev, info, scans) -> None:
    """zone_occupancy_device on the card at the SLAM cell's 128x2048 with
    ZONES rendered box zones (the port's zone model, numpy ray casting),
    over the yard scans' RANGE and RANGE2: counts equal to the numpy
    zone_occupancy of each zone; ms a scan with the bounds resident on the
    card (uint32) and with numpy inputs (bounds copied in each call)."""
    import ouster_sdk_tpu_torch.zone as pz

    t0 = time.perf_counter()
    zs = zone_boxes(pz)
    zs.render(info)
    zrbs = [zs.zones[k].zrb for k in sorted(zs.zones)]
    render_s = time.perf_counter() - t0
    near = np.stack([z.near_range_mm for z in zrbs])
    far = np.stack([z.far_range_mm for z in zrbs])
    check(near.shape == (ZONES, info.format.pixels_per_column,
                         info.format.columns_per_frame),
          f"zone bounds of shape {near.shape}")

    def u32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) \
            .to(dev).view(torch.uint32)

    near_t, far_t = u32(near), u32(far)
    counts = []
    for scan in scans:
        for field in ("RANGE", "RANGE2"):
            r = scan.field(field)
            got = pz.zone_occupancy_device(u32(r), near_t, far_t)
            check(got.device.type == "cuda", "zone occupancy left the card")
            want = [pz.zone_occupancy(r, z)[0] for z in zrbs]
            check(got.cpu().tolist() == want,
                  f"zone occupancy {got.cpu().tolist()} != numpy {want}")
            counts.append(want)
    r = scans[0].field("RANGE")
    r_t = u32(r)
    ms = device_ms(lambda: pz.zone_occupancy_device(r_t, near_t, far_t))[0]
    issue_ms = cuda_ms(lambda: pz.zone_occupancy_device(r_t, near_t, far_t),
                       iters=20, windows=5)[0]
    host_ms = cuda_ms(lambda: pz.zone_occupancy_device(r, near, far,
                                                       device=dev),
                      iters=5, windows=3)[0]
    numpy_ms = min(_host_s(lambda: [pz.zone_occupancy(r, z) for z in zrbs])
                   for _ in range(3)) * 1e3
    live = sum(1 for c in counts[0] if c > 0)
    print(f"zone: {ZONES} box zones rendered at "
          f"{info.format.pixels_per_column}x{info.format.columns_per_frame} "
          f"in {render_s:.1f} s (numpy); zone_occupancy_device on "
          f"{len(counts)} yard range images equal to numpy zone_occupancy "
          f"(first: {counts[0]}, {live} zones occupied); "
          f"{ms:.4f} ms a scan with the bounds on the card (device time; "
          f"{issue_ms:.4f} back to back, host issue included), "
          f"{host_ms:.3f} ms with numpy inputs (bounds copied in), numpy "
          f"{numpy_ms:.2f} ms [{CARD}]")


# -- SLAM: an outdoor yard driven through at vehicle speed --------------------

CLI_FRAMES = 10       # frames of the main capture `util benchmark` reads
CLI_SLAM_FRAMES = 12  # yard frames the `slam` subprocess registers
#: Whether the GPU machine this script is run on has click: it does
#: (recorded in PERF.md section 6). With click the phase also runs the
#: command line itself in subprocesses.
CLICK_ON_CARD = True


def _run_cli(torch, port, pk, dev, tmp, main_info, main_path, slam) -> dict:
    """The command line's device stages and the pose optimizer, driven
    through ouster_sdk_tpu_torch.cli.util and slam.pose_optimizer (no
    click): run_benchmark over CLI_FRAMES frames of the main capture (a
    metadata json beside it, as a user's capture has one), which must
    launch planar_project (the device stage) and icp_nn (icp_device), with
    icp_device within 0.05 m of icp_host and its report written;
    system_info(devices=True), which must name the card; the SLAM
    run's scans with the device backend's poses saved to an OSF through
    save_scans, then optimize_osf_trajectory with an ABSOLUTE_POSE at the
    last scan from the yard's ground truth, which must read through the
    OSF projector (planar_project launches), write every scan, correct
    each scan rigidly and bring the last scan closer to the truth.
    Returns the launches of each kernel case this phase made."""
    import copy

    from ouster_sdk_tpu_torch.cli import util
    from ouster_sdk_tpu_torch.io import osf as osf_mod
    from ouster_sdk_tpu_torch.io.save import save_scans
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.slam import device_icp as di
    from ouster_sdk_tpu_torch.slam import kiss_icp as ki
    from ouster_sdk_tpu_torch.slam import pose_optimizer as po

    made = {}
    # util benchmark: the capture with its metadata json beside it
    info = copy.deepcopy(main_info)
    info.config.udp_profile_lidar = info.format.udp_profile_lidar
    info.config.udp_port_lidar = 7502
    bench = os.path.join(tmp, "bench.pcap")
    os.symlink(main_path, bench)
    with open(os.path.join(tmp, "bench.json"), "w") as f:
        f.write(info.to_json_string())
    poses = {}

    def keep_pose(cls, tag):
        register = cls.register_frame

        def call(self, *args, **kwargs):
            poses[tag] = register(self, *args, **kwargs)
            return poses[tag]
        return register, call

    lines = []
    pk.reset_launches()
    nn.reset_launches()
    originals = {cls: keep_pose(cls, tag) for cls, tag in (
        (ki.KissICP, "host"), (di.DeviceICP, "device"))}
    with tempfile.TemporaryDirectory(dir=tmp) as td:
        t0 = time.perf_counter()
        try:
            for cls, (_, call) in originals.items():
                cls.register_frame = call
            report = util.run_benchmark(
                bench, frames=CLI_FRAMES, report_dir=td, echo=lines.append)
        finally:
            for cls, (register, _) in originals.items():
                cls.register_frame = register
        secs = time.perf_counter() - t0
        check(len(os.listdir(td)) == 1, "util benchmark wrote no report")
    bench_planar = dict(pk.launches)
    bench_nn = dict(nn.launches)
    check(bench_planar["planar_dual"] > 0,
          "util benchmark's device stage never launched planar_project")
    check(bench_nn["icp_nn"] > 0,
          "util benchmark's icp_device never launched icp_nn")
    apart = float(np.linalg.norm(poses["device"][:3, 3]
                                 - poses["host"][:3, 3]))
    check(apart <= 0.05, f"util benchmark: icp_device {apart} m from "
          f"icp_host")
    times = report["times"]
    check(report["pcap"]["n_frames"] == CLI_FRAMES,
          f"util benchmark read {report['pcap']['n_frames']} frames")
    print("cli util benchmark (run_benchmark, main capture, "
          f"{CLI_FRAMES} frames, ms/frame): "
          + ", ".join(f"{k} {v['per_frame'] * 1e3:.3f}"
                      for k, v in times.items())
          + f"; icp_device within {apart:.2e} m of icp_host; launches "
          f"planar_project<planar_dual> {bench_planar['planar_dual']}, "
          f"icp_nn {bench_nn['icp_nn']} (index {bench_nn['icp_nn_index']});"
          f" {secs:.1f} s [{CARD}]")
    made["planar_dual"] = bench_planar["planar_dual"]
    made["icp_nn"] = bench_nn["icp_nn"]
    made["icp_nn_index"] = bench_nn["icp_nn_index"]

    sysinfo = util.system_info(devices=True)
    name = torch.cuda.get_device_name(0)
    check([d["kind"] for d in sysinfo["devices"]][:1] == [name]
          and sysinfo["devices"][0]["platform"] == "gpu",
          f"system_info(devices=True) gave {sysinfo['devices']}")
    print(f"cli util system-info --devices: {sysinfo['devices']}")

    # pose_optimize: the SLAM run's scans with the device backend's poses
    scans, gt, yinfo = slam["run"], slam["truth"], slam["info"]
    src = os.path.join(tmp, "slam.osf")
    out = os.path.join(tmp, "slam_optimized.osf")
    t0 = time.perf_counter()
    save_scans(src, [yinfo], [port.LidarScanSet([s]) for s in scans])
    save_s = time.perf_counter() - t0
    mid = [int(np.flatnonzero(s.status & 1)[len(np.flatnonzero(
        s.status & 1)) // 2]) for s in scans]
    cfg = {"loss_function": "HuberLoss", "constraints": [
        {"type": "ABSOLUTE_POSE",
         "timestamp": int(scans[-1].timestamp[mid[-1]]),
         "pose": [float(v) for v in gt[-1].ravel()],
         "rotation_weight": 100.0, "translation_weight": 100.0}]}
    pk.reset_launches()
    # every set of the input is collated, so the optimizer writes each
    # with one save_set (which calls save for its scan)
    solve = count_calls(po.PoseOptimizer, "solve")
    saved_sets = count_calls(osf_mod.Writer, "save_set")
    t0 = time.perf_counter()
    with solve, saved_sets:
        n = po.optimize_osf_trajectory(src, out, json.dumps(cfg))
    total = time.perf_counter() - t0
    check(saved_sets.n == n, f"pose_optimize: {saved_sets.n} save_set "
          f"calls for {n} scans")
    po_launches = pk.launches["planar"]
    check(po_launches > 0, "pose_optimize never launched planar_project "
          "(the OSF projector)")
    check(n == len(scans), f"pose_optimize wrote {n} of {len(scans)} scans")
    back = [ls[0] for ls in port.open_source(out)]
    check(len(back) == len(scans),
          f"the optimized OSF holds {len(back)} scans")
    worst = 0.0
    for a, b in zip(back, scans):
        fix = a.pose @ np.linalg.inv(b.pose)
        worst = max(worst, float(np.abs(fix - fix[:1]).max()))
        check(np.array_equal(a.field("RANGE"), b.field("RANGE")),
              "pose_optimize changed a range image")
    check(worst <= 1e-6, f"pose_optimize: a scan's correction varies by "
          f"{worst} over its columns")
    err_in = float(np.linalg.norm(scans[-1].pose[mid[-1]][:3, 3]
                                  - gt[-1][:3, 3]))
    err_out = float(np.linalg.norm(back[-1].pose[mid[-1]][:3, 3]
                                   - gt[-1][:3, 3]))
    check(err_out < err_in, f"pose_optimize: last-scan error {err_out} m, "
          f"{err_in} m before")
    write_s = saved_sets.seconds
    print(f"cli pose_optimize ({len(scans)} yard scans "
          f"{yinfo.format.pixels_per_column}x"
          f"{yinfo.format.columns_per_frame} dual, device poses, "
          f"ABSOLUTE_POSE at the last scan): read and the rest "
          f"{(total - solve.seconds - write_s) * 1e3:.1f} ms, solve "
          f"{solve.seconds * 1e3:.1f} ms, write {write_s * 1e3:.1f} ms "
          f"({(write_s / n) * 1e3:.2f} ms/scan), total {total:.2f} s; "
          f"the input OSF written in {save_s:.2f} s; last-scan error "
          f"{err_in:.4f} -> {err_out:.4f} m; corrections rigid within "
          f"{worst:.1e}; planar_project<planar> {po_launches} launches in "
          f"the optimizer, {pk.launches['planar'] - po_launches} re-reading "
          f"[{CARD}]")
    made["planar"] = pk.launches["planar"]
    if CLICK_ON_CARD:
        _run_cli_subprocesses(bench, slam["path"], yinfo, tmp)
    for f in (src, out, bench, os.path.join(tmp, "bench.json")):
        os.remove(f)
    return made


def _run_cli_subprocesses(bench, yard, yard_info, tmp) -> None:
    """The command line as a user runs it, each command in a process of its
    own that must exit 0: `python3 -m ouster_sdk_tpu_torch source
    <yard> slice :CLI_SLAM_FRAMES slam --backend device -v 1.0 save <osf>`
    (the SLAM phase's capture, a metadata json beside it) and `util
    benchmark --frames 4 <main capture>`. Depth is cut to keep the phase
    near a minute: each process takes seconds to reach the card."""
    import copy

    info = copy.deepcopy(yard_info)
    info.config.udp_profile_lidar = info.format.udp_profile_lidar
    info.config.udp_port_lidar = 7502
    meta = os.path.splitext(yard)[0] + ".json"
    with open(meta, "w") as f:
        f.write(info.to_json_string())
    osf = os.path.join(tmp, "cli_slam.osf")
    for args, want in (
            (["source", yard, "slice", f":{CLI_SLAM_FRAMES}", "slam",
              "--backend", "device", "-v", "1.0", "save", osf],
             f"wrote {CLI_SLAM_FRAMES} scans to {osf}"),
            (["util", "benchmark", "--frames", "4", bench], "icp_device")):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "ouster_sdk_tpu_torch",
                              *args], cwd=HERE, capture_output=True,
                             text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(res.returncode == 0 and want in res.stdout,
              f"python3 -m ouster_sdk_tpu_torch {' '.join(args[:3])} ... "
              f"exited {res.returncode}: {res.stdout[-1000:]}"
              f"{res.stderr[-2000:]}")
        print(f"cli subprocess python3 -m ouster_sdk_tpu_torch "
              f"{' '.join(a for a in args if a not in (yard, bench, osf))}"
              f": exit 0 in {secs:.1f} s [{CARD}]")
        if args[0] == "util":
            print("cli subprocess util benchmark output: " + "; ".join(
                ln.strip() for ln in res.stdout.splitlines()
                if "ms/frame" in ln))
    os.remove(osf)
    os.remove(meta)



VIZ_FRAMES = 8        # frames of the main capture the viewer snapshots
VIZ_PO_SCANS = 8      # SLAM scans in the pose optimizer's viewer input
VIZ_PLY_SCANS = 2     # yard scans saved as PLY for ply_to_png / model_viz


class viz_consume:
    """SimpleViz._consume (update, accumulators, snapshot) counted while
    the block runs: its calls, host seconds and the device syncs each call
    made on the viewer's thread."""

    def __init__(self, torch, SimpleViz):
        self.torch, self.cls = torch, SimpleViz
        self.seconds, self.syncs = [], []

    def __enter__(self):
        self.fn = consume = self.cls._consume
        me = self

        def counted(self, scans, n):
            t0 = time.perf_counter()
            try:
                return synced(me.torch, lambda: consume(self, scans, n),
                              me.syncs)
            finally:
                me.seconds.append(time.perf_counter() - t0)

        self.cls._consume = counted
        return self

    def __exit__(self, *exc):
        self.cls._consume = self.fn


def _run_viz(torch, port, pk, dev, tmp, main_info, main_path, slam) -> int:
    """The viewer, ply_to_png and the examples over the card's sources.
    SimpleViz snapshots (1024x768, every frame) of VIZ_FRAMES frames of
    the main capture through `source <pcap> slice :N viz --out` (the
    command line in this process; the engine on the card), through the API
    over the numpy ScanBatcher (OUSTER_SDK_TPU_DEVICE_DECODE=0) and over an
    OSF of the same frames (the projector on the card, planar_project once
    a window of 4 scans): every PNG byte-equal across the three, with ms a
    snapshot, the syncs each made on the viewer's thread and the launches
    of each route checked; the same over OpenGL where this host has a
    surfaceless EGL, else why not. `pose_optimize --viz-snapshot` (PNG pair
    and .html) over VIZ_PO_SCANS SLAM scans with the device backend's
    poses, projector on and off; `model_viz` and `ply_to_png` on a PLY
    that save_scans wrote from yard scans read by the engine and by the
    batcher; and the examples (pcap, osf, colormaps, zone states, viz,
    viz_image_events) on the card's sources against the batcher's: files
    and printed text byte-equal, XYZ from the OSF projector's cache within
    1 f32 ulp of the f64 host LUT. Returns planar_project<planar>'s
    launches."""
    import contextlib
    import copy
    import io as _io
    import shutil

    from click.testing import CliRunner

    from ouster_sdk_tpu_torch.cli import cli
    from ouster_sdk_tpu_torch.examples import colormaps as ex_cm
    from ouster_sdk_tpu_torch.examples import osf as ex_osf
    from ouster_sdk_tpu_torch.examples import pcap as ex_pcap
    from ouster_sdk_tpu_torch.examples import viz as ex_viz
    from ouster_sdk_tpu_torch.examples import viz_image_events as ex_events
    from ouster_sdk_tpu_torch.examples import \
        zone_monitor_zone_states_example as ex_zone
    from ouster_sdk_tpu_torch.io import device_engine as de
    from ouster_sdk_tpu_torch.io.save import save_scans
    from ouster_sdk_tpu_torch.slam import ply_to_png
    from ouster_sdk_tpu_torch.slam import pose_optimizer as po
    from ouster_sdk_tpu_torch.viz import gl as vgl
    from ouster_sdk_tpu_torch.viz.core import SimpleViz

    env = "OUSTER_SDK_TPU_DEVICE_DECODE"
    launches = 0
    work = os.path.join(tmp, "viz")
    os.makedirs(work)

    @contextlib.contextmanager
    def route(value):
        """The source policy at `value` (None: unset), the engine's and
        the projector's counters and the kernel's launches zeroed."""
        if value is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = value
        de.stats.update(batches=0, scans=0, osf_batches=0)
        pk.reset_launches()
        try:
            yield
        finally:
            os.environ.pop(env, None)

    def read(path):
        with open(path, "rb") as f:
            data = f.read()
        check(len(data) > 0, f"{path} is empty")
        return data

    def first_sets(path, n, **kw):
        """The first n scan sets of open_source(path), the source closed
        after them."""
        src = port.open_source(path, **kw)
        try:
            for k, ls in enumerate(src):
                if k == n:
                    return
                yield ls
        finally:
            src.close()

    def pngs(d):
        names = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        for n in names:
            check(read(os.path.join(d, n))[:8] == b"\x89PNG\r\n\x1a\n",
                  f"{n} is not a PNG")
        return {n: read(os.path.join(d, n)) for n in names}

    try:
        # the capture with its metadata json beside it, as a user's is
        info = copy.deepcopy(main_info)
        info.config.udp_profile_lidar = info.format.udp_profile_lidar
        info.config.udp_port_lidar = 7502
        pcap = os.path.join(work, "main.pcap")
        os.symlink(main_path, pcap)
        with open(os.path.join(work, "main.json"), "w") as f:
            f.write(info.to_json_string())
        osf = os.path.join(work, "main.osf")
        save_scans(osf, [info], list(first_sets(pcap, VIZ_FRAMES)))
        synced(torch, lambda: None, [])   # the process's first window

        # 1. SimpleViz snapshots, three routes
        snaps, figures = {}, {}
        for name, value, run in (
                ("engine (cli)", None, lambda d: CliRunner().invoke(cli, [
                    "source", pcap, "slice", f":{VIZ_FRAMES}", "viz",
                    "--out", os.path.join(d, "s.png"), "--every", "1"])),
                ("batcher", "0", lambda d: SimpleViz(
                    [info], snapshot_path=os.path.join(d, "s.png"),
                    snapshot_every=1).run(first_sets(pcap, VIZ_FRAMES))),
                ("OSF projector", None, lambda d: SimpleViz(
                    [info], snapshot_path=os.path.join(d, "s.png"),
                    snapshot_every=1).run(port.open_source(osf)))):
            d = os.path.join(work, name.split()[0])
            os.makedirs(d)
            with route(value), viz_consume(torch, SimpleViz) as vc:
                t0 = time.perf_counter()
                res = run(d)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                ran = dict(de.stats)
                made = dict(pk.launches)
            if name.startswith("engine"):
                check(res.exit_code == 0, f"source viz exited "
                      f"{res.exit_code}: {res.output[-2000:]}"
                      f"{res.exception!r}")
            snaps[name] = pngs(d)
            check(len(snaps[name]) == VIZ_FRAMES == len(vc.seconds),
                  f"viz over the {name}: {len(snaps[name])} snapshots, "
                  f"{len(vc.seconds)} consumed")
            # save_scans records each set as a collation: the replay
            # projects one window a set
            want_windows = VIZ_FRAMES
            expect = {"engine (cli)": (ran["scans"] >= VIZ_FRAMES
                                       and sum(made.values()) == 0),
                      "batcher": (ran["scans"] == 0 and ran["batches"] == 0
                                  and sum(made.values()) == 0),
                      "OSF projector": (ran["osf_batches"] == want_windows
                                        and made["planar"] == want_windows
                                        and sum(made.values())
                                        == want_windows)}[name]
            check(expect, f"viz over the {name}: engine/projector "
                  f"{ran}, launches {made}")
            launches += made["planar"]
            figures[name] = (secs, vc.seconds, vc.syncs, made["planar"])
        ref = snaps["batcher"]
        for name, got in snaps.items():
            differ = [n for n in ref if got.get(n) != ref[n]]
            check(not differ and sorted(got) == sorted(ref),
                  f"viz over the {name}: {differ} differ from the batcher's")
        for name, (secs, each, syncs, made) in figures.items():
            print(f"viz snapshots over the {name}: {VIZ_FRAMES} of "
                  f"{info.h}x{info.w} dual at 1024x768, byte-equal to the "
                  f"batcher's; {np.median(each) * 1e3:.1f} ms a snapshot "
                  f"(min {min(each) * 1e3:.1f}, max {max(each) * 1e3:.1f}; "
                  f"update + PNG, software), syncs a snapshot "
                  f"{[len(x) for x in syncs]}, planar_project<planar> "
                  f"{made}; {secs:.2f} s in all [{CARD}]")

        # the same over OpenGL, where the host has a surfaceless EGL
        try:
            vgl.GLContext(4, 4).close()
            why = None
        except Exception as e:   # any failure: the reason is printed
            why = f"{type(e).__name__}: {e}"
        if why is None:
            gl = {}
            for name, value in (("engine", None), ("batcher", "0")):
                d = os.path.join(work, "gl_" + name)
                os.makedirs(d)
                with route(value), viz_consume(torch, SimpleViz) as vc:
                    sv = SimpleViz([info], snapshot_path=os.path.join(
                        d, "s.png"), snapshot_every=1, backend="gl")
                    try:
                        sv.run(first_sets(pcap, VIZ_FRAMES))
                    finally:
                        if sv.scan_viz.viz._gl_renderer is not None:
                            sv.scan_viz.viz._gl_renderer.close()
                gl[name] = (pngs(d), vc.seconds)
            check(gl["engine"][0] == gl["batcher"][0]
                  and len(gl["engine"][0]) == VIZ_FRAMES,
                  "GL snapshots over the engine differ from the batcher's")
            print(f"viz renderer: software and OpenGL (surfaceless EGL); GL "
                  f"{np.median(gl['engine'][1]) * 1e3:.1f} ms a snapshot "
                  f"over the engine, byte-equal to the batcher's [{CARD}]")
        else:
            print(f"viz renderer: software; OpenGL not run: gl_available() "
                  f"is False here ({why})")

        # 2. pose_optimize --viz-snapshot over SLAM scans with device poses
        scans, gt, yinfo = slam["run"][:VIZ_PO_SCANS], slam["truth"], \
            slam["info"]
        po_src = os.path.join(work, "slam.osf")
        save_scans(po_src, [yinfo], [port.LidarScanSet([s]) for s in scans])
        last = scans[-1]
        mid = int(np.flatnonzero(last.status & 1)[
            len(np.flatnonzero(last.status & 1)) // 2])
        cfg = json.dumps({"loss_function": "HuberLoss", "constraints": [
            {"type": "ABSOLUTE_POSE", "timestamp": int(last.timestamp[mid]),
             "pose": [float(v) for v in gt[len(scans) - 1].ravel()],
             "rotation_weight": 100.0, "translation_weight": 100.0}]})
        views = {}
        for name, value in (("projector", None), ("batcher", "0")):
            d = os.path.join(work, "po_" + name)
            os.makedirs(d)
            with route(value):
                t0 = time.perf_counter()
                for snap in ("po.png", "po.html"):
                    n = po.optimize_osf_trajectory(
                        po_src, os.path.join(d, "o.osf"), cfg,
                        viz_snapshot=os.path.join(d, snap))
                    check(n == len(scans), f"pose_optimize wrote {n} scans")
                secs = time.perf_counter() - t0
                made = pk.launches["planar"]
            check((made > 0) == (value is None),
                  f"pose_optimize over the {name}: {made} launches")
            launches += made
            views[name] = ({f: read(os.path.join(d, f)) for f in (
                "po_orbit.png", "po_top.png", "po.html")}, secs, made)
        check(views["projector"][0] == views["batcher"][0],
              "pose_optimize --viz-snapshot: the views differ between the "
              "projector and the batcher")
        print(f"viz pose_optimize --viz-snapshot ({len(scans)} SLAM scans, "
              f"PNG pair and .html, two solves a route): byte-equal with "
              f"the projector on the card and off; {views['projector'][1]:.2f}"
              f" s / {views['batcher'][1]:.2f} s, planar_project<planar> "
              f"{views['projector'][2]} [{CARD}]")

        # 3. ply_to_png and model_viz on a PLY of yard scans
        plys = {}
        for name, value in (("engine", None), ("batcher", "0")):
            d = os.path.join(work, "ply_" + name)
            os.makedirs(d)
            with route(value):
                ysets = list(first_sets(slam["path"], VIZ_PLY_SCANS,
                                        sensor_info=[yinfo]))
                check((de.stats["scans"] > 0) == (value is None),
                      f"yard read over the {name}: {de.stats}")
            save_scans(os.path.join(d, "y.ply"), [yinfo], ysets)
            files = sorted(f for f in os.listdir(d) if f.endswith(".ply"))
            check(len(files) >= 1, f"save_scans wrote {files}")
            t0 = time.perf_counter()
            for f in files:
                ply_to_png(os.path.join(d, f), os.path.join(d, f + ".png"))
            top_s = time.perf_counter() - t0
            for out in ("m.png", "m.html"):
                res = CliRunner().invoke(cli, [
                    "source", os.path.join(d, files[0]), "model_viz",
                    "--axes", "-o", os.path.join(d, out)])
                check(res.exit_code == 0, f"model_viz exited "
                      f"{res.exit_code}: {res.output[-1000:]}")
            plys[name] = ({f: read(os.path.join(d, f))
                           for f in sorted(os.listdir(d))}, top_s)
        check(plys["engine"][0] == plys["batcher"][0],
              "PLY, ply_to_png or model_viz output differs between the "
              "engine's yard scans and the batcher's")
        print(f"viz ply_to_png and model_viz: {len(plys['engine'][0])} files "
              f"({', '.join(plys['engine'][0])}) byte-equal over the engine "
              f"and the batcher; ply_to_png {plys['engine'][1] * 1e3:.1f} ms "
              f"for {VIZ_PLY_SCANS} scans [{CARD}]")

        # 4. the examples on the card's sources against the batcher's
        outs = {}
        for name, value in (("card", None), ("batcher", "0")):
            d = os.path.join(work, "ex_" + name)
            os.makedirs(d)
            buf = _io.StringIO()
            with route(value), contextlib.redirect_stdout(buf):
                t0 = time.perf_counter()
                pts = ex_pcap.pcap_3d_one_scan(pcap, 1)
                ex_pcap.pcap_to_ply(pcap, 1, ply_dir=d)
                ex_pcap.pcap_to_csv(pcap, 1, csv_dir=d)
                ex_cm.colormap_strip(pcap, os.path.join(d, "cm.png"))
                ex_zone.zone_states_example(pcap, n_scans=2)
                ex_osf.osf_read_scans(osf)
                osf_pts = ex_pcap.pcap_3d_one_scan(osf, 1)
                secs = time.perf_counter() - t0
                ran, made = dict(de.stats), pk.launches["planar"]
            check((ran["scans"] > 0 and made > 0) == (value is None),
                  f"the examples over the {name}: engine/projector {ran}, "
                  f"launches {made}")
            launches += made
            outs[name] = (pts, osf_pts, buf.getvalue(),
                          {f: read(os.path.join(d, f))
                           for f in sorted(os.listdir(d))}, secs, made)
        card, host = outs["card"], outs["batcher"]
        check(np.array_equal(card[0], host[0]) and card[0].shape[0] > 1000,
              "pcap_3d_one_scan over the engine differs from the batcher's")
        check(card[2] == host[2] and "zone 2" in card[2],
              "the examples printed other text over the engine")
        check(card[3] == host[3] and len(card[3]) == 3,
              f"example files differ: {sorted(card[3])}")
        check(card[1].shape == host[1].shape, "pcap_3d_one_scan over the "
              "OSF projector: another point count than over the batcher")
        worst = ulp_check(card[1], host[1])
        check(worst <= 1.0,
              f"pcap_3d_one_scan over the OSF projector: {worst} f32 ulp "
              f"from the f64 host LUT")
        scene = ex_viz.viz_scene(os.path.join(work, "scene.png"))
        clicks = ex_events.viz_image_events(os.path.join(work, "ev.png"))
        check(read(scene)[:4] == b"\x89PNG" and clicks
              and clicks[0][2], "the viz examples failed")
        print(f"viz examples (pcap_3d_one_scan, pcap_to_ply, pcap_to_csv, "
              f"colormap_strip, zone_states_example, osf_read_scans) over "
              f"the card's sources: files and text byte-equal to the "
              f"batcher's, OSF XYZ within {worst:.2f} f32 ulp of the f64 "
              f"host LUT; {card[4]:.2f} s ({host[4]:.2f} s over the "
              f"batcher), planar_project<planar> {card[5]}; viz_scene and "
              f"viz_image_events written [{CARD}]")
    finally:
        shutil.rmtree(work)
    return launches

SLAM_FRAMES = 30
YARD_SPEED = 1.0                   # m a frame: 10 m/s at 10 Hz
YARD_YAW = np.deg2rad(1.0)         # rad a frame at YARD_SPEED
YARD_RAMP = 10                     # frames from rest to YARD_SPEED
YARD_HEIGHT = 1.8                  # the sensor above the ground, m
# buildings and a fence (x0, x1, y0, y1, height) around an arc of 30 m, and
# the cars parked along it (4.5 x 1.8 x 1.5 m, from a seed)
YARD_BUILDINGS = (
    (10.0, 30.0, 14.0, 26.0, 8.0), (35.0, 60.0, -22.0, -9.0, 10.0),
    (-30.0, -12.0, -16.0, 6.0, 6.0), (46.0, 56.0, 22.0, 45.0, 12.0),
    (0.0, 16.0, -28.0, -16.0, 5.0), (68.0, 76.0, -4.0, 16.0, 15.0),
    (-8.0, 4.0, 12.0, 20.0, 7.0), (20.0, 32.0, -30.0, -18.0, 9.0),
    (-20.0, 80.0, -12.5, -12.2, 2.0))


def _parked_cars(seed: int = 11):
    rng = np.random.default_rng(seed)
    cars = []
    for y0, x in [(-5.0, x) for x in np.arange(-20.0, 70.0, 6.5)] + \
            [(9.5, x) for x in np.arange(-20.0, 40.0, 7.0)]:
        if rng.random() < 0.75:
            x0 = x + rng.uniform(-1.0, 1.0)
            cars.append((x0, x0 + 4.5, y0, y0 + 1.8, 1.5))
    return tuple(cars)


YARD_BOXES = YARD_BUILDINGS + _parked_cars()
# poles and tree trunks (x, y, radius, height)
YARD_POLES = tuple((x, -7.0, 0.2, 6.0) for x in range(-10, 75, 10)) + \
    tuple((x + 5.0, 12.0, 0.3, 4.0) for x in range(-10, 45, 8))
YARD_MAX_M = 90.0                  # no return beyond


def yard_poses(t: np.ndarray, ramp: int = YARD_RAMP) -> np.ndarray:
    """World poses (len(t), 4, 4) of the sensor at times t, in frames,
    YARD_HEIGHT above the ground: from rest at the origin the vehicle
    speeds up evenly to YARD_SPEED over `ramp` frames (0: at YARD_SPEED
    from the start) and holds it, on an arc that turns YARD_YAW a frame at
    that speed (a constant twist along the distance driven)."""
    from ouster_sdk_tpu_torch.utils.pose_util import _se3_exp64_batch

    t = np.asarray(t, np.float64)
    dist = YARD_SPEED * np.where(t < ramp, t * t / (2 * max(ramp, 1)),
                                 t - ramp / 2)
    xi = np.array([0.0, 0.0, YARD_YAW / YARD_SPEED, 1.0, 0.0, 0.0])
    P = _se3_exp64_batch(dist[:, None] * xi[None])
    P[:, 2, 3] += YARD_HEIGHT
    return P


def _wrap(a: np.ndarray) -> np.ndarray:
    return (a + np.pi) % (2 * np.pi) - np.pi


def _seen(o: np.ndarray, u: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Which rectangles (k, 4: x0, x1, y0, y1) a bundle of rays (origins o,
    unit directions u, (..., 3)) can reach in the xy plane, conservatively:
    those whose azimuth interval seen from the bundle's mean origin,
    widened by the origins' spread, overlaps the rays' azimuths."""
    c = o[..., :2].reshape(-1, 2).mean(axis=0)
    spread = np.linalg.norm(o[..., :2].reshape(-1, 2) - c, axis=1).max()
    uh = u[..., :2].reshape(-1, 2)
    if np.linalg.norm(uh, axis=1).min() < 0.1:      # steep rays: no cull
        return np.ones(len(rects), bool)
    az = np.arctan2(uh[:, 1], uh[:, 0])
    mid = np.arctan2(np.sin(az).mean(), np.cos(az).mean())
    rel = _wrap(az - mid)
    lo, hi = rel.min(), rel.max()
    cx = np.stack([rects[:, 0], rects[:, 1], rects[:, 0], rects[:, 1]], 1)
    cy = np.stack([rects[:, 2], rects[:, 2], rects[:, 3], rects[:, 3]], 1)
    ang = _wrap(np.arctan2(cy - c[1], cx - c[0]) - mid)
    dx = np.maximum(np.maximum(rects[:, 0] - c[0], c[0] - rects[:, 1]), 0)
    dy = np.maximum(np.maximum(rects[:, 2] - c[1], c[1] - rects[:, 3]), 0)
    dist = np.hypot(dx, dy)
    near = dist <= 2 * spread + 1e-6
    margin = np.arcsin(np.minimum(1.0, spread / np.maximum(dist, 1e-9)))
    behind = ang.max(axis=1) - ang.min(axis=1) > np.pi   # straddles +-pi
    return near | behind | ((ang.min(axis=1) - margin <= hi)
                            & (ang.max(axis=1) + margin >= lo))


def _ray_cast(o: np.ndarray, u: np.ndarray, cols: int = 64) -> np.ndarray:
    """Distance along unit rays u from origins o (both (h, w, 3), world)
    to the first yard surface (the ground z = 0, YARD_BOXES, YARD_POLES),
    inf where none lies within YARD_MAX_M; a bundle of `cols` columns at a
    time, against the shapes it can reach (_seen)."""
    boxes = np.asarray(YARD_BOXES)
    poles = np.asarray(YARD_POLES)
    x, y, r = poles[:, 0], poles[:, 1], poles[:, 2]
    pole_rects = np.stack([x - r, x + r, y - r, y + r], 1)
    out = np.empty(u.shape[:-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(0, u.shape[1], cols):
            ob, ub = o[:, k:k + cols], u[:, k:k + cols]
            t = np.full(ub.shape[:-1], np.inf)
            tg = -ob[..., 2] / ub[..., 2]
            t = np.where((ub[..., 2] < 0) & (tg > 0), tg, t)
            bx = boxes[_seen(ob, ub, boxes[:, :4])]
            if len(bx):                              # slabs, all at once
                lo = np.stack([bx[:, 0], bx[:, 2], 0 * bx[:, 0]], -1)
                hi = np.stack([bx[:, 1], bx[:, 3], bx[:, 4]], -1)
                inv = 1.0 / ub[..., None, :]
                ta = (lo - ob[..., None, :]) * inv
                tb = (hi - ob[..., None, :]) * inv
                tn = np.nanmax(np.minimum(ta, tb), axis=-1)
                tf = np.nanmin(np.maximum(ta, tb), axis=-1)
                tn = np.where((tn <= tf) & (tn > 0.05), tn, np.inf)
                t = np.minimum(t, tn.min(axis=-1))
            for cx, cy, r, hgt in poles[_seen(ob, ub, pole_rects)]:
                dx, dy = ob[..., 0] - cx, ob[..., 1] - cy
                a = ub[..., 0] ** 2 + ub[..., 1] ** 2
                b = 2 * (dx * ub[..., 0] + dy * ub[..., 1])
                c = dx * dx + dy * dy - r * r
                disc = b * b - 4 * a * c
                tc = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
                z = ob[..., 2] + tc * ub[..., 2]
                hit = (disc > 0) & (tc > 0.05) & (z >= 0) & (z <= hgt)
                t = np.where(hit, np.minimum(t, tc), t)
            out[:, k:k + cols] = t
    return np.where(out < YARD_MAX_M, out, np.inf)


def yard_scans(port, info, n_frames: int, seed: int = 4,
               ramp: int = YARD_RAMP):
    """n_frames LidarScans of `info` driving through the yard (frame ids
    1..n_frames, 100 ms apart): every column ray-cast from the sensor pose
    at its own time, so the scans carry the motion of the sweep; ranges
    with 5 mm noise and 2 % dropouts, second returns 0.4-0.6 m behind on
    15 % of the valid pixels where the profile has them, every column
    valid. Returns (scans, ground truth): the world pose of each frame's
    middle column, the pose the SLAM engine registers."""
    lut = port.make_xyz_lut(info)
    h, w = info.format.pixels_per_column, info.format.columns_per_frame
    unit = np.linalg.norm(lut.direction, axis=-1, keepdims=True)
    u_s = lut.direction / unit                      # (h, w, 3), sensor
    rng = np.random.default_rng(seed)
    mid = (w - 1) // 2
    scans, truth = [], []
    for k in range(n_frames):
        P = yard_poses(k + np.arange(w) / w, ramp)   # a pose a column
        R, p = P[:, :3, :3], P[:, :3, 3]
        o = np.einsum("wij,hwj->hwi", R, lut.offset) + p[None]
        u = np.einsum("wij,hwj->hwi", R, u_s)
        t = _ray_cast(o, u)
        r_mm = np.where(np.isfinite(t), t / unit[..., 0]
                        + rng.normal(0.0, 5.0, t.shape), 0.0)
        r_mm[rng.random(t.shape) < 0.02] = 0
        r1 = np.clip(np.round(r_mm), 0, (1 << 19) - 1).astype(np.uint32)
        scan = port.LidarScan(info)
        scan.frame_id = k + 1
        scan.status[:] = 1
        ts0 = 10**9 + k * 100_000_000
        scan.timestamp[:] = ts0 + np.arange(w, dtype=np.uint64) * (
            100_000_000 // w)
        scan.packet_timestamp[:] = ts0 + np.arange(
            scan.packet_timestamp.size, dtype=np.uint64) * 1000
        scan.field("RANGE")[:] = r1
        if scan.has_field("RANGE2"):
            r2 = r1 + rng.integers(400, 600, r1.shape).astype(np.uint32)
            r2[(r1 == 0) | (rng.random(r1.shape) >= 0.15)] = 0
            scan.field("RANGE2")[:] = np.minimum(r2, (1 << 19) - 1)
        if scan.has_field("REFLECTIVITY"):
            scan.field("REFLECTIVITY")[:] = rng.integers(
                0, 256, (h, w)).astype(np.uint8)
        scans.append(scan)
        truth.append(P[mid])
    return scans, np.stack(truth)


def yard_capture(port, path: str, info, n_frames: int, seed: int = 4,
                 ramp: int = YARD_RAMP):
    """yard_scans written as a pcap through the port's own writers
    (io/save.scan_to_packets, io/pcap.PcapWriter); returns the ground
    truth."""
    from ouster_sdk_tpu_torch.io.save import scan_to_packets

    scans, truth = yard_scans(port, info, n_frames, seed, ramp)
    write_capture(path, ((bytes(buf), int(scan.packet_timestamp[0])
                          + p * 1000)
                         for scan in scans
                         for p, buf in enumerate(scan_to_packets(scan, info))))
    return truth


if __name__ == "__main__":
    sys.exit(main())
