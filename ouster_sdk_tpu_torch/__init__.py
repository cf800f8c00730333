"""ouster_sdk_tpu_torch: the lidar data plane in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The planar path: a pcap is read and its frames staged word-planar on the
host (io.frames.FrameReader.iter_planar_chunks), every field decodes on
the device (ops.unpack), range projects to XYZ in double-single precision
with an optional fused per-column dewarp (ops.fused.ScanPipeline
.project_planar, kernel kernels/csrc/planar_project.cu), and destagger
follows (ops.destagger.destagger_torch).

The packet-layout path: frames are staged as whole packets
(FrameReader.iter_chunks); ScanPipeline.__call__/batch decode every field,
project XYZ (and XYZ2), dewarp by per-column poses (ops.pose) and
destagger; ops.packet_kernels.unpack_project_packet_batched projects XYZ
alone straight from the packet words (kernel
kernels/csrc/packet_project.cu), for any LUT, per-pixel angle tables
included.

The LUT-free projection: for a spinning sensor the direction of every
pixel is synthesized from per-row and per-column factor tables
(ops.lutfree_kernels.FactorTables) instead of read from a per-pixel LUT;
unpack_project_lutfree (f32), unpack_project_lutfree_dd (double-single,
one or both returns) and unpack_project_lutfree_planar project XYZ
straight from either staging (kernels kernels/csrc/lutfree_project.cu).

The device engine: what a user of the SDK iterates. A pcap is scanned
once (io.frames.pcap_scan), the ScanBatcher's admission state machine is
replayed over its packets, each admitted frame is staged word-planar,
copied to the device, decoded there (ops.unpack) and copied back into a
LidarScan (io.device_engine.DeviceScanIterator, DeviceScanIndex for random
access), bit-equal to what core.batcher.ScanBatcher makes of the same
packets. LiveDeviceBatcher is its live twin (packets pushed one by one,
pixel fields left on the device until first touched), and
OsfDeviceProjector attaches double-single XYZ to scans whose ranges were
decoded elsewhere (ops.planar_kernels.project_ranges, the planar kernel
again).

The scan sources: what a user opens. `open_source("capture.pcap")`
gives a PcapScanSource (io.pcap_scan_source) whose scans decode on the
device engine, one DeviceScanIterator a sensor merged in packet order, or
on the numpy ScanBatcher when OUSTER_SDK_TPU_DEVICE_DECODE=0; the host
staging under every path runs in the native library (utils.native, the
port's own C++ copy, built with g++ at first use).

OSF replay and recording: `open_source("x.osf")` gives an OsfScanSource
(io.osf) that reads the file through an mmap, decodes each scan's PNG or
zPNG fields on the host (scanlines unfiltered by the native library,
stagger by a cached index map), and projects RANGE and RANGE2 to
double-single XYZ on the device in windows (OsfDeviceProjector, the planar
kernel); each scan carries that XYZ as a cache, which XYZLut(info)(scan)
serves while the scan's RANGE is unchanged. io.osf.Writer writes OSF files
byte-identical to the JAX package's.

Live sensors: `open_source("<host>")` gives a SensorScanSource
(sensor.scan_source) that configures the sensor over HTTP (sensor.http),
drains its UDP streams with one recvmmsg a socket (utils.native) and
batches the packets on a thread into LiveDeviceBatchers on the device.
sensor.emulator.SensorEmulator serves synthesized packets as a sensor on
loopback (the tests' and the chip run's sensor), and
io.frames.PlanarStreamAssembler turns a live packet stream into the
word-planar frames ScanPipeline.decode_planar / project_planar take.

Wire-codec replay: io.frames.FrameReader.iter_packed_chunks (dense
nbits-a-pixel bitstreams) or iter_bp64_chunks (BP64 delta/bit-packed range
streams, ops.bp64) ship fewer bytes than the word planes; fused_pipelined
packs a chunk into one buffer on the staging thread (ChunkFuser), the
device splits it back (ops.packed.unfuse_words), decodes the ranges
(project_packed_batched, project_bp64_batched) and projects them through
the planar kernel (ops.planar_kernels.project_ranges_batched).

Multi-device: parallel.make_mesh lists the devices, ScanPipeline.sharded
splits a batch over them (parallel.ShardedScanPipeline: the planar kernel
on each device's shard), and sharded_multi_sensor_step /
fuse_multi_sensor_clouds run per-sensor work on a 2-D mesh.

SLAM: slam.SlamEngine(infos, SlamConfig(backend="device")).update(scans)
registers each scan set with KISS-ICP and writes per-column poses back;
the device backend (slam.DeviceICP) runs the Gauss-Newton loop on the
device around a hand-written nearest-neighbour kernel
(kernels/csrc/icp_nn.cu), the host backend (slam.KissICP) in numpy.
normals_device and voxel_downsample_device are the device twins of the
numpy normals and voxel_downsample.

Entry points run on CUDA unless the caller names another device; without
a GPU they raise instead of moving to the CPU.
"""

from __future__ import annotations

import os

import numpy as np

__version__ = "0.5.0"

from .core.batcher import ScanBatcher
from .core.constants import RANGE_UNIT, ChanField
from .core.error_handler import (Severity, default_error_handler,
                                 logging_error_handler)
from .core.logging import init_logger
from .core.field import ChanFieldType, FieldClass, FieldType
from .core.lidar_scan import (LidarScan, get_field_types,
                              resolve_field_types)
from .core.metadata import (ValidatorEntry, ValidatorIssues,
                            default_sensor_info, parse_and_validate_config,
                            parse_and_validate_metadata,
                            parse_and_validate_sensor_config, parse_config,
                            sensor_info_from_metadata)
from .core.packets import (ImuPacket, LidarPacket, Packet, PacketType,
                           PacketValidationFailure, ZonePacket)
from .core.scan_utils import (BufferT, ColHeader, FrameBorder,
                              first_valid_column_pose,
                              last_valid_column_pose, packet_ts,
                              poses_present, valid_packet_idxs)
from .core.scans import Packets, Scans
from .core.types import (INVALID_VERSION, BloomReductionOptimization,
                         CalibrationStatus, DataFormat, FullScaleRange,
                         HeaderType, LidarMode, MultipurposeIOMode,
                         NMEABaudRate, OperatingMode, Polarity, ProductInfo,
                         ReturnOrder, SensorConfig, SensorInfo,
                         ShotLimitingStatus, ThermalShutdownStatus,
                         TimestampMode, UDPProfileIMU, UDPProfileLidar,
                         Version)
from .io.cloud_io import read_pointcloud
from .io.derived import (ClippedScanSource, MaskedScanSource,
                         ReducedScanSource)
from .io.device_engine import (DeviceScanIndex, DeviceScanIterator,
                               LiveDeviceBatcher, OsfDeviceProjector,
                               make_osf_projector, supports_device_decode,
                               supports_osf_device_projection)
from .io.frames import (ChunkFuser, FrameReader, PlanarBatch,
                        PlanarStreamAssembler, fused_pipelined)
from .io.osf import OsfScanSource
from .io.pcap import PcapReader, PcapWriter
from .io.pcap_scan_source import PcapScanSource
from .io.pcap_source import PcapPacketSource
from .io.sources import (Collator, IoType, LidarScanSet, MultiScanSource,
                         OusterIoType, PacketSource, ScanSource, Singler,
                         Slicer, SourceURLException, collate, collate_scans,
                         extension_from_io_type, io_type,
                         io_type_from_extension, open_packet_source,
                         open_source, populate_extrinsics)
from .ops.bp64 import bp64_encode_numpy, project_bp64_batched
from .ops.destagger import destagger, destagger_torch, stagger
from .ops.downsample import voxel_downsample, voxel_downsample_device
from .ops.fused import PipelineConfig, ScanPipeline, default_device
from .ops.image_processing import AutoExposure, BeamUniformityCorrector
from .ops.normals import normals, scan_normals
from .ops.normals_device import normals_device
from .ops.lutfree_kernels import (FactorTables, lutfree_supported,
                                  unpack_project_lutfree,
                                  unpack_project_lutfree_dd,
                                  unpack_project_lutfree_planar)
from .ops.packed import (packed_range_fields, project_packed_batched,
                         unfuse_words, unpack_bits)
from .ops.packet_format import PacketFormat, PacketWriter
from .ops.packet_kernels import (lut_planes, unpack_project,
                                 unpack_project_packet,
                                 unpack_project_packet_batched)
from .ops.planar_kernels import (PlanarLut, launches, project_ranges,
                                 project_ranges_batched, reset_launches,
                                 unpack_project_planar_batched, words_tensor)
from .ops.pose import (dewarp, dewarp_np, exp_pose, interp_pose,
                       interp_pose_np, interp_trajectory, log_pose,
                       transform, transform_np)
from .ops.profiles import FieldInfo, add_custom_profile
from .ops.unpack import (decode_frame, decode_frame_batch,
                         decode_frame_planar, decode_frame_planar_batch,
                         frame_words_from_packets, make_decode_plan)
from .ops.xyzlut import (XYZLutDevice, cartesian, cartesian_dd,
                         cartesian_f32, make_xyz_lut, make_xyz_lut_float,
                         to_device_lut)
from .parallel import ShardedScanPipeline, make_mesh, make_mesh_2d
from .sensor.http import (LONG_HTTP_REQUEST_TIMEOUT_SECONDS,
                          SHORT_HTTP_REQUEST_TIMEOUT_SECONDS, SensorHttp)
from .state import (kiss_icp_from_numpy, lidar_scan_from_jax,
                    lidar_scan_from_numpy)
from .utils.pose_util import (euler_pose_to_matrix, interp_pose_float,
                              quaternion_pose_to_matrix)
from . import slam


def XYZLutFactory(info, use_extrinsics: bool = False):
    """Reference-compatible LUT constructor returning a callable that maps a
    scan or range image to (H, W, 3) points (ref: sdk/core/data.py:129
    XYZLut).

    Scans produced by OSF replay carry a device-projected XYZ cache
    (double-single, <= 0.5 f32 ulp of this host f64 path); when a SCAN is
    passed and its range content is unchanged since projection, the cache
    is served instead of re-projecting on the host.
    OUSTER_SDK_TPU_DEVICE_XYZ=0 disables serving (always recompute in
    f64). `project.return_xyz(scan, ret)` does the same for either return
    (0: RANGE, 1: RANGE2); io.derived.filter_xyz projects through it."""
    lut = make_xyz_lut(info, use_extrinsics)

    def return_xyz(scan, ret: int):
        rng = scan.field(ChanField.RANGE2 if ret else ChanField.RANGE)
        if hasattr(scan, "cached_xyz") and \
                os.environ.get("OUSTER_SDK_TPU_DEVICE_XYZ") != "0":
            hit = scan.cached_xyz(ret, use_extrinsics, rng)
            if hit is not None:
                return hit.astype(np.float64)
        return lut(rng)

    def project(scan_or_range):
        if hasattr(scan_or_range, "field"):
            return return_xyz(scan_or_range, 0)
        return lut(np.asarray(scan_or_range))

    project.return_xyz = return_xyz
    return project


def XYZLutFloatFactory(info, use_extrinsics: bool = False):
    """Single-precision variant of XYZLutFactory
    (ref: sdk/core/data.py:176 XYZLutFloat)."""
    lut = make_xyz_lut_float(info, use_extrinsics)

    def project(scan_or_range):
        if hasattr(scan_or_range, "field"):
            rng = scan_or_range.field(ChanField.RANGE)
        else:
            rng = np.asarray(scan_or_range)
        return lut(rng)

    return project


# The reference's ouster.sdk.core exports the data.py factory functions
# under the names XYZLut / XYZLutFloat (shadowing the C++ LUT classes), and
# so does the JAX package; the LUT dataclasses stay importable from
# ops.xyzlut.
XYZLut = XYZLutFactory
XYZLutFloat = XYZLutFloatFactory


# Deprecated aliases kept for reference parity
# (ref: core/__init__.py deprecated_alias block, deprecated since 0.16.0).
from ._deprecation import deprecated_alias, make_module_getattr  # noqa: E402

deprecated_alias("version", "Version", Version, globals())
deprecated_alias("lidar_mode", "LidarMode", LidarMode, globals())
deprecated_alias("timestamp_mode", "TimestampMode", TimestampMode, globals())
deprecated_alias("sensor_config", "SensorConfig", SensorConfig, globals())
deprecated_alias("data_format", "DataFormat", DataFormat, globals())
deprecated_alias("product_info", "ProductInfo", ProductInfo, globals())
deprecated_alias("sensor_info", "SensorInfo", SensorInfo, globals())
deprecated_alias("packet_format", "PacketFormat", PacketFormat, globals())
deprecated_alias("SensorCalibration", "CalibrationStatus",
                 CalibrationStatus, globals())
deprecated_alias("invalid_version", "INVALID_VERSION",
                 INVALID_VERSION, globals())

__getattr__ = make_module_getattr(globals())


__all__ = [
    "bp64_encode_numpy", "cartesian", "cartesian_dd", "cartesian_f32",
    "ChanField", "ChanFieldType", "ChunkFuser", "collate", "collate_scans", "Collator", "DataFormat",
    "decode_frame", "decode_frame_batch", "decode_frame_planar",
    "decode_frame_planar_batch", "default_device", "default_error_handler",
    "default_sensor_info", "destagger", "destagger_torch",
    "DeviceScanIndex", "DeviceScanIterator", "dewarp", "dewarp_np",
    "exp_pose", "extension_from_io_type", "FactorTables", "FieldClass",
    "FieldType", "frame_words_from_packets", "FrameReader",
    "fused_pipelined",
    "get_field_types", "HeaderType", "ImuPacket", "init_logger",
    "interp_pose", "interp_pose_np", "interp_trajectory", "io_type",
    "kiss_icp_from_numpy",
    "io_type_from_extension", "IoType", "launches", "lidar_scan_from_jax",
    "lidar_scan_from_numpy", "LidarMode", "LidarPacket", "LidarScan",
    "LidarScanSet", "LiveDeviceBatcher", "log_pose",
    "logging_error_handler", "LONG_HTTP_REQUEST_TIMEOUT_SECONDS",
    "lut_planes", "lutfree_supported",
    "make_decode_plan", "make_mesh", "make_mesh_2d",
    "make_osf_projector", "make_xyz_lut",
    "make_xyz_lut_float", "MultiScanSource", "normals", "normals_device",
    "open_packet_source",
    "open_source", "OsfDeviceProjector", "OsfScanSource", "OusterIoType",
    "Packet", "packed_range_fields", "PacketFormat", "PacketSource", "PacketWriter", "PcapPacketSource", "PcapReader",
    "PcapScanSource", "PcapWriter", "PipelineConfig", "PlanarBatch",
    "PlanarLut", "PlanarStreamAssembler", "populate_extrinsics",
    "project_bp64_batched", "project_packed_batched", "project_ranges",
    "project_ranges_batched", "reset_launches",
    "resolve_field_types", "ScanBatcher", "ScanPipeline", "ScanSource",
    "scan_normals", "slam",
    "sensor_info_from_metadata", "SensorHttp", "SensorInfo", "Severity",
    "ShardedScanPipeline",
    "SHORT_HTTP_REQUEST_TIMEOUT_SECONDS", "Singler",
    "Slicer", "SourceURLException", "stagger", "supports_device_decode",
    "supports_osf_device_projection", "to_device_lut", "transform",
    "transform_np", "UDPProfileIMU", "UDPProfileLidar", "unfuse_words",
    "unpack_bits", "unpack_project",
    "unpack_project_lutfree", "unpack_project_lutfree_dd",
    "unpack_project_lutfree_planar", "unpack_project_packet",
    "unpack_project_packet_batched", "unpack_project_planar_batched",
    "voxel_downsample", "voxel_downsample_device",
    "words_tensor", "XYZLut", "XYZLutDevice", "XYZLutFactory",
    "XYZLutFloat", "XYZLutFloatFactory", "ZonePacket",
    # the host layer, the enums and the reference's core names
    "add_custom_profile", "AutoExposure", "BeamUniformityCorrector",
    "BloomReductionOptimization", "BufferT", "CalibrationStatus",
    "ClippedScanSource", "ColHeader", "deprecated_alias",
    "euler_pose_to_matrix", "FieldInfo", "first_valid_column_pose",
    "FrameBorder", "FullScaleRange", "INVALID_VERSION", "interp_pose_float",
    "last_valid_column_pose", "make_module_getattr", "MaskedScanSource",
    "MultipurposeIOMode", "NMEABaudRate", "OperatingMode", "packet_ts",
    "Packets", "PacketType", "PacketValidationFailure",
    "parse_and_validate_config", "parse_and_validate_metadata",
    "parse_and_validate_sensor_config", "parse_config", "Polarity",
    "poses_present", "ProductInfo", "quaternion_pose_to_matrix",
    "RANGE_UNIT", "read_pointcloud", "ReducedScanSource", "ReturnOrder",
    "Scans", "SensorConfig", "ShotLimitingStatus", "ThermalShutdownStatus",
    "TimestampMode", "valid_packet_idxs", "ValidatorEntry",
    "ValidatorIssues", "Version",
]
