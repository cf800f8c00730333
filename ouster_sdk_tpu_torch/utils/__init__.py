"""Utility namespace mirroring the reference's ``ouster.sdk.util``
(ref: python/src/ouster/sdk/util/__init__.py)."""

from .metadata import resolve_metadata, resolve_metadata_multi  # noqa: F401
from .extrinsics import (  # noqa: F401
    fov_horizontal,
    fov_vertical,
    img_aspect_ratio,
    parse_extrinsics_from_string,
    position_quaternion_to_transform,
    quaternion_to_rotation_matrix,
    resolve_extrinsics,
    rotation_matrix_to_quaternion,
    xyzq_to_matrix,
    xyzrpy_to_matrix,
)
from .progress_bar import ProgressBar, progress_bar, progressbar  # noqa: F401
from .forward_slicer import ForwardSlicer  # noqa: F401
from .pose_util import (  # noqa: F401
    Trajectory,
    dewarp,
    euler_pose_to_matrix,
    interp_pose,
    interp_pose_float,
    quaternion_pose_to_matrix,
    transform,
)


def scan_to_packets(scan, info):
    """Re-packetize a scan (ref: util/parsing.py scan_to_packets)."""
    from ..io.save import scan_to_packets as _impl

    return _impl(scan, info)


def resolve_field_types(metadata, raw_headers: bool = False,
                        raw_fields: bool = False, field_names=None):
    """(ref: util/__init__.py resolve_field_types re-export)"""
    from ..core.lidar_scan import resolve_field_types as _impl

    return _impl(metadata, raw_headers, raw_fields, field_names)
