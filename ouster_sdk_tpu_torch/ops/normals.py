"""Range-image surface normals for single/dual returns.

Rebuild of the reference normals computation (ref: ouster_client/src/
normals.cpp:30-500, include/ouster/normals.h:58,100). The reference walks
pixels in cache-blocked scalar loops; here the same algorithm is evaluated
as data-parallel array passes over the (H, W) grid — one pass per search
radius with per-pixel running best-candidate state, which numpy and
PyTorch vectorize cleanly.

Algorithm (per valid pixel):
  - beam = normalize(xyz - sensor_origin[col])
  - find the best vertical and horizontal neighbor: the valid neighbor whose
    squared distance is closest to target_distance^2, gated by an
    angle-of-incidence threshold derived from the pixel subtent
  - thin-foreground: if every valid neighbor is >= 500 mm farther, the pixel
    is a thin pole -> normal = -beam
  - both neighbors: normal = normalize(cross(v_diff, h_diff)) with sign
    flips so the axes agree; one neighbor: component of the beam
    perpendicular to the diff (negated); none: -beam

The numpy functions are a copy of the JAX package's ops/normals.py, which
its tests/test_normals_conformance.py holds to the reference's compiled
normals.cpp (max |diff| 5.9e-14 over a full single- and dual-return
frame). The device twin is ops/normals_device.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

DEFAULT_TARGET_DISTANCE_METER = 0.025
DEFAULT_MIN_ANGLE_INCIDENCE_RAD = math.pi / 180.0
FOREGROUND_SALIENCE_MM = 500


def _compute_vertical_subtent(range_img: np.ndarray,
                              beams: np.ndarray) -> float:
    """Per-pixel vertical angular subtent from the outermost valid pair in a
    near-center column (ref: normals.cpp:29-75)."""
    h, w = range_img.shape
    mid = w // 2
    for col_offset in range(mid + 1):
        for sign in (-1, 1):
            col = mid + sign * col_offset
            if not 0 <= col < w:
                continue
            valid = np.flatnonzero(range_img[:, col] != 0)
            if valid.size >= 2:
                bottom, top = int(valid[0]), int(valid[-1])
                if top > bottom:
                    v_t, v_b = beams[top, col], beams[bottom, col]
                    dot = float(np.clip(np.dot(v_t, v_b), -1.0, 1.0))
                    return math.acos(dot) / (top - bottom)
    return (0.5 * math.pi) / max(h - 1, 1)


def _axis_candidates(axis: str, radius: int, h: int, w: int):
    """Yield (row_shift, col_shift, flip, wrap) for one radius."""
    if axis == "v":
        yield (-radius, 0, True, False)   # up
        yield (radius, 0, False, False)   # down
    else:
        yield (0, -radius, True, True)    # left (wraps)
        yield (0, radius, False, True)    # right (wraps)


def _shifted(arr: np.ndarray, dr: int, dc: int, wrap_cols: bool,
             fill=0) -> np.ndarray:
    """arr[(u+dr, v+dc)] with vertical edge fill and horizontal wrap
    (or edge fill when wrap_cols is False)."""
    out = arr
    if dc:
        out = np.roll(out, -dc, axis=1)
        if not wrap_cols:
            out = out.copy()
            if dc > 0:
                out[:, -dc:] = fill
            else:
                out[:, :-dc] = fill
    if dr:
        out = np.roll(out, -dr, axis=0)
        if dr > 0:
            out = out.copy()
            out[-dr:] = fill
        else:
            out = out.copy()
            out[:-dr] = fill
    return out


def _find_best_neighbors(
    axis: str, xyz: np.ndarray, rng: np.ndarray,
    xyz2: Optional[np.ndarray], rng2: Optional[np.ndarray],
    thresh_sq: np.ndarray, target_sq: float, search_range: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized find_best_neighbor (ref: normals.cpp:170-300).

    Returns (found (H,W), diff (H,W,3), flip (H,W), thin (H,W))."""
    h, w = rng.shape
    inf = np.inf
    best_d_sq = np.full((h, w), inf)
    best_diff = np.zeros((h, w, 3))
    best_flip = np.zeros((h, w), bool)
    best_radius = np.ones((h, w))
    thin = np.ones((h, w), bool)
    good = np.zeros((h, w), bool)
    active = np.ones((h, w), bool)

    center_r = rng.astype(np.int64)

    returns = [(xyz, rng)]
    if xyz2 is not None and rng2 is not None:
        returns.append((xyz2, rng2))

    for radius in range(1, search_range + 1):
        for dr, dc, flip, wrap in _axis_candidates(axis, radius, h, w):
            for nb_xyz, nb_rng in returns:
                n_r = _shifted(nb_rng, dr, dc, wrap)
                n_xyz = _shifted(nb_xyz, dr, dc, wrap)
                valid = (n_r != 0) & active
                diff = n_xyz - xyz
                d_sq = np.einsum("hwc,hwc->hw", diff, diff)
                # thin-foreground update: any neighbor closer than 500 mm
                # beyond center clears the flag
                salient = (n_r.astype(np.int64) - center_r) < \
                    FOREGROUND_SALIENCE_MM
                thin &= ~(valid & salient)
                err = np.abs(d_sq - target_sq)
                better = valid & (err < np.abs(best_d_sq - target_sq))
                best_d_sq = np.where(better, d_sq, best_d_sq)
                best_diff = np.where(better[..., None], diff, best_diff)
                best_flip = np.where(better, flip, best_flip)
                best_radius = np.where(better, radius, best_radius)

        # acceptance (ref: normals.cpp:276-292)
        cap = best_radius * best_radius * thresh_sq
        good |= active & (best_d_sq >= target_sq) & (best_d_sq < cap)
        if radius == search_range:
            good |= active & (best_d_sq > 0) & (best_d_sq < cap)
        # early break once good and not thin
        active &= ~(good & ~thin)

    found = good & np.isfinite(best_d_sq)
    return found, best_diff, best_flip, thin


def normals(
    xyz: np.ndarray,
    range_img: np.ndarray,
    sensor_origins_xyz: np.ndarray,
    xyz2: Optional[np.ndarray] = None,
    range2: Optional[np.ndarray] = None,
    pixel_search_range: int = 1,
    min_angle_of_incidence_rad: float = DEFAULT_MIN_ANGLE_INCIDENCE_RAD,
    target_distance_m: float = DEFAULT_TARGET_DISTANCE_METER,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Compute unit normals for destaggered clouds.

    xyz: (H, W, 3) destaggered; range_img: (H, W) u32 mm;
    sensor_origins_xyz: (W, 3). Returns ((H, W, 3) normals,
    (H, W, 3) second-return normals | None).
    """
    if target_distance_m <= 0:
        raise ValueError("normals: target_distance_m must be positive")
    if min_angle_of_incidence_rad <= 0:
        raise ValueError(
            "normals: min_angle_of_incidence_rad must be positive")
    h, w = range_img.shape
    xyz = np.asarray(xyz, dtype=np.float64).reshape(h, w, 3)
    if sensor_origins_xyz.shape[0] != w:
        raise ValueError(
            "normals: sensor_origins size must match image width")

    out2 = None
    if xyz2 is not None and range2 is not None:
        xyz2 = np.asarray(xyz2, dtype=np.float64).reshape(h, w, 3)
        # the dual overload computes the first return's beams and vertical
        # pixel subtent ONCE and shares them with BOTH passes so thresholds
        # stay consistent (ref: normals.cpp:480-536); recomputing the
        # subtent from the sparser second return shifts boundary-pixel
        # decisions
        dir1 = xyz - sensor_origins_xyz[None, :, :]
        mag1 = np.linalg.norm(dir1, axis=-1, keepdims=True)
        beams1 = np.where(mag1 > 0, dir1 / np.maximum(mag1, 1e-300), 0.0)
        v_subtent = _compute_vertical_subtent(range_img, beams1)
        out1 = _normals_single(xyz, range_img, sensor_origins_xyz, xyz2,
                               range2, pixel_search_range,
                               min_angle_of_incidence_rad, target_distance_m,
                               v_subtent=v_subtent, beams=beams1)
        out2 = _normals_single(xyz2, range2, sensor_origins_xyz, xyz,
                               range_img, pixel_search_range,
                               min_angle_of_incidence_rad, target_distance_m,
                               v_subtent=v_subtent)
    else:
        out1 = _normals_single(xyz, range_img, sensor_origins_xyz, None,
                               None, pixel_search_range,
                               min_angle_of_incidence_rad, target_distance_m)
    return out1, out2


def _normals_single(xyz, range_img, origins, xyz2, range2, search_range,
                    min_aoi, target_m, v_subtent=None,
                    beams=None) -> np.ndarray:
    h, w = range_img.shape
    target_sq = target_m * target_m
    safe_aoi = max(min_aoi, 1e-6)

    if beams is None:
        direction = xyz - origins[None, :, :]
        mag = np.linalg.norm(direction, axis=-1, keepdims=True)
        beams = np.where(mag > 0, direction / np.maximum(mag, 1e-300), 0.0)

    h_subtent = 2.0 * math.pi / w
    if v_subtent is None:
        v_subtent = _compute_vertical_subtent(range_img, beams)

    # AOI gating thresholds per pixel (ref: normals.cpp:152-163)
    def thresh_sq(subtent: float) -> np.ndarray:
        perimeter = 2.0 * math.pi * (range_img.astype(np.float64) * 0.001)
        px_res = (2.0 * math.pi) / subtent
        min_spacing = perimeter / px_res
        t = min_spacing / math.tan(safe_aoi)
        return t * t

    if xyz2 is not None:
        xyz2 = np.asarray(xyz2, dtype=np.float64).reshape(h, w, 3)

    v_found, v_diff, v_flip, v_thin = _find_best_neighbors(
        "v", xyz, range_img, xyz2, range2, thresh_sq(v_subtent), target_sq,
        search_range)
    h_found, h_diff, h_flip, h_thin = _find_best_neighbors(
        "h", xyz, range_img, xyz2, range2, thresh_sq(h_subtent), target_sq,
        search_range)

    valid = (range_img != 0) & (np.einsum("hwc,hwc->hw", beams, beams)
                                > np.finfo(np.float64).eps)
    out = np.zeros((h, w, 3))

    thin_both = v_thin & h_thin
    case_a = valid & ((~v_found & ~h_found) | thin_both)
    out[case_a] = -beams[case_a]

    def project_perp(diff, mask):
        denom = np.einsum("hwc,hwc->hw", diff, diff)
        ok = mask & (np.abs(denom) > np.finfo(np.float64).eps)
        dot = np.einsum("hwc,hwc->hw", diff, beams)
        proj = beams - (dot / np.maximum(denom, 1e-300))[..., None] * diff
        n_sq = np.einsum("hwc,hwc->hw", proj, proj)
        ok &= np.abs(n_sq) > np.finfo(np.float64).eps
        unit = -proj / np.maximum(np.sqrt(n_sq), 1e-300)[..., None]
        out[ok] = unit[ok]

    case_b_v = valid & ~case_a & v_found & (~h_found | h_thin)
    project_perp(v_diff, case_b_v)
    case_b_h = valid & ~case_a & h_found & (~v_found | v_thin) & ~case_b_v
    project_perp(h_diff, case_b_h)

    case_c = valid & ~case_a & ~case_b_v & ~case_b_h & v_found & h_found
    vd = np.where((h_flip != v_flip)[..., None], -v_diff, v_diff)
    n = np.cross(vd, h_diff)
    mag_n = np.linalg.norm(n, axis=-1, keepdims=True)
    ok_c = case_c & (mag_n[..., 0] != 0)
    out[ok_c] = (n / np.maximum(mag_n, 1e-300))[ok_c]
    return out


def scan_normals(scan, info=None, use_extrinsics: bool = False,
                 backend: str = "numpy", device=None):
    """Convenience: compute NORMALS (and NORMALS2) for a LidarScan in the
    sensor frame and write them back as fields (ref: processing.cpp bound
    normals overloads). backend="device" runs ops/normals_device.py in
    float32 on `device` (CUDA when none is named; raises without a GPU);
    backend="numpy" is the float64 host version."""
    from ..core.constants import ChanField
    from ..core.field import FieldClass, FieldType
    from .destagger import destagger
    from .xyzlut import make_xyz_lut

    if backend == "jax":
        raise ValueError('the normals backend "jax" is the JAX package\'s; '
                         'this package\'s device backend is "device"')
    if backend not in ("numpy", "device"):
        raise ValueError(f"unknown normals backend {backend!r}")
    info = info or scan.sensor_info
    lut = make_xyz_lut(info, use_extrinsics)
    rng = scan.field(ChanField.RANGE)
    xyz = destagger(info, lut(rng))
    rng_d = destagger(info, rng)
    origins = np.zeros((scan.w, 3))

    xyz2 = rng2_d = None
    if scan.has_field(ChanField.RANGE2):
        rng2 = scan.field(ChanField.RANGE2)
        xyz2 = destagger(info, lut(rng2))
        rng2_d = destagger(info, rng2)

    if backend == "device":
        from .normals_device import normals_device

        f32 = (lambda a: None if a is None else a.astype(np.float32))
        n1, n2 = normals_device(f32(xyz), rng_d, f32(origins), f32(xyz2),
                                rng2_d, device=device)
        n1 = n1.cpu().numpy()
        n2 = None if n2 is None else n2.cpu().numpy()
    else:
        n1, n2 = normals(xyz, rng_d, origins, xyz2, rng2_d)
    from .destagger import stagger

    n1_st = stagger(info, n1).astype(np.float32)
    if not scan.has_field(ChanField.NORMALS):
        scan.add_field(FieldType(ChanField.NORMALS, np.float32, (3,),
                                 FieldClass.PIXEL_FIELD), n1_st)
    else:
        scan.field(ChanField.NORMALS)[:] = n1_st
    if n2 is not None:
        n2_st = stagger(info, n2).astype(np.float32)
        if not scan.has_field(ChanField.NORMALS2):
            scan.add_field(FieldType(ChanField.NORMALS2, np.float32, (3,),
                                     FieldClass.PIXEL_FIELD), n2_st)
        else:
            scan.field(ChanField.NORMALS2)[:] = n2_st
    return scan
