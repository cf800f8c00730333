"""Device surface normals: the PyTorch twin of ops/normals.py.

The same algorithm as the host implementation (ref: ouster_client/src/
normals.cpp:30-500): per-pixel best vertical/horizontal neighbor search
with AOI gating, thin-foreground detection, and the four-case normal
assembly, as shift/where/reduce passes over the (H, W) grid in plain
PyTorch on the inputs' device. The vertical-subtent probe (the reference's
first usable column walking outward from the center) is an argmin over a
per-column preference score, so nothing is read back to the host. It is
the counterpart of the JAX package's ops/normals_jax.py.

Precision: the math runs in the input's float dtype. In float32 unit
normals are good to ~1e-6, and a small boundary population can flip
case/neighbor decisions against the float64 host path; in float64 it
matches the host implementation but for exact neighbor-distance ties.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .normals import (
    DEFAULT_MIN_ANGLE_INCIDENCE_RAD,
    DEFAULT_TARGET_DISTANCE_METER,
    FOREGROUND_SALIENCE_MM,
    _axis_candidates,
)
from .fused import resolve_device


def _shifted(arr: torch.Tensor, dr: int, dc: int, wrap_cols: bool
             ) -> torch.Tensor:
    """arr[(u+dr, v+dc)] with vertical edge zero-fill and horizontal
    wrap (or edge fill when wrap_cols is False) — ops/normals._shifted
    semantics on the device."""
    out = arr
    extra = (None,) * (arr.ndim - 2)  # broadcast masks over trailing dims
    zero = torch.zeros((), dtype=arr.dtype, device=arr.device)
    if dc:
        out = torch.roll(out, -dc, dims=1)
        if not wrap_cols:
            w = arr.shape[1]
            cols = torch.arange(w, device=arr.device)
            mask = (cols >= w - dc) if dc > 0 else (cols < -dc)
            out = torch.where(mask[(None, slice(None)) + extra], zero, out)
    if dr:
        out = torch.roll(out, -dr, dims=0)
        h = arr.shape[0]
        rows = torch.arange(h, device=arr.device)
        mask = (rows >= h - dr) if dr > 0 else (rows < -dr)
        out = torch.where(mask[(slice(None), None) + extra], zero, out)
    return out


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _beams(xyz: torch.Tensor, origins: torch.Tensor,
           tiny: torch.Tensor) -> torch.Tensor:
    direction = xyz - origins[None, :, :]
    mag = _norm(direction)
    return torch.where(mag > 0, direction / torch.maximum(mag, tiny),
                       torch.zeros((), dtype=xyz.dtype, device=xyz.device))


def _vertical_subtent(range_img: torch.Tensor, beams: torch.Tensor
                      ) -> torch.Tensor:
    """Vectorized _compute_vertical_subtent (ref: normals.cpp:29-75):
    the reference walks columns outward from the center (left candidate
    before right at each offset) and takes the first with >= 2 valid
    pixels; here an argmin over the per-column preference score
    2*|c-mid| + (c>mid)."""
    h, w = range_img.shape
    device = range_img.device
    validpx = range_img != 0
    rows = torch.arange(h, device=device)[:, None]
    first = torch.where(validpx, rows, h).amin(dim=0)
    last = torch.where(validpx, rows, -1).amax(dim=0)
    ok = last > first  # >= 2 valid pixels in the column

    mid = w // 2
    cols = torch.arange(w, device=device)
    pref = 2 * (cols - mid).abs() + (cols > mid).to(cols.dtype)
    c = torch.argmin(torch.where(ok, pref, 4 * w))
    # an empty column's first/last lie outside the image: clamped (jnp's
    # gathers clamp; torch's raise), and unused, since then no column is ok
    b_top = beams[last[c].clamp(min=0), c]
    b_bot = beams[first[c].clamp(max=h - 1), c]
    dot = torch.clamp((b_top * b_bot).sum(), -1.0, 1.0)
    span = torch.clamp(last[c] - first[c], min=1).to(beams.dtype)
    fallback = torch.tensor((0.5 * math.pi) / max(h - 1, 1),
                            dtype=beams.dtype, device=device)
    return torch.where(ok.any(), torch.arccos(dot) / span, fallback)


def _find_best_neighbors(axis, xyz, rng, xyz2, rng2, thresh_sq, target_sq,
                         search_range):
    """Vectorized find_best_neighbor (ref: normals.cpp:170-300) on the
    device. Returns (found, diff, flip, thin)."""
    h, w = rng.shape
    f = dict(dtype=xyz.dtype, device=xyz.device)
    b = dict(dtype=torch.bool, device=xyz.device)
    best_d_sq = torch.full((h, w), float("inf"), **f)
    best_diff = torch.zeros((h, w, 3), **f)
    best_flip = torch.zeros((h, w), **b)
    best_radius = torch.ones((h, w), **f)
    thin = torch.ones((h, w), **b)
    good = torch.zeros((h, w), **b)
    active = torch.ones((h, w), **b)

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
                d_sq = (diff * diff).sum(dim=-1)
                # thin-foreground update: any neighbor closer than 500 mm
                # beyond center clears the flag
                salient = (n_r - rng) < FOREGROUND_SALIENCE_MM
                thin &= ~(valid & salient)
                err = (d_sq - target_sq).abs()
                better = valid & (err < (best_d_sq - target_sq).abs())
                best_d_sq = torch.where(better, d_sq, best_d_sq)
                best_diff = torch.where(better[..., None], diff, best_diff)
                best_flip = torch.where(better, flip, best_flip)
                best_radius = torch.where(better, float(radius),
                                          best_radius)

        # acceptance (ref: normals.cpp:276-292)
        cap = best_radius * best_radius * thresh_sq
        good |= active & (best_d_sq >= target_sq) & (best_d_sq < cap)
        if radius == search_range:
            good |= active & (best_d_sq > 0) & (best_d_sq < cap)
        # early break once good and not thin
        active &= ~(good & ~thin)

    found = good & torch.isfinite(best_d_sq)
    return found, best_diff, best_flip, thin


def _normals_single(xyz, range_img, origins, xyz2, range2, search_range,
                    min_aoi, target_m, v_subtent=None, beams=None):
    h, w = range_img.shape
    dtype, device = xyz.dtype, xyz.device
    target_sq = torch.tensor(target_m * target_m, dtype=dtype, device=device)
    safe_aoi = max(min_aoi, 1e-6)
    eps = torch.tensor(torch.finfo(dtype).eps, dtype=dtype, device=device)
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=dtype,
                        device=device)

    if beams is None:
        beams = _beams(xyz, origins, tiny)

    h_subtent = 2.0 * math.pi / w
    if v_subtent is None:
        v_subtent = _vertical_subtent(range_img, beams)

    def thresh_sq(subtent):
        # AOI gating thresholds per pixel (ref: normals.cpp:152-163)
        perimeter = 2.0 * math.pi * (range_img.to(dtype) * 0.001)
        px_res = (2.0 * math.pi) / subtent
        min_spacing = perimeter / px_res
        t = min_spacing / math.tan(safe_aoi)
        return t * t

    v_found, v_diff, v_flip, v_thin = _find_best_neighbors(
        "v", xyz, range_img, xyz2, range2, thresh_sq(v_subtent), target_sq,
        search_range)
    h_found, h_diff, h_flip, h_thin = _find_best_neighbors(
        "h", xyz, range_img, xyz2, range2, thresh_sq(h_subtent), target_sq,
        search_range)

    valid = (range_img != 0) & ((beams * beams).sum(dim=-1) > eps)
    out = torch.zeros((h, w, 3), dtype=dtype, device=device)

    thin_both = v_thin & h_thin
    case_a = valid & ((~v_found & ~h_found) | thin_both)
    out = torch.where(case_a[..., None], -beams, out)

    def project_perp(out, diff, mask):
        denom = (diff * diff).sum(dim=-1)
        ok = mask & (denom.abs() > eps)
        dot = (diff * beams).sum(dim=-1)
        proj = beams - (dot / torch.maximum(denom, tiny))[..., None] * diff
        n_sq = (proj * proj).sum(dim=-1)
        ok &= n_sq.abs() > eps
        unit = -proj / torch.maximum(torch.sqrt(n_sq), tiny)[..., None]
        return torch.where(ok[..., None], unit, out)

    case_b_v = valid & ~case_a & v_found & (~h_found | h_thin)
    out = project_perp(out, v_diff, case_b_v)
    case_b_h = valid & ~case_a & h_found & (~v_found | v_thin) & ~case_b_v
    out = project_perp(out, h_diff, case_b_h)

    case_c = valid & ~case_a & ~case_b_v & ~case_b_h & v_found & h_found
    vd = torch.where((h_flip != v_flip)[..., None], -v_diff, v_diff)
    n = torch.linalg.cross(vd, h_diff, dim=-1)
    mag_n = _norm(n)
    ok_c = case_c & (mag_n[..., 0] != 0)
    out = torch.where(ok_c[..., None], n / torch.maximum(mag_n, tiny), out)
    return out


def normals_device(
    xyz,
    range_img,
    sensor_origins_xyz,
    xyz2=None,
    range2=None,
    pixel_search_range: int = 1,
    min_angle_of_incidence_rad: float = DEFAULT_MIN_ANGLE_INCIDENCE_RAD,
    target_distance_m: float = DEFAULT_TARGET_DISTANCE_METER,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Device twin of ops/normals.normals: the same signature plus
    `device`; returns ((H, W, 3) normals, second-return normals | None) as
    tensors. Inputs are numpy arrays or tensors; the math runs in xyz's
    float dtype (float32 or float64) on `device`, else on the device of
    the first tensor among the inputs, else on CUDA (raises without a
    GPU)."""
    if target_distance_m <= 0:
        raise ValueError("normals: target_distance_m must be positive")
    if min_angle_of_incidence_rad <= 0:
        raise ValueError(
            "normals: min_angle_of_incidence_rad must be positive")
    device = resolve_device(device, xyz, range_img, sensor_origins_xyz,
                            xyz2, range2)
    xyz = torch.as_tensor(xyz)
    if xyz.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"normals: xyz must be float32 or float64, got "
                         f"{xyz.dtype}")
    dtype = xyz.dtype

    def as_range(r):
        r = torch.as_tensor(np.asarray(r, dtype=np.int64)
                            if not isinstance(r, torch.Tensor) else r)
        return r.to(device, torch.int64)

    range_img = as_range(range_img)
    h, w = range_img.shape
    xyz = xyz.to(device).reshape(h, w, 3)
    origins = torch.as_tensor(sensor_origins_xyz).to(device, dtype)
    if origins.shape[0] != w:
        raise ValueError(
            "normals: sensor_origins size must match image width")
    search = int(pixel_search_range)
    aoi = float(min_angle_of_incidence_rad)
    target = float(target_distance_m)
    if xyz2 is None or range2 is None:
        return _normals_single(xyz, range_img, origins, None, None, search,
                               aoi, target), None
    xyz2 = torch.as_tensor(xyz2).to(device, dtype).reshape(h, w, 3)
    range2 = as_range(range2)
    # the dual overload shares the first return's beams + vertical
    # subtent with BOTH passes (ref: normals.cpp:480-536)
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=dtype, device=device)
    beams1 = _beams(xyz, origins, tiny)
    v_subtent = _vertical_subtent(range_img, beams1)
    out1 = _normals_single(xyz, range_img, origins, xyz2, range2, search,
                           aoi, target, v_subtent=v_subtent, beams=beams1)
    out2 = _normals_single(xyz2, range2, origins, xyz, range_img, search,
                           aoi, target, v_subtent=v_subtent)
    return out1, out2
