"""LUT-free range -> XYZ projection: the factor tables, the wrappers, their
kernel route and their plain versions.

For a spinning sensor the projection factorizes exactly (ref:
xyzlut.cpp:38-93): with per-row beam angles and a per-column encoder
angle,

    dir = ce * P + se * Q + S
    off = ce * E + se * F + G
    xyz = r * dir + off,   0 where r == 0

where P, Q, S, E, F, G are six per-row 3-vectors (the lidar_to_sensor
rotation and the range unit folded in) and ce, se = cos, sin of the encoder
angle are per-column scalars. `FactorTables` holds them, 36 floats a row
and 4 a column instead of 12 LUT values a pixel, so the projection's
traffic is the range words in and XYZ out. Sensors with per-pixel angle
tables do not factorize and take the LUT projections
(ops/planar_kernels.py, ops/packet_kernels.py).

Three entry points, counterparts of the reference's ops/pallas_lutfree.py
without its `tile_w` and `interpret` arguments, which are TPU block knobs:
`unpack_project_lutfree` (packet-layout frames, f32),
`unpack_project_lutfree_dd` (packet-layout, double-single, one or both
returns) and `unpack_project_lutfree_planar` (word-planar frames,
double-single). A tensor on the CPU takes the plain PyTorch version below;
a CUDA tensor launches the hand-written kernel
(kernels/csrc/lutfree_project.cu), or the wrapper raises. There is no
fallback from one to the other.

Numerics, which the kernels repeat op for op: the double-single entry
points carry every table as an (hi, lo) f32 pair and run synthesis and
projection in error-free transforms (`precision.dd_mul`, `dd_add`,
`dd_mul_f`), every product and sum rounded on its own, landing within
1 f32 ulp of the float64 projection. The f32 entry point evaluates the
formulas above on the hi parts with one rounding an op, never contracted
into a fused multiply-add.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.constants import RANGE_UNIT
from ..core.types import SensorInfo
from .fused import default_device
from .packet_kernels import _check_frames, packet_ranges
from .planar_kernels import _range_fields, status_valid_mask_batched
from .precision import dd_add, dd_mul, dd_mul_f, split_f64_array
from .unpack import DecodePlan, _bits, make_decode_plan

#: Kernel launches per case, counted by the wrapper where it launches the
#: CUDA kernel and nowhere else. Keys are named after the four projection
#: functions they replace.
launches: Dict[str, int] = {}

CASES = ("lutfree", "lutfree_dd", "lutfree_dd_dual", "lutfree_dd_planar")


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()


class FactorTables:
    """Per-row and per-column projection factors of a spinning sensor.

    Sixteen f32 leaves on `device`, each table an (hi, lo) pair: P, Q, S,
    E, F, G as (3, h, 1) and ce, se as (1, w). `rows` (h, 36) and `cols`
    (w, 4) are the same values packed for the kernels: for each of P, Q,
    S, E, F, G its hi[3] then its lo[3]; ce_hi, ce_lo, se_hi, se_lo.
    """

    _LEAVES = ("P", "P_lo", "Q", "Q_lo", "S", "S_lo", "E", "E_lo",
               "F", "F_lo", "G", "G_lo", "ce", "ce_lo", "se", "se_lo")

    def __init__(self, info: SensorInfo, use_extrinsics: bool = False,
                 device=None):
        fmt = info.format
        h, w = fmt.pixels_per_column, fmt.columns_per_frame
        azi = np.asarray(info.beam_azimuth_angles, dtype=np.float64)
        alt = np.asarray(info.beam_altitude_angles, dtype=np.float64)
        if azi.size != h or alt.size != h:
            raise ValueError("LUT-free projection requires per-row beam "
                             "angles (OS sensors)")

        b2l = np.asarray(info.beam_to_lidar_transform, dtype=np.float64)
        D = b2l[0, 3]
        if b2l[2, 3] != 0:
            D = math.sqrt(b2l[0, 3] ** 2 + b2l[2, 3] ** 2)
        Bx, Bz = b2l[0, 3], b2l[2, 3]

        T = info.lidar_to_sensor_transform
        if use_extrinsics:
            ext = info.extrinsic.copy()
            ext[:3, 3] /= RANGE_UNIT
            T = ext @ info.lidar_to_sensor_transform
        R = np.asarray(T, dtype=np.float64)[:3, :3]
        t = np.asarray(T, dtype=np.float64)[:3, 3]

        theta_a = -azi * math.pi / 180.0
        phi = alt * math.pi / 180.0
        A = np.cos(theta_a) * np.cos(phi)
        B = np.sin(theta_a) * np.cos(phi)
        C = np.sin(phi)

        zeros = np.zeros_like(A)
        pr = np.stack([A, B, zeros], axis=0)      # (3, h) pre-rotation
        qr = np.stack([-B, A, zeros], axis=0)
        sr = np.stack([zeros, zeros, C], axis=0)

        # rotate: columns are vectors
        P = R @ pr
        Q = R @ qr
        S = R @ sr
        E = (Bx * R[:, 0])[:, None] - D * P
        F = (Bx * R[:, 1])[:, None] - D * Q
        G = (Bz * R[:, 2])[:, None] - D * S + t[:, None]

        # r (mm) multiplies dir: fold the unit into the dir tables; offsets
        # are in mm as well -> scale both (ref: xyzlut.cpp:91-93)
        u = RANGE_UNIT
        col = np.arange(w, dtype=np.float64)
        theta_e = 2.0 * math.pi - col * (2.0 * math.pi / w)
        leaves = {}
        for name, x in (("P", u * P), ("Q", u * Q), ("S", u * S),
                        ("E", u * E), ("F", u * F), ("G", u * G)):
            leaves[name], leaves[name + "_lo"] = split_f64_array(
                x[:, :, None])                                  # (3, h, 1)
        for name, x in (("ce", np.cos(theta_e)), ("se", np.sin(theta_e))):
            leaves[name], leaves[name + "_lo"] = split_f64_array(
                x[None, :])                                     # (1, w)
        self._set(leaves, default_device() if device is None else device)

    @classmethod
    def from_leaves(cls, leaves: Dict[str, np.ndarray], device
                    ) -> "FactorTables":
        """From the sixteen leaves as numpy arrays, by the names in
        `_LEAVES`."""
        missing = [n for n in cls._LEAVES if n not in leaves]
        if missing:
            raise ValueError(f"factor table leaves missing: {missing}")
        self = cls.__new__(cls)
        self._set({n: np.asarray(leaves[n]) for n in cls._LEAVES}, device)
        return self

    def _set(self, leaves: Dict[str, np.ndarray], device) -> None:
        h, w = leaves["P"].shape[1], leaves["ce"].shape[1]
        for n in self._LEAVES:
            shape = (1, w) if n.startswith(("ce", "se")) else (3, h, 1)
            if leaves[n].shape != shape:
                raise ValueError(f"factor table {n} must be {shape}, got "
                                 f"{leaves[n].shape}")
        leaves = {n: np.array(leaves[n], dtype=np.float32, order="C")
                  for n in self._LEAVES}
        for n, v in leaves.items():
            setattr(self, n, torch.from_numpy(v).to(device))
        rows = np.concatenate(
            [leaves[n][:, :, 0].T for n in self._LEAVES[:12]], axis=1)
        cols = np.concatenate(
            [leaves[n].T for n in self._LEAVES[12:]], axis=1)
        self.rows = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
        self.cols = torch.from_numpy(np.ascontiguousarray(cols)).to(device)


def lutfree_supported(info: SensorInfo) -> bool:
    """Static eligibility for the LUT-free family.

    True when the projection factorizes into the six per-row tables: one
    azimuth and one altitude angle per pixel row (per-pixel w * h tables
    do not factorize, ref: xyzlut.cpp:52-64) and every RANGE plane of the
    profile lives in one u32 word. Other sensors, and profiles without a
    RANGE plane at all (FIVE_WORD_PIXEL decodes raw words only), take the
    LUT projections."""
    h = info.format.pixels_per_column
    if (len(info.beam_azimuth_angles or []) != h
            or len(info.beam_altitude_angles or []) != h):
        return False
    try:
        plan = make_decode_plan(info)
    except Exception:
        return False
    names = {f.name for f in plan.fields}
    if "RANGE" not in names:
        return False
    try:
        _range_fields(plan, "RANGE2" in names)
    except (ValueError, NotImplementedError):
        return False
    return True


# -- the plain versions ------------------------------------------------------

def _range_f32(r: torch.Tensor) -> torch.Tensor:
    """Integer range (B, h, w) int64 in mm -> (B, 1, h, w) f32; exact
    below 2**24."""
    return r.to(torch.float32)[:, None]


def _dd_dirs_offs(t: FactorTables):
    """dir = ce*P + se*Q + S, off = ce*E + se*F + G in double-single:
    (dir_hi, dir_lo, off_hi, off_lo), each (3, h, w)."""
    ce, cel = t.ce[None], t.ce_lo[None]           # (1, 1, w)
    se, sel = t.se[None], t.se_lo[None]

    dh, dl = dd_mul(ce, cel, t.P, t.P_lo)
    th, tl = dd_mul(se, sel, t.Q, t.Q_lo)
    dh, dl = dd_add(dh, dl, th, tl)
    dh, dl = dd_add(dh, dl, t.S, t.S_lo)

    oh, ol = dd_mul(ce, cel, t.E, t.E_lo)
    th, tl = dd_mul(se, sel, t.F, t.F_lo)
    oh, ol = dd_add(oh, ol, th, tl)
    oh, ol = dd_add(oh, ol, t.G, t.G_lo)
    return dh, dl, oh, ol


def _zero_where_no_return(r: torch.Tensor, xyz: torch.Tensor
                          ) -> torch.Tensor:
    return torch.where(r != 0, xyz, torch.zeros((), dtype=torch.float32,
                                                device=xyz.device))


def _dd_project(r: torch.Tensor, dh, dl, oh, ol) -> torch.Tensor:
    """r (B, 1, h, w) f32 and (3, h, w) double-single dir and off ->
    (B, 3, h, w) f32."""
    xh, xl = dd_mul_f(dh, dl, r)
    xh, xl = dd_add(xh, xl, oh, ol)
    return _zero_where_no_return(r, xh + xl)


def _f32_project(r: torch.Tensor, t: FactorTables) -> torch.Tensor:
    """The f32 chain on the hi parts, one rounding an op."""
    ce, se = t.ce[None], t.se[None]
    dirs = ce * t.P + se * t.Q + t.S              # (3, h, w)
    off = ce * t.E + se * t.F + t.G
    return _zero_where_no_return(r, r * dirs + off)


def unpack_project_lutfree_plain(frames_words: torch.Tensor,
                                 tables: FactorTables, plan: DecodePlan
                                 ) -> torch.Tensor:
    """The plain PyTorch version of unpack_project_lutfree on batched
    frames (B, n_pkts, pkt_words), on any device."""
    (r,) = packet_ranges(frames_words, plan, False)
    return _f32_project(_range_f32(r), tables)


def unpack_project_lutfree_dd_plain(frames_words: torch.Tensor,
                                    tables: FactorTables, plan: DecodePlan,
                                    dual: bool = False):
    """The plain PyTorch version of unpack_project_lutfree_dd on batched
    frames, on any device."""
    tabs = _dd_dirs_offs(tables)
    outs = tuple(_dd_project(_range_f32(r), *tabs)
                 for r in packet_ranges(frames_words, plan, dual))
    return outs if dual else outs[0]


def unpack_project_lutfree_planar_plain(planes: torch.Tensor,
                                        col_hdrs: torch.Tensor,
                                        tables: FactorTables,
                                        plan: DecodePlan) -> torch.Tensor:
    """The plain PyTorch version of unpack_project_lutfree_planar on
    batched planes (B, pw, h, w) and col_hdrs (B, schw, w), on any
    device."""
    _check_planes(planes, col_hdrs, plan)
    (f,) = _range_fields(plan, False)
    r = _bits(planes[:, f.word], None, f.bit, f.size, f.upshift)
    r = torch.where(status_valid_mask_batched(col_hdrs, plan), r,
                    torch.zeros((), dtype=r.dtype, device=r.device))
    return _dd_project(_range_f32(r), *_dd_dirs_offs(tables))


# -- the wrappers ------------------------------------------------------------

def _check_planes(planes: torch.Tensor, col_hdrs: torch.Tensor,
                  plan: DecodePlan) -> None:
    if planes.ndim != 4 or tuple(planes.shape[1:]) != (plan.pw, plan.h,
                                                       plan.w):
        raise ValueError(
            f"planes must be (B, pw, h, w) = (B, {plan.pw}, {plan.h}, "
            f"{plan.w}), got {tuple(planes.shape)}")
    if tuple(col_hdrs.shape) != (planes.shape[0], plan.schw, plan.w):
        raise ValueError(
            f"col_hdrs must be (B, schw, w) = ({planes.shape[0]}, "
            f"{plan.schw}, {plan.w}), got {tuple(col_hdrs.shape)}")
    if planes.dtype != torch.int32 or col_hdrs.dtype != torch.int32:
        raise ValueError(f"planes and col_hdrs must be int32 (the u32 "
                         f"words' view), got {planes.dtype} and "
                         f"{col_hdrs.dtype}")


def _route(device: torch.device) -> bool:
    """True for the kernel, False for the plain version."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"LUT-free projection runs on cpu or cuda tensors, "
                         f"not {device.type}")
    return True


def _project_packet(frames_words: torch.Tensor, tables: FactorTables,
                    plan: DecodePlan, dd: bool, dual: bool):
    """The packet-layout entry points' shared body: a 2-D frame is one
    frame and comes back without the batch axis."""
    squeeze = frames_words.ndim == 2
    if squeeze:
        frames_words = frames_words[None]
    if _route(frames_words.device):
        from ..kernels.lutfree_project import launch_packet

        _check_frames(frames_words, plan)
        outs = launch_packet(frames_words, tables.rows, tables.cols, plan,
                             _range_fields(plan, dual), dd)
        if frames_words.shape[0]:       # an empty batch launches nothing
            launches[("lutfree_dd_dual" if dual else "lutfree_dd") if dd
                     else "lutfree"] += 1
    elif dd:
        outs = unpack_project_lutfree_dd_plain(frames_words, tables, plan,
                                               dual)
        outs = outs if dual else (outs,)
    else:
        outs = (unpack_project_lutfree_plain(frames_words, tables, plan),)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs if dual else outs[0]


def unpack_project_lutfree(frames_words: torch.Tensor, tables: FactorTables,
                           plan: DecodePlan) -> torch.Tensor:
    """Packet-layout frames (B, n_pkts, pkt_words), the staged u32 words
    held as int32, -> XYZ (B, 3, h, w) f32, the direction synthesized from
    the factor tables in f32. A 2-D input is one frame and returns
    (3, h, w). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    return _project_packet(frames_words, tables, plan, dd=False, dual=False)


def unpack_project_lutfree_dd(frames_words: torch.Tensor,
                              tables: FactorTables, plan: DecodePlan,
                              dual: bool = False):
    """The double-single variant of unpack_project_lutfree: the same
    traffic, XYZ within 1 f32 ulp of the float64 projection. With
    dual=True returns (xyz, xyz2), the directions synthesized once for
    both returns; dual=False on a dual-return profile projects RANGE
    alone."""
    return _project_packet(frames_words, tables, plan, dd=True, dual=dual)


def unpack_project_lutfree_planar(planes: torch.Tensor,
                                  col_hdrs: torch.Tensor,
                                  tables: FactorTables, plan: DecodePlan
                                  ) -> torch.Tensor:
    """LUT-free double-single projection over word-planar frames: planes
    (B, pw, h, w) + col_hdrs (B, schw, w), the staged u32 words held as
    int32, -> XYZ (B, 3, h, w) f32. 3-D planes are one frame; the result
    keeps its batch axis. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if planes.ndim == 3:
        planes = planes[None]
        col_hdrs = col_hdrs[None]
    if not _route(planes.device):
        return unpack_project_lutfree_planar_plain(planes, col_hdrs, tables,
                                                   plan)
    from ..kernels.lutfree_project import launch_planar

    _check_planes(planes, col_hdrs, plan)
    (field,) = _range_fields(plan, False)
    out = launch_planar(planes, col_hdrs, tables.rows, tables.cols, plan,
                        field)
    if planes.shape[0]:                 # an empty batch launches nothing
        launches["lutfree_dd_planar"] += 1
    return out
