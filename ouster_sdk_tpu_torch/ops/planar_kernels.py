"""Planar range -> XYZ projection: the wrapper, its kernel route and its
plain version.

`unpack_project_planar_batched` turns word-planar staged frames into XYZ:
it extracts each range field from its word plane, zeroes columns whose
status bit 0 is clear, evaluates r * dir + off in double-single precision
from the 18-plane `PlanarLut` stack and, given per-column poses, applies
the SE(3) dewarp in the same pass. A tensor on the CPU takes the plain
PyTorch version below; a CUDA tensor launches the hand-written kernel
`planar_project<DUAL, DEWARP>` (kernels/csrc/planar_project.cu), or the
wrapper raises. There is no fallback from one to the other.

Numerics, which the kernel repeats op for op: the projection is a chain
of error-free transforms that must not be contracted into fused
multiply-adds (PyTorch's eager ops round once per op; the kernel uses
__fmul_rn/__fadd_rn). The dewarp is the opposite: the reference's CPU
lowering contracts each `acc + R_ik * v_k` into one fused multiply-add,
so the plain version emulates a correctly rounded fma
(`precision.fma_f32`) and the kernel calls __fmaf_rn, with acc starting
from t_i and k = 0, 1, 2.

The kernel reads the poses as they come, (B, w, 4, 4) float32: with such
poses, contiguous, a wrapper call launches the kernel and nothing else.
`_pose_planes` packs them into planes for the plain version alone.

`project_ranges` is the same projection for bare range images (no words to
unpack, every column valid): `_proj_lean` on the CPU, the same kernel on
the card. `project_ranges_batched` is the epilogue of the wire stagings
(ops/packed.py, ops/bp64.py): range images decoded on the device from
packed or BP64 words, masked by the column status words, projected by the
same kernel, then optionally dewarped in the rounding order of
ops/pose.rotate_translate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from .pose import rotate_translate
from .precision import fma_f32, split_f64_array
from .unpack import DecodePlan, FieldPlan, _bits, _u32
from .xyzlut import XYZLut

#: Kernel launches per case, counted by the wrapper where it launches the
#: CUDA kernel and nowhere else. Keys are the six planar cases, named after
#: the projection functions they replace.
launches: Dict[str, int] = {}

CASES = ("planar", "planar_dual", "planar_dual_split", "planar_dewarp",
         "planar_dual_dewarp", "planar_dual_split_dewarp")


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()


class PlanarLut:
    """The XYZ LUT as an (18, h, w) float32 stack on a device.

    Layout: [dir_hi(3), dh1(3), dh2(3), dir_lo(3), off_hi(3), off_lo(3)].
    The direction-hi planes ship pre-split into 12-bit Veltkamp halves
    (dh1 + dh2 == dir_hi exactly), so the error-free r * dir product needs
    no splitting at run time: the range integer splits exactly with bit
    masks and all four partial products are exact (Dekker).
    """

    def __init__(self, lut: XYZLut, device):
        dh, dl = split_f64_array(np.moveaxis(lut.direction, -1, 0))
        oh, ol = split_f64_array(np.moveaxis(lut.offset, -1, 0))
        c = np.float32(4097.0) * dh          # 2**12 + 1 f32 splitter
        dh1 = c - (c - dh)
        dh2 = dh - dh1
        # concatenate keeps the planes' (h, w, 3)-derived strides: copy to
        # C order, the layout the kernel takes
        self.stack = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([dh, dh1, dh2, dl, oh, ol], axis=0))).to(device)

    @classmethod
    def from_stack(cls, stack: np.ndarray, device) -> "PlanarLut":
        self = cls.__new__(cls)
        self.stack = torch.from_numpy(
            np.array(stack, dtype=np.float32, order="C")).to(device)
        return self


def _field_plan(plan: DecodePlan, name: str) -> FieldPlan:
    for f in plan.fields:
        if f.name == name:
            return f
    raise ValueError(f"profile has no {name} field")


# -- the plain version -------------------------------------------------------

def _extract_bits(w0: torch.Tensor, *, bit: int, size: int,
                  upshift: int) -> torch.Tensor:
    """Range field of an int32 word plane, as its unsigned value in int64."""
    return _bits(w0, None, bit, size, upshift)


def status_valid_mask_batched(col_hdrs: torch.Tensor, plan: DecodePlan
                              ) -> torch.Tensor:
    """(B, 1, w) bool: the per-column status valid bit — the zero-fill
    semantics every staging applies (ref: lidar_scan.cpp:1194
    zero_fields)."""
    status = _bits(col_hdrs[:, plan.staged_status_word], None,
                   plan.status_bit, plan.status_size)
    return ((status & 1) != 0)[:, None, :]


def _proj_lean(r: torch.Tensor, L: torch.Tensor, *, precision: str
               ) -> torch.Tensor:
    """Integer range (B, h, w) int64 (< 2**23) -> xyz (B, 3, h, w) f32.

    precision='dd': correctly rounded (<= 0.5 f32 ulp of the f64 value)
    compensated evaluation of r * dir + off; the Dekker residual of
    r * dir_hi uses the 11-bit split of r and the pre-split dir_hi.
    """
    DH, DH1, DH2, DL, OH, OL = (L[0:3], L[3:6], L[6:9], L[9:12],
                                L[12:15], L[15:18])
    r = r[:, None]                                  # (B, 1, h, w)
    zero = torch.zeros((), dtype=torch.float32, device=L.device)
    if precision != "dd":
        rf = r.to(torch.float32)
        return torch.where(rf != 0, rf * DH + OH, zero)
    rl_i = r & 0x7FF
    rh = (r - rl_i).to(torch.float32)
    rl = rl_i.to(torch.float32)
    rf = rh + rl                                    # exact (integer < 2^23)
    p = rf * DH
    # Dekker: all four partial products are exact (11+12 bit mantissas)
    e = ((rh * DH1 - p) + rh * DH2 + rl * DH1) + rl * DH2
    # two_sum(p, OH): magnitudes are not ordered (dir components cross 0)
    s = p + OH
    bb = s - p
    es = (p - (s - bb)) + (OH - bb)
    xyz = s + (((e + es) + rf * DL) + OL)
    return torch.where(rf != 0, xyz, zero)


def _dewarp_tile(xyz: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Per-column SE(3): pose planes P (B, 12, w) = row-major R (9) + t (3);
    xyz (B, 3, h, w) -> world (B, 3, h, w) (ref: pose_util.h:44 dewarp)."""
    P = P[:, :, None, :]                            # (B, 12, 1, w)
    rows = []
    for i in range(3):
        acc = P[:, 9 + i].expand_as(xyz[:, 0])
        for k in range(3):
            acc = fma_f32(P[:, 3 * i + k], xyz[:, k], acc)
        rows.append(acc)
    return torch.stack(rows, dim=1)


def _pose_planes(poses: torch.Tensor) -> torch.Tensor:
    """(B, w, 4, 4) poses -> (B, 12, w) planes: R row-major, then t."""
    B, w = poses.shape[:2]
    R = poses[..., :3, :3].reshape(B, w, 9)
    t = poses[..., :3, 3]
    return torch.cat([R, t], dim=-1).to(torch.float32).movedim(-1, 1)


def unpack_project_planar_batched_plain(
        planes: torch.Tensor, col_hdrs: torch.Tensor, lut_stack: torch.Tensor,
        plan: DecodePlan, *, precision: str = "dd", dual: bool = False,
        poses: Optional[torch.Tensor] = None,
        words: Optional[Tuple[int, ...]] = None):
    """The plain PyTorch version of the planar projection: same arguments
    and results as unpack_project_planar_batched, on any device."""
    planes, col_hdrs, poses, idx = _prepare(planes, col_hdrs, poses, plan,
                                            dual, words)
    vm = status_valid_mask_batched(col_hdrs, plan)       # (B, 1, w)
    P = None if poses is None else _pose_planes(poses)
    outs = []
    for k, f in enumerate(_range_fields(plan, dual)):
        r = _extract_bits(planes[:, idx[k]], bit=f.bit, size=f.size,
                          upshift=f.upshift)
        r = torch.where(vm, r, torch.zeros((), dtype=r.dtype,
                                           device=r.device))
        xyz = _proj_lean(r, lut_stack, precision=precision)
        if P is not None:
            # keep no-return pixels at zero (dewarp would move them to the
            # pose translation otherwise)
            xyz = torch.where((r != 0)[:, None], _dewarp_tile(xyz, P),
                              torch.zeros((), dtype=xyz.dtype,
                                          device=xyz.device))
        outs.append(xyz)
    return tuple(outs) if dual else outs[0]


# -- the wrapper -------------------------------------------------------------

def _range_fields(plan: DecodePlan, dual: bool) -> Tuple[FieldPlan, ...]:
    """The range field plans, shared by the planar and the packet-layout
    projection; a word-spanning range field has no projection (the
    reference refuses it too)."""
    fields = (_field_plan(plan, "RANGE"),) + (
        (_field_plan(plan, "RANGE2"),) if dual else ())
    for f in fields:
        if f.bit + f.size > 32:
            raise NotImplementedError("word-spanning RANGE profile")
    return fields


def _prepare(planes, col_hdrs, poses, plan: DecodePlan, dual: bool,
             words: Optional[Tuple[int, ...]]):
    """Add the batch axis to single frames and map the range words to
    plane indices (validating a word subset)."""
    if planes.ndim == 3:
        planes = planes[None]
        col_hdrs = col_hdrs[None]
    if poses is not None and poses.ndim == 3:
        poses = poses[None]
    if poses is not None and tuple(poses.shape) != (planes.shape[0], plan.w,
                                                    4, 4):
        raise ValueError(f"poses must be (B, w, 4, 4) = ({planes.shape[0]}, "
                         f"{plan.w}, 4, 4), got {tuple(poses.shape)}")
    pw = planes.shape[1]
    if words is None:
        if pw != plan.pw:
            raise ValueError(f"planes carry {pw} words but profile has "
                             f"{plan.pw}; pass words=(...) for subsets")
        words = tuple(range(plan.pw))

    def wmap(word):
        if word not in words:
            raise ValueError(f"projection needs packet word {word}; "
                             f"planes carry only {words}")
        return words.index(word)

    idx = tuple(wmap(f.word) for f in _range_fields(plan, dual))
    return planes, col_hdrs, poses, idx


def _case(plan: DecodePlan, dual: bool, dewarp: bool, pw: int,
          idx: Tuple[int, ...]) -> str:
    """Name of the projection case, as the reference's kernel family splits
    them: dual-return profiles whose two range words are adjacent and
    pair-aligned ride one merged block there, the others two operands."""
    case = "planar"
    if dual:
        w1, w2 = idx
        aligned = w2 == w1 + 1 and pw % 2 == 0 and w1 % 2 == 0
        case += "_dual" if aligned else "_dual_split"
    return case + ("_dewarp" if dewarp else "")


def unpack_project_planar_batched(planes: torch.Tensor,
                                  col_hdrs: torch.Tensor,
                                  lut_stack: torch.Tensor, plan: DecodePlan,
                                  *, precision: str = "dd",
                                  dual: bool = False,
                                  poses: Optional[torch.Tensor] = None,
                                  words: Optional[Tuple[int, ...]] = None):
    """Fused decode over word-planar frames: planes (B, pw, h, w) + col_hdrs
    (B, schw, w), the staged u32 words held as int32, -> XYZ (B, 3, h, w)
    f32, or a pair of them when dual=True. `lut_stack` is PlanarLut.stack.

    With poses (B, w, 4, 4) f32 the per-column SE(3) dewarp fuses into the
    same pass and the output is world-frame; both returns share the
    column's pose (ref: pose_util.h:44-67). `words` declares which packet
    words the planes carry (FrameReader.iter_planar_chunks word subsets);
    default: all pw words, in packet order.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if precision not in ("dd", "f32"):
        raise ValueError(f"precision must be 'dd' or 'f32', not "
                         f"{precision!r}")
    with profiling.span("project.issue"):
        device = planes.device
        if device.type == "cpu":
            return unpack_project_planar_batched_plain(
                planes, col_hdrs, lut_stack, plan, precision=precision,
                dual=dual, poses=poses, words=words)
        if device.type != "cuda":
            raise ValueError(f"planar projection runs on cpu or cuda tensors, "
                             f"not {device.type}")
        from ..kernels.planar_project import launch

        planes, col_hdrs, poses, idx = _prepare(planes, col_hdrs, poses, plan,
                                                dual, words)
        if poses is not None:
            # a no-op for float32 contiguous poses: the kernel reads them as
            # they are, and the call launches nothing but the kernel
            poses = poses.to(torch.float32).contiguous()
            if poses.data_ptr() % 16:       # a view at an odd storage offset
                poses = poses.clone()
        out = launch(planes, col_hdrs, lut_stack, poses, plan,
                     _range_fields(plan, dual), idx, precision)
        if planes.shape[0]:                 # an empty batch launches nothing
            launches[_case(plan, dual, poses is not None, planes.shape[1],
                           idx)] += 1
        return out if dual else out[0]


@dataclass(frozen=True)
class _RangeImagePlan:
    """What the kernel launch reads of a DecodePlan, for bare range
    images: one col-header row whose bit 0 is the column's valid bit."""

    h: int
    w: int
    schw: int = 1
    staged_status_word: int = 0
    status_bit: int = 0


#: A range image is a one-plane frame whose range field is the whole word.
_RANGE_WORD = FieldPlan(name="RANGE", word=0, bit=0, size=32, upshift=0,
                        out_dtype="uint32")

#: All-ones col-header rows, one per (B, w, device): every column valid.
_VALID_ROWS: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _valid_rows(B: int, w: int, device: torch.device) -> torch.Tensor:
    key = (B, w, device)
    row = _VALID_ROWS.get(key)
    if row is None:
        if len(_VALID_ROWS) >= 16:      # a handful of window sizes recur
            _VALID_ROWS.clear()
        row = _VALID_ROWS[key] = torch.ones((B, 1, w), dtype=torch.int32,
                                            device=device)
    return row


def project_ranges(rngs: torch.Tensor, lut_stack: torch.Tensor,
                   precision: str = "dd") -> torch.Tensor:
    """Range images (B, h, w), u32 millimetres held as int32, -> XYZ
    (B, 3, h, w) f32 through the LUT stack (PlanarLut.stack): the
    projection of unpack_project_planar_batched without the unpacking,
    for ranges that were decoded elsewhere (OSF replay). Every column is
    valid; a zero range projects to the origin. The arithmetic is exact
    for ranges below 2**23, which nothing here checks.

    CPU tensors take the plain `_proj_lean`; CUDA tensors launch the
    planar kernel on the images as one-plane frames whose range field is
    word 0, bit 0, 32 bits wide, with a cached all-ones col-header row,
    and count under launches["planar"]. An empty batch launches nothing.
    """
    if precision not in ("dd", "f32"):
        raise ValueError(f"precision must be 'dd' or 'f32', not "
                         f"{precision!r}")
    if rngs.ndim != 3 or rngs.dtype != torch.int32:
        raise ValueError(f"rngs must be (B, h, w) int32, got "
                         f"{tuple(rngs.shape)} {rngs.dtype}")
    device = rngs.device
    if device.type == "cpu":
        return _proj_lean(_u32(rngs), lut_stack, precision=precision)
    if device.type != "cuda":
        raise ValueError(f"range projection runs on cpu or cuda tensors, "
                         f"not {device.type}")
    from ..kernels.planar_project import launch

    B, h, w = rngs.shape
    out = launch(rngs.contiguous()[:, None], _valid_rows(B, w, device),
                 lut_stack, None, _RangeImagePlan(h, w), (_RANGE_WORD,),
                 (0,), precision)
    if B:
        launches["planar"] += 1
    return out[0]


#: The second range image of a dual-return pair, at plane 1.
_RANGE2_WORD = FieldPlan(name="RANGE2", word=1, bit=0, size=32, upshift=0,
                         out_dtype="uint32")


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> the int32 word with the same bits."""
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def _dewarp_ranges(xyz: Tuple[torch.Tensor, ...],
                   masked: Tuple[torch.Tensor, ...],
                   poses: Optional[torch.Tensor]):
    """Per-column SE(3) of (B, 3, h, w) XYZ in the rounding order of
    rotate_translate (the JAX package's `einsum("bwij,bjhw->bihw") + t`),
    with the pixels whose masked range is zero kept at the origin. Both
    returns share the column's pose (ref: pose_util.h:44-67)."""
    if poses is None:
        return xyz
    if poses.ndim == 3:
        poses = poses[None]
    poses = poses.to(device=xyz[0].device, dtype=torch.float32)
    rot = poses[:, None, :, :3, :3]                 # (B, 1, w, 3, 3)
    trans = poses[:, None, :, :3, 3]
    zero = torch.zeros((), dtype=torch.float32, device=xyz[0].device)
    return tuple(
        torch.where((r != 0)[:, None],
                    rotate_translate(rot, trans, x.permute(0, 2, 3, 1))
                    .permute(0, 3, 1, 2), zero)
        for x, r in zip(xyz, masked))


def _masked(ranges, col_hdrs: torch.Tensor, plan: DecodePlan
            ) -> Tuple[torch.Tensor, ...]:
    """The range images with the columns whose status bit is clear
    zeroed."""
    vm = status_valid_mask_batched(col_hdrs, plan)
    zero = torch.zeros((), dtype=torch.int64, device=col_hdrs.device)
    return tuple(torch.where(vm, r, zero) for r in ranges)


def project_ranges_batched_plain(ranges, col_hdrs: torch.Tensor,
                                 lut_stack: torch.Tensor, plan: DecodePlan,
                                 *, precision: str = "dd",
                                 poses: Optional[torch.Tensor] = None):
    """The plain PyTorch version of project_ranges_batched: same arguments
    and results, on any device."""
    masked = _masked(ranges, col_hdrs, plan)
    xyz = tuple(_proj_lean(r, lut_stack, precision=precision)
                for r in masked)
    out = _dewarp_ranges(xyz, masked, poses)
    return out if len(out) == 2 else out[0]


def project_ranges_batched(ranges, col_hdrs: torch.Tensor,
                           lut_stack: torch.Tensor, plan: DecodePlan, *,
                           precision: str = "dd",
                           poses: Optional[torch.Tensor] = None):
    """The shared epilogue of the wire stagings: one or two range images
    (B, h, w), int64 holding u32 values (upshifts applied), whose columns
    the status words of col_hdrs (B, schw, w) mask as the planar path
    masks them, -> XYZ (B, 3, h, w) f32, or a pair for two images. With
    poses (B, w, 4, 4) the XYZ is dewarped per column after the
    projection, in rotate_translate's rounding order, and the pixels whose
    masked range is zero stay at the origin: the order of the JAX
    package's `project_ranges_batched` (ops/pallas_kernels.py:566), not
    the planar kernel's fused dewarp, which rounds otherwise.

    CPU tensors take the plain version. CUDA tensors launch the planar
    kernel once, on the images stacked as the planes of (B, n, h, w)
    frames (range k at word k, bit 0, 32 bits) with the real col headers,
    so the kernel masks the columns; the launch counts under
    launches["planar"], or launches["planar_dual"] for a pair (the
    instantiation that runs). The dewarp is plain PyTorch on the card.
    """
    if precision not in ("dd", "f32"):
        raise ValueError(f"precision must be 'dd' or 'f32', not "
                         f"{precision!r}")
    ranges = tuple(ranges)
    if len(ranges) not in (1, 2):
        raise ValueError(f"one or two range images, not {len(ranges)}")
    device = ranges[0].device
    if device.type == "cpu":
        return project_ranges_batched_plain(ranges, col_hdrs, lut_stack,
                                            plan, precision=precision,
                                            poses=poses)
    if device.type != "cuda":
        raise ValueError(f"range projection runs on cpu or cuda tensors, "
                         f"not {device.type}")
    from ..kernels.planar_project import launch

    if col_hdrs.dtype == torch.uint32:
        col_hdrs = col_hdrs.view(torch.int32)
    B, h, w = ranges[0].shape
    n = len(ranges)
    planes = torch.stack([_as_int32(r) for r in ranges], dim=1)
    rplan = _RangeImagePlan(h, w, schw=col_hdrs.shape[1],
                            staged_status_word=plan.staged_status_word,
                            status_bit=plan.status_bit)
    idx = tuple(range(n))
    xyz = launch(planes, col_hdrs.contiguous(), lut_stack, None, rplan,
                 (_RANGE_WORD, _RANGE2_WORD)[:n], idx, precision)
    if B:
        launches[_case(rplan, n == 2, False, n, idx)] += 1
    if poses is not None:
        xyz = _dewarp_ranges(xyz, _masked(ranges, col_hdrs, plan), poses)
    return xyz if n == 2 else xyz[0]


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """Staged u32 words (numpy) -> an int32 tensor on `device`, the layout
    the decode and the projection take (a bit-identical view)."""
    with profiling.span("h2d_copy"):
        return torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(device)

