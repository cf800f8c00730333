"""ScanPipeline: staged frames -> decoded fields and XYZ.

Two stagings, two paths (ref: SURVEY.md §3.3: ScanBatcher parse,
cartesianT, destagger_into, dewarp):

- Packet layout (io/frames.FrameReader.iter_chunks, whole packets at
  their slots): `pipe(packet_words)` / `pipe.batch(frames_words, poses)`
  run the whole chain `_pipeline` in tensor ops: decode of every field,
  XYZ (and XYZ2 for dual-return profiles) as (h, w, 3), optional
  per-column dewarp, destagger of every (h, w[, 3]) entry.
- Word-planar (FrameReader.iter_planar_chunks): `decode_planar` decodes
  every field from the planes and `project_planar` turns the range words
  into (3, h, w) XYZ through the planar projection
  (ops/planar_kernels.py), optionally dewarped in the same pass;
  destagger (ops/destagger.destagger_torch) follows on the caller's side.

XYZ alone from packet-layout frames is the packet projection's job
(ops/packet_kernels.unpack_project_packet_batched).

The pipeline lives on one device: CUDA unless the caller names another.
Where the tensors live picks the route: the CUDA kernel on the card, the
plain PyTorch version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.constants import ChanField
from ..core.types import SensorInfo
from .destagger import destagger_torch
from .planar_kernels import (PlanarLut, unpack_project_planar_batched,
                             words_tensor)
from .pose import rotate_translate
from .unpack import (DecodePlan, decode_frame_batch, decode_frame_planar,
                     decode_frame_planar_batch, make_decode_plan)
from .xyzlut import (XYZLutDevice, cartesian_dd, cartesian_f32,
                     make_xyz_lut, range_f32, to_device_lut)

Words = Union[np.ndarray, torch.Tensor]


def default_device() -> torch.device:
    """The device the entry points run on: CUDA. Raises without it (the
    entry points never move to the CPU on their own)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port's entry points "
                           "run on the GPU (pass device='cpu' explicitly "
                           "for the plain PyTorch path)")
    return torch.device("cuda")


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the packet-layout pipeline."""

    plan: DecodePlan
    shifts: Tuple[int, ...]
    destagger: bool = True
    dewarp: bool = True
    dual: bool = False
    precision: str = "dd"  # "dd" | "f32"


class ScanPipeline:
    """Per-sensor pipeline.

    Usage:
        pipe = ScanPipeline(info)                     # on CUDA
        out = pipe(packet_words)                      # single frame
        out = pipe.batch(frames_words, poses)         # (B, ...) frames
        fields = pipe.decode_planar(planes, col_hdrs)
        xyz = pipe.project_planar(planes, col_hdrs)   # pair if dual-return

    `destagger` and `dewarp` configure the packet-layout calls: with
    dewarp=False poses are ignored, and a call without poses never runs
    the dewarp.
    """

    def __init__(self, info: SensorInfo, *, use_extrinsics: bool = False,
                 destagger: bool = True, dewarp: bool = True,
                 precision: str = "dd", device=None):
        if precision not in ("dd", "f32"):
            raise ValueError(f"precision must be 'dd' or 'f32', not "
                             f"{precision!r}")
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.info = info
        self.precision = precision
        self._use_extrinsics = use_extrinsics
        self.plan = make_decode_plan(info)
        self.dual = any(f.name == ChanField.RANGE2 for f in self.plan.fields)
        self.shifts = tuple(info.format.pixel_shift_by_row)
        self.cfg = PipelineConfig(
            plan=self.plan, shifts=self.shifts, destagger=destagger,
            dewarp=dewarp, dual=self.dual, precision=precision)

    @functools.cached_property
    def lut(self) -> XYZLutDevice:
        return to_device_lut(make_xyz_lut(self.info, self._use_extrinsics),
                             self.device)

    @functools.cached_property
    def planar_lut(self) -> PlanarLut:
        return PlanarLut(make_xyz_lut(self.info, self._use_extrinsics),
                         self.device)

    def _words(self, x: Words) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            return words_tensor(x, self.device)
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return x.to(self.device).contiguous()

    def __call__(self, packet_words: Words,
                 poses: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """One packet-layout frame (n_pkts, pkt_words) -> dict of fields,
        'XYZ' (h, w, 3) and, for dual-return profiles, 'XYZ2'; poses
        (w, 4, 4) dewarp both into the world frame."""
        out = self.batch(self._words(packet_words)[None],
                         None if poses is None else
                         torch.as_tensor(poses)[None])
        return {k: v[0] for k, v in out.items()}

    def batch(self, frames_words: Words,
              poses: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """Packet-layout frames (B, n_pkts, pkt_words), as
        FrameReader.iter_chunks stages them, with optional per-column poses
        (B, w, 4, 4) -> dict of (B, ...) entries."""
        cfg = self.cfg
        if poses is None or not cfg.dewarp:
            # no poses: skip the dewarp, never multiply by an identity
            cfg, poses = dataclasses.replace(cfg, dewarp=False), None
        else:
            poses = torch.as_tensor(poses).to(self.device)
            want = (frames_words.shape[0], self.plan.w, 4, 4)
            if tuple(poses.shape) != want:
                raise ValueError(f"poses must be (B, w, 4, 4) = {want}, "
                                 f"got {tuple(poses.shape)}")
        return _pipeline(self._words(frames_words), self.lut, poses,
                         cfg=cfg)

    def project_planar(self, planes: Words, col_hdrs: Words,
                       poses: Optional[torch.Tensor] = None,
                       words: Optional[Tuple[int, ...]] = None):
        """Word-planar staged frames -> (B, 3, h, w) XYZ in the sensor frame,
        or the world frame when per-column poses (B, w, 4, 4) are given; a
        pair for dual-return profiles (both returns dewarp with the
        column's shared pose, ref: pose_util.h:44-67). `words` declares a
        word-subset staging (FrameReader.iter_planar_chunks)."""
        if poses is not None:
            poses = torch.as_tensor(poses).to(
                device=self.device, dtype=torch.float32).contiguous()
        return unpack_project_planar_batched(
            self._words(planes), self._words(col_hdrs),
            self.planar_lut.stack, self.plan, precision=self.precision,
            dual=self.dual, poses=poses, words=words)

    def sharded(self, mesh=None, *, axis_name: Optional[str] = None,
                words: Optional[Tuple[int, ...]] = None):
        """Multi-device face of the planar projection: a ShardedScanPipeline
        running project_planar's kernel on each device's shard of a batch
        split on its leading axis over `mesh` (default: a 1-D mesh of every
        CUDA device; raises without CUDA). See parallel/sharding.py."""
        from ..parallel.sharding import ShardedScanPipeline, make_mesh

        if mesh is None:
            mesh = make_mesh()
        return ShardedScanPipeline(self, mesh, axis_name=axis_name,
                                   words=words)

    def decode_planar(self, planes: Words, col_hdrs: Words
                      ) -> Dict[str, torch.Tensor]:
        """Full-field decode from planar staging; batched when the inputs
        carry a leading batch axis."""
        planes, col_hdrs = self._words(planes), self._words(col_hdrs)
        if planes.ndim == 4:
            return decode_frame_planar_batch(planes, col_hdrs, self.plan)
        return decode_frame_planar(planes, col_hdrs, self.plan)


def _project(rng: torch.Tensor, lut: XYZLutDevice, valid: torch.Tensor,
             precision: str) -> torch.Tensor:
    """range (B, h, w) integer + valid (B, w) -> xyz (B, h, w, 3) f32 in
    the staggered frame, zero where the range is zero or the column is
    invalid."""
    xyz = (cartesian_dd if precision == "dd" else cartesian_f32)(rng, lut)
    return torch.where(valid[:, None, :, None], xyz,
                       torch.zeros((), dtype=torch.float32,
                                   device=xyz.device))


def _pipeline(frames_words: torch.Tensor, lut: XYZLutDevice,
              poses: Optional[torch.Tensor], *, cfg: PipelineConfig
              ) -> Dict[str, torch.Tensor]:
    """The packet-layout chain over a batch: frames_words (B, n_pkts,
    pkt_words) int32, poses (B, w, 4, 4) (read only when cfg.dewarp)."""
    plan = cfg.plan
    out = decode_frame_batch(frames_words, plan)
    valid = (out["status"].view(torch.int32) & 1) != 0        # (B, w)
    zero = torch.zeros((), dtype=torch.float32, device=frames_words.device)
    if cfg.dewarp:
        # per-column world poses applied in the staggered frame: column w
        # of every row shares pose w (ref: pose_util.h:44-67)
        poses = poses.to(torch.float32)
        rot = poses[:, None, :, :3, :3]                       # (B, 1, w, ..)
        trans = poses[:, None, :, :3, 3]

    returns = [(ChanField.RANGE, "XYZ")]
    if cfg.dual and ChanField.RANGE2 in out:
        returns.append((ChanField.RANGE2, "XYZ2"))
    for field, key in returns:
        rng = out[field]
        xyz = _project(rng, lut, valid, cfg.precision)
        if cfg.dewarp:
            # the dewarp moves no-return pixels to the pose translation:
            # mask them back to zero
            keep = (range_f32(rng) != 0)[..., None] \
                & valid[:, None, :, None]
            xyz = torch.where(keep, rotate_translate(rot, trans, xyz), zero)
        out[key] = xyz

    if cfg.destagger:
        for k, v in out.items():
            if v.ndim >= 3 and tuple(v.shape[1:3]) == (plan.h, plan.w):
                out[k] = destagger_torch(v, cfg.shifts)
    return out
