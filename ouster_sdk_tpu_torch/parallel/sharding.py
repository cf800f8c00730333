"""Data parallelism over frames and sensors on a list of devices.

The reference's parallelism stops at host threads (ref: SURVEY.md §2.15).
The JAX package scales by SPMD over a device mesh: a batch of frames is
split on its leading axis, every op of the pipeline is elementwise over
(B, h, w), and reductions ride psum / all_gather. The port keeps that
face in one process: a `Mesh` is an array of torch devices with axis
names, a sharded batch is a `Sharded` (the list of per-device blocks, and
`join()`), every device runs the port's own entry points on its block
(the planar kernel on CUDA devices, the plain versions on the CPU), a
psum is the sum of the per-block partials on the first device and an
all_gather a torch.cat. There is no torch.distributed and no NCCL: the
devices are driven from one process, in turn (CUDA launches are
asynchronous, so the devices overlap).

A mesh may list one device more than once: the split and the join then
run on that device, which is how the tests split a batch over CPU
"devices" and a one-card machine runs the multi-device face.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.xyzlut import XYZLutDevice


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: `devices` is an object array of
    torch.device with one dimension an axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along one axis (index 0 on the others)."""
        ax = self.axis_names.index(axis_name)
        idx = [0] * self.devices.ndim
        idx[ax] = slice(None)
        return list(self.devices[tuple(idx)])


def _device_list(devices, n: Optional[int]) -> List[torch.device]:
    """The first n of `devices` (all when n is None); every CUDA device
    when `devices` is None, which raises without CUDA: a mesh never falls
    back to the CPU on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; a mesh takes every "
                               "CUDA device unless `devices` names them")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n is None:
        return devices
    if n > len(devices):
        raise ValueError(f"{n} devices asked for, {len(devices)} listed")
    return devices[:n]


def _object_array(items, shape) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for k, item in enumerate(items):    # one by one: numpy would convert
        arr[k] = item                   # whole tensors
    return arr.reshape(shape)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch",
              *, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over `devices` (every CUDA device when none is listed; raises
    without CUDA), the first `n_devices` of them when given."""
    devs = _device_list(devices, n_devices)
    return Mesh(_object_array(devs, (len(devs),)), (axis_name,))


def make_mesh_2d(n_sensors: int, n_frames: int,
                 axis_names=("sensor", "frame"), *,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: sensors on one axis, the frame batch on the other (the
    layout of a multi-sensor rig: per-sensor LUTs on the sensor axis,
    frames data parallel)."""
    devs = _device_list(devices, n_sensors * n_frames)
    return Mesh(_object_array(devs, (n_sensors, n_frames)),
                tuple(axis_names))


class Sharded:
    """A tensor split over mesh devices. `blocks` is an object array of
    tensors laid out like the mesh axes the tensor is split over: block
    (i, j, ...) holds part i of dim 0, part j of dim 1, ... and lives on
    its device."""

    def __init__(self, blocks: np.ndarray):
        self.blocks = blocks

    @property
    def shards(self) -> List[torch.Tensor]:
        return list(self.blocks.flat)

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.blocks.flat[0]
        shape = list(first.shape)
        for d in range(self.blocks.ndim):
            idx = [0] * self.blocks.ndim
            idx[d] = slice(None)
            shape[d] = sum(b.shape[d] for b in self.blocks[tuple(idx)])
        return tuple(shape)

    def join(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first block's): the
        all_gather of the blocks."""
        dev = self.blocks.flat[0].device if device is None else device

        def cat(blocks, dim):
            if blocks.ndim == 1:
                return torch.cat([b.to(dev) for b in blocks], dim=dim)
            return torch.cat([cat(b, dim + 1) for b in blocks], dim=dim)

        return cat(self.blocks, 0)


def _tensor(arr) -> torch.Tensor:
    """numpy or torch -> tensor; u32 words become their int32 view, the
    layout the port's entry points take."""
    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        return torch.from_numpy(arr)
    if arr.dtype == torch.uint32:
        arr = arr.view(torch.int32)
    return arr


def _split(t: torch.Tensor, devices: Sequence[torch.device], dim: int,
           what: str) -> List[torch.Tensor]:
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(
            f"{what} {t.shape[dim]} not divisible by the mesh's {n} "
            f"shards; pad the batch (see map_source) or resize the chunk")
    return [p.to(d) for p, d in zip(torch.chunk(t, n, dim=dim), devices)]


def shard_frames(mesh: Mesh, frames, axis_name: str = "batch") -> Sharded:
    """A (B, ...) array split on its leading axis over the mesh axis."""
    devs = mesh.axis_devices(axis_name)
    return Sharded(_object_array(
        _split(_tensor(frames), devs, 0, f"batch on axis {axis_name!r}"),
        (len(devs),)))


def _lut_to(lut: XYZLutDevice, device) -> XYZLutDevice:
    return XYZLutDevice(*(getattr(lut, f.name).to(device)
                          for f in dataclasses.fields(lut)))


def _batch_local(pipe, frames: torch.Tensor, lut: XYZLutDevice,
                 poses: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ScanPipeline.batch on one device's block, with that device's LUT."""
    from ..ops.fused import _pipeline

    cfg = pipe.cfg
    if poses is None or not cfg.dewarp:
        cfg, poses = dataclasses.replace(cfg, dewarp=False), None
    return _pipeline(frames, lut, poses, cfg=cfg)


def sharded_pipeline(pipe, mesh: Mesh, axis_name: str = "batch"):
    """The packet-layout pipeline (ScanPipeline.batch) over a batch split on
    the mesh axis. Returns fn(frames_words (B, n_pkts, pkt_words), poses
    (B, w, 4, 4) or None) -> dict of Sharded (B, ...) entries."""
    devs = mesh.axis_devices(axis_name)
    luts = {d: _lut_to(pipe.lut, d) for d in set(devs)}

    def run(frames_words, poses=None):
        fr = _split(_tensor(frames_words), devs, 0, "batch")
        po = (None if poses is None else
              _split(_tensor(poses), devs, 0, "poses batch"))
        outs = [_batch_local(pipe, f, luts[d], None if po is None else po[i])
                for i, (f, d) in enumerate(zip(fr, devs))]
        return {k: Sharded(_object_array([o[k] for o in outs], (len(devs),)))
                for k in outs[0]}

    return run


def sharded_multi_sensor_step(pipes: Sequence, mesh: Mesh):
    """A step over a (S, F, n_pkts, pkt_words) frame batch on a ("sensor",
    "frame") mesh: sensors split on the first axis, frames on the second;
    every sensor runs pipes[0]'s packet-layout pipeline with its own LUT.

    Returns (step_fn, stacked_luts): step_fn(frames, luts, poses (S, F, w,
    4, 4)) -> (xyz, a Sharded (S, F, h, w, 3) split on both axes;
    centroid (3,) on the mesh's first device), the centroid being the sum
    of every XYZ over the count of non-zero ranges, each summed a block
    and then over the frame axis and the sensor axis (the JAX package's
    two psums). stacked_luts is an XYZLutDevice whose tensors carry the
    sensor axis first, on pipes[0]'s device."""
    pipe0 = pipes[0]
    luts = XYZLutDevice(*(
        torch.stack([getattr(p.lut, f.name).to(pipe0.device) for p in pipes])
        for f in dataclasses.fields(XYZLutDevice)))
    S_ax, F_ax = mesh.axis_names
    n_s, n_f = mesh.devices.shape

    def step(frames, luts, poses):
        frames, poses = _tensor(frames), _tensor(poses)
        if frames.shape[0] % n_s or frames.shape[1] % n_f:
            raise ValueError(
                f"frames {tuple(frames.shape[:2])} not divisible by the "
                f"mesh's ({n_s}, {n_f}) shards on axes ({S_ax!r}, {F_ax!r})")
        out = np.empty((n_s, n_f), dtype=object)
        totals, counts = [], []
        s_parts = torch.chunk(torch.arange(frames.shape[0]), n_s)
        f_parts = torch.chunk(torch.arange(frames.shape[1]), n_f)
        for i, s_idx in enumerate(s_parts):
            row_t, row_c = [], []
            for j, f_idx in enumerate(f_parts):
                dev = mesh.devices[i, j]
                xyz, nz = [], []
                for s in s_idx.tolist():
                    lut = XYZLutDevice(*(getattr(luts, f.name)[s].to(dev)
                                         for f in dataclasses.fields(luts)))
                    o = _batch_local(pipe0, frames[s, f_idx].to(dev), lut,
                                     poses[s, f_idx].to(dev))
                    xyz.append(o["XYZ"])
                    nz.append((o["RANGE"].view(torch.int32) != 0).sum())
                xyz = torch.stack(xyz)               # (S_loc, F_loc, h, w, 3)
                out[i, j] = xyz
                row_t.append(xyz.sum(dim=(0, 1, 2, 3)))
                row_c.append(torch.stack(nz).sum())
            # psum over the frame axis, then over the sensor axis
            totals.append(_psum(row_t))
            counts.append(_psum(row_c))
        total, count = _psum(totals), _psum(counts)
        centroid = total / torch.clamp(count, min=1)
        return Sharded(out), centroid

    return step, luts


def _psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-device partials, on the first one's device."""
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def fuse_multi_sensor_clouds(mesh: Mesh, clouds, extrinsics,
                             axis_name: str = "sensor") -> torch.Tensor:
    """Apply per-sensor extrinsics to (S, N, 3) clouds split over the mesh's
    sensor axis (`cloud @ R.T + t` a sensor), then gather the fused
    (S * N, 3) world-frame cloud onto the axis' first device (the
    reference's Collator + extrinsics fan-in, ref: scan_source_utils.h:22)."""
    devs = mesh.axis_devices(axis_name)
    cl = _split(_tensor(clouds), devs, 0, "sensors")
    ex = _split(_tensor(extrinsics).to(_tensor(clouds).dtype), devs, 0,
                "sensors")
    fused = [c @ e[:, :3, :3].transpose(1, 2) + e[:, None, :3, 3]
             for c, e in zip(cl, ex)]
    return torch.cat([f.to(devs[0]) for f in fused]).reshape(-1, 3)


class ShardedScanPipeline:
    """Multi-device face of the planar projection: a (B, ...) batch of
    word-planar staged frames is split on its leading axis over a mesh
    axis, each device runs ScanPipeline.project_planar's projection on its
    shard (the planar_project kernel on CUDA devices, TPU kernel rows 1-6;
    the plain version on CPU devices), and outputs stay split.

        pipe = ScanPipeline(info)
        sp = pipe.sharded(make_mesh())          # every CUDA device
        xyz = sp.project(sp.shard(planes), sp.shard(hdrs))  # Sharded
        xyz.join()                              # (B, 3, h, w)

    or straight from a capture:

        for fids, xyz in sp.map_source(FrameReader(path, info)):
            ...

    As in the JAX package, a call with poses projects the first return
    alone, dewarped (a dual-return profile gives one Sharded, not a
    pair).
    """

    def __init__(self, pipe, mesh: Mesh, *, axis_name: Optional[str] = None,
                 words: Optional[Tuple[int, ...]] = None):
        self.pipe = pipe
        self.mesh = mesh
        self.axis_name = mesh.axis_names[0] if axis_name is None \
            else axis_name
        self.devices = mesh.axis_devices(self.axis_name)
        self.n_shards = len(self.devices)
        self.words = words
        self._luts: Dict[torch.device, torch.Tensor] = {}

    def shard(self, arr) -> Sharded:
        """A (B, ...) array split on B over the mesh axis."""
        return Sharded(_object_array(
            _split(_tensor(arr), self.devices, 0,
                   f"batch on axis {self.axis_name!r}"),
            (self.n_shards,)))

    def replicate(self, arr) -> List[torch.Tensor]:
        """A copy of the array on every device of the mesh axis."""
        t = _tensor(arr)
        return [t.to(d) for d in self.devices]

    def _lut(self, device) -> torch.Tensor:
        lut = self._luts.get(device)
        if lut is None:
            lut = self._luts[device] = self.pipe.planar_lut.stack.to(device)
        return lut

    def _blocks(self, x) -> List[torch.Tensor]:
        return (x if isinstance(x, Sharded) else self.shard(x)).shards

    def project(self, planes, col_hdrs, poses=None):
        """Batched planes (B, pw | len(words), h, w) + col headers (B, schw,
        w), numpy or tensors or Sharded, -> XYZ (B, 3, h, w) f32 as a
        Sharded over the mesh axis (a pair for dual-return profiles; the
        world frame, first return only, when per-column poses (B, w, 4, 4)
        are given). Bit-identical to ScanPipeline.project_planar on the
        same frames."""
        from ..ops.planar_kernels import unpack_project_planar_batched

        cfg = self.pipe.cfg
        dual = cfg.dual and poses is None
        pl, hd = self._blocks(planes), self._blocks(col_hdrs)
        po = ([None] * self.n_shards if poses is None else
              [p.to(torch.float32).contiguous() for p in self._blocks(poses)])
        outs = [unpack_project_planar_batched(
            p, h, self._lut(p.device), cfg.plan, precision=cfg.precision,
            dual=dual, poses=q, words=self.words)
            for p, h, q in zip(pl, hd, po)]
        if dual:
            return tuple(Sharded(_object_array([o[k] for o in outs],
                                               (self.n_shards,)))
                         for k in range(2))
        return Sharded(_object_array(outs, (self.n_shards,)))

    __call__ = project

    def map_source(self, reader, chunk: Optional[int] = None,
                   pipelined: bool = True
                   ) -> Iterator[Tuple[np.ndarray, object]]:
        """Stream a FrameReader's word-planar chunks through the sharded
        projection: yields (frame_ids, xyz) a chunk, xyz split over the
        mesh. A short tail chunk is padded to `chunk` frames with copies of
        its last frame, and the padding has no frame id: callers slice xyz
        by len(frame_ids)."""
        if chunk is None:
            chunk = self.n_shards * max(1, 8 // self.n_shards)
        if chunk % self.n_shards:
            raise ValueError(f"chunk {chunk} must be a multiple of the "
                             f"mesh's {self.n_shards} shards")
        it = (reader.iter_planar_chunks_pipelined(chunk, words=self.words)
              if pipelined else
              reader.iter_planar_chunks(chunk, words=self.words))
        for fids, planes, hdrs, _ts in it:
            n = fids.size
            if n < chunk:
                pad = chunk - n
                planes = np.concatenate(
                    [planes, np.broadcast_to(planes[-1:],
                                             (pad,) + planes.shape[1:])])
                hdrs = np.concatenate(
                    [hdrs, np.broadcast_to(hdrs[-1:],
                                           (pad,) + hdrs.shape[1:])])
            yield fids, self.project(self.shard(planes), self.shard(hdrs))
