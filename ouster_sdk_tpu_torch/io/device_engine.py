"""The device engine: pcap or live packets -> LidarScans, decoded on the
device.

This is the user-facing half of the device pipeline: what scan sources
iterate, so that the path users run is the device path. The numpy
ScanBatcher stays the streaming decoder and the semantic oracle: scans
produced here are bit-equal to its scans, dtypes included.

Per batch: one scan pass of the capture with IPv4 reassembly
(io.frames.pcap_scan), an admission replay of the ScanBatcher state
machine (_AuxRouter) whose frame instances drive the word-planar staging
(FrameReader.iter_instance_batches, on a background staging thread), one
host->device copy, the decode of every field
(ops.unpack.decode_frame_planar_batch), one device->host copy, and the
LidarScan materialization. Beside it, the live twin (LiveDeviceBatcher:
packets in, scans out, pixel fields left on the device until first
touched) and the OSF half (OsfDeviceProjector: host range images ->
double-single XYZ on the device -> LidarScan.attach_xyz_cache).

Entry points take `device=None`: CUDA, and an error without a GPU. Where
the tensors live picks the route, as everywhere in the package: plain
PyTorch ops on either device for the decode, and for the projector the
hand-written planar kernel on CUDA tensors and its plain version on CPU
tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.batcher import ScanBatcher, _frame_status
from ..core.lidar_scan import LidarScan
from ..core.packets import ImuPacket, ZonePacket
from ..core.types import SensorInfo, UDPProfileIMU, UDPProfileLidar
from ..ops.fused import default_device
from ..ops.packet_format import PacketFormat, read_bits
from ..ops.planar_kernels import PlanarLut, project_ranges, words_tensor
from ..ops.unpack import decode_frame_planar_batch, make_decode_plan
from ..ops.xyzlut import make_xyz_lut
from ..utils import profiling
from .frames import FrameReader, stage_planar

#: Introspection counters (reset freely in tests): proof of which engine
#: decoded. `batches` counts device dispatches (decode batches and
#: projector windows), `scans` the LidarScans handed out, `osf_batches`
#: the projector's windows alone.
stats = {"batches": 0, "scans": 0, "osf_batches": 0}


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def device_decode_enabled() -> bool:
    """The scan sources' routing policy, read when a source iterates:
    OUSTER_SDK_TPU_DEVICE_DECODE=0 asks for the numpy ScanBatcher; 1 or
    unset is the engine on the source's device (CUDA unless the caller
    names another, and an error without a GPU: there is no quiet move to
    the numpy batcher)."""
    env = os.environ.get("OUSTER_SDK_TPU_DEVICE_DECODE", "").strip()
    if env not in ("", "0", "1"):
        raise ValueError(f"OUSTER_SDK_TPU_DEVICE_DECODE={env!r}: expected "
                         "0 or 1")
    return env != "0"


def supports_device_decode(info: SensorInfo,
                           field_names: Optional[List[str]] = None,
                           raw_headers: bool = False,
                           raw_fields: bool = False) -> bool:
    """Static eligibility: the device route covers every lidar profile.
    eUDP decodes planar, LEGACY ships its column-FOOTER status as one
    extra staged col-header row (plan.schw), and NMEA-IMU /
    zone-monitoring scans run HYBRID (lidar fields decode on the device,
    aux packets batch host-side into the matching scan by frame id, see
    _AuxApplier). RAW32 side-channels decode on the device too (each is
    one staged plane); only RAW_HEADERS, which needs the unstaged packet
    FOOTER bytes, stays on the numpy batcher."""
    fmt = info.format
    if fmt.udp_profile_lidar == UDPProfileLidar.OFF:
        return False
    if raw_headers:
        return False
    plan = make_decode_plan(info)
    if field_names is not None:
        decodable = {f.name.split("#")[0] for f in plan.fields}
        if not set(field_names) <= decodable:
            return False
    return True


def _to_host(dev: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The decode's output dict copied to the host, each field in its scan
    dtype (the decode already cast it on the device). Each copy waits for
    the decode."""
    with profiling.span("engine.copy_back"):
        profiling.count("engine.d2h_copies", len(dev))
        return {k: v.cpu().numpy() for k, v in dev.items()}


def materialize_scan(info: SensorInfo, pf: PacketFormat, plan,
                     host: Dict[str, np.ndarray], k: int, frame_id: int,
                     pkt_ts_row: np.ndarray, pkt_hdrs_row: np.ndarray,
                     first_hdr_row: np.ndarray,
                     field_types=None) -> LidarScan:
    """Build a LidarScan from one decoded frame: field arrays from the
    decode's output dict on the host (slot k) plus headers read from the
    staged packet-header words, the same population ScanBatcher does per
    packet (ref: lidar_scan.cpp:1324-1372, :1546-1552). Nothing is cast:
    the decode gave every field its scan dtype."""
    with profiling.span("engine.materialize", int(frame_id)):
        ls = LidarScan(info, field_types=field_types)
        ls.frame_id = int(frame_id)
        ls.sensor_info = info

        _populate_pixel_fields(ls, plan, host, k)

        ls.timestamp[:] = (host["timestamp_lo"][k].astype(np.uint64)
                           | host["timestamp_hi"][k].astype(np.uint64)
                           << np.uint64(32))
        ls.measurement_id[:] = host["measurement_id"][k]
        ls.status[:] = host["status"][k]
        _populate_packet_headers(ls, pf, pkt_ts_row, pkt_hdrs_row,
                                 first_hdr_row)
        return ls


def _populate_pixel_fields(ls: LidarScan, plan,
                           host: Dict[str, np.ndarray], k: int) -> None:
    """Write one decoded frame's channel fields (slot k of the decode
    output dict) into the scan, restacking multi-element '#' planes on
    the last axis."""
    combined: Dict[str, np.ndarray] = {}
    multi: Dict[str, List[np.ndarray]] = {}
    for f in plan.fields:
        if "#" in f.name:
            multi.setdefault(f.name.split("#")[0], []).append(
                host[f.name][k])
        else:
            combined[f.name] = host[f.name][k]
    for name, parts in multi.items():
        combined[name] = np.stack(parts, axis=-1)
    for name, arr in combined.items():
        if ls.has_field(name):
            ls.field(name)[:] = arr


def _populate_packet_headers(ls: LidarScan, pf: PacketFormat,
                             pkt_ts_row: np.ndarray,
                             pkt_hdrs_row: np.ndarray,
                             first_hdr_row: np.ndarray) -> None:
    ls.packet_timestamp[:] = pkt_ts_row
    ls.alert_flags[:] = read_bits(
        pkt_hdrs_row, pf.geom.alert_flags).astype(np.uint8)
    ls.frame_status = _frame_status(
        int(read_bits(first_hdr_row, pf.geom.thermal_shutdown)),
        int(read_bits(first_hdr_row, pf.geom.shot_limiting)))
    ls.shutdown_countdown = int(
        read_bits(first_hdr_row, pf.geom.countdown_thermal_shutdown))
    ls.shot_limiting_countdown = int(
        read_bits(first_hdr_row, pf.geom.countdown_shot_limiting))


def _host_bits(words: np.ndarray, word: int, bit: int, size: int
               ) -> np.ndarray:
    """Bitfield of u32 words on the last axis, on the host (u64)."""
    lo = words[..., word].astype(np.uint64) >> np.uint64(bit)
    if bit + size > 32:
        lo |= words[..., word + 1].astype(np.uint64) << np.uint64(32 - bit)
    return lo & np.uint64((1 << size) - 1)


def _host_column_headers(plan, colhdr: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Numpy twin of decode_frame_planar_batch's column-header extraction
    (the zeroing of invalid columns included) over the HOST-staged
    col-header words (schw, w), so the live route populates scan headers
    without any device readback. Returns (timestamp u64, measurement_id
    u16, status u32) arrays plus the valid mask."""
    w = colhdr.T  # words on the last axis
    status = _host_bits(w, plan.staged_status_word, plan.status_bit,
                        plan.status_size)
    m_id = _host_bits(w, plan.mid_word, plan.mid_bit, 16)
    valid = (status & np.uint64(1)).astype(bool)
    ts = (colhdr[0].astype(np.uint64)
          | colhdr[1].astype(np.uint64) << np.uint64(32))
    return (np.where(valid, ts, 0).astype(np.uint64),
            np.where(valid, m_id, 0).astype(np.uint16),
            np.where(valid, status, 0).astype(np.uint32),
            valid)


def materialize_scan_deferred(info: SensorInfo, pf: PacketFormat, plan,
                              dev: Dict[str, torch.Tensor],
                              colhdr: np.ndarray, frame_id: int,
                              pkt_ts_row: np.ndarray,
                              pkt_hdrs_row: np.ndarray,
                              first_hdr_row: np.ndarray,
                              field_types=None) -> LidarScan:
    """Build a LidarScan whose pixel fields stay on the DEVICE: every
    header populates eagerly from the host-staged words (no device->host
    copy), and the decoded frame (`dev`, the decode's output dict of
    tensors, slot 0) is copied back lazily on first field access via
    LidarScan.set_deferred_fields.

    This is the live contract: scans that are queued, dropped, counted,
    or consumed by further device stages never pay a device->host copy;
    only a host consumer that touches a field does
    (ref: sensor_scan_source.cpp:222 drop-oldest: dropped scans there
    never surface their pixels either)."""
    ls = LidarScan(info, field_types=field_types)
    ls.frame_id = int(frame_id)
    ls.sensor_info = info

    ts, m_id, status, _ = _host_column_headers(plan, colhdr)
    ls.timestamp[:] = ts
    ls.measurement_id[:] = m_id
    ls.status[:] = status
    _populate_packet_headers(ls, pf, pkt_ts_row, pkt_hdrs_row,
                             first_hdr_row)

    def fill(scan: LidarScan, _dev=dev, _plan=plan) -> None:
        _populate_pixel_fields(scan, _plan, _to_host(_dev), 0)

    ls.set_deferred_fields(fill)
    return ls


class _AuxApplier:
    """Host-side half of the HYBRID device route: applies IMU/zone
    packets to a device-decoded scan with the numpy batcher's own field
    writers, so aux population is by definition identical to the
    ScanBatcher path (ref: lidar_scan.cpp:1374 batch_imu_packet, :1458
    batch_zone_packet)."""

    def __init__(self, info: SensorInfo):
        self._b = ScanBatcher(info)
        self.expected_imu = self._b._expected_imu_packets
        self.expected_zone = self._b._expected_zone_packets

    @staticmethod
    def wanted(info: SensorInfo) -> bool:
        fmt = info.format
        return (fmt.udp_profile_imu == UDPProfileIMU.ACCEL32_GYRO32_NMEA
                or fmt.zone_monitoring_enabled)

    def counts(self, kind: str, buf: np.ndarray) -> bool:
        """Whether this packet increments the batcher's completion
        counter: _batch_imu_packet rejects malformed measurement ids /
        degenerate metadata WITHOUT counting, so a corrupt packet must
        not complete a frame early here either. Zone packets always count
        (no early return in the writer)."""
        if kind != "imu":
            return True
        pf, w = self._b.pf, self._b.w
        ippf = pf.imu_packets_per_frame
        mpp = pf.imu_measurements_per_packet
        if ippf <= 0 or mpp <= 0 or w < ippf:
            return False
        _, m_id, _ = pf.imu_measurement_headers(buf)
        return 0 <= int(m_id[0]) // (w // ippf) < ippf

    def apply(self, kind: str, buf: np.ndarray, host_ts: int,
              ls: LidarScan) -> None:
        if kind == "imu":
            self._b._batch_imu_packet(ImuPacket(buf, host_ts), ls)
        else:
            self._b._batch_zone_packet(ZonePacket(buf, host_ts), ls)


def _read_opener(pf: PacketFormat, buf: np.ndarray) -> Tuple[int, int, int]:
    """(frame_status, shutdown_countdown, shot_limiting_countdown) from a
    frame-OPENING packet's header: the batcher populates these from
    whichever packet starts the scan, lidar or aux alike
    (ref: lidar_scan.cpp:1546-1552)."""
    return (_frame_status(pf.thermal_shutdown(buf), pf.shot_limiting(buf)),
            pf.countdown_thermal_shutdown(buf),
            pf.countdown_shot_limiting(buf))


class _FrameInstance:
    """One frame the admission replay released: the datagram indices of
    the lidar packets the batcher admitted to it, which aux packets, the
    opener header when an AUX packet opened it, and whether it was
    released at a boundary (or left open at the end of the capture)."""

    __slots__ = ("fid", "aux", "opener", "boundary", "lidar_n", "slots",
                 "counts", "pkt_idx_parts", "released_at")

    # end-of-capture sentinel: orders after every real datagram index so
    # that a multi-sensor merge flushes partial scans last, like
    # packet-by-packet batching
    EOF_RELEASE = 1 << 62

    def __init__(self, fid: int, opener):
        self.fid = fid
        self.aux: List[Tuple[str, np.ndarray, int]] = []
        self.opener = opener          # (fs, sd, sl) or None (lidar opener)
        self.boundary = True
        self.lidar_n = 0
        self.slots: set = set()
        self.counts = {"imu": 0, "zone": 0}
        self.pkt_idx_parts: List[np.ndarray] = []
        # datagram index of the event that RELEASED this frame: the
        # position at which packet-by-packet batching would yield the scan
        # (the completing packet, or the new-id packet that closed it); a
        # multi-sensor merge orders per-sensor streams by this key
        self.released_at = self.EOF_RELEASE

    @property
    def has_lidar(self) -> bool:
        return self.lidar_n > 0

    @property
    def pkt_idx(self) -> np.ndarray:
        return (np.concatenate(self.pkt_idx_parts)
                if self.pkt_idx_parts else np.zeros(0, np.int64))


class _AuxRouter:
    """Replays the ScanBatcher admission state machine
    (ref: lidar_scan.cpp:1505-1617) over the capture's interleaved
    lidar/aux packet order, producing the exact frame instances the
    oracle would release: which lidar packets each admits (reordered
    stragglers and post-release duplicates drop), which aux packets,
    aux-only frames in release order, the frame-opening packet's header
    for frame_status, and count-based completion (the malformed-imu
    no-count rule included) releasing at the same packet the oracle
    would. The instance list then DRIVES the staging
    (FrameReader.iter_instance_batches), so the lidar grouping cannot
    diverge from the replay. Frame-id wraps are instance-scoped, so
    hour-long captures cannot alias aux across the 16-bit id period.

    Lidar packets are processed as vectorized same-id runs (numpy
    segmentation), not per-packet Python; aux packets (a handful a frame)
    take the per-packet path."""

    def __init__(self, aux: _AuxApplier, plan, pf: PacketFormat,
                 lidar, aux_events) -> None:
        self._aux = aux
        self._m = pf.max_frame_id
        self._pf = pf
        self._n_pkts = plan.n_pkts
        self.instances: List[_FrameInstance] = []
        self._cur: Optional[_FrameInstance] = None
        self._finished = -1

        lidx, lfid, lslot, lts = lidar
        a_ptr, l_pos, nL = 0, 0, lidx.size
        while l_pos < nL or a_ptr < len(aux_events):
            nxt = aux_events[a_ptr][0] if a_ptr < len(aux_events) else None
            if l_pos < nL and (nxt is None or lidx[l_pos] < nxt):
                seg_end = nL if nxt is None else l_pos + int(
                    np.searchsorted(lidx[l_pos:], nxt))
                f = lfid[l_pos:seg_end]
                starts = np.flatnonzero(
                    np.concatenate(([True], f[1:] != f[:-1]))) + l_pos
                ends = np.append(starts[1:], seg_end)
                for s, e in zip(starts, ends):
                    self._lidar_run(int(lfid[s]), lidx[s:e], lslot[s:e],
                                    lts[s:e])
                l_pos = seg_end
            else:
                idx, kind, fid, buf, ts = aux_events[a_ptr]
                a_ptr += 1
                self._aux_packet(kind, fid, buf, ts, idx)
        if self._cur is not None:
            self._release(False, _FrameInstance.EOF_RELEASE)  # open at EOF

    def _release(self, boundary: bool, at: int) -> None:
        self._cur.boundary = boundary
        self._cur.released_at = at
        self.instances.append(self._cur)
        self._finished = self._cur.fid
        self._cur = None

    def _admit(self, fid: int, opener, at: int) -> bool:
        """Boundary/drop rules for one packet (or a same-id run: drops
        do not mutate state, so the decision is uniform across a run).
        `at` is the packet's datagram index: a new id releases the open
        frame AT this packet, exactly where the oracle's call would
        return true (ref: lidar_scan.cpp:1526-1565 cached replay)."""
        m = self._m
        if self._cur is not None:
            if self._cur.fid == fid:
                return True
            if self._cur.fid == (fid + 1) & m:
                return False   # reordered from the previous frame
            self._release(True, at)
        if self._finished >= 0 and (
                self._finished == fid
                or self._finished == (fid + 1) & m):
            return False       # duplicate / reorder past a release
        self._cur = _FrameInstance(fid, opener)
        return True

    def _aux_ok(self) -> bool:
        return (self._cur.counts["imu"] >= self._aux.expected_imu
                and self._cur.counts["zone"] >= self._aux.expected_zone)

    def _lidar_run(self, fid: int, idxs: np.ndarray, slots: np.ndarray,
                   tss: np.ndarray) -> None:
        if not self._admit(fid, None, int(idxs[0])):
            return
        cur, n_pkts = self._cur, self._n_pkts
        take = idxs.size
        valid = (slots >= 0) & (slots < n_pkts)
        if bool((tss[valid] == 0).any()):
            # a zero-host-ts write UN-stamps a slot: the oracle writes
            # packet_timestamp unconditionally and completion counts the
            # NONZERO entries, so a zero-ts duplicate of an already
            # stamped slot reopens the count. Set-based tracking cannot
            # express that vectorized: replay this run (rare: synthetic
            # or zero-ts captures only) packet by packet.
            for t in range(take):
                if valid[t]:
                    s = int(slots[t])
                    if tss[t]:
                        cur.slots.add(s)
                    else:
                        cur.slots.discard(s)
                if (self._aux_ok() and cur.lidar_n + t + 1 >= n_pkts
                        and len(cur.slots) >= n_pkts):
                    cur.lidar_n += t + 1
                    cur.pkt_idx_parts.append(idxs[:t + 1])
                    self._release(True, int(idxs[t]))
                    return
            cur.lidar_n += take
            cur.pkt_idx_parts.append(idxs)
            return
        # distinct NEW slots per position (the oracle counts nonzero
        # packet_timestamp stamps): sentinel out invalid/zero-ts slots,
        # first occurrence in the run minus already stamped slots
        sl = np.where(valid & (tss != 0), slots, n_pkts)
        if self._aux_ok() and cur.lidar_n + take >= n_pkts:
            seen = np.zeros(n_pkts + 1, bool)
            if cur.slots:
                seen[np.fromiter(cur.slots, np.int64,
                                 len(cur.slots))] = True
            seen[n_pkts] = True
            uniq, first = np.unique(sl, return_index=True)
            new_mask = np.zeros(take, bool)
            new_mask[first[~seen[uniq]]] = True
            distinct = len(cur.slots) + np.cumsum(new_mask)
            count = cur.lidar_n + np.arange(1, take + 1)
            done = (count >= n_pkts) & (distinct >= n_pkts)
            if done.any():
                # completion mid-run: admit through the completing
                # packet, release; the rest are post-release duplicates
                # the oracle drops (finished == fid)
                p = int(np.argmax(done)) + 1
                cur.lidar_n += p
                cur.slots.update(int(v) for v in np.unique(sl[:p])
                                 if v < n_pkts)
                cur.pkt_idx_parts.append(idxs[:p])
                self._release(True, int(idxs[p - 1]))
                return
        cur.lidar_n += take
        cur.slots.update(int(v) for v in np.unique(sl) if v < n_pkts)
        cur.pkt_idx_parts.append(idxs)

    def _aux_packet(self, kind: str, fid: int, buf: np.ndarray,
                    ts: int, idx: int) -> None:
        if not self._admit(fid, _read_opener(self._pf, buf), idx):
            return
        cur = self._cur
        cur.aux.append((kind, buf, ts))
        if self._aux.counts(kind, buf):
            cur.counts[kind] += 1
        if (cur.lidar_n >= self._n_pkts
                and len(cur.slots) >= self._n_pkts and self._aux_ok()):
            self._release(True, idx)


class DeviceScanIterator:
    """Iterate LidarScans for ONE sensor from a pcap via device decode.

    Scans are bit-equal to ScanBatcher output: same fields, column
    headers, per-packet timestamps/alert flags, frame status/countdowns,
    boundary drop semantics and trailing-scan validity filter
    (ref: lidar_scan.cpp:1505-1643, pcap_scan_source.cpp flush).

    `batch` frames are staged, copied and decoded at a time; a last,
    shorter batch decodes just its frames (no padding to `batch`: eager
    PyTorch compiles nothing per shape, and padded slots were never
    read). `device=None` is CUDA and raises without a GPU.
    """

    def __init__(self, path: str, info: SensorInfo,
                 field_names: Optional[List[str]] = None,
                 soft_id_check: bool = False,
                 batch: int = 4,
                 field_types=None,
                 pipelined: bool = True,
                 raw_fields: bool = False,
                 device=None):
        self.device = _device(device)
        self.info = info
        self.pf = PacketFormat.from_info(info)
        # strict ports: packet-by-packet reading classifies by the
        # CONFIGURED port unconditionally; the lenient fallback could
        # claim another sensor's size-matching stream when this sensor's
        # packets are absent from the capture
        self._reader = FrameReader(path, info=info, strict_ports=True)
        self._batch = batch
        self._pipelined = pipelined
        names = tuple(field_names) if field_names is not None else None
        self.plan = make_decode_plan(info, field_names=names,
                                     raw_fields=raw_fields)
        self._field_types = field_types
        # Replay the batcher's admission over the interleaved lidar/aux
        # capture order once; the resulting frame instances drive BOTH
        # the aux assignment and the lidar staging
        # (iter_instance_batches), so the two cannot diverge, and give
        # O(1)-memory random access (DeviceScanIndex). For plain lidar
        # profiles the aux half is empty and the replay reduces to the
        # batcher's frame-id boundary/duplicate semantics.
        self._aux = _AuxApplier(info)
        with profiling.span("engine.admission"):
            lidar_ev, aux_ev = self._reader.hybrid_streams(
                soft_id_check=soft_id_check)
            self._instances: List[_FrameInstance] = _AuxRouter(
                self._aux, self.plan, self.pf, lidar_ev, aux_ev).instances

    @property
    def id_error_count(self) -> int:
        return self._reader.id_error_count

    def _materialize(self, batch, k: int,
                     host: Dict[str, np.ndarray]) -> LidarScan:
        return materialize_scan(
            self.info, self.pf, self.plan, host, k,
            int(batch.frame_ids[k]), batch.pkt_ts[k], batch.pkt_hdrs[k],
            batch.first_hdr[k], self._field_types)

    def _aux_only_scan(self, inst: _FrameInstance) -> LidarScan:
        """A frame the batcher opened on an aux packet and released at a
        boundary with no lidar packets: emitted with zeroed lidar fields,
        like the oracle (a scan opened by ANY packet releases at the next
        frame boundary)."""
        ls = LidarScan(self.info, field_types=self._field_types)
        ls.frame_id = inst.fid
        ls.sensor_info = self.info
        for kind, buf, ts in inst.aux:
            self._aux.apply(kind, buf, ts, ls)
        ls.frame_status, ls.shutdown_countdown, \
            ls.shot_limiting_countdown = inst.opener
        return ls

    def _decoded_scans(self, batches) -> Iterator[LidarScan]:
        """Decode staged batches to LidarScans, in order: one
        host->device copy of the staged words (from pageable pool buffers,
        so the copy has read them when it returns), the decode, one
        device->host copy of every decoded field."""
        for batch in batches:
            planes = words_tensor(batch.planes, self.device)
            hdrs = words_tensor(batch.col_hdrs, self.device)
            with profiling.span("engine.decode", int(batch.frame_ids[0])):
                dev = decode_frame_planar_batch(planes, hdrs, self.plan,
                                                True)
            host = _to_host(dev)
            # the decoded fields leave the card now, not at the next
            # batch's decode: the device's memory peak
            del dev
            stats["batches"] += 1
            for k in range(batch.frame_ids.size):
                yield self._materialize(batch, k, host)

    def _finish_scan(self, ls: LidarScan, inst: _FrameInstance
                     ) -> LidarScan:
        """Apply an instance's aux packets and opener header to its
        device-decoded scan."""
        with profiling.span("engine.materialize", ls.frame_id):
            for kind, buf, ts in inst.aux:
                self._aux.apply(kind, buf, ts, ls)
            if inst.opener is not None:
                ls.frame_status, ls.shutdown_countdown, \
                    ls.shot_limiting_countdown = inst.opener
        return ls

    def __iter__(self) -> Iterator[LidarScan]:
        for _, ls in self.iter_released():
            yield ls

    def iter_released(self) -> Iterator[Tuple[int, LidarScan]]:
        """Walk the admission replay's frame instances in release order,
        yielding (released_at, scan): lidar-carrying instances decode on
        the device from exactly the packets the oracle admitted; aux-only
        instances emit zero-lidar scans; the instance left open at the
        end of the capture gets the trailing validity filter. Alignment
        with the staging is by construction: the instance list IS the
        staging plan. `released_at` is the datagram index at which
        packet-by-packet batching would have yielded the scan
        (EOF_RELEASE for the trailing flush), the key a multi-sensor
        merge orders by."""
        inst = self._instances
        groups = [i.pkt_idx for i in inst if i.has_lidar]
        B = self._batch
        if self._pipelined:
            batches = self._reader.iter_instance_batches_pipelined(
                groups, B)
        else:
            batches = self._reader.iter_instance_batches(groups, B)
        scans = self._decoded_scans(batches)
        last = len(inst) - 1
        for j, i in enumerate(inst):
            trailing = j == last and not i.boundary
            if not i.has_lidar:
                # aux-only frame: released at a boundary like any other;
                # the one open at the end never emits (no valid column)
                if not trailing:
                    stats["scans"] += 1
                    yield i.released_at, self._aux_only_scan(i)
                continue
            ls = self._finish_scan(next(scans), i)
            if trailing and not np.any(ls.status & 1):
                continue
            stats["scans"] += 1
            yield i.released_at, ls
        # run the staging to its end so that its pools check back in
        for _ in scans:
            pass


class DeviceScanIndex:
    """Random access over a pcap's scans WITHOUT materializing them: the
    admission replay's frame-instance list is the index (which datagrams
    belong to scan j), and `scan_at(j)` stages and device-decodes just
    that frame on demand, LRU-caching a few results. The decoded-scan
    memory is O(LRU). This is the equivalent of the SDK's
    IndexedPcapReader frame index {file offset, sensor idx, timestamp} +
    seek-and-rebatch (ref: indexed_pcap_reader.h:28-101), with the decode
    running on the device. Scans are identical to iterating the
    DeviceScanIterator (same instances, same decode)."""

    def __init__(self, it: DeviceScanIterator, cache_scans: int = 8):
        self._it = it
        self._cache_cap = max(1, cache_scans)
        self._cache: "Dict[int, LidarScan]" = {}
        self._order: List[int] = []
        self._timestamps: Optional[List[int]] = None
        inst = it._instances
        emitted: List[int] = []
        last = len(inst) - 1
        for j, i in enumerate(inst):
            trailing = j == last and not i.boundary
            if trailing:
                if not i.has_lidar:
                    continue
                # frame open at the end of the capture: emitted only when
                # it has a valid column; decode once now to decide, the
                # scan lands in the LRU for reuse
                ls = self._decode_instance(j)
                if not np.any(ls.status & 1):
                    continue
            emitted.append(j)
        self._emitted = emitted

    def __len__(self) -> int:
        return len(self._emitted)

    @property
    def frame_ids(self) -> List[int]:
        return [self._it._instances[j].fid for j in self._emitted]

    def _decode_instance(self, j: int) -> LidarScan:
        if j in self._cache:
            self._order.remove(j)      # LRU: refresh recency on hit
            self._order.append(j)
            return self._cache[j]
        it = self._it
        inst = it._instances[j]
        if not inst.has_lidar:
            ls = it._aux_only_scan(inst)
        else:
            # hold the staging generator open until the decode has read
            # the pooled buffers: closing it returns the pool, and a
            # concurrent lookup could otherwise overwrite the views
            gen = it._reader.iter_instance_batches([inst.pkt_idx],
                                                   chunk=1)
            try:
                batch = next(gen)
                ls = it._finish_scan(
                    next(it._decoded_scans(iter([batch]))), inst)
            finally:
                gen.close()
        self._cache[j] = ls
        self._order.append(j)
        if len(self._order) > self._cache_cap:
            self._cache.pop(self._order.pop(0), None)
        return ls

    def scan_at(self, i: int) -> LidarScan:
        """The i-th scan the source would emit, decoded on demand."""
        return self._decode_instance(self._emitted[i])

    def timestamps(self) -> List[int]:
        """Per-scan index timestamps (first valid packet host ts, falling
        back to the first valid column ts): one batched, pipelined decode
        pass on first call, memoized after (scans themselves are not
        retained beyond the LRU)."""
        if self._timestamps is None:
            self._timestamps = [
                int(s.first_valid_packet_timestamp()
                    or s.first_valid_column_timestamp())
                for _, s in self._it.iter_released()]
        return self._timestamps


class LiveDeviceBatcher:
    """Frame-batch device handoff for the LIVE path: per-packet host work
    collapses to a memcpy into a staging slab (plus an 8-byte frame-id /
    2-byte measurement-id peek); whole frames then decode on the device
    in one dispatch. The live twin of DeviceScanIterator, with
    ScanBatcher's boundary semantics replicated at the slab level
    (ref: lidar_scan.cpp:1505-1643 reorder/duplicate/zero-fill,
    :1605-1617 count-based completion; sensor_scan_source.cpp:185
    batcher thread).

    push() returns the scans released by this packet (0 or 1), bit-equal
    to the numpy ScanBatcher's on the same packet stream once a field is
    touched; until then their pixel fields stay on the device
    (LidarScan.fields_deferred).

    The staged frame rides a ring of host buffers, pinned on CUDA: the
    copy to the device is asynchronous, and before a slot is rewritten
    the batcher waits on the event recorded after that slot's DECODE was
    issued. The decode reads the copied words, so its completion subsumes
    the copy's, and every consumer of the slot's bytes has run; the
    copy's own completion would not say that much. On the CPU there is
    nothing to wait for. `device=None` is CUDA and raises without a GPU.
    """

    _RING = 4

    def __init__(self, info: SensorInfo, field_types=None, device=None):
        self.device = _device(device)
        self.info = info
        self.pf = PacketFormat.from_info(info)
        self.plan = make_decode_plan(info)
        g = self.pf.geom
        self._fid_byte, self._fid_shift = divmod(g.frame_id.bit_start, 8)
        self._fid_mask = (1 << g.frame_id.bit_size) - 1
        self._mid_byte = self.pf.packet_header_size + \
            (self.plan.mid_word * 4)
        plan = self.plan
        # completion counts the WINDOW's packets, not the full frame's
        # (azimuth-windowed sensors never send out-of-window packets;
        # ref: lidar_scan.cpp:1605-1617, types.h:849-856)
        self._expected_pkts = info.format.lidar_packets_per_frame()
        cap = plan.n_pkts + 8  # one frame + straggler slack
        self._slab = np.zeros((cap, self.pf.lidar_packet_size), np.uint8)
        self._ts = np.zeros(cap, np.uint64)
        self._n = 0
        self._cur = -1            # fid of the open frame
        self._released = -1       # fid of the last released frame
        self._slots: set = set()  # distinct packet slots with ts != 0
        # single-frame outputs: the slab only ever holds one frame id (a
        # boundary flush precedes staging a new id). planes/colhdr are a
        # small RING because the copy to the device is asynchronous (the
        # deferred scans never force a sync): a host buffer must not be
        # rewritten by the next flush while the device may still read it.
        pin = self.device.type == "cuda"
        self._ring = [
            (torch.zeros((1, plan.pw, plan.h, plan.w), dtype=torch.int32,
                         pin_memory=pin),
             torch.zeros((1, plan.schw, plan.w), dtype=torch.int32,
                         pin_memory=pin))
            for _ in range(self._RING)]
        self._ring_events: List = [None] * self._RING
        self._ring_i = 0
        self._fid_out = np.zeros(1, np.int64)
        self._ts_out = np.zeros(1, np.uint64)
        self._pkt_ts = np.zeros((1, plan.n_pkts), np.uint64)
        self._pkt_hdrs = np.zeros((1, plan.n_pkts, plan.hw), np.uint32)
        self._first_hdr = np.zeros((1, plan.hw), np.uint32)
        self._field_types = field_types
        # hybrid aux route (NMEA imu / zone packets for the open frame);
        # the applier (a full ScanBatcher) exists only for profiles that
        # carry aux streams
        self._aux = _AuxApplier(info) if _AuxApplier.wanted(info) else None
        self._aux_pending: List[Tuple[str, np.ndarray, int]] = []
        self._aux_counts = {"imu": 0, "zone": 0}
        # frame-opening packet's header feeds frame_status/countdowns;
        # an aux packet can open the frame
        self._opener = (0, 0, 0)

    @property
    def expected_imu_packets(self) -> int:
        return self._aux.expected_imu if self._aux is not None else 0

    @property
    def expected_zone_packets(self) -> int:
        return self._aux.expected_zone if self._aux is not None else 0

    @property
    def wants_imu(self) -> bool:
        """Whether live imu packets should run the admission state
        machine: the oracle only rejects ImuPackets for non-NMEA
        profiles; with NMEA metadata declaring imu_packets_per_frame == 0
        they still open/release frames and supply opener headers, so gate
        on the profile, not the count."""
        return self.pf.udp_profile_imu == UDPProfileIMU.ACCEL32_GYRO32_NMEA

    def _admit(self, fid: int, buf: np.ndarray
               ) -> Tuple[List[LidarScan], bool]:
        """Shared boundary logic: returns (scans released by a frame-id
        change, whether the packet is admitted). A packet from a NEW
        frame always releases the open one first: the oracle finalizes
        and caches the packet, then re-runs the drop rules against the
        JUST-released id, never a stale one
        (ref: lidar_scan.cpp:1526-1565)."""
        m = self._fid_mask
        if self._cur >= 0:
            if fid == self._cur:
                return [], True
            if fid == (self._cur - 1) & m:
                return [], False  # reordered from the previous frame
            out = self._flush()
        else:
            out = []
        if self._released >= 0 and (fid == self._released
                                    or self._released == (fid + 1) & m):
            return out, False     # duplicate / reorder past a release
        self._cur = fid
        self._opener = _read_opener(self.pf, buf)
        return out, True

    def _complete(self) -> bool:
        """Count-based completion incl. aux, mirroring
        _check_scan_complete (lidar_scan.cpp:1605-1617): enough packets
        batched AND the count of distinct stamped slots EQUALS the
        window's expectation. A stray out-of-window packet overshoots the
        oracle's count_nonzero(packet_timestamp) == expected, so the
        frame then releases only at the boundary, like the oracle."""
        return (self._n >= self._expected_pkts
                and len(self._slots) == self._expected_pkts
                and self._aux_counts["imu"] >= self.expected_imu_packets
                and self._aux_counts["zone"] >= self.expected_zone_packets)

    def push_aux(self, kind: str, buf: np.ndarray, host_ts: int
                 ) -> List[LidarScan]:
        """Stage one IMU/zone packet for the open frame (hybrid route):
        applied to the device-decoded scan at release with the numpy
        batcher's own writers. Malformed packets the oracle's writer
        rejects are staged (the writer will no-op on them identically)
        but do NOT count toward completion."""
        if self._aux is None:
            return []
        fid = self._fid_of(buf)
        out, ok = self._admit(fid, buf)
        if not ok:
            return out
        self._aux_pending.append((kind, buf.copy(), host_ts))
        if self._aux.counts(kind, buf):
            self._aux_counts[kind] += 1
        if self._complete():
            out.extend(self._flush())
        return out

    def _fid_of(self, buf: np.ndarray) -> int:
        word = int.from_bytes(
            buf[self._fid_byte:self._fid_byte + 8].tobytes(), "little")
        return (word >> self._fid_shift) & self._fid_mask

    def push(self, buf: np.ndarray, host_ts: int) -> List[LidarScan]:
        """Stage one validated lidar packet; returns released scans."""
        fid = self._fid_of(buf)
        out, ok = self._admit(fid, buf)
        if not ok:
            return out
        if self._n >= self._slab.shape[0]:
            # pathological duplicate storm: grow rather than split the
            # frame (the numpy batcher keeps accumulating too)
            cap = self._slab.shape[0] * 2
            slab = np.zeros((cap, self._slab.shape[1]), np.uint8)
            slab[:self._n] = self._slab[:self._n]
            self._slab = slab
            self._ts = np.concatenate(
                [self._ts, np.zeros(cap - self._ts.size, np.uint64)])
        self._slab[self._n, :len(buf)] = buf
        self._ts[self._n] = host_ts
        self._n += 1
        mid0 = int.from_bytes(
            buf[self._mid_byte:self._mid_byte + 2].tobytes(), "little")
        slot = mid0 // self.plan.cpp
        if 0 <= slot < self.plan.n_pkts:
            # out-of-range slots never stamp packet_timestamp in the
            # oracle so they must not complete here; and the oracle's
            # write is UNCONDITIONAL, so a zero-ts duplicate un-stamps a
            # previously stamped slot (completion counts nonzero entries)
            if host_ts:
                self._slots.add(slot)
            else:
                self._slots.discard(slot)
        # completion mirrors the numpy batcher: enough packets batched
        # AND every packet slot stamped (duplicates do not complete a
        # frame early) AND the expected aux (imu/zone) packets arrived
        if self._complete():
            out.extend(self._flush())
        return out

    def _flush(self) -> List[LidarScan]:
        """Group and device-decode the pending packets (one frame run),
        then merge the pending aux packets (hybrid route)."""
        aux = self._aux_pending
        self._aux_pending = []
        self._aux_counts = {"imu": 0, "zone": 0}
        if self._n == 0:
            # aux-only frame released at a boundary: the numpy batcher
            # emits it with zeroed lidar fields; mirror that
            if not aux or self._cur < 0:
                if self._cur >= 0:
                    self._released = self._cur
                self._cur = -1
                return []
            ls = LidarScan(self.info, field_types=self._field_types)
            ls.frame_id = self._cur
            ls.sensor_info = self.info
            for kind, buf, ts in aux:
                self._aux.apply(kind, buf, ts, ls)
            ls.frame_status, ls.shutdown_countdown, \
                ls.shot_limiting_countdown = self._opener
            self._released = self._cur
            self._cur = -1
            stats["scans"] += 1
            return [ls]
        plan = self.plan
        slot = self._ring_i
        planes_t, colhdr_t = self._ring[slot]
        self._ring_i = (self._ring_i + 1) % self._RING
        if self._ring_events[slot] is not None:
            # completion fence before rewriting a slot: the decode that
            # read this buffer's copy 4 flushes ago must have run, or the
            # rewrite would corrupt that frame. With the ring ahead of the
            # device this does not block.
            self._ring_events[slot].synchronize()
            self._ring_events[slot] = None
        planes = planes_t.numpy().view(np.uint32)
        colhdr = colhdr_t.numpy().view(np.uint32)
        size = self._slab.shape[1]
        _, nf = stage_planar(
            self._slab.reshape(-1), np.arange(self._n, dtype=np.int64) * size,
            self._ts[:self._n], self.pf, plan, planes, colhdr, self._fid_out,
            self._ts_out, out_pkt_ts=self._pkt_ts,
            out_pkt_hdrs=self._pkt_hdrs, out_first_hdr=self._first_hdr)
        self._released = self._cur if self._cur >= 0 else self._released
        self._n = 0
        self._cur = -1
        self._slots.clear()
        if nf == 0:
            return []
        # asynchronous copy and decode, NO readback: the scan's pixel
        # fields stay in device memory and materialize lazily on first
        # access (headers populate from the host-staged words); a live
        # pipeline that feeds device-side consumers or drops scans under
        # backpressure never pays a device->host copy per frame
        dev = decode_frame_planar_batch(
            planes_t.to(self.device, non_blocking=True),
            colhdr_t.to(self.device, non_blocking=True), plan, True)
        if self.device.type == "cuda":
            # the fence is the DECODE's event, not the copy's
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._ring_events[slot] = event
        stats["batches"] += 1
        scan = materialize_scan_deferred(
            self.info, self.pf, plan, dev, colhdr[0],
            int(self._fid_out[0]), self._pkt_ts[0], self._pkt_hdrs[0],
            self._first_hdr[0], self._field_types)
        # frame_status/countdowns come from the frame-OPENING packet,
        # which may be an aux packet, not the first lidar packet the
        # staged first_hdr carries
        scan.frame_status, scan.shutdown_countdown, \
            scan.shot_limiting_countdown = self._opener
        if aux:
            # hybrid route: aux packets write only scan FIELDS (the numpy
            # batcher's own writers) and never the frame_status/countdown
            # headers; those were assigned eagerly above at release time,
            # so a consumer mutation made before first field access
            # survives the deferred fill.
            base_fill, applier = scan._deferred_fields, self._aux

            def fill_with_aux(s: LidarScan) -> None:
                base_fill(s)
                for kind, buf, ts in aux:
                    applier.apply(kind, buf, ts, s)

            scan.set_deferred_fields(fill_with_aux)
        stats["scans"] += 1
        return [scan]


def supports_osf_device_projection(info: SensorInfo,
                                   field_names) -> bool:
    """Static eligibility for the OSF device route: the file must carry
    RANGE (projection input), and the sensor must have projection
    geometry. OSF field decompression itself is host-side (PNG/zstd); the
    device half of OSF replay is the projection
    (ref: osf_scan_source.h:29)."""
    if field_names is not None and "RANGE" not in field_names:
        return False
    try:
        return (info.format.pixels_per_column > 0
                and info.format.columns_per_frame > 0
                and len(info.beam_altitude_angles or []) > 0)
    except Exception:
        return False


class OsfDeviceProjector:
    """Device half of OSF replay: host-decoded RANGE/RANGE2 images batch
    to the device, the double-single projection runs there
    (ops.planar_kernels.project_ranges: the planar kernel on CUDA, the
    same arithmetic in plain PyTorch on the CPU, <= 0.5 f32 ulp of the
    f64 host LUT), and each scan gets an exact-snapshot-guarded XYZ cache
    (LidarScan.attach_xyz_cache) to serve in place of the host f64
    re-projection. PNG/zstd decompression stays on the host
    (ref: stream_lidar_scan.h:204 decode_msg).

    One dispatch per LUT variant and window: the sensor frame and, where
    the extrinsic is not the identity, the extrinsics frame; both returns
    of every scan ride the batch axis. The window is not padded to
    `batch`. The range images are taken as they come: the projection is
    exact for ranges below 2**23 mm (every profile's range field is
    narrower) and nothing checks a larger value. `device=None` is CUDA
    and raises without a GPU."""

    def __init__(self, infos: List[SensorInfo], batch: int = 4,
                 device=None):
        self.device = _device(device)
        self._infos = infos
        self._batch = max(1, batch)
        self._per_sensor = [None] * len(infos)  # lazy (variants, luts)

    def _sensor_ctx(self, si: int):
        ctx = self._per_sensor[si]
        if ctx is None:
            info = self._infos[si]
            variants = [False]
            ext = np.asarray(info.extrinsic, np.float64)
            identity_ext = np.allclose(ext, np.eye(4))
            if not identity_ext:
                variants.append(True)
            luts = [PlanarLut(make_xyz_lut(info, v), self.device).stack
                    for v in variants]                   # V x (18, h, w)
            ctx = (variants, identity_ext, luts)
            self._per_sensor[si] = ctx
        return ctx

    def attach(self, entries: List[Tuple[int, "LidarScan"]]) -> None:
        """Project a window of (sensor_idx, scan) pairs: one device
        dispatch per sensor present and LUT variant (returns ride the
        batch axis), XYZ caches attached in place. Traced as one
        `osf.project` span a call; each dispatch counts its images under
        `osf.images_projected`."""
        by_sensor: Dict[int, List[Tuple["LidarScan", int, np.ndarray]]] = {}
        for si, ls in entries:
            if ls is None or not ls.has_field("RANGE"):
                continue
            info = self._infos[si]
            if not supports_osf_device_projection(info, None):
                continue
            rng = np.asarray(ls.field("RANGE"), np.uint32)
            if rng.shape != (info.format.pixels_per_column,
                             info.format.columns_per_frame):
                continue
            by_sensor.setdefault(si, []).append((ls, 0, rng))
            if ls.has_field("RANGE2"):
                by_sensor[si].append(
                    (ls, 1, np.asarray(ls.field("RANGE2"), np.uint32)))
        if not by_sensor:
            return
        first = next(iter(by_sensor.values()))[0][0]
        with profiling.span("osf.project", first.frame_id):
            for si, items in by_sensor.items():
                variants, identity_ext, luts = self._sensor_ctx(si)
                rngs = words_tensor(np.stack([r for _, _, r in items]),
                                    self.device)         # (B, h, w)
                out = []                                 # V x (B, 3, h, w)
                for L in luts:
                    out.append(project_ranges(rngs, L).cpu().numpy())
                    profiling.count("osf.images_projected", len(items))
                stats["batches"] += 1
                stats["osf_batches"] += 1
                for k, (ls, ret, r) in enumerate(items):
                    for v, use_ext in enumerate(variants):
                        xyz = np.moveaxis(out[v][k], 0, -1)   # (h, w, 3)
                        ls.attach_xyz_cache(ret, use_ext, xyz, r)
                        if identity_ext:
                            # identity extrinsic: the sensor frame IS the
                            # extrinsics frame, serve both keys
                            ls.attach_xyz_cache(ret, True, xyz, r)

    def wrap(self, it: Iterator[Tuple[int, "LidarScan"]]
             ) -> Iterator[Tuple[int, "LidarScan"]]:
        """Stream (sensor_idx, scan) through the projector in windows of
        `batch` items (yield order unchanged; latency bounded by the
        window)."""
        window: List[Tuple[int, "LidarScan"]] = []
        for item in it:
            window.append(item)
            if len(window) >= self._batch:
                self.attach(window)
                yield from window
                window = []
        if window:
            self.attach(window)
            yield from window


def make_osf_projector(infos: List[SensorInfo], field_names, device=None
                       ) -> Optional[OsfDeviceProjector]:
    """The OSF replay's projector on `device`, or None where the policy
    (device_decode_enabled) is off or no sensor is eligible: then scans
    carry no XYZ cache and XYZLut projects on the host. With the policy on,
    `device=None` is CUDA and raises without a GPU."""
    if not device_decode_enabled():
        return None
    if not any(supports_osf_device_projection(i, field_names)
               for i in infos):
        return None
    return OsfDeviceProjector(infos, device=device)
