"""FrameReader: pcap -> staged frames, in numpy, in two layouts.

Packet-layout staging (iter_chunks, read_all, iteration,
stream_from_packets) keeps whole lidar packets: a frame is
(n_pkts, pkt_words) u32 with each packet at the slot of its first column's
measurement id (m_id // columns-per-packet), gaps zero-filled, the last
packet of a slot winning. It is what ScanPipeline.__call__/batch and the
packet projection take.

Word-planar staging is the layout the planar projection kernel and the
planar decode read: pixel word k of pixel row p at column C lands at
planes[k, p, C] ((pw, h, W) u32 per frame) and column-header word q at
col_hdrs[q, C] ((schw, W) u32), so the device needs no transpose. LEGACY
keeps its 32-bit column status in the column FOOTER, which is staged as one
extra col-header row after the chw header words (schw = chw + 1).

Frame grouping follows the batcher's frame-id semantics
(ref: lidar_scan.cpp:1505-1591), as the SDK's native planar grouper does:
a new frame id closes the frame being built, except that a packet of the
previous id (a straggler of the frame just released) is dropped. Packets
land in their slot by measurement id; slots no packet filled stay zero,
and so decode as invalid columns.

Staging runs in the native host library (utils/native.py, built with
g++ at first use): one pass over the capture (`pcap_scan`), then the
packet-layout grouper or the word-planar grouper with the per-packet scan
headers the device engine materializes LidarScans from. Where no g++ is
found the numpy versions here run instead, with the same contracts and
the same bytes out: `pcap_scan`, `group_frames_planar` and `_group`. They
are also the oracle the native staging is tested against.

PlanarStreamAssembler is the live twin of word-planar staging: packets
pushed one by one, frames released word-planar at each frame-id boundary.

The wire stagings ship fewer bytes to the device than the word planes:
iter_packed_chunks packs each range field's nbits bits a pixel into dense
bitstreams (native library only), iter_bp64_chunks codes them with BP64
(ops/bp64.py; the native encoder, or numpy without g++). ChunkFuser packs
a chunk's arrays into one u32 buffer for a single host->device copy, and
fused_pipelined runs staging and packing on a background thread.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.types import SensorInfo, UDPProfileIMU, UDPProfileLidar
from ..ops.packet_format import PacketFormat, read_bits
from ..ops.unpack import (DecodePlan, frame_words_from_packets,
                          make_decode_plan)
from ..utils import native, profiling
from .pcap import _PCAP_MAGICS, PcapReader


@dataclass
class PlanarBatch:
    """One chunk of word-planar staged frames plus every scan header the
    batcher materializes (ref: lidar_scan.cpp:1324-1372 per-packet
    headers, :1546-1552 frame status): everything the device engine needs
    to build LidarScans bit-equal to ScanBatcher's."""

    frame_ids: np.ndarray   # (m,) i64
    planes: np.ndarray      # (m, pw, h, w) u32
    col_hdrs: np.ndarray    # (m, schw, w) u32
    host_ts: np.ndarray     # (m,) u64, first packet's host timestamp
    pkt_ts: np.ndarray      # (m, n_pkts) u64, host ts by packet slot
    pkt_hdrs: np.ndarray    # (m, n_pkts, hw) u32, packet header words
    first_hdr: np.ndarray   # (m, hw) u32, opening packet's header


def _pipelined(make_iter, depth: int, on_close=None) -> Iterator:
    """Run `make_iter()` on a background staging thread, queueing up to
    `depth` items ahead of the consumer, so staging overlaps the
    consumer's host->device copy and device work (numpy releases the
    interpreter lock inside its copies). Exceptions surface on the
    consumer side; closing the generator joins the producer. `on_close`
    runs in the CONSUMER's finally, after the join: resource check-in
    (pool freelists) must happen there, not in the producer's finally,
    because when the producer exhausts, up to `depth` yielded items whose
    arrays view those pools are still queued unread."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()
    err: List[BaseException] = []

    def produce():
        it = None
        try:
            it = make_iter()
            for item in it:
                with profiling.span("frames.queue_full"):
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            if it is not None:
                # deterministic close so the producer's finally blocks
                # run now, not at garbage collection
                getattr(it, "close", lambda: None)()
            while not stop.is_set():
                try:
                    q.put(done, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def staged(state):
        with state:
            produce()

    def consume():
        # the tracer's state of this thread goes with the staging thread:
        # the profiler's flag does not cross threads
        t = threading.Thread(target=staged, args=(profiling.carry(),),
                             daemon=True, name="frame-staging")
        t.start()
        try:
            while True:
                with profiling.span("frames.queue_wait"):
                    item = q.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            t.join()
            if on_close is not None:
                on_close()
        if err:
            raise err[0]

    return consume()


class ChunkFuser:
    """Pack one staged chunk's arrays into ONE pooled contiguous u32 buffer,
    so that the consumer makes a single host->device copy a chunk (a
    strided pool view, such as the BP64 payload's `pay[:m, :ship]`, is
    copied into place here). The pack is a few host memcpys, run on the
    staging thread by fused_pipelined. Device twin:
    ops.packed.unfuse_words.

    Layouts are (offset_words, shape, dtype) tuples, hashable. Sub-word
    arrays (u8, u16) pad to a word multiple with zeros. The buffers form a
    ring of `pool_depth` (at least 2): a returned buffer stays valid for
    pool_depth - 1 further packs."""

    def __init__(self, pool_depth: int = 4):
        self._pools: List[np.ndarray] = []
        self._depth = max(2, pool_depth)
        self._flip = 0
        self._words = 0

    @staticmethod
    def layout_of(arrays) -> Tuple[Tuple[int, Tuple[int, ...], str], ...]:
        out = []
        off = 0
        for a in arrays:
            nbytes = int(np.prod(a.shape)) * a.dtype.itemsize
            out.append((off, tuple(a.shape), a.dtype.name))
            off += (nbytes + 3) // 4
        return tuple(out)

    def pack(self, arrays) -> Tuple[np.ndarray,
                                    Tuple[Tuple[int, Tuple[int, ...], str],
                                          ...]]:
        with profiling.span("frames.fuse"):
            layout = self.layout_of(arrays)
            total = layout[-1][0] + (
                int(np.prod(layout[-1][1]))
                * np.dtype(layout[-1][2]).itemsize + 3) // 4
            if total > self._words or not self._pools:
                self._words = total
                self._pools = [np.zeros(total, np.uint32)
                               for _ in range(self._depth)]
                self._flip = 0
            buf = self._pools[self._flip]
            self._flip = (self._flip + 1) % len(self._pools)
            for (off, _, _), a in zip(layout, arrays):
                flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                dst = buf[off:off + (flat.size + 3) // 4].view(np.uint8)
                dst[:flat.size] = flat
                if flat.size % 4:
                    dst[flat.size:] = 0
        # what the consumer's one copy ships
        profiling.count("frames.fused_bytes", total * 4)
        return buf[:total], layout


def fused_pipelined(make_iter, select, depth: int = 2) -> Iterator:
    """Pipelined staging with the ChunkFuser on the producer's side:
    `select(item) -> (meta, arrays)`; yields (meta, fused u32, layout).
    Staging and pack run on the staging thread, overlapped with the
    consumer's copy and device work. The ring holds depth + 2 buffers:
    a yielded buffer stays valid until the consumer takes the next item,
    so copy it to the device first."""
    fuser = ChunkFuser(pool_depth=depth + 2)

    def gen():
        for item in make_iter():
            meta, arrays = select(item)
            fused, layout = fuser.pack(arrays)
            yield meta, fused, layout

    return _pipelined(gen, depth)


def pcap_scan(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray, np.ndarray]:
    """One pass over a capture: (payloads u8, offsets i64, sizes i64,
    ts u64, ports u32, dst_ips u32), one entry per reassembled UDP
    datagram of ANY stream, in capture order. `payloads` is the
    concatenation of the UDP payloads, `ports` packs src << 16 | dst,
    `ts` is the capture time in nanoseconds of the record that completed
    the datagram, `dst_ips` the IPv4 destination read little-endian (an
    IPv6 destination folded by xor). The position of a datagram in these
    arrays is the index the device engine stages packets by and orders
    released scans by."""
    bufs: List[bytes] = []
    sizes: List[int] = []
    ts: List[int] = []
    ports: List[int] = []
    ips: List[int] = []
    if os.path.getsize(path) >= 24:
        with PcapReader(path) as reader:
            for pi, payload in reader:
                bufs.append(bytes(payload))
                sizes.append(len(payload))
                ts.append(pi.timestamp)
                ports.append((pi.src_port << 16) | pi.dst_port)
                ips.append(_ip_key(pi.dst_ip))
    sizes_a = np.asarray(sizes, dtype=np.int64)
    offsets = np.zeros(len(bufs), dtype=np.int64)
    if len(bufs) > 1:
        np.cumsum(sizes_a[:-1], out=offsets[1:])
    return (np.frombuffer(b"".join(bufs), dtype=np.uint8), offsets, sizes_a,
            np.asarray(ts, dtype=np.uint64),
            np.asarray(ports, dtype=np.uint32),
            np.asarray(ips, dtype=np.uint32))


def _ip_key(ip: str) -> int:
    if "." in ip:
        return int.from_bytes(bytes(int(x) for x in ip.split(".")), "little")
    raw = bytes.fromhex(ip)
    key = 0
    for k in range(0, len(raw), 4):
        key ^= int.from_bytes(raw[k:k + 4], "little")
    return key


def _gather_packets(payloads: np.ndarray, offs: np.ndarray, size: int
                    ) -> np.ndarray:
    """The datagrams of `size` bytes at `offs` as (n, size // 4) u32 words:
    a view where they lie back to back (a capture of one stream), else a
    copy made by one gather; no per-packet loop either way."""
    if offs.size == 0:
        return np.zeros((0, size // 4), np.uint32)
    first, n = int(offs[0]), offs.size
    if first % 4 == 0 and (np.diff(offs) == size).all():
        return payloads[first:first + n * size].view("<u4").reshape(n, -1)
    rows = np.lib.stride_tricks.sliding_window_view(payloads, size)[offs]
    return rows.view("<u4")


def _last_occurrence(dest: np.ndarray) -> np.ndarray:
    """Indices of the last entry of each distinct value of `dest` (later
    writes win, as the sequential grouper's memcpys do)."""
    _, rev = np.unique(dest[::-1], return_index=True)
    return dest.size - 1 - rev


def _stage(plan: DecodePlan, pk: np.ndarray, word_sel: np.ndarray,
           planes: np.ndarray, hdrs: np.ndarray) -> None:
    """Scatter one frame's packets (n, pkt_words) into its planar slot:
    planes (len(word_sel), h, W) and hdrs (schw, W), zeroed by the
    caller."""
    n, cpp, W = pk.shape[0], plan.cpp, plan.w
    cols = pk[:, plan.hw:plan.hw + cpp * plan.cw].reshape(n, cpp, plan.cw)
    mids = (cols[:, :, plan.mid_word] & 0xFFFF).astype(np.int64)
    ftr = plan.schw - plan.chw
    hdr_words = cols[:, :, :plan.chw]
    if ftr:
        hdr_words = np.concatenate(
            [hdr_words, cols[:, :, plan.cw - ftr:]], axis=2)
    hdr_words = hdr_words.reshape(n * cpp, plan.schw)
    dest = mids.reshape(-1)
    ok = np.nonzero(dest < W)[0]
    sel = ok[_last_occurrence(dest[ok])]
    hdrs[:, dest[sel]] = hdr_words[sel].T

    # pixel columns: an aligned packet fills cpp consecutive columns
    # from its first column's id; any other packet scatters per column
    mid0 = mids[:, :1]
    aligned = (mid0 + cpp <= W) & (mid0 % cpp == 0)
    pdest = np.where(aligned, mid0 + np.arange(cpp), mids).reshape(-1)
    ok = np.nonzero(pdest < W)[0]
    sel = ok[_last_occurrence(pdest[ok])]
    pix = cols[:, :, plan.chw:plan.chw + plan.h * plan.pw].reshape(
        n * cpp, plan.h, plan.pw)
    planes[:, :, pdest[sel]] = np.transpose(
        pix[sel][:, :, word_sel], (2, 1, 0))


def _group(fids: np.ndarray, mask: int, max_frames: Optional[int] = None,
           released: int = -1) -> Tuple[List[np.ndarray], int, int]:
    """Packet indices of each frame of a packet run, by the batcher's id
    semantics: while frame F builds, a packet of id F-1 is a straggler of
    the frame just released and is dropped; any other id closes F and
    opens a new frame. Before the first frame opens, duplicates and
    one-older stragglers of `released` (the frame an earlier, resumed call
    released) are dropped. Stops before opening frame max_frames + 1.
    Returns (frames, packets consumed, released id to carry over)."""
    frames: List[List[int]] = []
    cur = -1
    i = 0
    for i, fid in enumerate(fids.tolist()):
        if fid != cur:
            if cur >= 0 and fid == ((cur - 1) & mask):
                continue  # straggler from the frame just released
            if cur < 0 and released >= 0 and (
                    fid == released or released == ((fid + 1) & mask)):
                continue  # duplicate / straggler right after a close
            if cur >= 0:
                released = cur
            if max_frames is not None and len(frames) >= max_frames:
                break     # resume from packet i in the next call
            frames.append([])
            cur = fid
        frames[-1].append(i)
    else:
        i = fids.size
    return [np.asarray(f, dtype=np.int64) for f in frames], i, released


def group_frames_planar(pk_words: np.ndarray, ts: Optional[np.ndarray],
                        pf: PacketFormat, plan: DecodePlan,
                        out_planes: np.ndarray, out_colhdr: np.ndarray,
                        out_fids: np.ndarray, out_ts: np.ndarray,
                        word_sel: Optional[np.ndarray] = None,
                        out_pkt_ts: Optional[np.ndarray] = None,
                        out_pkt_hdrs: Optional[np.ndarray] = None,
                        out_first_hdr: Optional[np.ndarray] = None,
                        io_released: Optional[np.ndarray] = None
                        ) -> Tuple[int, int]:
    """Word-planar grouping of a run of lidar packets, pk_words
    (n, pkt_words) u32 with host timestamps ts (n,) u64 or None, into
    out_planes (max_frames, pw | len(word_sel), h, w) u32 and out_colhdr
    (max_frames, schw, w) u32 (the LEGACY status footer staged as the
    extra row), with per-frame id (out_fids) and first packet's timestamp
    (out_ts); every output is reused across calls and zeroed here for the
    frames it emits. Grouping and the resume contract are `_group`'s:
    io_released (1,) i64, -1 = none, carries the released frame id across
    resumed calls.

    Optional scan headers: out_pkt_ts (max_frames, n_pkts) u64, host
    timestamp by packet slot; out_pkt_hdrs (max_frames, n_pkts, hw) u32,
    packet header words by packet slot (alert flags, init id and serial
    live there); out_first_hdr (max_frames, hw) u32, the header of the
    packet that OPENED the frame in arrival order (frame status and
    countdowns come from it, ref: lidar_scan.cpp:1546-1552). A packet
    whose slot lies outside the frame stamps neither; of several packets
    of one slot the last wins, a zero timestamp included.

    Returns (packets consumed, frames emitted)."""
    max_frames = out_planes.shape[0]
    sel_words = (np.arange(plan.pw) if word_sel is None
                 else np.asarray(word_sel, dtype=np.int64))
    fids = read_bits(pk_words, pf.geom.frame_id).astype(np.int64)
    released = int(io_released[0]) if io_released is not None else -1
    frames, consumed, released = _group(fids, pf.max_frame_id, max_frames,
                                        released)
    if io_released is not None:
        io_released[0] = released
    for k, idx in enumerate(frames):
        pk = pk_words[idx]
        out_planes[k] = 0
        out_colhdr[k] = 0
        out_fids[k] = fids[idx[0]]
        out_ts[k] = ts[idx[0]] if ts is not None else 0
        _stage(plan, pk, sel_words, out_planes[k], out_colhdr[k])
        if out_first_hdr is not None:
            out_first_hdr[k] = pk[0, :plan.hw]
        if out_pkt_ts is None and out_pkt_hdrs is None:
            continue
        slot = (pk[:, plan.hw + plan.mid_word] & 0xFFFF).astype(
            np.int64) // plan.cpp
        ok = np.nonzero(slot < plan.n_pkts)[0]
        win = ok[_last_occurrence(slot[ok])]
        if out_pkt_ts is not None:
            out_pkt_ts[k] = 0
            if ts is not None:
                out_pkt_ts[k, slot[win]] = ts[idx[win]]
        if out_pkt_hdrs is not None:
            out_pkt_hdrs[k] = 0
            out_pkt_hdrs[k, slot[win]] = pk[win, :plan.hw]
    return consumed, len(frames)


def _frame_id_field(pf: PacketFormat) -> Tuple[int, int, int]:
    """(byte, shift, mask) of the packet header's frame id, as the native
    groupers read it: an 8-byte little-endian load at `byte`."""
    fid = pf.geom.frame_id
    byte, shift = divmod(int(fid.bit_start), 8)
    return byte, shift, (1 << int(fid.bit_size)) - 1


def stage_planar(payloads: np.ndarray, offs: np.ndarray,
                 ts: Optional[np.ndarray], pf: PacketFormat,
                 plan: DecodePlan, out_planes: np.ndarray,
                 out_colhdr: np.ndarray, out_fids: np.ndarray,
                 out_ts: np.ndarray, word_sel: Optional[np.ndarray] = None,
                 out_pkt_ts: Optional[np.ndarray] = None,
                 out_pkt_hdrs: Optional[np.ndarray] = None,
                 out_first_hdr: Optional[np.ndarray] = None,
                 io_released: Optional[np.ndarray] = None
                 ) -> Tuple[int, int]:
    """group_frames_planar over the lidar packets at byte offsets `offs` of
    `payloads` (u8): the native grouper where the library is built, else
    the numpy version on the gathered packets. Same outputs, same return."""
    if native.get_lib() is None:
        return group_frames_planar(
            _gather_packets(payloads, offs, pf.lidar_packet_size), ts, pf,
            plan, out_planes, out_colhdr, out_fids, out_ts, word_sel,
            out_pkt_ts, out_pkt_hdrs, out_first_hdr, io_released)
    fid_byte, fid_shift, fid_mask = _frame_id_field(pf)
    return native.group_frames_planar(
        payloads, offs, ts, pf.lidar_packet_size, fid_byte, fid_shift,
        fid_mask, pf.packet_header_size, pf.col_size, pf.col_header_size,
        plan.mid_word * 4, plan.cpp, plan.h, plan.pw, plan.w, out_planes,
        out_colhdr, out_fids, out_ts, word_sel=word_sel,
        out_pkt_ts=out_pkt_ts, out_pkt_hdrs=out_pkt_hdrs,
        out_first_hdr=out_first_hdr, io_released=io_released,
        ftr_words=plan.schw - plan.chw)


class FrameReader:
    """Stage one sensor's lidar frames from a pcap.

    `strict_ports` applies a configured udp_port_lidar unconditionally,
    the classification rule of packet-by-packet reading that the device
    engine must match; the default keeps the leniency for relocated
    captures: the port filters only when the capture carries it."""

    def __init__(self, pcap_path: str, info: SensorInfo,
                 strict_ports: bool = False):
        self.info = info
        self.pf = PacketFormat.from_info(info)
        self.plan: DecodePlan = make_decode_plan(info)
        self._path = pcap_path
        self._strict_ports = strict_ports
        self.id_error_count = 0
        # the cached capture scan and the freelists of staging pools
        self._pools: dict = {}
        # BP64 ship widths, locked per (fields, nbits) (iter_bp64_chunks)
        self._bp64_ship: dict = {}

    # -- the capture scan ---------------------------------------------------
    def _scan(self):
        """pcap_scan of this reader's capture, cached by file size and
        modification time: replaying the same capture (indexed re-reads,
        a second iteration) skips the whole pass."""
        st = os.stat(self._path)
        key = (st.st_size, st.st_mtime_ns)
        cached = self._pools.get("scan_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        with profiling.span("frames.capture_scan"):
            profiling.count("frames.capture_bytes", st.st_size)
            res = (self._native_scan(st.st_size)
                   if native.get_lib() is not None
                   else pcap_scan(self._path))
        self._pools["scan_cache"] = (key, res)
        return res

    def _native_scan(self, size: int):
        """native.pcap_scan over a map of the file (read once in order; the
        capture's pages stay file-backed), into a workspace this reader
        keeps."""
        if size < 24:
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), np.zeros(0, np.uint64),
                    np.zeros(0, np.uint32), np.zeros(0, np.uint32))
        data = np.memmap(self._path, np.uint8, mode="r")
        # the table maps the magic READ LITTLE-ENDIAN to the file's byte
        # order: a big-endian capture reads as the swapped magic, which is
        # also a key
        magic = struct.unpack("<I", data[:4].tobytes())[0]
        if magic not in _PCAP_MAGICS:
            raise ValueError(f"{self._path}: unknown pcap magic")
        endian, ts_scale = _PCAP_MAGICS[magic]
        linktype = struct.unpack(endian + "I", data[20:24].tobytes())[0] \
            & 0x0FFFFFFF
        ws = self._pools.setdefault("scan_ws", {})
        return native.pcap_scan(data, endian == ">", ts_scale == 1, linktype,
                                workspace=ws)

    def _stream_mask(self, sizes: np.ndarray, ports: np.ndarray,
                     size: int, port: int, strict: bool) -> np.ndarray:
        """Datagrams of one of this sensor's streams: packet size plus the
        metadata's destination port (ports pack src << 16 | dst). `strict`
        applies a configured port unconditionally; non-strict keeps the
        lidar stream's leniency for relocated captures whose metadata port
        never appears."""
        m = sizes == size
        if port:
            pm = (ports & np.uint32(0xFFFF)) == np.uint32(port)
            if strict or (m & pm).any():
                m = m & pm
        return m

    def _lidar_mask(self, sizes: np.ndarray, ports: np.ndarray) -> np.ndarray:
        """Datagrams belonging to THIS sensor's lidar stream: packet size
        plus the metadata's udp_port_lidar (multi-sensor captures share
        packet sizes). Strictness per the constructor's `strict_ports`."""
        return self._stream_mask(sizes, ports, self.pf.lidar_packet_size,
                                 self.info.config.udp_port_lidar or 0,
                                 strict=self._strict_ports)

    def _lidar_datagrams(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(payloads, byte offsets, host ts) of this sensor's lidar
        datagrams, in capture order, from the capture scan."""
        payloads, offsets, sizes, ts, ports, _ = self._scan()
        lidar = self._lidar_mask(sizes, ports)
        return payloads, offsets[lidar], ts[lidar]

    def _lidar_packets(self) -> Tuple[np.ndarray, np.ndarray]:
        """All lidar datagrams of this sensor, in capture order: words
        (n, pkt_words) u32 and host timestamps (n,) u64."""
        payloads, offs, ts = self._lidar_datagrams()
        return _gather_packets(payloads, offs, self.pf.lidar_packet_size), ts

    # -- the device engine's staging ------------------------------------------
    def _aux_streams(self) -> List[Tuple[str, int, int]]:
        """(kind, packet_size, port) for the aux streams this sensor's
        profile carries (hybrid device route)."""
        pf, fmt = self.pf, self.info.format
        wanted = []
        if fmt.udp_profile_imu == UDPProfileIMU.ACCEL32_GYRO32_NMEA and \
                pf.imu_packet_size:
            wanted.append(("imu", pf.imu_packet_size,
                           self.info.config.udp_port_imu or 0))
        if fmt.zone_monitoring_enabled and pf.zone_packet_size:
            wanted.append(("zone", pf.zone_packet_size,
                           self.info.config.udp_port_zm or 0))
        return wanted

    def hybrid_streams(self, soft_id_check: bool = False) -> Tuple[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
            List[Tuple[int, str, int, np.ndarray, int]]]:
        """The capture's packet stream reduced to the two halves of the
        device engine's admission replay (device_engine._AuxRouter), both
        in datagram order:

        - lidar: (idx, fid, packet_slot, host_ts) parallel numpy arrays
          for every lidar datagram that survives the port and id filters,
          from vectorized header gathers;
        - aux: [(idx, kind, fid, payload, host_ts), ...] for every IMU /
          zone datagram (few per frame), classified by its configured
          port, strictly.

        `idx` is the datagram's position in the capture scan, the index
        iter_instance_batches stages packets by. Sets `id_error_count`;
        packets whose init id or serial contradicts the metadata are
        dropped unless `soft_id_check`."""
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.int64), np.zeros(0, np.uint64))
        payloads, offsets, sizes, ts, ports, _ = self._scan()
        pf, plan = self.pf, self.plan

        lidar = self._lidar_mask(sizes, ports)
        lidx = np.nonzero(lidar)[0]
        offs = offsets[lidar]
        if lidx.size:
            idmask = self.id_check_mask(payloads, offs)
            self.id_error_count = int((~idmask).sum())
            if not soft_id_check and self.id_error_count:
                lidx, offs = lidx[idmask], offs[idmask]
        if lidx.size:
            fids = self._vec_header_field(
                payloads, offs, pf.geom.frame_id).astype(np.int64)
            slots = (self._vec_first_mid(payloads, offs).astype(np.int64)
                     // plan.cpp)
            lidar_ev = (lidx, fids, slots, ts[lidx])
        else:
            lidar_ev = empty
        aux_ev: List[Tuple[int, str, int, np.ndarray, int]] = []
        for kind, size, port in self._aux_streams():
            m = self._stream_mask(sizes, ports, size, port, strict=True)
            for idx in np.nonzero(m)[0]:
                buf = payloads[offsets[idx]:offsets[idx] + size].copy()
                aux_ev.append((int(idx), kind, int(pf.frame_id(buf)),
                               buf, int(ts[idx])))
        aux_ev.sort(key=lambda t: t[0])
        return lidar_ev, aux_ev

    def _vec_header_field(self, payloads: np.ndarray, offs: np.ndarray,
                          finfo) -> np.ndarray:
        """Vectorized packet-header bitfield: value of `finfo` for every
        packet at `offs` (u64), from one 8-byte gather a packet."""
        byte, shift = divmod(int(finfo.bit_start), 8)
        idx = offs[:, None] + byte + np.arange(8)
        v = payloads[idx].astype(np.uint64)
        v = (v << (np.arange(8, dtype=np.uint64) * np.uint64(8))).sum(
            axis=1, dtype=np.uint64)
        v >>= np.uint64(shift)
        if finfo.bit_size < 64:
            v &= np.uint64((1 << finfo.bit_size) - 1)
        return v

    def _vec_first_mid(self, payloads: np.ndarray, offs: np.ndarray
                       ) -> np.ndarray:
        """First column's measurement id for every packet at `offs`
        (vectorized 2-byte little-endian gather, u16)."""
        mid_off = self.pf.packet_header_size + self.plan.mid_word * 4
        return (payloads[offs[:, None] + mid_off
                         + np.arange(2)].astype(np.uint16)
                * np.array([1, 256], np.uint16)).sum(axis=1)

    def id_check_mask(self, payloads: np.ndarray, offs: np.ndarray
                      ) -> np.ndarray:
        """Per-packet init_id/serial validation against the metadata, the
        vectorized twin of LidarPacket.validate (ref: packet.h:205):
        False where a nonzero packet id contradicts a nonzero metadata
        id. LEGACY has no ids in the header: all True."""
        ok = np.ones(offs.size, dtype=bool)
        if self.info.format.udp_profile_lidar == UDPProfileLidar.LEGACY:
            return ok
        if self.info.init_id:
            pkt = self._vec_header_field(payloads, offs,
                                         self.pf.geom.init_id)
            ok &= (pkt == 0) | (pkt == np.uint64(self.info.init_id))
        if self.info.sn:
            pkt = self._vec_header_field(payloads, offs,
                                         self.pf.geom.prod_sn)
            ok &= (pkt == 0) | (pkt == np.uint64(self.info.sn))
        return ok

    def _checkout_inst_pools(self, chunk: int, pool_depth: int):
        """Check out (key, pools) for an instance-batch iteration; check
        back in with `self._pools[key].append(pools)` once no yielded
        view can be read anymore."""
        plan = self.plan
        key = ("inst", chunk, pool_depth)
        free = self._pools.setdefault(key, [])
        pools = free.pop() if free else [(
            np.zeros((chunk, plan.pw, plan.h, plan.w), np.uint32),
            np.zeros((chunk, plan.schw, plan.w), np.uint32),
            np.zeros((chunk, plan.n_pkts), np.uint64),
            np.zeros((chunk, plan.n_pkts, plan.hw), np.uint32),
            np.zeros((chunk, plan.hw), np.uint32),
        ) for _ in range(pool_depth)]
        return key, pools

    def iter_instance_batches(self, groups: List[np.ndarray],
                              chunk: int = 4, pool_depth: int = 2,
                              _pools=None) -> Iterator[PlanarBatch]:
        """Stage explicit per-frame packet groups as planar scan batches:
        slot k of each yielded PlanarBatch is the k-th group (a numpy
        array of datagram indices into the capture scan), packed by one
        single-frame grouper call a group. The device engine uses this so
        that its admission replay, which has already decided exactly which
        lidar packets belong to which frame instance, drives the staging;
        re-deriving boundaries from the lidar stream alone cannot see
        aux-induced boundaries or aux-gated completion
        (ref: lidar_scan.cpp:1505-1617).

        Pool buffers are pageable numpy arrays, checked out per iterator
        and returned on close, so concurrent iterations of one reader
        never write into each other's yielded views; a yielded batch's
        arrays stay valid for pool_depth - 1 further iterations of the
        SAME iterator. When `_pools` is passed, the CALLER owns the pools'
        lifetime (the pipelined wrapper checks them back in from the
        consumer side: this generator exhausts while yielded views are
        still queued)."""
        payloads, offsets, _, ts, _, _ = self._scan()
        plan, pf = self.plan, self.pf
        owns = _pools is None
        if owns:
            key, pools = self._checkout_inst_pools(chunk, pool_depth)
        else:
            pools = _pools
        try:
            fid_out = np.zeros(chunk, np.int64)
            ts_out = np.zeros(chunk, np.uint64)
            flip = 0
            for base in range(0, len(groups), chunk):
                sel = groups[base:base + chunk]
                planes, hdrs, pkt_ts, pkt_hdrs, first_hdr = pools[flip]
                flip = (flip + 1) % len(pools)
                with profiling.span("frames.stage_chunk") as sp:
                    for k, grp in enumerate(sel):
                        # slices on axis 0 of C-contiguous pools: contiguous
                        stage_planar(
                            payloads, offsets[grp], ts[grp], pf, plan,
                            planes[k:k + 1], hdrs[k:k + 1], fid_out[k:k + 1],
                            ts_out[k:k + 1], out_pkt_ts=pkt_ts[k:k + 1],
                            out_pkt_hdrs=pkt_hdrs[k:k + 1],
                            out_first_hdr=first_hdr[k:k + 1])
                    sp.key = int(fid_out[0])
                n = len(sel)
                yield PlanarBatch(fid_out[:n].copy(), planes[:n],
                                  hdrs[:n], ts_out[:n].copy(), pkt_ts[:n],
                                  pkt_hdrs[:n], first_hdr[:n])
        finally:
            if owns:
                self._pools[key].append(pools)

    def iter_instance_batches_pipelined(
            self, groups: List[np.ndarray], chunk: int = 4,
            depth: int = 2) -> Iterator[PlanarBatch]:
        """iter_instance_batches staged on a background thread. The pools
        check back in when the CONSUMER closes: the producer exhausts
        while up to `depth` yielded batches still view them."""
        key, pools = self._checkout_inst_pools(chunk, depth + 2)
        return _pipelined(
            lambda: self.iter_instance_batches(groups, chunk,
                                               pool_depth=depth + 2,
                                               _pools=pools),
            depth,
            on_close=lambda: self._pools[key].append(pools))

    # -- packet-layout staging ----------------------------------------------
    def iter_chunks(self, chunk: int = 8) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (frame_ids (m,) i64, frames (m, n_pkts, pkt_words) u32,
        host_ts (m,) u64) for chunks of up to `chunk` packet-layout
        frames; host_ts is the capture time of the packet that opened the
        frame. Every yielded array is the caller's own.

        One native grouper call a chunk where the library is built: it
        resumes where the last call stopped, carrying the released frame
        id across the break."""
        plan = self.plan
        if native.get_lib() is not None:
            yield from self._native_chunks(chunk)
            return
        pk_words, ts = self._lidar_packets()
        if pk_words.shape[0] == 0:
            return
        fids = read_bits(pk_words, self.pf.geom.frame_id).astype(np.int64)
        slots = (pk_words[:, plan.hw + plan.mid_word] & 0xFFFF).astype(
            np.int64) // plan.cpp
        groups = _group(fids, self.pf.max_frame_id)[0]
        for base in range(0, len(groups), chunk):
            sel = groups[base:base + chunk]
            frames = np.zeros((len(sel), plan.n_pkts, plan.pkt_words),
                              np.uint32)
            for k, idx in enumerate(sel):
                idx = idx[slots[idx] < plan.n_pkts]
                idx = idx[_last_occurrence(slots[idx])]
                frames[k, slots[idx]] = pk_words[idx]
            yield (np.asarray([fids[g[0]] for g in sel], dtype=np.int64),
                   frames,
                   np.asarray([ts[g[0]] for g in sel], dtype=np.uint64))

    def _native_chunks(self, chunk: int) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """iter_chunks through native.group_frames."""
        plan, pf = self.plan, self.pf
        payloads, offs, tss = self._lidar_datagrams()
        fid_byte, fid_shift, fid_mask = _frame_id_field(pf)
        fid_out = np.zeros(chunk, np.int64)
        ts_out = np.zeros(chunk, np.uint64)
        released = np.full(1, -1, np.int64)
        pos = 0
        while pos < offs.size:
            frames = np.empty((chunk, plan.n_pkts, plan.pkt_words),
                              np.uint32)
            consumed, nf = native.group_frames(
                payloads, offs[pos:], tss[pos:], pf.lidar_packet_size,
                fid_byte, fid_shift, fid_mask,
                (plan.hw + plan.mid_word) * 4, plan.cpp, plan.n_pkts, frames,
                fid_out, ts_out, io_released=released)
            if nf == 0:
                break
            pos += consumed
            yield fid_out[:nf].copy(), frames[:nf], ts_out[:nf].copy()

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int]]:
        """(frame_id, frame (n_pkts, pkt_words) u32, host_ts) per frame."""
        for fids, frames, tss in self.iter_chunks():
            for k in range(fids.size):
                yield int(fids[k]), frames[k], int(tss[k])

    def read_all(self, max_frames: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Stack all frames (the first max_frames when nonzero) into a
        (B, n_pkts, pkt_words) batch for the batched device calls; returns
        (batch, frame_ids)."""
        frames, fids = [], []
        for fid, words, _ in self:
            frames.append(words)
            fids.append(fid)
            if max_frames and len(frames) >= max_frames:
                break
        if not frames:
            return (np.zeros((0, self.plan.n_pkts, self.plan.pkt_words),
                             np.uint32), np.zeros(0, np.int64))
        return np.stack(frames), np.asarray(fids)

    def stream_from_packets(self, packets) -> Iterator[
            Tuple[int, np.ndarray, int]]:
        """Stage packet-layout frames from any (idx, packet) iterable, e.g.
        a live packet source: packets need `.type().value`, `.buf` (u8
        array) and `.host_timestamp`. A frame is released when the frame
        id changes, and the last one when the iterable ends."""
        current: List[np.ndarray] = []
        current_fid: Optional[int] = None
        first_ts = 0
        pkt_size = self.pf.lidar_packet_size
        for _, p in packets:
            if p.type().value != "Lidar" or p.buf.size != pkt_size:
                continue
            fid = self.pf.frame_id(p.buf)
            if current_fid is None:
                current_fid, first_ts = fid, p.host_timestamp
            if fid != current_fid:
                yield (current_fid,
                       frame_words_from_packets(current, self.plan),
                       first_ts)
                current, current_fid, first_ts = [], fid, p.host_timestamp
            current.append(p.buf)
        if current:
            yield (current_fid,
                   frame_words_from_packets(current, self.plan), first_ts)

    # -- word-planar staging -------------------------------------------------
    def iter_planar_chunks(self, chunk: int = 8,
                           words: Optional[Tuple[int, ...]] = None
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]]:
        """Yield (frame_ids (m,) i64, planes (m, pw | len(words), h, W) u32,
        col_hdrs (m, schw, W) u32, host_ts (m,) u64) for chunks of up to
        `chunk` frames. `words` stages only the listed packet words, in
        the given order (projection needs only the range words). Every
        yielded array is the caller's own.

        One grouper call a chunk (stage_planar: the native one where the
        library is built), resumed where the last call stopped with the
        released frame id carried across the break."""
        if words is not None and len(words) == 0:
            raise ValueError("words must be a non-empty tuple or None")
        plan, pf = self.plan, self.pf
        word_sel = None if words is None else np.asarray(words, np.int64)
        payloads, offs, tss = self._lidar_datagrams()
        n_planes = plan.pw if word_sel is None else word_sel.size
        fid_out = np.zeros(chunk, np.int64)
        ts_out = np.zeros(chunk, np.uint64)
        released = np.full(1, -1, np.int64)
        pos = 0
        while pos < offs.size:
            planes = np.empty((chunk, n_planes, plan.h, plan.w), np.uint32)
            hdrs = np.empty((chunk, plan.schw, plan.w), np.uint32)
            with profiling.span("frames.stage_chunk") as sp:
                consumed, nf = stage_planar(
                    payloads, offs[pos:], tss[pos:], pf, plan, planes, hdrs,
                    fid_out, ts_out, word_sel=word_sel, io_released=released)
                sp.key = int(fid_out[0]) if nf else None
            if nf == 0:
                break
            pos += consumed
            yield (fid_out[:nf].copy(), planes[:nf], hdrs[:nf],
                   ts_out[:nf].copy())


    def iter_planar_chunks_pipelined(
            self, chunk: int = 8, words: Optional[Tuple[int, ...]] = None,
            depth: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]]:
        """iter_planar_chunks staged on a background thread, up to `depth`
        chunks ahead of the consumer (the native grouper releases the
        interpreter lock, so staging overlaps the consumer's copy and
        device work)."""
        return _pipelined(lambda: self.iter_planar_chunks(chunk, words),
                          depth)

    # -- wire stagings --------------------------------------------------------
    def iter_packed_chunks(self, chunk: int = 8,
                           fields: Tuple[Tuple[int, int], ...] = (),
                           nbits: int = 19,
                           pool_depth: int = 2) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Bit-packed staging: yield (frame_ids (m,) i64, packed (m,
        n_fields, h, w * nbits // 32) u32, col_hdrs (m, chw, w) u32,
        host_ts (m,) u64), each selected field's nbits bits a pixel packed
        into a dense LSB-first bitstream a pixel row (native
        group_frames_packed): nbits / 32 of the word-planar bytes. `fields`
        lists (pixel_word, bit_offset) pairs (ops.packed.
        packed_range_fields); decode with ops.packed.project_packed_batched.

        Raises RuntimeError where the staging does not apply, so that the
        caller takes iter_planar_chunks: a profile whose status is not in
        the column header, w % 32 or cpp * nbits % 8 not zero, a field
        crossing a word, no native library, no lidar datagram, or a packet
        whose first measurement id is not a multiple of columns-per-packet.
        The yielded arrays are views of `pool_depth` pooled buffers: valid
        for pool_depth - 1 further iterations."""
        plan = self.plan
        if plan.status_word >= plan.chw:
            raise RuntimeError("packed staging supports eUDP only")
        if not fields:
            raise ValueError(
                "packed staging needs a non-empty `fields` list of "
                "(pixel_word, bit_offset) pairs")
        if plan.w % 32 or (plan.cpp * nbits) % 8:
            raise RuntimeError("packed staging needs w%32==0 and "
                               "cpp*nbits%8==0")
        for _, bit in fields:
            if bit + nbits > 32:
                raise RuntimeError("packed field crosses a word boundary")
        if native.get_lib() is None:
            raise RuntimeError("packed staging needs the native library")
        payloads, offsets, sizes, ts, ports, _ = self._scan()
        lidar = self._lidar_mask(sizes, ports)
        if not lidar.any():
            raise RuntimeError("no lidar datagrams for packed staging")
        offs, tss = offsets[lidar], ts[lidar]
        if (self._vec_first_mid(payloads, offs) % plan.cpp).any():
            raise RuntimeError("capture has non-aligned packets")

        fid_byte, fid_shift, fid_mask = _frame_id_field(self.pf)
        wp = plan.w * nbits // 32
        key = ("packed", chunk, fields, nbits, pool_depth)
        if key not in self._pools:
            self._pools[key] = [
                (np.zeros((chunk, len(fields), plan.h, wp), np.uint32),
                 np.zeros((chunk, plan.chw, plan.w), np.uint32))
                for _ in range(pool_depth)]
        pools = self._pools[key]
        fw = np.asarray([f[0] for f in fields], np.int64)
        fb = np.asarray([f[1] for f in fields], np.int64)
        fid_out = np.zeros(chunk, np.int64)
        ts_out = np.zeros(chunk, np.uint64)
        released = np.full(1, -1, np.int64)
        pos, flip = 0, 0
        while pos < offs.size:
            planes, hdrs = pools[flip]
            flip = (flip + 1) % len(pools)
            consumed, nf = native.group_frames_packed(
                payloads, offs[pos:], tss[pos:],
                self.pf.lidar_packet_size, fid_byte, fid_shift, fid_mask,
                self.pf.packet_header_size, self.pf.col_size,
                self.pf.col_header_size, plan.mid_word * 4, plan.cpp,
                plan.h, plan.pw, plan.w, fw, fb, nbits, planes, hdrs,
                fid_out, ts_out, io_released=released)
            if nf == 0:
                break
            pos += consumed
            yield (fid_out[:nf].copy(), planes[:nf], hdrs[:nf],
                   ts_out[:nf].copy())

    def iter_bp64_chunks(self, chunk: int = 8,
                         fields: Tuple[Tuple[int, int], ...] = (),
                         nbits: int = 19,
                         pool_depth: int = 2) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                  np.ndarray, np.ndarray]]:
        """Compressed staging: yield (frame_ids (m,) i64, payload (m, P)
        u32, widths (m, n_fields, h, w // 64) u8, anchors (m, n_fields, h,
        w // 64) u32, col_hdrs (m, chw, w) u32, host_ts (m,) u64), each
        selected field BP64-coded (ops/bp64.py) by the native encoder, or
        by bp64_encode_numpy where the library is not built. Decode with
        ops.bp64.project_bp64_batched.

        P, the shipped payload width, is the first chunk's need plus a
        quarter, rounded up to 1024 words, and grows only when a later
        chunk needs more; it is kept per (fields, nbits) across
        iterations of this reader, so that shapes stay stable between
        replay passes. Each frame's payload is followed by two zero slack
        words; the words past them are never read by the decode. The
        yielded arrays are views of `pool_depth` pooled buffers."""
        plan = self.plan
        if plan.w % 64:
            raise RuntimeError("bp64 staging needs w % 64 == 0")
        if not 1 <= nbits <= 30:
            # 5-bit block widths: zigzag deltas need up to nbits+1 bits
            raise ValueError("bp64 staging supports 1 <= nbits <= 30")
        if not fields:
            raise ValueError(
                "bp64 staging needs a non-empty `fields` list of "
                "(pixel_word, bit_offset) pairs")
        words = tuple(f[0] for f in fields)
        bits = np.asarray([f[1] for f in fields], np.int64)
        F = len(fields)
        nb = plan.w // 64
        # capacity: the worst case (white noise), so the encoder can never
        # run out; the shipped slice is the coded size
        cap = F * plan.h * nb * (2 * (nbits + 1) + 2) + 2
        key = ("bp64", chunk, fields, nbits, pool_depth)
        if key not in self._pools:
            self._pools[key] = [
                (np.zeros((chunk, cap), np.uint32),
                 np.zeros((chunk, F, plan.h, nb), np.uint8),
                 np.zeros((chunk, F, plan.h, nb), np.uint32))
                for _ in range(pool_depth)]
        pools = self._pools[key]
        vmask = np.uint32((1 << nbits) - 1)
        ship_key = (fields, nbits)
        ship: int = self._bp64_ship.get(ship_key, 0)
        flip = 0
        for fids, planes, hdrs, ts in self.iter_planar_chunks(
                chunk, words=words):
            pay, wid, anc = pools[flip]
            flip = (flip + 1) % len(pools)
            m = fids.size
            max_used = 0
            for i in range(m):
                with profiling.span("frames.bp64_encode", int(fids[i])):
                    used = native.bp64_encode(
                        np.ascontiguousarray(planes[i]), bits, nbits,
                        pay[i], wid[i].reshape(-1), anc[i].reshape(-1))
                    if used == -2:      # no native library: numpy encoder
                        from ..ops.bp64 import bp64_encode_numpy

                        vals = (planes[i] >> bits[:, None, None].astype(
                            np.uint32)) & vmask
                        p, w_, a_ = bp64_encode_numpy(vals, nbits)
                        used = p.size
                        pay[i, :used] = p
                        wid[i] = w_
                        anc[i] = a_
                    elif used < 0:
                        raise RuntimeError("bp64 encoder overflow (capacity "
                                           "is sized for the worst case)")
                pay[i, used:used + 2] = 0     # the decode's slack words
                max_used = max(max_used, used)
            if max_used + 2 > ship:           # grow only: stable shapes
                want = (max_used + 2) * 5 // 4
                ship = min((want + 1023) // 1024 * 1024, cap)
                self._bp64_ship[ship_key] = ship
            yield (fids, pay[:m, :ship], wid[:m], anc[:m], hdrs[:m], ts)

    def iter_packed_chunks_pipelined(
            self, chunk: int = 8, fields: Tuple[Tuple[int, int], ...] = (),
            nbits: int = 19, depth: int = 2) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """iter_packed_chunks staged on a background thread (pool ring of
        depth + 2, so a yielded view outlives the chunks queued behind
        it)."""
        return _pipelined(
            lambda: self.iter_packed_chunks(chunk, fields, nbits,
                                            pool_depth=depth + 2),
            depth)

    def iter_bp64_chunks_pipelined(
            self, chunk: int = 8, fields: Tuple[Tuple[int, int], ...] = (),
            nbits: int = 19, depth: int = 2) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                  np.ndarray, np.ndarray]]:
        """iter_bp64_chunks staged on a background thread (the native
        encoder releases the interpreter lock, so the coding overlaps the
        consumer's copy and device work)."""
        return _pipelined(
            lambda: self.iter_bp64_chunks(chunk, fields, nbits,
                                          pool_depth=depth + 2),
            depth)


class PlanarStreamAssembler:
    """Live planar ingest: packets fed one by one as they arrive (e.g.
    from a sensor.SensorPacketSource) come out as word-planar frames, the
    input of ScanPipeline.decode_planar / project_planar and of the planar
    projection kernel: the streaming twin of iter_planar_chunks. A frame
    is released when a packet of another frame id arrives (the batcher's
    frame-id boundary; flush() releases the last one), staged by one
    grouper call (stage_planar: the native one where the library is
    built). Buffers are pooled: a released frame's planes and headers stay
    valid until the next-but-one release.
    """

    def __init__(self, info: SensorInfo):
        self.info = info
        self.pf = PacketFormat.from_info(info)
        self.plan = make_decode_plan(info)
        p = self.plan
        self._pools = [(np.zeros((1, p.pw, p.h, p.w), np.uint32),
                        np.zeros((1, p.schw, p.w), np.uint32))
                       for _ in range(2)]
        self._flip = 0
        self._cur_fid: Optional[int] = None
        self._bufs: List[bytes] = []
        self._ts = 0

    def _flush(self) -> Tuple[int, np.ndarray, np.ndarray, int]:
        size = self.pf.lidar_packet_size
        payloads = np.frombuffer(b"".join(self._bufs), np.uint8)
        offsets = np.arange(len(self._bufs), dtype=np.int64) * size
        planes, hdrs = self._pools[self._flip]
        self._flip ^= 1
        fid_out = np.zeros(1, np.int64)
        ts_out = np.zeros(1, np.uint64)
        stage_planar(payloads, offsets, None, self.pf, self.plan, planes,
                     hdrs, fid_out, ts_out)
        self._bufs = []
        return int(fid_out[0]), planes[0], hdrs[0], self._ts

    def push(self, packet) -> Optional[Tuple[int, np.ndarray, np.ndarray,
                                             int]]:
        """Feed one lidar packet (a LidarPacket, or its bytes); returns
        (frame_id, planes (pw, h, w) u32, col_hdrs (schw, w) u32, host_ts
        of the frame's first packet) when a frame releases, else None."""
        buf = packet.buf if hasattr(packet, "buf") else packet
        if len(buf) != self.pf.lidar_packet_size:
            return None
        fid = self.pf.frame_id(np.frombuffer(bytes(buf), np.uint8))
        out = None
        if self._cur_fid is not None and fid != self._cur_fid and \
                self._bufs:
            out = self._flush()
        if self._cur_fid != fid:
            self._cur_fid = fid
            self._ts = getattr(packet, "host_timestamp", 0)
        self._bufs.append(bytes(buf))
        return out

    def flush(self) -> Optional[Tuple[int, np.ndarray, np.ndarray, int]]:
        """Release the partial frame currently buffered."""
        if not self._bufs:
            return None
        return self._flush()
