"""FrameReader: pcap -> staged frames, in numpy, in two layouts.

Packet-layout staging (iter_chunks, read_all, iteration,
stream_from_packets) keeps whole lidar packets: a frame is
(n_pkts, pkt_words) u32 with each packet at the slot of its first column's
measurement id (m_id // columns-per-packet), gaps zero-filled, the last
packet of a slot winning. It is what ScanPipeline.__call__/batch and the
packet projection take.

Word-planar staging is the layout the planar projection kernel reads:
pixel word k of pixel row p at column C lands at planes[k, p, C]
((pw, h, W) u32 per frame) and column-header word q at col_hdrs[q, C]
((schw, W) u32), so the device needs no transpose. LEGACY keeps its 32-bit
column status in the column FOOTER, which is staged as one extra
col-header row after the chw header words (schw = chw + 1).

Frame grouping follows the batcher's frame-id semantics
(ref: lidar_scan.cpp:1505-1591), as the SDK's native planar grouper does:
a new frame id closes the frame being built, except that a packet of the
previous id (a straggler of the frame just released) is dropped. Packets
land in their slot by measurement id; slots no packet filled stay zero,
and so decode as invalid columns.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.types import SensorInfo
from ..ops.packet_format import PacketFormat, read_bits
from ..ops.unpack import (DecodePlan, frame_words_from_packets,
                          make_decode_plan)
from .pcap import PcapReader


def _last_occurrence(dest: np.ndarray) -> np.ndarray:
    """Indices of the last entry of each distinct value of `dest` (later
    writes win, as the sequential grouper's memcpys do)."""
    _, rev = np.unique(dest[::-1], return_index=True)
    return dest.size - 1 - rev


class FrameReader:
    """Stage one sensor's lidar frames from a pcap, word-planar."""

    def __init__(self, pcap_path: str, info: SensorInfo):
        self.info = info
        self.pf = PacketFormat(info)
        self.plan: DecodePlan = make_decode_plan(info)
        self._path = pcap_path

    def _lidar_packets(self) -> Tuple[np.ndarray, np.ndarray]:
        """All lidar datagrams of this sensor, in capture order: words
        (n, pkt_words) u32 and host timestamps (n,) u64. A datagram is
        lidar by its size; a configured udp_port_lidar filters only when
        the capture carries that port (relocated captures keep working)."""
        size = self.pf.lidar_packet_size
        port = self.info.config.udp_port_lidar or 0
        bufs: List[bytes] = []
        ts: List[int] = []
        ports: List[int] = []
        with PcapReader(self._path) as reader:
            for pi, payload in reader:
                if len(payload) == size:
                    bufs.append(bytes(payload))
                    ts.append(pi.timestamp)
                    ports.append(pi.dst_port)
        keep = np.ones(len(bufs), dtype=bool)
        if port:
            match = np.asarray(ports, dtype=np.int64) == port
            if match.any():
                keep = match
        words = np.frombuffer(b"".join(bufs), dtype="<u4").reshape(
            len(bufs), size // 4)
        return words[keep], np.asarray(ts, dtype=np.uint64)[keep]

    def _group(self, fids: np.ndarray) -> List[np.ndarray]:
        """Packet indices of each frame, by the batcher's id semantics."""
        mask = (1 << self.pf.geom.frame_id.bit_size) - 1
        frames: List[List[int]] = []
        cur = -1
        for i, fid in enumerate(fids.tolist()):
            if fid != cur:
                if cur >= 0 and fid == ((cur - 1) & mask):
                    continue  # straggler from the frame just released
                frames.append([])
                cur = fid
            frames[-1].append(i)
        return [np.asarray(f, dtype=np.int64) for f in frames]

    def _stage(self, pk: np.ndarray, word_sel: np.ndarray,
               planes: np.ndarray, hdrs: np.ndarray) -> None:
        """Scatter one frame's packets (n, pkt_words) into its planar slot."""
        plan = self.plan
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

    def iter_chunks(self, chunk: int = 8) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (frame_ids (m,) i64, frames (m, n_pkts, pkt_words) u32,
        host_ts (m,) u64) for chunks of up to `chunk` packet-layout
        frames; host_ts is the capture time of the packet that opened the
        frame."""
        plan = self.plan
        pk_words, ts = self._lidar_packets()
        if pk_words.shape[0] == 0:
            return
        fids = read_bits(pk_words, self.pf.geom.frame_id).astype(np.int64)
        slots = (pk_words[:, plan.hw + plan.mid_word] & 0xFFFF).astype(
            np.int64) // plan.cpp
        groups = self._group(fids)
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

    def iter_planar_chunks(self, chunk: int = 8,
                           words: Optional[Tuple[int, ...]] = None
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]]:
        """Yield (frame_ids (m,) i64, planes (m, pw | len(words), h, W) u32,
        col_hdrs (m, schw, W) u32, host_ts (m,) u64) for chunks of up to
        `chunk` frames. `words` stages only the listed packet words, in
        the given order (projection needs only the range words)."""
        if words is not None and len(words) == 0:
            raise ValueError("words must be a non-empty tuple or None")
        plan = self.plan
        word_sel = np.arange(plan.pw) if words is None else \
            np.asarray(words, dtype=np.int64)
        pk_words, ts = self._lidar_packets()
        if pk_words.shape[0] == 0:
            return
        fids = read_bits(pk_words, self.pf.geom.frame_id).astype(np.int64)
        groups = self._group(fids)
        for base in range(0, len(groups), chunk):
            sel = groups[base:base + chunk]
            m = len(sel)
            planes = np.zeros((m, word_sel.size, plan.h, plan.w), np.uint32)
            hdrs = np.zeros((m, plan.schw, plan.w), np.uint32)
            for k, idx in enumerate(sel):
                self._stage(pk_words[idx], word_sel, planes[k], hdrs[k])
            yield (np.asarray([fids[g[0]] for g in sel], dtype=np.int64),
                   planes, hdrs,
                   np.asarray([ts[g[0]] for g in sel], dtype=np.uint64))
