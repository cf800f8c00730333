"""Pcap files: classic libpcap reading with IPv4 fragment reassembly, and
a writer.

Ouster lidar packets (up to ~33 kB) exceed the MTU, so captures carry them
as IPv4 fragments and reassembly is mandatory (ref: ouster_pcap/src/
pcap.cpp, ouster_pcap/include/ouster/ip_reassembler.h:76-100).

Supported link types: Ethernet (1, incl. 802.1Q VLAN), raw IPv4/6 (101,
228), Linux SLL (113), SLL2 (276), null/loopback (0).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class PacketInfo:
    """Metadata of one (reassembled) UDP datagram
    (ref: ouster_pcap/include/ouster/pcap.h:37-62)."""

    src_ip: str
    dst_ip: str
    src_port: int
    dst_port: int
    timestamp: int  # nanoseconds
    payload_size: int
    fragments_count: int = 1
    file_offset: int = -1  # offset of the *first* record of the datagram


class _Fragments:
    """Accumulates IPv4 fragments of one datagram.

    Completion is decided from merged covered-byte ranges, not a byte
    counter, so duplicated/overlapping (retransmitted) fragments cannot
    mask a hole (the reference ip_reassembler tracks holes explicitly,
    ref: ip_reassembler.h:76-100).
    """

    __slots__ = ("chunks", "total_len", "ranges", "first_info")

    def __init__(self) -> None:
        self.chunks: List[Tuple[int, bytes]] = []
        self.total_len = -1
        self.ranges: List[Tuple[int, int]] = []  # merged, sorted [start,end)
        self.first_info: Optional[PacketInfo] = None

    def _cover(self, start: int, end: int) -> None:
        merged = []
        for s, e in self.ranges:
            if e < start or end < s:
                merged.append((s, e))
            else:
                start, end = min(start, s), max(end, e)
        merged.append((start, end))
        self.ranges = sorted(merged)

    def add(self, offset: int, data: bytes, more: bool) -> Optional[bytes]:
        self.chunks.append((offset, data))
        self._cover(offset, offset + len(data))
        if not more:
            self.total_len = offset + len(data)
        if self.total_len >= 0 and len(self.ranges) == 1 and \
                self.ranges[0][0] == 0 and \
                self.ranges[0][1] >= self.total_len:
            buf = bytearray(self.total_len)
            for off, chunk in self.chunks:
                buf[off:off + len(chunk)] = chunk
            return bytes(buf)
        return None


class IpReassembler:
    """IPv4 fragment reassembly keyed on (src, dst, id, proto)
    (ref: ip_reassembler.h:76-100). Incomplete groups EXPIRE after a
    bounded number of subsequent fragments: without expiry a lossy
    capture leaks one group per lost fragment, and because the 16-bit
    IP ID recycles within ~a minute at line rate, a stale group would
    merge into an unrelated later datagram and corrupt it."""

    _MAX_PENDING = 1024
    _TTL_RECORDS = 4096

    def __init__(self) -> None:
        self._pending: Dict[Tuple, _Fragments] = {}
        self._last_seen: Dict[Tuple, int] = {}
        self._rec = 0

    def process(self, src: str, dst: str, ip_id: int, proto: int,
                frag_offset: int, more_fragments: bool,
                payload: bytes) -> Optional[bytes]:
        self._rec += 1
        if frag_offset == 0 and not more_fragments:
            return payload  # unfragmented fast path
        key = (src, dst, ip_id, proto)
        if len(self._pending) > self._MAX_PENDING:
            cut = self._rec - self._TTL_RECORDS
            for k in [k for k, seen in self._last_seen.items()
                      if seen < cut]:
                self._pending.pop(k, None)
                self._last_seen.pop(k, None)
        frags = self._pending.get(key)
        if frags is None:
            frags = self._pending[key] = _Fragments()
        self._last_seen[key] = self._rec
        done = frags.add(frag_offset, payload, more_fragments)
        if done is not None:
            del self._pending[key]
            self._last_seen.pop(key, None)
        return done


_PCAP_MAGICS = {
    0xA1B2C3D4: ("<", 1_000),      # little endian, microseconds
    0xD4C3B2A1: (">", 1_000),      # big endian, microseconds
    0xA1B23C4D: ("<", 1),          # little endian, nanoseconds
    0x4D3CB2A1: (">", 1),          # big endian, nanoseconds
}

LINKTYPE_NULL = 0
LINKTYPE_ETHERNET = 1
LINKTYPE_RAW = 101
LINKTYPE_LINUX_SLL = 113
LINKTYPE_IPV4 = 228
LINKTYPE_LINUX_SLL2 = 276


def _ip4_str(b: bytes) -> str:
    return ".".join(str(x) for x in b)


class PcapReader:
    """Iterates UDP datagrams (reassembled) from a pcap file
    (ref: ouster_pcap/include/ouster/pcap.h:62)."""

    def __init__(self, path: str):
        import mmap

        self._path = path
        self._f = open(path, "rb")
        try:
            # O(1) resident memory for multi-GB captures; bytes are
            # paged in on demand
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._data = memoryview(self._mm)
        except (ValueError, OSError):  # empty file / no-mmap fs
            self._mm = None
            self._data = self._f.read()
        if len(self._data) < 24:
            raise ValueError(f"{path}: not a pcap file")
        self._closed = False
        magic = struct.unpack("<I", self._data[:4])[0]
        if magic not in _PCAP_MAGICS:
            magic = struct.unpack(">I", self._data[:4])[0]
        if magic not in _PCAP_MAGICS:
            raise ValueError(f"{path}: unknown pcap magic")
        self._endian, self._ts_scale = _PCAP_MAGICS[magic]
        hdr = struct.unpack(self._endian + "IHHiIII", self._data[:24])
        self._linktype = hdr[6] & 0x0FFFFFFF
        self._pos = 24
        self._reasm = IpReassembler()

    def close(self) -> None:
        """Release the mmap/file handle (views into packets become
        invalid)."""
        self._data = b""
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "PcapReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def reset(self) -> None:
        self._pos = 24
        self._reasm = IpReassembler()

    @property
    def path(self) -> str:
        return self._path

    def seek(self, file_offset: int) -> None:
        self._pos = file_offset
        self._reasm = IpReassembler()

    def __iter__(self) -> Iterator[Tuple[PacketInfo, bytes]]:
        return self

    def __next__(self) -> Tuple[PacketInfo, bytes]:
        res = self.next_packet()
        if res is None:
            raise StopIteration
        return res

    def next_packet(self) -> Optional[Tuple[PacketInfo, bytes]]:
        data = self._data
        e = self._endian
        while self._pos + 16 <= len(data):
            rec_off = self._pos
            ts_sec, ts_frac, incl, _orig = struct.unpack(
                e + "IIII", data[rec_off:rec_off + 16])
            start = rec_off + 16
            self._pos = start + incl
            if start + incl > len(data):
                return None  # truncated capture
            ts_ns = ts_sec * 1_000_000_000 + ts_frac * self._ts_scale
            frame = data[start:start + incl]
            res = self._parse_frame(frame, ts_ns, rec_off)
            if res is not None:
                return res
        return None

    # -- frame parsing ----------------------------------------------------
    def _parse_frame(self, frame: bytes, ts_ns: int,
                     file_offset: int) -> Optional[Tuple[PacketInfo, bytes]]:
        lt = self._linktype
        if lt == LINKTYPE_ETHERNET:
            if len(frame) < 14:
                return None
            ethertype = struct.unpack(">H", frame[12:14])[0]
            off = 14
            while ethertype in (0x8100, 0x88A8):  # VLAN tags
                if len(frame) < off + 4:
                    return None
                ethertype = struct.unpack(">H", frame[off + 2:off + 4])[0]
                off += 4
            if ethertype == 0x0800:
                return self._parse_ip4(frame[off:], ts_ns, file_offset)
            if ethertype == 0x86DD:
                return self._parse_ip6(frame[off:], ts_ns, file_offset)
            return None
        if lt in (LINKTYPE_RAW, LINKTYPE_IPV4):
            return self._parse_ip4(frame, ts_ns, file_offset)
        if lt == LINKTYPE_LINUX_SLL:
            if len(frame) < 16:
                return None
            proto = struct.unpack(">H", frame[14:16])[0]
            if proto == 0x0800:
                return self._parse_ip4(frame[16:], ts_ns, file_offset)
            if proto == 0x86DD:
                return self._parse_ip6(frame[16:], ts_ns, file_offset)
            return None
        if lt == LINKTYPE_LINUX_SLL2:
            if len(frame) < 20:
                return None
            proto = struct.unpack(">H", frame[0:2])[0]
            if proto == 0x0800:
                return self._parse_ip4(frame[20:], ts_ns, file_offset)
            return None
        if lt == LINKTYPE_NULL:
            if len(frame) < 4:
                return None
            # the null-linktype AF family is written in the CAPTURING
            # host's byte order — use the file's detected endianness
            family = struct.unpack(self._endian + "I", frame[:4])[0]
            if family in (2,):  # AF_INET
                return self._parse_ip4(frame[4:], ts_ns, file_offset)
            return None
        return None

    def _parse_ip4(self, pkt: bytes, ts_ns: int,
                   file_offset: int) -> Optional[Tuple[PacketInfo, bytes]]:
        if len(pkt) < 20:
            return None
        ver_ihl = pkt[0]
        if ver_ihl >> 4 != 4:
            return None
        ihl = (ver_ihl & 0x0F) * 4
        total_len = struct.unpack(">H", pkt[2:4])[0]
        ip_id = struct.unpack(">H", pkt[4:6])[0]
        flags_frag = struct.unpack(">H", pkt[6:8])[0]
        more = bool(flags_frag & 0x2000)
        frag_offset = (flags_frag & 0x1FFF) * 8
        proto = pkt[9]
        src = _ip4_str(pkt[12:16])
        dst = _ip4_str(pkt[16:20])
        if proto != 17:  # UDP only
            return None
        payload = pkt[ihl:total_len] if total_len >= ihl else pkt[ihl:]

        datagram = self._reasm.process(src, dst, ip_id, proto, frag_offset,
                                       more, payload)
        if datagram is None or len(datagram) < 8:
            return None
        src_port, dst_port, udp_len, _ck = struct.unpack(
            ">HHHH", datagram[:8])
        udp_payload = datagram[8:8 + max(udp_len - 8, 0)] \
            if udp_len >= 8 else datagram[8:]
        info = PacketInfo(
            src_ip=src, dst_ip=dst, src_port=src_port, dst_port=dst_port,
            timestamp=ts_ns, payload_size=len(udp_payload),
            file_offset=file_offset)
        return info, udp_payload

    def _parse_ip6(self, pkt: bytes, ts_ns: int,
                   file_offset: int) -> Optional[Tuple[PacketInfo, bytes]]:
        if len(pkt) < 40:
            return None
        next_hdr = pkt[6]
        payload_len = struct.unpack(">H", pkt[4:6])[0]
        src = pkt[8:24].hex()
        dst = pkt[24:40].hex()
        if next_hdr != 17:
            return None  # extension headers unsupported for now
        datagram = pkt[40:40 + payload_len]
        if len(datagram) < 8:
            return None
        src_port, dst_port, udp_len, _ck = struct.unpack(
            ">HHHH", datagram[:8])
        udp_payload = datagram[8:8 + max(udp_len - 8, 0)]
        info = PacketInfo(
            src_ip=src, dst_ip=dst, src_port=src_port, dst_port=dst_port,
            timestamp=ts_ns, payload_size=len(udp_payload),
            file_offset=file_offset)
        return info, udp_payload


@dataclass
class StreamKey:
    src_ip: str
    dst_ip: str
    src_port: int
    dst_port: int

    def __hash__(self) -> int:
        return hash((self.src_ip, self.dst_ip, self.src_port, self.dst_port))


@dataclass
class StreamStats:
    """Per-(flow, payload-size) packet counts for guessing which streams are
    lidar/imu (ref: ouster_pcap/include/ouster/os_pcap.h:89-178)."""

    count: int = 0
    sizes: Dict[int, int] = None  # payload size -> count

    def __post_init__(self):
        if self.sizes is None:
            self.sizes = {}


def stream_info(path: str, max_packets: int = 0) -> Dict[Tuple, StreamStats]:
    """Scan a pcap and collect per-flow payload-size histograms, keyed by
    (dst_ip, dst_port)."""
    out: Dict[Tuple, StreamStats] = {}
    n = 0
    with PcapReader(path) as reader:
        for info, payload in reader:
            st = out.setdefault((info.dst_ip, info.dst_port), StreamStats())
            st.count += 1
            st.sizes[len(payload)] = st.sizes.get(len(payload), 0) + 1
            n += 1
            if max_packets and n >= max_packets:
                break
    return out


#: Reference binding alias (ref: pcap.pyi get_stream_info).
get_stream_info = stream_info


def guess_ports(stream_stats, lidar_packet_size: int,
                imu_packet_size: int, lidar_spec: int = 0,
                imu_spec: int = 0):
    """Candidate (lidar_port, imu_port) pairs from per-flow payload
    sizes (ref: pcap.pyi guess_ports / sdk/pcap/pcap.py _guess_ports):
    a port qualifies when its dominant payload size matches the
    expected packet size; explicit spec ports filter the candidates."""
    lidar_ports = set()
    imu_ports = set()
    for (dst_ip, dst_port), st in stream_stats.items():
        if not st.sizes:
            continue
        dominant = max(st.sizes, key=st.sizes.get)
        if dominant == lidar_packet_size and \
                (not lidar_spec or dst_port == lidar_spec):
            lidar_ports.add(dst_port)
        if dominant == imu_packet_size and \
                (not imu_spec or dst_port == imu_spec):
            imu_ports.add(dst_port)
    guesses = [(lp, ip) for lp in (lidar_ports or {0})
               for ip in (imu_ports or {0}) if lp != ip or lp == 0]
    guesses.sort(reverse=True, key=lambda p: (p[0] != 0, p[1] != 0, p))
    return guesses


class PcapDuplicatePortException(RuntimeError):
    """Multiple sensors with the same UDP port in one capture and no
    way to disambiguate (ref: indexed_pcap_reader.h:147)."""


class PcapWriter:
    """Record UDP packets to a classic pcap file (Ethernet frames, with IPv4
    fragmentation for payloads over MTU)
    (ref: ouster_pcap/src/os_pcap.cpp record functions)."""

    def __init__(self, path: str, mtu: int = 1500):
        self._f = open(path, "wb")
        self._mtu = mtu
        self._ip_id = 0
        # magic, vmaj, vmin, thiszone, sigfigs, snaplen, linktype
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  0x40000, LINKTYPE_ETHERNET))

    def write(self, payload: bytes, src_ip: str, dst_ip: str,
              src_port: int, dst_port: int, timestamp_ns: int) -> None:
        udp = struct.pack(">HHHH", src_port, dst_port, 8 + len(payload),
                          0) + payload
        self._ip_id = (self._ip_id + 1) & 0xFFFF
        max_frag = (self._mtu - 20) & ~7
        frags = []
        off = 0
        while off < len(udp) or not frags:
            chunk = udp[off:off + max_frag]
            more = off + len(chunk) < len(udp)
            frags.append((off, chunk, more))
            off += len(chunk)

        src_b = bytes(int(x) for x in src_ip.split("."))
        dst_b = bytes(int(x) for x in dst_ip.split("."))
        for off, chunk, more in frags:
            flags_frag = (0x2000 if more else 0) | (off // 8)
            ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(chunk),
                             self._ip_id, flags_frag, 64, 17, 0,
                             src_b, dst_b)
            eth = b"\x00" * 12 + struct.pack(">H", 0x0800)
            frame = eth + ip + chunk
            ts_sec, ts_rem = divmod(timestamp_ns, 1_000_000_000)
            self._f.write(struct.pack("<IIII", ts_sec, ts_rem // 1000,
                                      len(frame), len(frame)))
            self._f.write(frame)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PcapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def record(packets, pcap_path: str, *,
           src_ip: str = "127.0.0.1", dst_ip: str = "127.0.0.1",
           lidar_port: int = 7502, imu_port: int = 7503) -> int:
    """Record a finite sequence of lidar and IMU packets to a pcap file
    (ref: sdk/pcap/pcap.py:77-133 record). A packet without a host
    timestamp is stamped with the time of writing. Returns the packet
    count; a file left with no packet by an error is removed."""
    import time

    from ..core.packets import ImuPacket, LidarPacket

    has_timestamp = None
    n = 0
    error = False
    writer = PcapWriter(pcap_path)
    try:
        for packet in packets:
            if isinstance(packet, LidarPacket):
                port = lidar_port
            elif isinstance(packet, ImuPacket):
                port = imu_port
            else:
                raise ValueError("Unexpected packet type")
            if has_timestamp is None:
                has_timestamp = packet.host_timestamp != 0
            elif has_timestamp != (packet.host_timestamp != 0):
                raise ValueError(
                    "Mixing timestamped/untimestamped packets")
            ts = packet.host_timestamp or int(time.time() * 1e9)
            writer.write(bytes(packet.buf), src_ip, dst_ip, port, port, ts)
            n += 1
    except Exception:
        error = True
        raise
    finally:
        writer.close()
        if error and n == 0 and os.path.exists(pcap_path):
            os.remove(pcap_path)
    return n
