"""PcapPacketSource: pcap file -> typed, sensor-attributed packets.

Rebuild of the reference pcap backend (ref: ouster_pcap/src/
pcap_packet_source.cpp, indexed_pcap_reader.h:28-101). Packets are matched to
sensors by destination port (when configured) and payload size, with eUDP
init_id/serial disambiguation for same-port captures
(ref: indexed_pcap_reader.cpp check_sensor_idx_for_packet).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.error_handler import Severity, logging_error_handler
from ..core.metadata import sensor_info_from_metadata
from ..core.packets import (ImuPacket, LidarPacket, Packet,
                            PacketValidationFailure, ZonePacket)
from ..core.types import SensorInfo, UDPProfileIMU, UDPProfileLidar
from ..ops.packet_format import PacketFormat
from .pcap import PcapDuplicatePortException, PcapReader, PcapWriter


def ichunked_before(it, pred):
    """Chunk a stream lazily, starting a new chunk BEFORE each item where
    pred is true (ref: sdk/pcap/packet_iter.py:16-56 ichunked_before):
    chunks are iterators, not lists — no caching, safe on infinite
    streams where pred may never fire; requesting the next chunk consumes
    whatever remains of the current one."""
    i = iter(it)
    done = False
    try:
        t = next(i)
    except StopIteration:
        return

    def chunk():
        nonlocal done, t
        yield t
        for t in i:
            if pred(t):
                break
            yield t
        else:
            done = True

    import collections

    while not done:
        c = chunk()
        yield c
        # drain any unread remainder without retaining a reference to it
        collections.deque(c, maxlen=0)


class RecordingPacketSource:
    """Pass-through packet source that tees every packet to rolling pcap
    chunks while yielding it (ref: sdk/pcap/packet_iter.py:58
    RecordingPacketSource): files are `<prefix>-NNN.pcap`, rolled when
    `chunk_size` MB is exceeded at a frame boundary; recording stops
    after `n_frames` frames or `n_seconds` wall seconds (iteration
    continues un-recorded)."""

    def __init__(self, source, prefix_path: str, *, sensor_idx: int = -1,
                 n_seconds: float = 0.0, n_frames: Optional[int] = None,
                 chunk_size: int = 0, src_ip: str = "127.0.0.1",
                 dst_ip: str = "127.0.0.1", lidar_port: int = -1,
                 imu_port: int = -1, overwrite: bool = True):
        self.source = source
        self.prefix_path = prefix_path
        self.sensor_idx = sensor_idx
        self.n_seconds = n_seconds
        self.n_frames = n_frames
        self.chunk_size = chunk_size
        self.src_ip, self.dst_ip = src_ip, dst_ip
        self.lidar_port, self.imu_port = lidar_port, imu_port
        self.overwrite = overwrite

    @property
    def sensor_info(self):
        return self.source.sensor_info

    def close(self):
        self.source.close()

    def __iter__(self):
        import time as _time

        infos = self.source.sensor_info
        pfs = [PacketFormat.from_info(i) for i in infos]
        last_fid = [None] * len(infos)
        ports = []
        for m in infos:
            lidar = m.config.udp_port_lidar if self.lidar_port < 0 \
                else self.lidar_port
            imu = m.config.udp_port_imu if self.imu_port < 0 \
                else self.imu_port
            ports.append((lidar or 7502, imu or 7503))

        chunk = 0
        path = f"{self.prefix_path}-{chunk:03d}.pcap"
        if os.path.isfile(path) and not self.overwrite:
            raise FileExistsError(f"File '{path}' already exists")
        writer = PcapWriter(path)
        recording = True
        start = _time.time()
        num_frames = 0
        try:
            for item in self.source:
                idx, pkt = item if isinstance(item, tuple) else (0, item)
                if recording and (self.sensor_idx < 0
                                  or idx == self.sensor_idx):
                    if isinstance(pkt, LidarPacket):
                        port = ports[idx][0]
                    elif isinstance(pkt, ImuPacket):
                        port = ports[idx][1]
                    else:
                        port = ports[idx][0]
                    ts = pkt.host_timestamp or int(_time.time() * 1e9)
                    writer.write(bytes(pkt.buf), self.src_ip, self.dst_ip,
                                 port, port, ts)
                    if isinstance(pkt, LidarPacket):
                        fid = pfs[idx].frame_id(pkt.buf)
                        if last_fid[idx] is not None and \
                                fid != last_fid[idx]:
                            num_frames += 1
                            if self.chunk_size and os.path.getsize(
                                    path) > self.chunk_size * 2**20:
                                writer.close()
                                chunk += 1
                                path = (f"{self.prefix_path}"
                                        f"-{chunk:03d}.pcap")
                                if os.path.isfile(path) and \
                                        not self.overwrite:
                                    raise FileExistsError(
                                        f"File '{path}' already exists")
                                writer = PcapWriter(path)
                            if (self.n_frames
                                    and num_frames >= self.n_frames) or \
                                    (self.n_seconds and _time.time()
                                     - start > self.n_seconds):
                                recording = False
                        last_fid[idx] = fid
                yield item
        finally:
            writer.close()

    def __getattr__(self, attr):
        return getattr(self.source, attr)



def resolve_metadata_paths(pcap_path: str) -> List[str]:
    """Find metadata json files next to a pcap, following the reference
    conventions (ref: python/src/ouster/sdk/util/metadata.py): exact stem
    match first, then stem prefixes, with multi-sensor `.N.json` variants."""
    d = os.path.dirname(os.path.abspath(pcap_path)) or "."
    base = os.path.splitext(os.path.basename(pcap_path))[0]
    candidates = []
    listing = sorted(os.listdir(d))
    json_files = [f for f in listing if f.endswith(".json")]

    # exact stem and numbered multi-sensor variants: stem.json, stem.1.json..
    def stem_of(f: str) -> str:
        s = f[: -len(".json")]
        parts = s.rsplit(".", 1)
        if len(parts) == 2 and parts[1].isdigit():
            return parts[0]
        return s

    exact = [f for f in json_files if stem_of(f) == base]
    if exact:
        return [os.path.join(d, f) for f in exact]

    # longest prefix match in either direction: metadata recorded under a
    # shortened or extended name (ref: sdk/util/metadata.py conventions)
    best: List[str] = []
    best_len = 0
    for f in json_files:
        s = stem_of(f)
        if base.startswith(s) or s.startswith(base):
            n = min(len(s), len(base))
            if n > best_len:
                best, best_len = [f], n
            elif n == best_len:
                best.append(f)
    return [os.path.join(d, f) for f in best]


class PcapPacketSource:
    """Iterate (sensor_idx, packet) pairs from a pcap
    (ref: ouster_pcap/src/pcap_packet_source.cpp)."""

    def __init__(
        self,
        pcap_path: str,
        *,
        metadata_paths: Optional[List[str]] = None,
        sensor_infos: Optional[List[SensorInfo]] = None,
        soft_id_check: bool = False,
        error_handler=None,
    ):
        self._path = pcap_path
        self._error_handler = error_handler or logging_error_handler
        if sensor_infos is not None:
            self._infos = list(sensor_infos)
        else:
            if metadata_paths is None:
                metadata_paths = resolve_metadata_paths(pcap_path)
            if not metadata_paths:
                raise FileNotFoundError(
                    f"no metadata json found for {pcap_path}")
            self._infos = []
            for p in metadata_paths:
                with open(p) as f:
                    self._infos.append(sensor_info_from_metadata(f.read()))
        self._soft_id_check = soft_id_check
        self._formats = [PacketFormat.from_info(i) for i in self._infos]
        self._check_duplicate_ports()
        self.id_error_count = 0
        self.size_error_count = 0

    def _check_duplicate_ports(self) -> None:
        """Two sensors may share a port only if their packets are
        distinguishable by serial; LEGACY lidar/IMU packets carry no id,
        so any same-port legacy pair is ambiguous
        (ref: indexed_pcap_reader.cpp:85-131)."""
        port_map: Dict[int, Dict[str, int]] = {}
        for index, info in enumerate(self._infos):
            sn_lidar = sn_imu = sn_zm = str(info.sn)
            if info.format.udp_profile_lidar == UDPProfileLidar.LEGACY:
                sn_lidar = "LEGACY_LIDAR"
            if info.format.udp_profile_imu == UDPProfileIMU.LEGACY:
                sn_imu = "LEGACY_IMU"
            for name, port, sn in (
                    ("lidar", info.config.udp_port_lidar, sn_lidar),
                    ("imu", info.config.udp_port_imu, sn_imu),
                    ("zm", info.config.udp_port_zm, sn_zm)):
                if port is None or port == 0:
                    continue  # unknown / stream disabled
                seen = port_map.setdefault(port, {})
                if sn in seen:
                    raise PcapDuplicatePortException(
                        f"Duplicate {name} port/sn found in pcap: "
                        f"{sn}:{port}")
                seen[sn] = index

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return self._infos

    def _classify(self, dst_port: int, payload: bytes
                  ) -> Optional[Tuple[int, type]]:
        """Match a datagram to (sensor_idx, packet class)."""
        size = len(payload)
        candidates: List[Tuple[int, type]] = []
        for idx, (info, pf) in enumerate(zip(self._infos, self._formats)):
            cfg = info.config
            lidar_port = cfg.udp_port_lidar or 0
            imu_port = cfg.udp_port_imu or 0
            zm_port = cfg.udp_port_zm or 0
            if size == pf.lidar_packet_size and \
                    (lidar_port in (0, dst_port)):
                candidates.append((idx, LidarPacket))
            elif size == pf.imu_packet_size and (imu_port in (0, dst_port)):
                candidates.append((idx, ImuPacket))
            elif pf.zone_monitoring_enabled and \
                    size == pf.zone_packet_size and \
                    (zm_port in (0, dst_port)):
                candidates.append((idx, ZonePacket))

        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]

        # ambiguous: disambiguate eUDP lidar packets by init_id / serial
        for idx, cls in candidates:
            info = self._infos[idx]
            if cls is LidarPacket and \
                    info.format.udp_profile_lidar != UDPProfileLidar.LEGACY:
                pf = self._formats[idx]
                buf = np.frombuffer(payload, dtype=np.uint8)
                if pf.init_id(buf) == info.init_id or \
                        pf.prod_sn(buf) == info.sn:
                    return idx, cls
        return candidates[0]

    def __iter__(self) -> Iterator[Tuple[int, Packet]]:
        with PcapReader(self._path) as reader:
            for pkt_info, payload in reader:
                m = self._classify(pkt_info.dst_port, payload)
                if m is None:
                    self.size_error_count += 1
                    continue
                idx, cls = m
                packet = cls(payload, host_timestamp=pkt_info.timestamp)
                if cls is LidarPacket:
                    res = packet.validate(self._infos[idx],
                                          self._formats[idx])
                    if res == PacketValidationFailure.ID:
                        self.id_error_count += 1
                        if not self._soft_id_check:
                            continue
                    elif res == PacketValidationFailure.PACKET_SIZE:
                        self.size_error_count += 1
                        continue
                yield idx, packet
        # one summary report per pass, not one per bad packet
        # (ref: pcap_scan_source.cpp end-of-stream id error warning)
        if self.id_error_count:
            self._error_handler(
                Severity.WARNING,
                f"{self._path}: {self.id_error_count} lidar packets with "
                f"mismatched init_id/serial"
                + (" (passed through: soft_id_check)"
                   if self._soft_id_check else " (dropped)"))

    def close(self) -> None:
        pass

    def __enter__(self) -> "PcapPacketSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
