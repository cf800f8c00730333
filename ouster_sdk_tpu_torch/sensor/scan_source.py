"""Live sensor scan source: multi-sensor UDP fan-in + batcher thread.

Rebuild of the reference live backend (ref: ouster_sensor/src/
sensor_packet_source.cpp:343-580, sensor_scan_source.cpp:128-275): one
socket set per sensor, an optional buffering thread with drop-oldest
overflow, and a batcher thread pushing completed scans into a bounded
queue consumed by iteration.

Each readable socket is drained with one recvmmsg (utils.native
.udp_recv_batch, one host timestamp a batch); a datagram at a time with
recv only where the native library is not built (no g++). The batcher
thread hands every lidar packet to a LiveDeviceBatcher on the source's
device (CUDA unless named), whose scans come out with their pixel fields
decoded on the device and left there until first touched, or to the numpy
ScanBatcher when OUSTER_SDK_TPU_DEVICE_DECODE=0 or engine="numpy". The
batchers are built in the constructor, so a device that cannot be used
raises there; a failure in the batcher thread is re-raised to the
consumer by the next get_scan or iteration step.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Iterator, List, Optional, Tuple

import torch

from ..core.batcher import ScanBatcher
from ..core.lidar_scan import LidarScan
from ..core.packets import ImuPacket, LidarPacket, Packet, ZonePacket
from ..core.types import SensorConfig, SensorInfo
from ..io.sources import (
    ScanSource,
    collate_scans,
    populate_extrinsics,
)
from ..io import device_engine as de
from ..ops.packet_format import PacketFormat
from ..utils import native
from .client import Client, init_client


class ClientError(RuntimeError):
    """(ref: sensor_packet_source.h:43)"""


class ClientTimeout(ClientError):
    """No packets/scans within the receive timeout — raised from
    iteration like the reference's iterator (ref:
    sensor_packet_source.cpp:820, sensor_scan_source.cpp:69)."""


class ClientOverflow(ClientError):
    """Declared for API parity (ref: sensor_packet_source.h:60); the
    current reference never throws it — buffer overflow is handled by
    drop-oldest in both implementations (sensor_packet_source.cpp:573,
    sensor_scan_source.cpp:222); see the dropped_packets /
    dropped_scans counters."""


class Sensor:
    """Sensor descriptor: hostname + desired configuration
    (ref: sensor_packet_source.h:137-175)."""

    def __init__(self, hostname: str,
                 config: Optional[SensorConfig] = None):
        self._hostname = hostname
        self._config = config if config is not None else SensorConfig()
        self._http = None

    @property
    def hostname(self) -> str:
        return self._hostname

    def desired_config(self) -> SensorConfig:
        return self._config

    def http_client(self):
        from .http import SensorHttp

        if self._http is None:
            self._http = SensorHttp.create(self._hostname)
        return self._http

    def fetch_metadata(self, timeout: int = 10) -> SensorInfo:
        from ..core.metadata import sensor_info_from_metadata

        return sensor_info_from_metadata(
            self.http_client().metadata(timeout=timeout))


class SensorPacketSource:
    """Multi-sensor UDP packet fan-in (ref: sensor_packet_source.cpp)."""

    def __init__(
        self,
        hostnames: List[str],
        *,
        configs: Optional[List[Optional[SensorConfig]]] = None,
        sensor_info: Optional[List[SensorInfo]] = None,
        lidar_port: Optional[int] = None,
        imu_port: Optional[int] = None,
        do_not_reinitialize: bool = False,
        no_auto_udp_dest: bool = False,
        timeout: Optional[float] = 1.0,
        config_timeout: float = 45.0,
        buffer_time_sec: float = 0.0,
        buffer_queue_size: int = 4096,
        soft_id_check: bool = False,
        error_handler=None,
    ):
        """`timeout` is the packet receive timeout: iterating raises
        ClientTimeout after that many seconds without packets (<= 0 or
        None disables, matching the reference's iterator_timeout_ > 0
        gate); `config_timeout` bounds the HTTP configuration handshake
        (ref: open_source.h:69-74 timeout/config_timeout defaults)."""
        from ..core.error_handler import logging_error_handler

        self._soft_id_check = soft_id_check
        self._error_handler = error_handler or logging_error_handler
        self._clients: List[Client] = []
        self._infos: List[SensorInfo] = []
        self.id_error_count = 0
        self._timeout = timeout
        self.dropped_packets = 0

        configs = configs or [None] * len(hostnames)
        for i, (host, cfg) in enumerate(zip(hostnames, configs)):
            if sensor_info is not None:
                # operate without contacting hardware
                # (ref: open_source.h:80 sensor_info override)
                if lidar_port == 0 or imu_port == 0:
                    raise ValueError(
                        "Cannot specify ephemeral ports when providing "
                        "metadata to SensorClient for sensor "
                        f"'{host}'")  # ref: sensor_packet_source.cpp:384
                info = sensor_info[i]
                zm_port = (info.config.udp_port_zm or 7504) \
                    if info.format.zone_monitoring_enabled else None
                client = Client(host,
                                lidar_port or info.config.udp_port_lidar
                                or 7502,
                                imu_port or info.config.udp_port_imu
                                or 7503,
                                zm_port=zm_port)
            else:
                # None and 0 are distinct: None listens on the config's
                # ports, 0 requests an OS-assigned ephemeral port
                # (ref: sensor_packet_source.cpp:344-365)
                client, info = init_client(
                    host, lidar_port, imu_port, config=cfg,
                    do_not_reinitialize=do_not_reinitialize,
                    no_auto_udp_dest=no_auto_udp_dest,
                    timeout_sec=config_timeout)
            self._clients.append(client)
            self._infos.append(info)

        self._formats = [PacketFormat.from_info(i) for i in self._infos]
        # precomputed per-sensor fast paths for _classify: the live
        # receive path runs per packet (2.5k pkts/s/sensor at 2048x20)
        # so the id check reads init_id/prod_sn straight from the packet
        # bytes instead of staging header words
        self._idchecks = [
            self._make_idcheck(i, pf)
            for i, pf in zip(self._infos, self._formats)]
        self._drained: deque = deque()
        self._stop = threading.Event()
        self._bufq: "queue.Queue" = queue.Queue(
            maxsize=max(buffer_queue_size, 1))
        self._thread: Optional[threading.Thread] = None
        if buffer_time_sec > 0:
            self._thread = threading.Thread(target=self._buffer_loop,
                                            daemon=True)
            self._thread.start()

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return self._infos

    @staticmethod
    def _make_idcheck(info: SensorInfo, pf: PacketFormat):
        """Closure replicating LidarPacket.validate's ID semantics
        (packet init_id/prod_sn must match metadata when both sides are
        nonzero, ref: packet.cpp LidarPacket::validate) at a per-packet
        cost of two int.from_bytes. None = nothing to check."""
        from ..core.types import UDPProfileLidar

        if info.format.udp_profile_lidar == UDPProfileLidar.LEGACY:
            return None  # no packet header to check
        exp_init = int(info.init_id or 0)
        exp_sn = int(info.sn or 0)
        if not exp_init and not exp_sn:
            return None
        read_init = pf.scalar_reader(pf.geom.init_id)
        read_sn = pf.scalar_reader(pf.geom.prod_sn)

        def check(data) -> bool:
            if exp_init:
                v = read_init(data)
                if v and v != exp_init:
                    return False
            if exp_sn:
                v = read_sn(data)
                if v and v != exp_sn:
                    return False
            return True

        return check

    def _classify(self, idx: int, data: bytes, ts: int) -> Optional[Packet]:
        pf = self._formats[idx]
        n = len(data)
        if n == pf.lidar_packet_size:
            check = self._idchecks[idx]
            if check is None or check(data):
                return LidarPacket(data, ts)
            self.id_error_count += 1
            # throttled: first mismatch, then every 100th, to avoid a
            # per-packet log storm at 10 Gbit line rate
            if self.id_error_count == 1 or \
                    self.id_error_count % 100 == 0:
                from ..core.error_handler import Severity

                self._error_handler(
                    Severity.WARNING,
                    f"sensor {idx}: lidar packet init_id/serial "
                    f"mismatch (count={self.id_error_count})")
            if not self._soft_id_check:
                return None
            return LidarPacket(data, ts)
        if n == pf.imu_packet_size:
            return ImuPacket(data, ts)
        if pf.zone_monitoring_enabled and n == pf.zone_packet_size:
            return ZonePacket(data, ts)
        return None

    def get_packet(self, timeout_sec: float = 1.0
                   ) -> Tuple[Optional[int], Optional[Packet]]:
        """Blocking read of the next packet from any sensor
        (ref: sensor_packet_source.cpp get_packet)."""
        if self._thread is not None:
            try:
                return self._bufq.get(timeout=timeout_sec)
            except queue.Empty:
                return None, None
        return self._poll_once(timeout_sec)

    def _poll_once(self, timeout_sec: float
                   ) -> Tuple[Optional[int], Optional[Packet]]:
        import select as _select

        if self._drained:
            return self._drained.popleft()

        socks = self.__dict__.get("_sock_map")
        if socks is None:
            socks = self._sock_map = self._build_sock_map()
        readable, _, _ = _select.select(list(socks), [], [], timeout_sec)
        batched = native.get_lib() is not None
        for s in readable:
            idx = socks[s]
            # high-rate path: drain the socket in one recvmmsg syscall
            # (ref: sensor_packet_source.cpp recv loop; native batching
            # amortizes syscall cost at multi-kHz packet rates). EVERY
            # readable socket is drained before returning: stopping at
            # the first non-empty one would starve the other sensors of
            # a multi-sensor fan-in whenever one stream stays busy
            if batched:
                ws = self.__dict__.setdefault("_recv_ws", {})
                batch = native.udp_recv_batch(s, stride=65536, max_msgs=64,
                                              workspace=ws)
                if batch is None:
                    continue
                bufs, sizes, ts = batch
                for k in range(len(sizes)):
                    pkt = self._classify(
                        idx, bufs[k, :sizes[k]].tobytes(), ts)
                    if pkt is not None:
                        self._drained.append((idx, pkt))
                continue
            try:
                data = s.recv(65536)
            except BlockingIOError:
                continue
            pkt = self._classify(idx, data, time.time_ns())
            if pkt is not None:
                self._drained.append((idx, pkt))
        if self._drained:
            return self._drained.popleft()
        return None, None

    def _build_sock_map(self):
        socks = {}
        for i, c in enumerate(self._clients):
            socks[c.lidar_sock] = i
            socks[c.imu_sock] = i
            if c.zm_sock:
                socks[c.zm_sock] = i
        return socks

    def _buffer_loop(self) -> None:
        """Background receiver with drop-oldest overflow
        (ref: sensor_packet_source.cpp:550-580)."""
        while not self._stop.is_set():
            idx, pkt = self._poll_once(0.1)
            if pkt is None:
                continue
            try:
                self._bufq.put_nowait((idx, pkt))
            except queue.Full:
                # drop oldest (ref: sensor_packet_source.cpp:573-575)
                self.dropped_packets += 1
                try:
                    self._bufq.get_nowait()
                except queue.Empty:
                    pass
                self._bufq.put_nowait((idx, pkt))

    def __iter__(self) -> Iterator[Tuple[int, Packet]]:
        last_rx = time.monotonic()
        while not self._stop.is_set():
            try:
                idx, pkt = self.get_packet()
            except (OSError, ValueError):
                # sockets closed under us (close() from another thread)
                return
            if pkt is not None:
                last_rx = time.monotonic()
                yield idx, pkt
            elif self._timeout and self._timeout > 0 and \
                    time.monotonic() - last_rx > self._timeout:
                raise ClientTimeout("No packets received in timeout.")

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
        for c in self._clients:
            c.close()

    def __enter__(self) -> "SensorPacketSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SensorScanSource(ScanSource):
    """Live ScanSource with a batcher thread and bounded scan queue
    (ref: sensor_scan_source.cpp:128-275)."""

    def __init__(self, hostnames: List[str], *, queue_size: int = 2,
                 extrinsics=None, extrinsics_file=None,
                 engine: str = "auto", device=None, **kw):
        """engine: "device" decodes whole frames on `device` (CUDA unless
        named; an error without a GPU) through one LiveDeviceBatcher a
        sensor, the per-packet host work a memcpy; "numpy" decodes packet
        by packet on the host ScanBatcher; "auto" follows
        device_engine.device_decode_enabled() (OUSTER_SDK_TPU_DEVICE_DECODE:
        unset or 1 is "device", 0 is "numpy"), the routing policy of the
        pcap and OSF sources. A sensor the device route cannot serve (a
        lidar profile of OFF) stays on the ScanBatcher, as in the
        reference design; nothing else moves a sensor off the device."""
        if queue_size < 1:
            raise ValueError("The queue_size cannot be less than 1.")
        if engine not in ("auto", "device", "numpy"):
            raise ValueError(f"engine {engine!r}: expected 'auto', 'device' "
                             "or 'numpy'")
        use_device = engine == "device" or (
            engine == "auto" and de.device_decode_enabled())
        self._packets = SensorPacketSource(hostnames, **kw)
        try:
            infos = self._packets.sensor_info
            populate_extrinsics(infos, extrinsics, extrinsics_file)
            super().__init__(infos)
            #: per-sensor decode route of the batcher thread
            self.engine_used = [
                "device" if use_device and de.supports_device_decode(i)
                else "numpy" for i in infos]
            self.device = (de._device(device) if "device" in self.engine_used
                           else None)
            if self.device is not None and self.device.type == "cuda" \
                    and not torch.cuda.is_available():
                raise RuntimeError(f"CUDA is not available for device "
                                   f"{device!r}")
            # built here, not on the thread: a device that cannot be used
            # raises from the constructor
            self._stagers = [
                de.LiveDeviceBatcher(i, device=self.device)
                if eng == "device" else None
                for i, eng in zip(infos, self.engine_used)]
        except BaseException:
            self._packets.close()
            raise
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._error: Optional[Exception] = None
        self.dropped_scans = 0
        # per-sensor scan receive watermark for the iteration timeout,
        # updated at CONSUME time in _iter_scans like the reference
        # iterator (ref: sensor_scan_source.cpp:55-80 last_receive_times_)
        self._timeout = self._packets._timeout
        self._last_scan_time = [time.monotonic()] * len(infos)
        self._thread = threading.Thread(target=self._batch_loop, daemon=True,
                                        name="sensor-batcher")
        self._thread.start()

    @property
    def is_live(self) -> bool:
        return True

    def _emit(self, idx: int, done: LidarScan) -> None:
        try:
            self._queue.put_nowait((idx, done))
        except queue.Full:
            # drop oldest (ref: sensor_scan_source.cpp:222)
            self.dropped_scans += 1
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._queue.put_nowait((idx, done))

    def _batch_loop(self) -> None:
        """The batcher thread. Its CUDA work runs on the source's device
        (the current device is per thread) and on the default stream,
        which the consumer's readback of a deferred field also uses: that
        orders the readback after the decode. Any exception ends the loop
        and is kept for the consumer."""
        try:
            with (torch.cuda.device(self.device)
                  if self.device is not None and self.device.type == "cuda"
                  else nullcontext()):
                self._batch_packets()
        except Exception as e:  # the thread's boundary: get_scan raises it
            self._error = e

    def _batch_packets(self) -> None:
        stagers = self._stagers
        batchers = [ScanBatcher(i) for i in self.sensor_info]
        scans = [LidarScan(i) for i in self.sensor_info]
        while not self._stop.is_set():
            idx, pkt = self._packets.get_packet(timeout_sec=0.5)
            if pkt is None:
                continue
            stager = stagers[idx]
            if stager is not None:
                if isinstance(pkt, LidarPacket):
                    for done in stager.push(pkt.buf, pkt.host_timestamp):
                        self._emit(idx, done)
                elif isinstance(pkt, ZonePacket):
                    for done in stager.push_aux("zone", pkt.buf,
                                                pkt.host_timestamp):
                        self._emit(idx, done)
                elif isinstance(pkt, ImuPacket) and stager.wants_imu:
                    # NMEA-imu profiles batch imu packets into scans
                    # (hybrid route); legacy imu packets are not part
                    # of frames
                    for done in stager.push_aux("imu", pkt.buf,
                                                pkt.host_timestamp):
                        self._emit(idx, done)
                continue
            if batchers[idx](pkt, scans[idx]):
                done = scans[idx]
                scans[idx] = LidarScan(self.sensor_info[idx])
                self._emit(idx, done)

    def _raise_failure(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"the sensor batcher thread failed: {self._error!r}"
            ) from self._error

    def get_scan(self, timeout_sec: Optional[float] = None
                 ) -> Tuple[Optional[int], Optional[LidarScan]]:
        """The next scan as (sensor index, scan), or (None, None) after
        `timeout_sec` (None waits for ever). Raises the batcher thread's
        failure once it has failed."""
        deadline = (None if timeout_sec is None
                    else time.monotonic() + timeout_sec)
        while True:
            self._raise_failure()
            wait = 0.1 if deadline is None else min(
                0.1, deadline - time.monotonic())
            try:
                return self._queue.get(timeout=max(wait, 0.0))
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    self._raise_failure()
                    return None, None

    def _iter_scans(self):
        poll = (min(1.0, self._timeout / 2)
                if self._timeout and self._timeout > 0 else 1.0)
        # baseline at iteration start so scans queued before the
        # consumer attached are delivered, not timed out
        self._last_scan_time = [time.monotonic()] * len(self.sensor_info)
        while not self._stop.is_set():
            idx, scan = self.get_scan(timeout_sec=poll)
            if scan is not None:
                # deliver the in-hand scan before any timeout check
                self._last_scan_time[idx] = time.monotonic()
                yield idx, scan
            if self._timeout and self._timeout > 0:
                now = time.monotonic()
                for i, t in enumerate(self._last_scan_time):
                    if now - t > self._timeout:
                        info = self.sensor_info[i]
                        raise ClientTimeout(
                            f"No valid scans received within "
                            f"{self._timeout} from sensor {info.sn} "
                            f"using udp destination "
                            f"'{info.config.udp_dest or ''}' on port "
                            f"{info.config.udp_port_lidar or 0}")

    def _iter_sets(self):
        return collate_scans(self._iter_scans(), len(self.sensor_info))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self._packets.close()

    def __enter__(self) -> "SensorScanSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
