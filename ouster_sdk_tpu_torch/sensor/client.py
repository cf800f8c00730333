"""Low-level UDP client: socket setup, polling, packet reads.

Rebuild of the reference client layer (ref: ouster_sensor/include/ouster/
client.h:109-380, src/client.cpp): UDP socket creation with SO_REUSEPORT /
multicast membership, select()-based polling, and sized packet reads.
"""

from __future__ import annotations

import select
import socket
import struct
import time
from dataclasses import dataclass
from enum import IntEnum
from typing import List, Optional, Tuple

from ..core.types import SensorConfig, SensorInfo
from .http import SensorHttp, build_sensor_config, fetch_metadata

RCVBUF_SIZE = 256 * 1024 * 1024  # generous; kernel clamps to rmem_max


def grow_rcvbuf(sock: socket.socket, size: int = RCVBUF_SIZE) -> int:
    """Grow a socket's kernel receive buffer as far as the host allows
    and return the effective size. SO_RCVBUFFORCE (root) bypasses the
    rmem_max clamp: at 128x2048 a frame is 2.1 MB of UDP payload (4.2 MB
    dual), so a stock 4 MB rmem_max holds two frames at most and any
    consumer stall beyond 100-200 ms silently loses whole frames in the
    kernel. The
    reference sets a 256 MB SO_RCVBUF for the same reason
    (ref: client.cpp udp_data_socket RCVBUF_SIZE)."""
    force = getattr(socket, "SO_RCVBUFFORCE", 33)  # linux-only opt
    return _grow_buf(sock, force, socket.SO_RCVBUF, size)


def grow_sndbuf(sock: socket.socket, size: int) -> int:
    """Send-side twin of grow_rcvbuf (SO_SNDBUFFORCE bypasses wmem_max
    for root) — the emulator's data plane uses it so the loopback
    sender never blocks on the host's send queue, like a real sensor's
    NIC."""
    force = getattr(socket, "SO_SNDBUFFORCE", 32)  # linux-only opt
    return _grow_buf(sock, force, socket.SO_SNDBUF, size)


def _grow_buf(sock: socket.socket, force_opt: int, plain_opt: int,
              size: int) -> int:
    try:
        sock.setsockopt(socket.SOL_SOCKET, force_opt, size)
    except OSError:
        try:
            sock.setsockopt(socket.SOL_SOCKET, plain_opt, size)
        except OSError:
            pass
    try:
        return sock.getsockopt(socket.SOL_SOCKET, plain_opt)
    except OSError:
        return 0


@dataclass
class ClientEvent:
    """(ref: sensor_packet_source.h:43)"""

    source: int
    type: str  # "lidar" | "imu" | "zone" | "timeout" | "error"


def udp_data_socket(port: int, reuse: bool = True,
                    mtp_group: Optional[str] = None) -> socket.socket:
    """Bind a UDP data socket, optionally joining a multicast group
    (ref: client.cpp udp_data_socket, sensor_packet_source.cpp:49-70)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuse and hasattr(socket, "SO_REUSEPORT"):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    grow_rcvbuf(sock)
    sock.bind(("", port))
    if mtp_group:
        mreq = struct.pack("4s4s", socket.inet_aton(mtp_group),
                           socket.inet_aton("0.0.0.0"))
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
    sock.setblocking(False)
    return sock


def in_multicast(addr: str) -> bool:
    """(ref: client.h:380)"""
    try:
        first = int(addr.split(".")[0])
    except (ValueError, IndexError):
        return False
    return 224 <= first <= 239


class Client:
    """One sensor's data-plane connection (ref: client.h init_client)."""

    def __init__(self, hostname: str, lidar_port: int = 7502,
                 imu_port: int = 7503, zm_port: Optional[int] = None,
                 mtp_group: Optional[str] = None):
        self.hostname = hostname
        self.lidar_sock = udp_data_socket(lidar_port, mtp_group=mtp_group)
        self.imu_sock = udp_data_socket(imu_port, mtp_group=mtp_group)
        self.zm_sock = udp_data_socket(zm_port, mtp_group=mtp_group) \
            if zm_port else None
        self.lidar_port = self.lidar_sock.getsockname()[1]
        self.imu_port = self.imu_sock.getsockname()[1]
        self.zm_port = self.zm_sock.getsockname()[1] if self.zm_sock else 0

    def close(self) -> None:
        self.lidar_sock.close()
        self.imu_sock.close()
        if self.zm_sock:
            self.zm_sock.close()

    def poll(self, timeout_sec: float = 1.0) -> List[str]:
        """select() for readable sockets (ref: client.h:189 poll_client)."""
        socks = [self.lidar_sock, self.imu_sock] + (
            [self.zm_sock] if self.zm_sock else [])
        readable, _, err = select.select(socks, [], socks, timeout_sec)
        if err:
            return ["error"]
        out = []
        for s in readable:
            if s is self.lidar_sock:
                out.append("lidar")
            elif s is self.imu_sock:
                out.append("imu")
            else:
                out.append("zone")
        return out or ["timeout"]

    def _read(self, sock: socket.socket
              ) -> Optional[Tuple[bytes, int]]:
        try:
            data = sock.recv(65536)
        except BlockingIOError:
            return None
        return data, time.time_ns()

    def read_lidar_packet(self):
        """(ref: client.h:202; size validation happens in
        Packet.validate, core/packets.py)"""
        return self._read(self.lidar_sock)

    def read_imu_packet(self):
        return self._read(self.imu_sock)

    def read_zone_packet(self):
        return self._read(self.zm_sock) if self.zm_sock else None


def init_client(
    hostname: str,
    lidar_port: Optional[int] = None,
    imu_port: Optional[int] = None,
    *,
    config: Optional[SensorConfig] = None,
    do_not_reinitialize: bool = False,
    no_auto_udp_dest: bool = False,
    timeout_sec: float = 60.0,
) -> Tuple[Client, SensorInfo]:
    """Configure the sensor over HTTP and open data sockets
    (ref: client.h:109-166 init_client overloads + config handshake
    client.cpp:309-396). Port semantics follow the reference: None
    (unspecified) listens on the staged/active config's ports; an
    explicit 0 binds an OS-assigned ephemeral port and reconfigures
    the sensor to send there (ref: sensor_packet_source.cpp:344-365
    "Opening ephemeral port")."""
    import copy

    http_client = SensorHttp.create(hostname)
    # explicit 0 = ephemeral request: Client(port=0) binds an
    # OS-assigned port; the sensor is then staged to send there
    ephemeral = lidar_port == 0 or imu_port == 0
    # port priority: explicit args > ports pinned in the passed config >
    # the sensor's active config > defaults — the sockets must listen
    # exactly where the sensor is told to send
    cfg = copy.deepcopy(config) if config is not None else None
    if lidar_port is None and cfg is not None and cfg.udp_port_lidar:
        lidar_port = cfg.udp_port_lidar
    if imu_port is None and cfg is not None and cfg.udp_port_imu:
        imu_port = cfg.udp_port_imu
    if lidar_port is None and cfg is None:
        try:
            active = http_client.active_config_params()
            lidar_port = int(active.get("udp_port_lidar") or 0) or None
            if imu_port is None:
                imu_port = int(active.get("udp_port_imu") or 0) or None
        except Exception:
            pass
    if ephemeral and cfg is None and not do_not_reinitialize:
        cfg = SensorConfig()  # stage the bound ports below
    # open the zone-monitor socket when the sensor streams zone packets
    # (ref: sensor_packet_source.cpp zone socket)
    zm_port = None
    try:
        active = http_client.active_config_params()
        if active.get("zone_monitoring_enabled") or \
                active.get("udp_port_zm"):
            zm_port = int(active.get("udp_port_zm") or 7504)
    except Exception:
        pass
    # 0 passes through: Client binds an ephemeral port and reports the
    # OS-assigned number back via .lidar_port/.imu_port
    client = Client(hostname,
                    7502 if lidar_port is None else lidar_port,
                    7503 if imu_port is None else imu_port,
                    zm_port=zm_port)
    if cfg is not None and not do_not_reinitialize:
        if cfg.udp_port_lidar is None:
            cfg.udp_port_lidar = client.lidar_port
        if cfg.udp_port_imu is None:
            cfg.udp_port_imu = client.imu_port
        build_sensor_config(http_client, cfg,
                            udp_dest_auto=not no_auto_udp_dest)
    elif not no_auto_udp_dest:
        try:
            http_client.set_udp_dest_auto()
        except Exception:
            pass

    # metadata fetch with retry while the sensor reinitializes
    # (ref: client.cpp:402): only RUNNING (or sensors that don't report
    # a status at all) counts as ready
    deadline = time.monotonic() + timeout_sec
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            info = fetch_metadata(hostname)
            if info.status in ("RUNNING", "", None):
                return client, info
            last_err = RuntimeError(
                f"sensor status {info.status!r}")
        except Exception as e:  # noqa: BLE001
            last_err = e
        time.sleep(1.0)
    client.close()
    raise TimeoutError(
        f"timed out waiting for sensor {hostname} to initialize: {last_err}")


class ClientState(IntEnum):
    """Legacy poll-state bitmask (ref: client.pyi ClientState)."""

    TIMEOUT = 0
    ERROR = 1
    LIDAR_DATA = 2
    IMU_DATA = 4
    EXIT = 8


class ClientEventType(IntEnum):
    """(ref: client.pyi ClientEventType / sensor_packet_source.h)"""

    Error = 0
    Exit = 1
    PollTimeout = 2
    Packet = 3


#: Reference name for the low-level UDP connection
#: (ref: client.pyi SensorConnection).
SensorConnection = Client
