"""Dependency-free multicast DNS service discovery (RFC 6762/6763).

The reference's `discover` rides the pip `zeroconf` package
(ref: python/src/ouster/cli/plugins/discover.py); this module implements
the slice of mDNS/DNS-SD that sensor discovery actually needs — a PTR
question for `_roger._tcp.local.` / `_ouster-lidar._tcp.local.` and
PTR/SRV/TXT/A(/AAAA) answer parsing — directly on raw UDP sockets, so
discovery works in any environment with a socket API.

Also provides `MDNSResponder`, a minimal advertiser used by the sensor
emulator (sensor/emulator.py) so the full discovery path is testable
in-image with no hardware: the emulator answers the same PTR question a
real sensor would.

Wire format notes: DNS names are length-prefixed labels with 0xC0xx
compression pointers (responses use them heavily; the parser follows
pointers with a loop guard). mDNS questions set the top class bit (QU,
"unicast response requested") so responders reply straight to our
ephemeral port — that keeps the querier independent of port-5353
ownership and works across loopback test rigs.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MDNS_GRP = "224.0.0.251"
MDNS_PORT = 5353
TYPE_A = 1
TYPE_PTR = 12
TYPE_TXT = 16
TYPE_AAAA = 28
TYPE_SRV = 33
CLASS_IN = 1
QU_BIT = 0x8000          # question: unicast response requested
CACHE_FLUSH = 0x8000     # answer: cache-flush

SENSOR_SERVICES = ("_roger._tcp.local.", "_ouster-lidar._tcp.local.")


def _encode_name(name: str) -> bytes:
    out = bytearray()
    for label in name.rstrip(".").split("."):
        raw = label.encode()
        if not 0 < len(raw) < 64:
            raise ValueError(f"bad DNS label {label!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def _decode_name(msg: bytes, off: int) -> Tuple[str, int]:
    """Returns (name, offset after the name at the TOP level). Follows
    compression pointers with a hop guard."""
    labels: List[str] = []
    jumps = 0
    end = -1
    while True:
        if off >= len(msg):
            raise ValueError("truncated name")
        n = msg[off]
        if n == 0:
            off += 1
            break
        if n & 0xC0 == 0xC0:
            if off + 1 >= len(msg):
                raise ValueError("truncated pointer")
            ptr = ((n & 0x3F) << 8) | msg[off + 1]
            if end < 0:
                end = off + 2
            off = ptr
            jumps += 1
            if jumps > 32:
                raise ValueError("compression loop")
            continue
        if n & 0xC0:
            raise ValueError("bad label length")
        labels.append(msg[off + 1:off + 1 + n].decode(errors="replace"))
        off += 1 + n
    return ".".join(labels) + ".", (end if end >= 0 else off)


@dataclass
class ServiceRecord:
    """One discovered DNS-SD service instance."""

    instance: str                       # "os-122246000087._roger._tcp.local."
    service: str                        # "_roger._tcp.local."
    host: str = ""                      # SRV target, e.g. "os-...local."
    port: int = 0
    addresses: List[str] = field(default_factory=list)
    txt: Dict[str, str] = field(default_factory=dict)
    source: str = ""                    # responder's IP

    @property
    def hostname(self) -> str:
        return self.instance.split(".")[0]


def build_query(services, qu: bool = True) -> bytes:
    services = tuple(services)  # a generator must survive two uses
    flags = 0
    head = struct.pack(">HHHHHH", 0, flags, len(services), 0, 0, 0)
    body = b"".join(
        _encode_name(s) + struct.pack(
            ">HH", TYPE_PTR, CLASS_IN | (QU_BIT if qu else 0))
        for s in services)
    return head + body


def _parse_rrs(msg: bytes, off: int, count: int):
    rrs = []
    for _ in range(count):
        name, off = _decode_name(msg, off)
        rtype, rclass, ttl, rdlen = struct.unpack_from(">HHIH", msg, off)
        off += 10
        rdata = msg[off:off + rdlen]
        rrs.append((name, rtype, rclass & 0x7FFF, ttl, rdata, off))
        off += rdlen
    return rrs, off


def parse_response(msg: bytes) -> List[Tuple[str, int, int, bytes, int]]:
    """Flatten a DNS response's answer+additional RRs to
    (name, type, ttl, rdata, rdata_offset) tuples; [] for queries/junk."""
    if len(msg) < 12:
        return []
    _, flags, qd, an, ns, ar = struct.unpack_from(">HHHHHH", msg, 0)
    if not flags & 0x8000:       # not a response
        return []
    off = 12
    try:
        for _ in range(qd):      # skip questions
            _, off = _decode_name(msg, off)
            off += 4
        out = []
        for count in (an, ns, ar):
            rrs, off = _parse_rrs(msg, off, count)
            out.extend(rrs)
        return [(n, t, ttl, rd, ro) for n, t, _c, ttl, rd, ro in out]
    except (ValueError, struct.error):
        return []


def _merge_response(msg: bytes, src: str, services,
                    found: Dict[str, ServiceRecord]) -> None:
    rrs = parse_response(msg)
    if not rrs:
        return
    addrs_by_host: Dict[str, List[str]] = {}
    srv_by_inst: Dict[str, Tuple[str, int]] = {}
    txt_by_inst: Dict[str, Dict[str, str]] = {}
    insts: List[Tuple[str, str]] = []
    for name, rtype, _ttl, rdata, roff in rrs:
        lname = name.lower()
        if rtype == TYPE_PTR and lname in {s.lower() for s in services}:
            inst, _ = _decode_name(msg, roff)
            insts.append((inst, name))
        elif rtype == TYPE_SRV and len(rdata) >= 6:
            _prio, _weight, port = struct.unpack_from(">HHH", msg, roff)
            target, _ = _decode_name(msg, roff + 6)
            srv_by_inst[lname] = (target, port)
        elif rtype == TYPE_TXT:
            txt: Dict[str, str] = {}
            i = 0
            while i < len(rdata):
                n = rdata[i]
                item = rdata[i + 1:i + 1 + n]
                i += 1 + n
                if b"=" in item:
                    k, v = item.split(b"=", 1)
                    txt[k.decode(errors="replace")] = v.decode(
                        errors="replace")
                elif item:
                    txt[item.decode(errors="replace")] = ""
            txt_by_inst[lname] = txt
        elif rtype == TYPE_A and len(rdata) == 4:
            addrs_by_host.setdefault(lname, []).append(
                socket.inet_ntoa(rdata))
        elif rtype == TYPE_AAAA and len(rdata) == 16:
            addrs_by_host.setdefault(lname, []).append(
                socket.inet_ntop(socket.AF_INET6, rdata))
    # a sensor may also answer SRV/TXT for an instance whose PTR arrived
    # in an earlier packet
    for inst in list(srv_by_inst) + list(txt_by_inst):
        if inst not in {i.lower() for i, _ in insts} and \
                inst in {k.lower() for k in found}:
            for svc in services:
                if inst.endswith(svc.lower()):
                    insts.append((inst, svc))
    for inst, svc in insts:
        key = inst.lower()
        rec = found.get(key)
        if rec is None:
            rec = found[key] = ServiceRecord(instance=inst, service=svc,
                                             source=src)
        tgt = srv_by_inst.get(key)
        if tgt:
            rec.host, rec.port = tgt
            for a in addrs_by_host.get(tgt[0].lower(), []):
                if a not in rec.addresses:
                    rec.addresses.append(a)
        rec.txt.update(txt_by_inst.get(key, {}))
        if not rec.addresses and src and src not in rec.addresses:
            rec.addresses.append(src)


def discover_sensors(timeout: float = 2.0,
                     services=SENSOR_SERVICES,
                     targets: Optional[List[Tuple[str, int]]] = None,
                     interval: float = 0.7) -> List[ServiceRecord]:
    """Send mDNS PTR queries and collect sensor service records for
    `timeout` seconds. Queries go to the 224.0.0.251:5353 multicast
    group; `targets` adds unicast (host, port) destinations (test rigs,
    emulators bound off the multicast port). Repeats the question every
    `interval` seconds like zeroconf's browser."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                         socket.IPPROTO_UDP)
    try:
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        sock.bind(("", 0))
        query = build_query(services)
        dests = [(MDNS_GRP, MDNS_PORT)] + list(targets or [])
        found: Dict[str, ServiceRecord] = {}
        deadline = time.monotonic() + timeout
        next_q = 0.0
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            if now >= next_q:
                for d in dests:
                    try:
                        sock.sendto(query, d)
                    except OSError:
                        pass
                next_q = now + interval
            sock.settimeout(min(deadline, next_q) - now)
            try:
                msg, (src, _port) = sock.recvfrom(9000)
            except socket.timeout:
                continue
            except OSError:
                # transient (e.g. ICMP port-unreachable surfaced for a
                # dead unicast target): keep listening for the rest of
                # the window instead of returning partial results; the
                # sleep bounds the spin if the socket is truly broken
                time.sleep(0.01)
                continue
            _merge_response(msg, src, services, found)
        return list(found.values())
    finally:
        sock.close()


class MDNSResponder:
    """Minimal DNS-SD advertiser: answers PTR questions for `service`
    with PTR + SRV + TXT + A records (the responder half the emulator
    needs; a real deployment would use the OS's mDNS daemon). Joins the
    multicast group when it can; always answers unicast questions sent
    straight to its socket (QU handling)."""

    def __init__(self, instance: str, service: str = SENSOR_SERVICES[0],
                 port: int = 80, address: str = "127.0.0.1",
                 txt: Optional[Dict[str, str]] = None,
                 bind_port: int = MDNS_PORT):
        self.instance_name = f"{instance}.{service}"
        self.service = service
        self.hostname = f"{instance}.local."
        self.port = port
        self.address = address
        self.txt = dict(txt or {})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                                   socket.IPPROTO_UDP)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except (AttributeError, OSError):
            pass
        self._sock.bind(("", bind_port))
        self.bound_port = self._sock.getsockname()[1]
        try:
            mreq = struct.pack("4sl", socket.inet_aton(MDNS_GRP),
                               socket.INADDR_ANY)
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_ADD_MEMBERSHIP, mreq)
        except OSError:
            pass  # unicast-only rigs still work
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="mdns-responder")

    def _answers(self) -> bytes:
        head = struct.pack(">HHHHHH", 0, 0x8400, 0, 3, 0, 1)
        svc = _encode_name(self.service)
        inst = _encode_name(self.instance_name)
        host = _encode_name(self.hostname)
        ptr = svc + struct.pack(">HHIH", TYPE_PTR, CLASS_IN, 4500,
                                len(inst)) + inst
        srv_rd = struct.pack(">HHH", 0, 0, self.port) + host
        srv = inst + struct.pack(">HHIH", TYPE_SRV,
                                 CLASS_IN | CACHE_FLUSH, 120,
                                 len(srv_rd)) + srv_rd
        items = b"".join(
            bytes([len(f"{k}={v}".encode())]) + f"{k}={v}".encode()
            for k, v in self.txt.items()) or b"\x00"
        txt = inst + struct.pack(">HHIH", TYPE_TXT,
                                 CLASS_IN | CACHE_FLUSH, 4500,
                                 len(items)) + items
        a_rd = socket.inet_aton(self.address)
        a = host + struct.pack(">HHIH", TYPE_A, CLASS_IN | CACHE_FLUSH,
                               120, len(a_rd)) + a_rd
        return head + ptr + srv + txt + a

    def _wants_us(self, msg: bytes) -> bool:
        if len(msg) < 12:
            return False
        _, flags, qd, *_rest = struct.unpack_from(">HHHHHH", msg, 0)
        if flags & 0x8000 or qd == 0:
            return False
        off = 12
        try:
            for _ in range(qd):
                name, off = _decode_name(msg, off)
                qtype, _qclass = struct.unpack_from(">HH", msg, off)
                off += 4
                if name.lower() == self.service.lower() and \
                        qtype in (TYPE_PTR, 255):
                    return True
        except (ValueError, struct.error):
            return False
        return False

    def _serve(self):
        resp = self._answers()
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.25)
                msg, addr = self._sock.recvfrom(9000)
            except socket.timeout:
                continue
            except OSError:
                return
            if self._wants_us(msg):
                try:
                    self._sock.sendto(resp, addr)  # QU: answer the asker
                except OSError:
                    pass

    def start(self) -> "MDNSResponder":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
