"""Sensor emulator: serve a recorded/synthesized stream as a live sensor.

Rebuild of the reference replay server (ref: python/src/ouster/cli/plugins/
source_replay.py — flask HTTP control plane + paced UDP republish with
loop/rate). Pure stdlib: ThreadingHTTPServer for the /api/v1 surface our
own SensorHttp client consumes, a sender thread pacing UDP packets by
their timestamps. Doubles as the no-hardware rig for the live sensor
backend (loopback sockets: tests/test_torch_sensor.py and the live phase
of chip_smoke.py drive SensorScanSource with it).
"""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional, Tuple
from urllib.parse import urlparse

from ..core.types import SensorInfo

# (ts_ns, kind, payload) with kind in {"lidar", "imu", "zone"}
PacketItem = Tuple[int, str, bytes]

# -- fw-style config parameter domains ---------------------------------------
# The accept/reject sets a modern (fw 3.x, gen2+) sensor enforces at
# set_config_param time; the reference HIL matrix drives exactly these
# (ref: tests/hil/test_config.py:185-230 signal-multiplier accept
# {0.25,0.5,1,2,3} / reject {0.3,1.2,5,5.5}; types.h:87-97 lidar modes).
_VALID_SIGNAL_MULTIPLIERS = (0.25, 0.5, 1.0, 2.0, 3.0)
_VALID_LIDAR_MODES = {"512x10", "512x20", "1024x10", "1024x20",
                      "2048x10", "4096x5"}
_VALID_TIMESTAMP_MODES = {"TIME_FROM_INTERNAL_OSC",
                          "TIME_FROM_SYNC_PULSE_IN", "TIME_FROM_PTP_1588"}
_VALID_OPERATING_MODES = {"NORMAL", "STANDBY"}
_VALID_NMEA_BAUD = {"BAUD_9600", "BAUD_115200"}
_VALID_POLARITIES = {"ACTIVE_LOW", "ACTIVE_HIGH"}


def _config_param_error(key: str, value) -> Optional[str]:
    """fw-style DOMAIN validation of one staged parameter; returns an
    error string (the fw's 400 body) or None when acceptable. Unknown
    keys pass through verbatim, like the fw's extra_options surface."""
    def _bad():
        return (f"Invalid Configuration Value: cannot set {key} "
                f"to {value!r}")

    if key == "signal_multiplier":
        try:
            v = float(value)
        except (TypeError, ValueError):
            return _bad()
        if not any(abs(v - ok) < 1e-9 for ok in _VALID_SIGNAL_MULTIPLIERS):
            return _bad()
    elif key == "azimuth_window":
        try:
            lo, hi = value
            lo, hi = int(lo), int(hi)
        except (TypeError, ValueError):
            return _bad()
        if not (0 <= lo <= 360000 and 0 <= hi <= 360000):
            return _bad()
    elif key == "lidar_mode":
        if str(value) not in _VALID_LIDAR_MODES:
            return _bad()
    elif key == "timestamp_mode":
        if str(value) not in _VALID_TIMESTAMP_MODES:
            return _bad()
    elif key == "operating_mode" or key == "auto_start_flag":
        mode = value
        if key == "auto_start_flag":  # legacy alias (types.h:164-184)
            mode = "NORMAL" if value in (1, True, "1") else "STANDBY"
        if str(mode) not in _VALID_OPERATING_MODES:
            return _bad()
    elif key in ("udp_port_lidar", "udp_port_imu", "udp_port_zm"):
        try:
            port = int(value)
        except (TypeError, ValueError):
            return _bad()
        if not 0 <= port <= 65535:
            return _bad()
    elif key == "nmea_leap_seconds":
        try:
            if int(value) < 0:
                return _bad()
        except (TypeError, ValueError):
            return _bad()
    elif key == "nmea_baud_rate":
        if str(value) not in _VALID_NMEA_BAUD:
            return _bad()
    elif key in ("nmea_in_polarity", "sync_pulse_in_polarity",
                 "sync_pulse_out_polarity"):
        if str(value) not in _VALID_POLARITIES:
            return _bad()
    elif key == "columns_per_packet":
        try:
            if int(value) not in (16, 32):
                return _bad()
        except (TypeError, ValueError):
            return _bad()
    return None


def _config_cross_error(cfg: dict) -> Optional[str]:
    """fw-style cross-parameter validation run at REINITIALIZE over the
    merged (active <- staged) set: signal multiplier >1 narrows the
    allowed azimuth window (2x -> <=180 deg, 3x -> <=120 deg), the rule
    the reference accept-matrix sidesteps by shrinking the window first
    (ref: tests/hil/test_config.py:193 'make sure azimuth window is
    small enough for everything')."""
    try:
        sm = float(cfg.get("signal_multiplier", 1) or 1)
    except (TypeError, ValueError):
        return None
    if sm <= 1:
        return None
    win = cfg.get("azimuth_window") or (0, 360000)
    try:
        lo, hi = int(win[0]), int(win[1])
    except (TypeError, ValueError, IndexError):
        return None
    size = (hi - lo) if hi >= lo else (360000 - lo + hi)
    limit = int(360000 / sm)
    if size > limit:
        return ("Invalid Configuration: signal_multiplier "
                f"{sm:g} requires azimuth window <= {limit} "
                f"millidegrees, got {size}")
    return None


class SensorEmulator:
    """Serve packets as a fake sensor on loopback/LAN.

    packets_factory is called once per playback pass (so loop=True can
    restart the stream) and must return an iterable of (ts_ns, kind,
    payload_bytes).
    """

    def __init__(self, info: SensorInfo,
                 packets_factory: Callable[[], Iterable[PacketItem]], *,
                 udp_dest: str = "127.0.0.1",
                 lidar_port: Optional[int] = None,
                 imu_port: Optional[int] = None,
                 http_port: int = 0,
                 http_addr: str = "127.0.0.1",
                 rate: float = 1.0,
                 loop: bool = False,
                 upgrade_firmware: bool = True,
                 mdns: bool = False,
                 mdns_port: int = 5353):
        self.info = info
        self._factory = packets_factory
        self._udp_dest = udp_dest
        self.lidar_port = lidar_port if lidar_port is not None else \
            (info.config.udp_port_lidar or 7502)
        self.imu_port = imu_port if imu_port is not None else \
            (info.config.udp_port_imu or 7503)
        self._rate = rate
        self._loop = loop
        self._stop = threading.Event()
        self._upgrade_firmware = upgrade_firmware
        # fw-style config plane (ref: sensor_http_imp.cpp + the fw
        # semantics the reference HIL matrix exercises,
        # tests/hil/test_config.py:26-209): parameters stage with DOMAIN
        # validation at set_config_param time, apply to the active set at
        # reinitialize (with cross-parameter validation), persist via
        # save_config_params, and restart() reloads the persisted set.
        # Every apply bumps init_id like a real reinit.
        self._cfg_lock = threading.Lock()
        self._staged_config: dict = {}
        self._active_config: dict = {}    # seeded in _make_handler
        self._persisted_config: dict = {}
        self._init_id_bump = 0
        self.packets_sent = 0
        self.passes_completed = 0

        self._http = ThreadingHTTPServer((http_addr, http_port),
                                         self._make_handler())
        self.http_port = self._http.server_address[1]
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True)
        self._send_thread = threading.Thread(target=self._send_loop,
                                             daemon=True)
        # optional DNS-SD advertisement, like a real sensor's mDNS
        # announcer (ref: plugins/discover.py service names); answers
        # PTR queries with SRV pointing at the emulator's HTTP port
        self._mdns = None
        if mdns:
            from .mdns import MDNSResponder

            self._mdns = MDNSResponder(
                f"os-{info.sn or 122246000000}", port=self.http_port,
                address=http_addr, bind_port=mdns_port,
                txt={"pn": info.prod_line or "OS-1-128",
                     "sn": str(info.sn or "")})
        self.mdns_port = self._mdns.bound_port if self._mdns else None

    # -- control plane ------------------------------------------------------
    def _apply_staged(self) -> Optional[str]:
        """Reinitialize: cross-validate, staged -> active, bump init_id.
        Returns an error string instead of applying when the merged set
        is inconsistent (fw rejects the reinit, staged params remain)."""
        with self._cfg_lock:
            merged = dict(self._active_config)
            merged.update(self._staged_config)
            err = _config_cross_error(merged)
            if err:
                return err
            self._active_config = merged
            self._staged_config = {}
            self._init_id_bump += 1
        return None

    def _restart(self) -> None:
        """System restart: active reloads from the persisted set (the
        mechanism test_config_persist exercises), staged cleared."""
        with self._cfg_lock:
            self._active_config = dict(self._persisted_config)
            self._staged_config = {}
            self._init_id_bump += 1

    def _make_handler(self):
        meta = json.loads(self.info.to_json_string())
        # the fw's metadata endpoint never carries the client-side
        # 'ouster-sdk' section (ref: tests/hil/test_core.py:243
        # "'ouster-sdk' not in meta_via_requests")
        meta.pop("ouster-sdk", None)
        # advertise the emulator's actual ports
        meta.setdefault("config_params", {})
        meta["config_params"]["udp_port_lidar"] = self.lidar_port
        meta["config_params"]["udp_port_imu"] = self.imu_port
        # seed the fw config plane: active = the metadata's config
        # section + the constructor's data-plane destination; the send
        # loop reads udp_dest/operating_mode back from the ACTIVE set so
        # a reinit with udp_dest="" really stops the stream (the
        # behavior test_config_udp_auto measures)
        self._active_config = dict(meta["config_params"])
        # the constructor's destination is where this rig actually
        # sends; a recorded metadata's capture-time udp_dest (e.g. the
        # original LAN address baked into a real fixture's
        # config_params) is stale for this process and would silently
        # blackhole the stream
        self._active_config["udp_dest"] = self._udp_dest
        if not self._active_config.get("operating_mode"):
            self._active_config["operating_mode"] = "NORMAL"
        self._base_init_id = int(
            meta.get("sensor_info", {}).get("initialization_id", 0) or 0)
        self._persisted_config = dict(self._active_config)
        # SensorHttp.create() probes image_rev and rejects fw < 2.4; the
        # emulator only implements the modern /api/v1 surface, so a missing
        # or pre-2.4 image_rev (common in old recordings) is upgraded to a
        # firmware the served API actually matches
        from ..core.types import Version

        si = meta.setdefault("sensor_info", {})
        fw = Version.from_string(str(si.get("image_rev", "")))
        if self._upgrade_firmware and (
                fw.major < 2 or (fw.major == 2 and fw.minor <= 3)):
            si["image_rev"] = "ousteros-image-prod-aries-v3.2.0"
        emu = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _bytes(self, data: bytes, code=200,
                       ctype="application/zip"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _meta_view(self):
                """Metadata reflecting the LIVE config plane: active
                config_params + the current init_id (a real reinit
                changes initialization_id, which test_config_noop
                checks; everything else must stay byte-identical)."""
                m = dict(meta)
                with emu._cfg_lock:
                    m["config_params"] = dict(emu._active_config)
                    si = dict(m.get("sensor_info", {}))
                    si["initialization_id"] = \
                        emu._base_init_id + emu._init_id_bump
                    m["sensor_info"] = si
                return m

            def do_GET(self):
                u = urlparse(self.path)
                p = u.path.rstrip("/")
                if p == "/api/v1/sensor/metadata":
                    return self._json(self._meta_view())
                if p.startswith("/api/v1/sensor/metadata/"):
                    key = p.rsplit("/", 1)[1]
                    m = self._meta_view()
                    if key in m:
                        return self._json(m[key])
                    return self._json({"error": "unknown section"}, 404)
                if p == "/api/v1/sensor/cmd/get_config_param":
                    which = (u.query.split("=", 1) + [""])[1]
                    with emu._cfg_lock:
                        cfg = dict(emu._active_config)
                        if which == "staged":
                            cfg.update(emu._staged_config)
                    return self._json(cfg)
                if p == "/api/v1/system/firmware":
                    return self._json(
                        {"fw": meta.get("sensor_info", {}).get(
                            "build_rev", "ousteros-image-prod-aries-"
                            "v2.0.0")})
                if p == "/api/v1/system/network":
                    return self._json({"ipv4": {"override": None}})
                if p == "/api/v1/user/data":
                    return self._json(getattr(emu, "_user_data", ""))
                # zone monitor surface (ref: sensor_http_imp.cpp:273-341)
                if p == "/api/v1/zone_monitor/active/zip":
                    return self._bytes(getattr(emu, "_zm_active", b""))
                if p == "/api/v1/zone_monitor/staged/zip":
                    return self._bytes(getattr(emu, "_zm_staged", b""))
                if p == "/api/v1/zone_monitor/live_ids":
                    return self._json(getattr(emu, "_zm_live_ids", []))
                return self._json({"error": "not found"}, 404)

            def do_POST(self):
                u = urlparse(self.path)
                p = u.path.rstrip("/")
                if p == "/api/v1/sensor/cmd/set_config_param":
                    from urllib.parse import unquote

                    args = u.query.split("=", 1)
                    if len(args) == 2 and "+" in args[1]:
                        k, v = args[1].split("+", 1)
                        k, v = unquote(k), unquote(v)
                        try:
                            v = json.loads(v)
                        except ValueError:
                            pass
                        if k == "udp_dest" and v == "@auto":
                            # like the fw: resolve '@auto' to the
                            # requester's address (ref:
                            # sensor_http_imp.cpp auto udp_dest flow)
                            v = self.client_address[0]
                        # fw-style domain validation: an out-of-domain
                        # value is rejected HERE with a 400, which the
                        # client surfaces as a RuntimeError — the
                        # reference reject matrix (sig mult 0.3/1.2/5/
                        # 5.5, test_config.py:217) exercises exactly
                        # this path
                        err = _config_param_error(k, v)
                        if err:
                            return self._json({"error": err}, 400)
                        with emu._cfg_lock:
                            emu._staged_config[k] = v
                    return self._json("set_config_param")
                if p == "/api/v1/sensor/cmd/set_udp_dest_auto":
                    with emu._cfg_lock:
                        emu._staged_config["udp_dest"] = \
                            self.client_address[0]
                    return self._json("ok")
                if p == "/api/v1/sensor/cmd/reinitialize":
                    err = emu._apply_staged()
                    if err:
                        return self._json({"error": err}, 400)
                    return self._json("ok")
                if p == "/api/v1/sensor/cmd/save_config_params":
                    with emu._cfg_lock:
                        emu._persisted_config = dict(emu._active_config)
                    return self._json("ok")
                if p == "/api/v1/system/restart":
                    emu._restart()
                    return self._json("ok")
                if p == "/api/v1/user/data":
                    ln = int(self.headers.get("Content-Length", 0))
                    emu._user_data = json.loads(
                        self.rfile.read(ln).decode() or '""')
                    return self._json("ok")
                # zone monitor: stage zip (applied automatically, like the
                # current fw; ref: sensor_http_imp.cpp:294-299), apply,
                # set live ids
                if p == "/api/v1/zone_monitor/staged/zip":
                    ln = int(self.headers.get("Content-Length", 0))
                    emu._zm_staged = self.rfile.read(ln)
                    emu._zm_active = emu._zm_staged
                    return self._json("ok")
                if p == "/api/v1/zone_monitor/apply":
                    self.rfile.read(
                        int(self.headers.get("Content-Length", 0)))
                    emu._zm_active = getattr(emu, "_zm_staged", b"")
                    return self._json("ok")
                if p == "/api/v1/zone_monitor/live_ids":
                    ln = int(self.headers.get("Content-Length", 0))
                    emu._zm_live_ids = json.loads(
                        self.rfile.read(ln).decode() or "[]")
                    return self._json("ok")
                return self._json({"error": "not found"}, 404)

            do_PUT = do_POST

            def do_DELETE(self):
                p = urlparse(self.path).path.rstrip("/")
                if p == "/api/v1/user/data":
                    emu._user_data = ""
                    return self._json("ok")
                if p == "/api/v1/zone_monitor/staged":
                    emu._zm_staged = b""
                    return self._json("ok")
                return self._json({"error": "not found"}, 404)

        return Handler

    # -- data plane ----------------------------------------------------------
    def _send_loop(self):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # a real sensor's NIC never blocks on the host's send queue; give
        # the loopback sender the same headroom (root bypasses wmem_max)
        from .client import grow_sndbuf

        grow_sndbuf(sock, 64 * 1024 * 1024)
        ports = {"lidar": self.lidar_port, "imu": self.imu_port,
                 "zone": self.info.config.udp_port_zm or 7504}
        # init_id restamping: a real reinit changes the id every
        # subsequent packet carries; the factory pre-baked packets with
        # the ORIGINAL init_id, so after any bump the emulator must
        # rewrite the header field or the client's hard packet-id check
        # (scan_source._make_idcheck) drops every lidar packet
        from ..ops.profiles import make_packet_geometry

        try:
            geom = make_packet_geometry(self.info.format)
            initid_fi = geom.init_id if geom.init_id.bit_size else None
        except Exception:
            initid_fi = None  # LEGACY / exotic formats carry no init_id
        while not self._stop.is_set():
            t0_pkt = None
            t0_wall = time.monotonic()
            for ts, kind, payload in self._factory():
                if self._stop.is_set():
                    return
                if self._rate > 0:
                    if t0_pkt is None:
                        t0_pkt = ts
                    target = t0_wall + (ts - t0_pkt) * 1e-9 / self._rate
                    # sleep in <=1 s slices, re-checking the target and
                    # stop flag, so capture gaps longer than 1 s are
                    # honored instead of compressed
                    while not self._stop.is_set():
                        delay = target - time.monotonic()
                        if delay <= 0:
                            break
                        time.sleep(min(delay, 1.0))
                    if self._stop.is_set():
                        return
                # destination + gating come from the ACTIVE config so a
                # reinit with udp_dest="" (or operating_mode STANDBY)
                # really silences the stream, like the fw
                # (ref: tests/hil/test_config.py test_config_udp_auto:
                # "Checking for no incoming data"); pacing continues so a
                # later re-enable stays time-consistent
                cfg = self._active_config
                dest = cfg.get("udp_dest", self._udp_dest)
                if not dest or cfg.get("operating_mode") == "STANDBY":
                    continue
                bump = self._init_id_bump
                if (bump and kind == "lidar" and initid_fi is not None
                        and len(payload) % 4 == 0):
                    from ..ops.packet_format import read_bits, write_bits

                    words = np.frombuffer(bytearray(payload),
                                          dtype="<u4")
                    old = int(read_bits(words, initid_fi))
                    if old:  # zero means "unstamped": leave it alone
                        write_bits(words, initid_fi,
                                   self._base_init_id + bump)
                        payload = words.tobytes()
                # like udp_dest, the destination PORT follows the
                # ACTIVE config: a client that staged an ephemeral
                # port (udp_port_lidar=0 flow) must start receiving
                # there after the reinit (ref:
                # sensor_packet_source.cpp:344-365 ephemeral ports)
                if kind == "lidar":
                    port = int(cfg.get("udp_port_lidar")
                               or ports["lidar"])
                elif kind == "imu":
                    port = int(cfg.get("udp_port_imu") or ports["imu"])
                else:
                    port = int(cfg.get("udp_port_zm") or ports["zone"])
                sock.sendto(payload, (dest, port))
                self.packets_sent += 1
            self.passes_completed += 1
            if not self._loop:
                break

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SensorEmulator":
        self._http_thread.start()
        self._send_thread.start()
        if self._mdns is not None:
            self._mdns.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for playback to finish (non-loop mode)."""
        self._send_thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._mdns is not None:
            self._mdns.stop()
        self._http.shutdown()
        self._http.server_close()

    def __enter__(self) -> "SensorEmulator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def packets_from_scans(scan_sets: Iterable, info: SensorInfo,
                       sensor_idx: int = 0,
                       frame_period_ns: Optional[int] = None,
                       frame_id_offset: int = 0
                       ) -> Iterable[PacketItem]:
    """Re-packetize a scan stream for the emulator (one sensor).

    frame_id_offset shifts every frame id — looped playback must rotate
    ids each pass or the consumer's batcher (correctly) drops the repeats
    as duplicates."""
    from ..io.save import scan_to_packets
    from ..ops.packet_format import PacketWriter

    fps = getattr(info.format, "fps", 0) or 10
    period = frame_period_ns or int(1e9 / fps)
    pw = PacketWriter(info.format) if frame_id_offset else None
    t = 0
    for ls_set in scan_sets:
        scan = ls_set[sensor_idx] if sensor_idx < len(ls_set) else None
        if scan is None:
            continue
        base = int(scan.first_valid_packet_timestamp()
                   or scan.first_valid_column_timestamp() or t)
        pkts = scan_to_packets(scan, info)
        for i, pkt in enumerate(pkts):
            if pw is not None:
                fid = (max(scan.frame_id, 0) + frame_id_offset) & 0xFFFF
                pw.set_frame_id(pkt, fid)
            yield base + i * period // max(len(pkts), 1), "lidar", \
                pkt.tobytes()
        t = base + period


def looping_packets_factory(scan_sets, info: SensorInfo,
                            sensor_idx: int = 0, id_stride: int = 16):
    """Factory for SensorEmulator(loop=True): each playback pass shifts
    frame ids by id_stride so downstream batchers see fresh frames."""
    sets = list(scan_sets)
    state = {"pass": 0}

    def factory():
        off = state["pass"] * id_stride
        state["pass"] += 1
        return packets_from_scans(sets, info, sensor_idx,
                                  frame_id_offset=off)

    return factory
