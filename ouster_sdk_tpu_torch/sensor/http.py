"""Sensor HTTP control plane.

Rebuild of the reference SensorHttp interface (ref: ouster_sensor/include/
ouster/sensor_http.h:40-505, sensor_http_imp.cpp): firmware-versioned REST
endpoints for metadata, config get/set, intrinsics, reinitialization, user
data, network info and zone-monitor configuration. Uses stdlib http.client
(the reference uses libcurl).
"""

from __future__ import annotations

import http.client
import json
import socket
from typing import Any, Dict, List, Optional, Union

from ..core.types import SensorConfig, Version
from ..core.metadata import sensor_info_from_metadata

SHORT_HTTP_REQUEST_TIMEOUT_SECONDS = 4   # ref: defaults.h:3
LONG_HTTP_REQUEST_TIMEOUT_SECONDS = 40


class SensorHttpError(RuntimeError):
    pass


class SensorHttp:
    """HTTP client for one sensor (ref: sensor_http.h:93-461)."""

    def __init__(self, hostname: str,
                 timeout: float = LONG_HTTP_REQUEST_TIMEOUT_SECONDS):
        self.hostname = hostname
        self._timeout = timeout

    @classmethod
    def create(cls, hostname: str,
               timeout: float = LONG_HTTP_REQUEST_TIMEOUT_SECONDS
               ) -> "SensorHttp":
        """Probe the firmware and return a version-specific client
        (ref: sensor_http.h:475-505, sensor_http.cpp:45-85): image_rev is
        read from sensor_info; fw < 2.4 / unparseable raises; fw 2.4 and
        3.0 get an impl whose user-data API raises; 3.1+ the full
        surface."""
        probe = cls(hostname, timeout)
        try:
            si = probe.sensor_info()
        except Exception as e:
            raise SensorHttpError(
                f"SensorHttp: could not reach sensor {hostname}: {e}"
            ) from e
        fw = Version.from_string(str(si.get("image_rev", "")))
        if fw.major < 2 or (fw.major == 2 and fw.minor <= 3):
            raise SensorHttpError(
                "SensorHttp: firmware version information unavailable or "
                "version not supported. Please upgrade your sensor to FW "
                "2.4 or later.")
        if (fw.major == 2 and fw.minor == 4) or \
                (fw.major == 3 and fw.minor == 0):
            inst: SensorHttp = SensorHttp_2_4_or_3(hostname, timeout)
        else:
            inst = cls(hostname, timeout)
        inst.version = fw
        return inst

    # -- plumbing ---------------------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[Union[str, bytes]] = None,
                 content_type: str = "application/json",
                 timeout: Optional[float] = None) -> bytes:
        conn = http.client.HTTPConnection(
            self.hostname, timeout=timeout or self._timeout)
        if _API_PREFIX:
            # the reference splices the prefix AFTER api/v1
            # (ref: sensor_http_imp.cpp "api/v1/" + api_prefix_ + ...)
            path = path.replace("/api/v1/", f"/api/v1/{_API_PREFIX}/", 1)
        try:
            headers = dict(_API_HEADERS)
            if body is not None:
                headers["Content-Type"] = content_type
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                raise SensorHttpError(
                    f"{method} {path} -> {resp.status}: "
                    f"{data[:200].decode(errors='replace')}")
            return data
        except (socket.timeout, ConnectionError, OSError) as e:
            raise SensorHttpError(f"{method} {path} failed: {e}") from e
        finally:
            conn.close()

    def _get_json(self, path: str, timeout: Optional[float] = None) -> Any:
        return json.loads(self._request("GET", path, timeout=timeout))

    # -- metadata / info --------------------------------------------------
    def metadata(self, timeout: Optional[float] = None) -> str:
        """Full metadata blob (ref: sensor_http.h metadata())."""
        return self._request("GET", "/api/v1/sensor/metadata",
                             timeout=timeout).decode()

    def sensor_info(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/sensor_info")

    def firmware_version(self) -> Version:
        data = self._get_json("/api/v1/system/firmware")
        return Version.from_string(data.get("fw", ""))

    def beam_intrinsics(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/beam_intrinsics")

    def imu_intrinsics(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/imu_intrinsics")

    def lidar_intrinsics(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/lidar_intrinsics")

    def lidar_data_format(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/lidar_data_format")

    def calibration_status(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/metadata/calibration_status")

    # -- config -----------------------------------------------------------
    def active_config_params(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/cmd/get_config_param?args=active")

    def staged_config_params(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/sensor/cmd/get_config_param?args=staged")

    def set_config_param(self, key: str, value: Any) -> None:
        from urllib.parse import quote

        val = json.dumps(value, separators=(",", ":")) \
            if not isinstance(value, str) else value
        self._request(
            "POST",
            "/api/v1/sensor/cmd/set_config_param?args="
            f"{quote(key)}+{quote(val)}")

    def set_udp_dest_auto(self) -> None:
        self._request("POST", "/api/v1/sensor/cmd/set_udp_dest_auto")

    def reinitialize(self) -> None:
        self._request("POST", "/api/v1/sensor/cmd/reinitialize")

    def save_config_params(self) -> None:
        self._request("POST", "/api/v1/sensor/cmd/save_config_params")

    def restart(self) -> None:
        self._request("POST", "/api/v1/system/restart")

    # -- user data (ref: sensor_http.h user_data endpoints) ---------------
    def get_user_data(self) -> str:
        return json.loads(self._request("GET", "/api/v1/user/data"))

    def set_user_data(self, data: str, keep_on_config_delete: bool = True
                      ) -> None:
        policy = "keep_on_config_delete" if keep_on_config_delete \
            else "clear_on_config_delete"
        self._request("PUT",
                      f"/api/v1/user/data?policy={policy}",
                      body=json.dumps(data))

    def delete_user_data(self) -> None:
        self._request("DELETE", "/api/v1/user/data")

    # -- network ----------------------------------------------------------
    def network(self) -> Dict[str, Any]:
        return self._get_json("/api/v1/system/network")

    def set_static_ip(self, ip: str) -> None:
        self._request("PUT", "/api/v1/system/network/ipv4/override",
                      body=json.dumps(ip))

    def delete_static_ip(self) -> None:
        self._request("DELETE", "/api/v1/system/network/ipv4/override")

    def diagnostics_dump(self) -> bytes:
        return self._request("GET", "/api/v1/diagnostics/dump",
                             timeout=LONG_HTTP_REQUEST_TIMEOUT_SECONDS)

    # -- zone monitoring (ref: sensor_http.h:401-461) ---------------------
    # -- zone monitor (fw 3.2+; ref: sensor_http_imp.cpp:273-341) ---------
    _MINIMUM_ZM_VERSION = (3, 2)

    def _require_zm(self) -> None:
        fw = getattr(self, "version", None)
        if fw is not None and (fw.major, fw.minor) < self._MINIMUM_ZM_VERSION:
            raise SensorHttpError(
                "zone monitor only available on fw versions 3.2+")

    def get_zone_monitor_config_zip(self, staged: bool = False) -> bytes:
        self._require_zm()
        which = "staged" if staged else "active"
        return self._request("GET", f"/api/v1/zone_monitor/{which}/zip")

    def set_zone_monitor_config_zip(self, zip_bytes: bytes) -> None:
        self._require_zm()
        self._request("POST", "/api/v1/zone_monitor/staged/zip",
                      body=zip_bytes, content_type="application/zip")

    def delete_zone_monitor_staged_config(self) -> None:
        self._require_zm()
        self._request("DELETE", "/api/v1/zone_monitor/staged")

    def apply_zone_monitor_staged_config_to_active(self) -> None:
        self._require_zm()
        self._request("POST", "/api/v1/zone_monitor/apply", body="")

    def get_zone_monitor_live_ids(self) -> List[int]:
        self._require_zm()
        return self._get_json("/api/v1/zone_monitor/live_ids")

    def set_zone_monitor_live_ids(self, zones: List[int]) -> None:
        self._require_zm()
        self._request("POST", "/api/v1/zone_monitor/live_ids",
                      body=json.dumps(list(zones)))

    # legacy method names kept from round 1
    def get_zone_monitoring_config(self) -> bytes:
        return self.get_zone_monitor_config_zip()

    def set_zone_monitoring_config(self, zip_bytes: bytes) -> None:
        self.set_zone_monitor_config_zip(zip_bytes)

    def delete_zone_monitoring_config(self) -> None:
        self.delete_zone_monitor_staged_config()

    def live_zone_ids(self) -> List[int]:
        return self.get_zone_monitor_live_ids()

    # -- reference binding extras (ref: client.pyi SensorHttp) ------------
    def get_config_params(self, active: bool = True) -> Dict[str, Any]:
        return (self.active_config_params() if active
                else self.staged_config_params())

    @staticmethod
    def get_firmware_version(
            hostname: str,
            timeout: float = SHORT_HTTP_REQUEST_TIMEOUT_SECONDS) -> Version:
        return SensorHttp(hostname, timeout).firmware_version()

    def auto_detected_udp_dest(
            self, timeout: Optional[float] = None,
            original_destination: Optional[str] = None) -> str:
        """The sender IP the sensor would pick for auto udp_dest
        (ref: sensor_http_imp.cpp:182-217): stage udp_dest='@auto'
        without reinit, read the staged value back, then restore the
        original destination."""
        if original_destination is None:
            original_destination = str(
                self.active_config_params().get("udp_dest") or "")
        self.set_config_param("udp_dest", "@auto")
        detected = str(self.staged_config_params().get("udp_dest") or "")
        self.set_config_param("udp_dest", original_destination)
        return detected


class SensorHttp_2_4_or_3(SensorHttp):
    """fw 2.4 / 3.0 surface: no user-data API
    (ref: sensor_http_imp.cpp:399-419 SensorHttpImp_2_4_or_3)."""

    def get_user_data(self) -> str:
        raise SensorHttpError(
            "user data API not supported on this FW version")

    def set_user_data(self, data: str, keep_on_config_delete: bool = True
                      ) -> None:
        raise SensorHttpError(
            "user data API not supported on this FW version")

    def delete_user_data(self) -> None:
        raise SensorHttpError(
            "user data API not supported on this FW version")


def fetch_metadata(hostname: str, timeout: float = 40.0):
    """GET + parse metadata into a SensorInfo (ref: client.cpp:402
    get_metadata with retry)."""
    http_client = SensorHttp.create(hostname, timeout)
    return sensor_info_from_metadata(http_client.metadata())


def build_sensor_config(
    http_client: SensorHttp,
    config: SensorConfig,
    *,
    udp_dest_auto: bool = True,
    persist: bool = False,
) -> None:
    """Stage config params + optional auto udp dest + reinitialize
    (ref: client.cpp:309-396 set_config handshake)."""
    for key, value in config.to_json_dict().items():
        http_client.set_config_param(key, value)
    if udp_dest_auto and config.udp_dest is None:
        http_client.set_udp_dest_auto()
    http_client.reinitialize()
    if persist:
        http_client.save_config_params()


# minimum supported sensor firmware (ref: client.h:50)
MIN_VERSION = Version(1, 12, 0)

# module-level HTTP overrides applied to every SensorHttp request
# (ref: sensor_http.cpp:34-44 set_http_api_headers/set_http_api_prefix)
_API_HEADERS: Dict[str, str] = {}
_API_PREFIX: str = ""


def set_http_api_headers(headers: Dict[str, str]) -> None:
    """Extra headers sent with every sensor HTTP request
    (ref: sensor_http.cpp:34)."""
    _API_HEADERS.clear()
    _API_HEADERS.update(headers)


def set_http_api_prefix(prefix: str) -> None:
    """URL prefix prepended to every sensor API path
    (ref: sensor_http.cpp:40)."""
    global _API_PREFIX
    _API_PREFIX = prefix.strip("/")


def get_config(hostname: str, active: bool = True) -> SensorConfig:
    """Fetch the active (or staged) sensor configuration
    (ref: client.cpp:329-345 get_config binding)."""
    from ..core.metadata import parse_and_validate_config

    http_client = SensorHttp.create(hostname,
                                    SHORT_HTTP_REQUEST_TIMEOUT_SECONDS)
    params = (http_client.active_config_params() if active
              else http_client.staged_config_params())
    config, _ = parse_and_validate_config(params)
    return config


def set_config(hostname: str, config: SensorConfig,
               persist: bool = False, udp_dest_auto: bool = False,
               force_reinit: bool = False) -> None:
    """Stage config params on the sensor, optionally auto-deriving the
    UDP destination and persisting (ref: client.cpp:294-327 set_config
    binding; CONFIG_PERSIST/CONFIG_UDP_DEST_AUTO flag semantics)."""
    if udp_dest_auto and config.udp_dest is not None:
        raise ValueError(
            "UDP_DEST_AUTO option cannot be set together with a "
            "configuration with udp_dest")
    http_client = SensorHttp.create(hostname,
                                    LONG_HTTP_REQUEST_TIMEOUT_SECONDS)
    build_sensor_config(http_client, config,
                        udp_dest_auto=udp_dest_auto, persist=persist)
