"""PcapScanSource: the ScanSource over a pcap file, decoded on the device.

Rebuild of the reference pcap scan source and frame index
(ref: ouster_pcap/src/pcap_scan_source.cpp, indexed_pcap_reader.h:28-101).

Routing: when a source iterates, device_engine.device_decode_enabled()
(OUSTER_SDK_TPU_DEVICE_DECODE) chooses between the device engine (1 or
unset: one DeviceScanIterator a sensor on `device`, CUDA unless named) and
the numpy ScanBatcher the caller asked for with 0. Two static rules keep a
capture on the batcher whatever the variable says, as in the reference
design: raw_headers (the packet FOOTER bytes are not staged) and sensors
whose streams collide on (packet size, port), which only the batcher's
per-packet classification can attribute. Nothing else moves a source off
the engine: a failure there raises.
"""

from __future__ import annotations

import heapq
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.batcher import ScanBatcher
from ..core.error_handler import Severity
from ..core.lidar_scan import LidarScan, resolve_field_types
from ..core.types import SensorInfo, UDPProfileIMU
from ..ops.packet_format import PacketFormat
from . import device_engine as de
from .pcap_source import PcapPacketSource
from .sources import (
    IoType,
    LidarScanSet,
    ScanSource,
    ScanSourceOptions,
    collate_scans,
    populate_extrinsics,
    register_packet_source,
    register_scan_source,
)


class PcapScanSource(ScanSource):
    """Batches a pcap's packets into per-sensor scans; builds a frame index
    for random access when index=True (ref: indexed_pcap_reader.h:28-79).
    `device` is where the engine decodes (None: CUDA, an error at
    iteration without a GPU)."""

    def __init__(self, path: str, *,
                 sensor_infos: Optional[List[SensorInfo]] = None,
                 meta: Optional[List[str]] = None,
                 soft_id_check: bool = False,
                 index: bool = False,
                 extrinsics=None, extrinsics_file=None,
                 field_names: Optional[List[str]] = None,
                 raw_headers: bool = False,
                 raw_fields: bool = False,
                 error_handler=None,
                 device=None):
        self._path = path
        self._packets = PcapPacketSource(
            path, metadata_paths=meta, sensor_infos=sensor_infos,
            soft_id_check=soft_id_check, error_handler=error_handler)
        infos = self._packets.sensor_info
        populate_extrinsics(infos, extrinsics, extrinsics_file)
        super().__init__(infos)
        self._field_names = field_names
        self._raw_headers = raw_headers
        self._raw_fields = raw_fields
        self._device = device
        self._index: Optional[List[List[int]]] = None
        self._lazy: Optional[de.DeviceScanIndex] = None
        self._scan_cache: Optional[List[List[LidarScan]]] = None
        self._set_cache: Optional[List[List[Optional[LidarScan]]]] = None
        if index:
            self._build_index()

    @property
    def is_indexed(self) -> bool:
        return self._index is not None

    # -- routing -------------------------------------------------------------
    def _device_route(self) -> bool:
        """Whether this iteration decodes on the engine: the policy, then
        the static rules (eligibility of every sensor, no colliding
        streams)."""
        return (de.device_decode_enabled()
                and all(de.supports_device_decode(
                    info, self._field_names, self._raw_headers,
                    self._raw_fields) for info in self.sensor_info)
                and not self._device_ambiguous())

    def _device_scan_iterator(self, info: SensorInfo
                              ) -> de.DeviceScanIterator:
        return de.DeviceScanIterator(
            self._path, info, field_names=self._field_names,
            soft_id_check=self._packets._soft_id_check,
            field_types=self._field_types(info),
            raw_fields=self._raw_fields, device=self._device)

    def _device_iter(self) -> Iterator[Tuple[int, LidarScan]]:
        """The engine route: one DeviceScanIterator a sensor, merged by
        release position (the datagram index at which the batcher would
        have yielded each scan), so the interleaved yield order is the
        packet-order batcher's; scans left open at the end of the capture
        flush in sensor order (the same sentinel, ties broken by sensor
        index). The id-error report comes after the merge, once."""
        if len(self.sensor_info) == 1 and self._lazy is not None:
            its = [self._lazy._it]       # the index's staged capture
        else:
            its = [self._device_scan_iterator(info)
                   for info in self.sensor_info]
        streams = [it.iter_released() for it in its]
        heads = []
        for si, st in enumerate(streams):
            nxt = next(st, None)
            if nxt is not None:
                heads.append((nxt[0], si, nxt[1]))
        heapq.heapify(heads)
        while heads:
            _, si, scan = heapq.heappop(heads)
            yield si, scan
            nxt = next(streams[si], None)
            if nxt is not None:
                heapq.heappush(heads, (nxt[0], si, nxt[1]))
        errs = sum(it.id_error_count for it in its)
        if errs:
            self._packets.id_error_count = errs
            self._packets._error_handler(
                Severity.WARNING,
                f"{self._path}: {errs} lidar packets "
                f"with mismatched init_id/serial"
                + (" (passed through: soft_id_check)"
                   if self._packets._soft_id_check else " (dropped)"))

    def _device_ambiguous(self) -> bool:
        """Whether any two sensors' streams collide on (packet size,
        effective port): the numpy route disambiguates such datagrams
        per packet by init_id/serial (pcap_source.py _classify), which
        the independent per-sensor device readers cannot replicate, so
        those captures stay on the batcher. Port 0 is a wildcard."""

        def collide(pa, pb):
            return pa == 0 or pb == 0 or pa == pb

        infos = self.sensor_info
        pfs = [PacketFormat.from_info(i) for i in infos]

        def scan_affecting_imu(k):
            # an imu packet misrouted between sensors only changes scans
            # when a sensor's profile batches imu into its scans
            return (infos[k].format.udp_profile_imu
                    == UDPProfileIMU.ACCEL32_GYRO32_NMEA)

        def scan_affecting_zone(k):
            return bool(getattr(infos[k].format,
                                "zone_monitoring_enabled", False))

        for i in range(len(infos)):
            for j in range(i + 1, len(infos)):
                ci, cj = infos[i].config, infos[j].config
                if pfs[i].lidar_packet_size == pfs[j].lidar_packet_size \
                        and collide(ci.udp_port_lidar or 0,
                                    cj.udp_port_lidar or 0):
                    return True
                for sz_i, sz_j, pi, pj, affects in (
                        (pfs[i].imu_packet_size, pfs[j].imu_packet_size,
                         ci.udp_port_imu or 0, cj.udp_port_imu or 0,
                         scan_affecting_imu(i) or scan_affecting_imu(j)),
                        (pfs[i].zone_packet_size, pfs[j].zone_packet_size,
                         ci.udp_port_zm or 0, cj.udp_port_zm or 0,
                         scan_affecting_zone(i) or scan_affecting_zone(j))):
                    if affects and sz_i and sz_i == sz_j \
                            and collide(pi, pj):
                        return True
        # cross-type: a datagram matching sensor i's lidar stream AND any
        # sensor's aux stream is resolved by _classify's candidate order
        # in the numpy route; the device readers' independent masks would
        # double-assign it
        for i in range(len(infos)):
            for j in range(len(infos)):
                ci, cj = infos[i].config, infos[j].config
                ls, lp = pfs[i].lidar_packet_size, ci.udp_port_lidar or 0
                if pfs[j].imu_packet_size == ls and \
                        collide(lp, cj.udp_port_imu or 0):
                    return True
                if pfs[j].zone_packet_size == ls and \
                        collide(lp, cj.udp_port_zm or 0):
                    return True
        # aux-vs-aux cross-kind: a datagram matching sensor i's imu
        # stream AND sensor j's zone stream (j may be i; _classify's elif
        # chain classifies it once, as imu) would be double-assigned by
        # the device route's independent strict per-kind masks. Only
        # streams the device readers route matter: imu when the profile
        # batches NMEA into scans, zone when monitoring is on.
        for i in range(len(infos)):
            if not scan_affecting_imu(i) or not pfs[i].imu_packet_size:
                continue
            for j in range(len(infos)):
                if not scan_affecting_zone(j):
                    continue
                if pfs[i].imu_packet_size == pfs[j].zone_packet_size and \
                        collide(infos[i].config.udp_port_imu or 0,
                                infos[j].config.udp_port_zm or 0):
                    return True
        return False

    def _iter_scans(self) -> Iterator[Tuple[int, LidarScan]]:
        if self._device_route():
            yield from self._device_iter()
            return
        batchers = [ScanBatcher(i) for i in self.sensor_info]
        scans = [LidarScan(i, field_types=self._field_types(i))
                 for i in self.sensor_info]
        for idx, packet in self._packets:
            if batchers[idx](packet, scans[idx]):
                out = scans[idx]
                scans[idx] = LidarScan(
                    self.sensor_info[idx],
                    field_types=self._field_types(self.sensor_info[idx]))
                yield idx, out
        # flush partials (the reference emits incomplete trailing scans)
        for idx, s in enumerate(scans):
            if s.frame_id != -1 and np.any(s.status & 1):
                yield idx, s

    def _field_types(self, info: SensorInfo):
        """The profile's fields, narrowed to field_names, with RAW_HEADERS
        (packed header and footer bytes a column) and RAW32_WORDk (the raw
        words of each pixel block) when asked for
        (ref: open_source.h raw_headers / raw_fields)."""
        return resolve_field_types(info, raw_headers=self._raw_headers,
                                   raw_fields=self._raw_fields,
                                   field_names=self._field_names)[0]

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        return collate_scans(self._iter_scans(), len(self.sensor_info))

    # -- indexing ----------------------------------------------------------
    def _build_index(self) -> None:
        """Build the frame index for random access. A single sensor on the
        engine route gets the LAZY index: the admission replay's per-frame
        datagram groups are the index, and `source[i]` stages and decodes
        just that frame on demand (like the reference's file-offset
        seek-and-rebatch, indexed_pcap_reader.h:28-101). Several sensors,
        or the batcher route, materialize the scans (collation needs the
        whole stream). Indexed access equals iteration bit for bit: both
        walk the same instances (lazy) or the same collation
        (materialized). The route is decided here, once."""
        if len(self.sensor_info) == 1 and self._device_route():
            self._lazy = de.DeviceScanIndex(
                self._device_scan_iterator(self.sensor_info[0]))
            self._index = [self._lazy.frame_ids]
            return
        sets = [list(ls_set) for ls_set in collate_scans(
            self._iter_scans(), len(self.sensor_info))]
        self._set_cache = sets
        cache: List[List[LidarScan]] = [[] for _ in self.sensor_info]
        for s_list in sets:
            for k, sc in enumerate(s_list):
                if sc is not None:
                    cache[k].append(sc)
        self._scan_cache = cache
        self._index = [[s.frame_id for s in lst] for lst in cache]

    def __len__(self) -> int:
        if self._lazy is not None:
            return len(self._lazy)
        if self._scan_cache is None:
            raise TypeError("Cannot get the length of an unindexed scan "
                            "source.")
        return len(self._set_cache)

    def __getitem__(self, i) -> LidarScanSet:
        if self._lazy is None and self._scan_cache is None:
            raise TypeError("source is not indexed")
        n = len(self)
        if isinstance(i, slice):
            if i.step is not None and i.step <= 0:
                raise ValueError("scan sources require a positive step")
            return [self[j] for j in range(*i.indices(n))]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self._lazy is not None:
            return LidarScanSet([self._lazy.scan_at(i)])
        return LidarScanSet(self._set_cache[i])

    @property
    def scans_num(self) -> List[int]:
        if self._lazy is not None:
            return [len(self._lazy)]
        if self._scan_cache is None:
            raise RuntimeError(
                "Cannot perform 'scans_num' on an unindexed source. "
                "Specify the index parameter as true when creating the "
                "source to produce an index.")
        return [len(c) for c in self._scan_cache]

    def individual_index(self) -> List[List[int]]:
        """Per-sensor set positions; the lazy index is single-sensor with
        one scan a set, so this is the identity, answered without decoding
        the capture (the base class's loop reads `self[i]`)."""
        if self._lazy is not None:
            return [list(range(len(self._lazy)))]
        return super().individual_index()

    def full_index(self) -> List[List[Tuple[int, int]]]:
        """Per-sensor (timestamp, scan_index) pairs
        (ref: indexed_pcap_reader.h:28-101 frame index)."""
        if self._lazy is not None:
            return [[(ts, i)
                     for i, ts in enumerate(self._lazy.timestamps())]]
        if self._scan_cache is None:
            raise TypeError("source is not indexed")
        return [[(int(s.first_valid_packet_timestamp()
                      or s.first_valid_column_timestamp()), i)
                 for i, s in enumerate(lst)]
                for lst in self._scan_cache]

    def close(self) -> None:
        self._packets.close()


@register_scan_source(IoType.PCAP)
def _build_pcap_scan_source(source: str, opts: ScanSourceOptions):
    return PcapScanSource(
        source,
        sensor_infos=opts.take("sensor_info"),
        meta=opts.take("meta"),
        soft_id_check=bool(opts.take("soft_id_check")),
        index=bool(opts.take("index")),
        extrinsics=opts.take("extrinsics"),
        extrinsics_file=opts.take("extrinsics_file"),
        field_names=opts.take("field_names"),
        raw_headers=bool(opts.take("raw_headers")),
        raw_fields=bool(opts.take("raw_fields")),
        error_handler=opts.take("error_handler"),
        device=opts.take("device"),
    )


@register_packet_source(IoType.PCAP)
def _build_pcap_packet_source(source: str, opts: ScanSourceOptions):
    return PcapPacketSource(
        source,
        metadata_paths=opts.take("meta"),
        sensor_infos=opts.take("sensor_info"),
        soft_id_check=bool(opts.take("soft_id_check")),
        error_handler=opts.take("error_handler"),
    )
