"""ScanSource / PacketSource abstractions, collation and open_source registry.

Rebuild of the reference source layer (ref: ouster_client/include/ouster/
scan_source.h:48-194, open_source.h:26-226, scan_source_utils.h:22-90,
io_type.h:17-25). Sources are Python iterables; the registry maps an IoType
to a constructor so backends self-register exactly like the reference's
static registry (ref: impl/open_source_impl.h:98-122).

The backends: PCAP (io/pcap_scan_source.py), whose scans decode on the
device engine, OSF (io/osf_source.py), whose scans decode on the host and
get their XYZ projected on the device, SENSOR
(sensor/sensor_scan_source.py), a live sensor's UDP streams batched into
scans decoded on the device, BAG and MCAP (io/bag_source.py: ROS1,
rosbag2 and MCAP bags batched on the host) and PLY, PCD, CSV and LAS
(io/cloud_source.py: one scan built from a point-cloud file on the host).
PNG and STL are recognized and refused with "Unhandled source type". The
options carry `device` beside the reference's: where the engine decodes
or the projector runs (CUDA unless named); the host backends refuse it.
ScanSource.mask/clip/reduce chain the derived views of io/derived.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..utils import profiling


class IoType(Enum):
    """(ref: io_type.h:17-25)"""

    OSF = "OSF"
    PCAP = "PCAP"
    SENSOR = "SENSOR"
    BAG = "BAG"
    CSV = "CSV"
    PLY = "PLY"
    PCD = "PCD"
    LAS = "LAS"
    MCAP = "MCAP"
    PNG = "PNG"
    STL = "STL"


_EXTENSIONS = {
    ".osf": IoType.OSF,
    ".pcap": IoType.PCAP,
    ".bag": IoType.BAG,
    ".mcap": IoType.MCAP,
    ".db3": IoType.BAG,
    ".png": IoType.PNG,
    ".stl": IoType.STL,
    ".csv": IoType.CSV,
    ".ply": IoType.PLY,
    ".pcd": IoType.PCD,
    ".las": IoType.LAS,
}


_EXT_ERROR = ("Could not detect IO type from file extension. Expecting "
              "one of .osf, .pcap, .bag, .mcap, .csv, .png, .ply, .pcd, "
              ".stl or .las.")


def is_host(name: str) -> bool:
    """Whether the string resolves as a host (ref: compat_ops.cpp:65-80
    is_host — getaddrinfo probe). An optional ':port' suffix (the
    emulator rig's http override) is stripped first."""
    import socket as _socket

    host = name
    if host.count(":") == 1:
        h, p = host.split(":")
        if p.isdigit():
            host = h
    try:
        _socket.getaddrinfo(host, None)
        return True
    except OSError:
        return False


def io_type(source: str) -> IoType:
    """URL/extension -> IoType (ref: io_type.cpp:123-152). A directory is
    a ROS bag when it carries a .bag suffix or contains .db3 storage."""
    if not source:
        raise ValueError("source url is empty")
    ext = os.path.splitext(source)[1].lower()
    if os.path.isdir(source):
        import glob

        if ext == ".bag" or glob.glob(os.path.join(source, "*.db3")):
            return IoType.BAG
        raise ValueError(
            f"Source type of '{source}' not found. Was a directory and "
            "was not a ROSbag.")
    if os.path.exists(source):
        if ext in _EXTENSIONS:
            return _EXTENSIONS[ext]
        raise ValueError(_EXT_ERROR)
    if ext in _EXTENSIONS:
        # a named-but-missing file of a known type: let the backend
        # surface the IO error for its own format
        return _EXTENSIONS[ext]
    if is_host(source):
        return IoType.SENSOR
    raise ValueError(f"Source type of '{source}' not found. File or "
                     "host not found.")


#: Reference export name for the IoType enum (ref: core/io_types.py:2).
OusterIoType = IoType


def io_type_from_extension(filename: str) -> IoType:
    """Filename extension -> IoType, no filesystem checks
    (ref: io_type.cpp:82-121)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext in _EXTENSIONS:
        return _EXTENSIONS[ext]
    raise ValueError(_EXT_ERROR)


def extension_from_io_type(t: IoType) -> Optional[str]:
    """IoType -> canonical extension incl. the dot, or None for
    non-file types (ref: io_type.cpp:18-45)."""
    for ext, typ in _EXTENSIONS.items():
        if typ is t and ext != ".db3":
            return ext
    return None


class SourceURLException(Exception):
    """Wraps a backend construction failure with the offending URL(s)
    (ref: sdk/open_source.py:39-57)."""

    def __init__(self, sub_exception, url, packet: bool = False):
        self._sub_exception = sub_exception
        self._url = url
        self._packet = packet

    def __str__(self) -> str:
        kind = "packet_source" if self._packet else "scan_source"
        return (f"Failed to create {kind} for url {self._url}\n"
                f"more details: {self._sub_exception}")

    def get_sub_exception(self):
        return self._sub_exception

    def get_url(self):
        return self._url


class PacketSource:
    """Iterable of (sensor_idx, Packet) with metadata — the abstract
    packet-source surface (ref: _bindings client.pyi PacketSource,
    core/core.py PacketSource). Concrete backends (pcap / sensor / bag)
    duck-type this; subclassing is optional."""

    @property
    def sensor_info(self) -> List[SensorInfo]:
        raise NotImplementedError

    @property
    def is_live(self) -> bool:
        return False

    def __iter__(self):
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "PacketSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LidarScanSet:
    """One collated time slice: at most one scan per sensor
    (ref: lidar_scan_set.h:213)."""

    def __init__(self, scans: Optional[Sequence[Optional[LidarScan]]]
                 = None):
        # empty overload (ref: client.pyi LidarScanSet.__init__())
        self._scans: List[Optional[LidarScan]] = \
            list(scans) if scans is not None else []
        # set-level fields (ref: lidar_scan_set.h add_field/field) — extra
        # arrays attached to the collation itself, not to any one scan
        self._fields: Dict[str, np.ndarray] = {}

    @property
    def fields(self) -> List[str]:
        return sorted(self._fields)

    def field(self, name: str) -> np.ndarray:
        return self._fields[name]

    def add_field(self, name: str, arr, shape=None) -> np.ndarray:
        # overloads (ref: client.pyi LidarScanSet.add_field): (name, array)
        # or (name, dtype, shape=())
        if isinstance(arr, type) or isinstance(arr, np.dtype):
            arr = np.zeros(tuple(shape or ()), dtype=arr)
        self._fields[name] = np.asarray(arr)
        return self._fields[name]

    def del_field(self, name: str) -> None:
        del self._fields[name]

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def __len__(self) -> int:
        return len(self._scans)

    def __getitem__(self, i: int) -> Optional[LidarScan]:
        return self._scans[i]

    def __setitem__(self, i: int, value: Optional[LidarScan]) -> None:
        # (ref: client.pyi LidarScanSet.__setitem__)
        self._scans[i] = value

    def __iter__(self) -> Iterator[Optional[LidarScan]]:
        return iter(self._scans)

    def valid(self) -> List[LidarScan]:
        return [s for s in self._scans if s is not None]

    def combined_timestamp(self) -> int:
        ts = [s.first_valid_column_timestamp() for s in self.valid()]
        return min(ts) if ts else 0

    def __repr__(self) -> str:
        return f"LidarScanSet({self._scans!r})"


class ScanSource:
    """Iterable of LidarScanSet (ref: scan_source.h:48-194).

    Subclasses implement _iter_sets(); indexed backends also implement
    __len__/__getitem__.
    """

    def __init__(self, sensor_infos: List[SensorInfo]):
        self._sensor_infos = sensor_infos

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return self._sensor_infos

    @property
    def is_live(self) -> bool:
        return False

    @property
    def is_indexed(self) -> bool:
        return False

    def __iter__(self) -> Iterator[LidarScanSet]:
        return self._iter_sets()

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        raise NotImplementedError

    def size_hint(self) -> int:
        """Best-effort scan-set count without requiring an index
        (ref: scan_source.h size_hint); 0 when unknown/live."""
        try:
            return len(self)  # type: ignore[arg-type]
        except TypeError:
            return 0

    def individual_index(self) -> List[List[int]]:
        """Per-sensor global positions: for each sensor, the scan-set
        indices at which that sensor has a scan
        (ref: scan_source.h individual_index). Requires an index."""
        if not self.is_indexed:
            raise TypeError("source is not indexed")
        out: List[List[int]] = [[] for _ in self.sensor_info]
        for i in range(len(self)):  # type: ignore[arg-type]
            for s_idx, scan in enumerate(self[i]):  # type: ignore[index]
                if scan is not None:
                    out[s_idx].append(i)
        return out

    @property
    def scans_num(self) -> List[int]:
        """Number of scans per sensor — a property, like the reference
        binding (ref: client.pyi:4343 ScanSource.scans_num;
        python/tests/test_open_source.py:96-104 unindexed error)."""
        if not self.is_indexed:
            raise RuntimeError(
                "Cannot perform 'scans_num' on an unindexed source. "
                "Specify the index parameter as true when creating the "
                "source to produce an index.")
        out = [0] * len(self.sensor_info)
        for i in range(len(self)):  # type: ignore[arg-type]
            for s_idx, scan in enumerate(self[i]):  # type: ignore[index]
                if scan is not None:
                    out[s_idx] += 1
        return out

    def single(self, sensor_idx: int = 0) -> "SingleScanSource":
        """Iterate one sensor's scans (ref: Singler,
        scan_source_utils.h:90)."""
        return SingleScanSource(self, sensor_idx)

    # -- chaining derived views (ref: client.pyi:4402-4415) -----------------
    def mask(self, fields, masks) -> "ScanSource":
        """Zero the given fields outside per-sensor destaggered masks
        (ref: client.pyi:4402 ScanSource.mask)."""
        from .derived import MaskedScanSource

        return MaskedScanSource(self, fields, masks)

    def clip(self, fields, lower, upper) -> "ScanSource":
        """Clamp field values to [lower, upper], zeroing outside
        (ref: client.pyi:4405 ScanSource.clip)."""
        from .derived import ClippedScanSource

        return ClippedScanSource(self, fields, lower, upper)

    def reduce(self, beams) -> "ScanSource":
        """Reduce beam count per sensor
        (ref: client.pyi:4412 ScanSource.reduce)."""
        from .derived import ReducedScanSource

        return ReducedScanSource(self, beams)

    def close(self) -> None:
        pass

    def __enter__(self) -> "ScanSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- optional random access -------------------------------------------
    def __len__(self) -> int:
        # (ref: python/tests/test_open_source.py:106-113)
        raise TypeError("Cannot get the length of an unindexed scan "
                        "source.")

    def __getitem__(self, i) -> LidarScanSet:
        raise TypeError("source is not indexed")


class SingleScanSource:
    """Single-sensor view over a ScanSource."""

    def __init__(self, parent: ScanSource, sensor_idx: int):
        self._parent = parent
        self._idx = sensor_idx
        self._index: Optional[List[int]] = None

    @property
    def sensor_info(self) -> List[SensorInfo]:
        return [self._parent.sensor_info[self._idx]]

    @property
    def metadata(self) -> SensorInfo:
        return self._parent.sensor_info[self._idx]

    def __iter__(self) -> Iterator[LidarScan]:
        for ls_set in self._parent:
            s = ls_set[self._idx]
            if s is not None:
                yield s

    @property
    def is_live(self) -> bool:
        return self._parent.is_live

    @property
    def is_indexed(self) -> bool:
        return self._parent.is_indexed

    def _sensor_index(self) -> List[int]:
        """Scan-set positions at which THIS sensor has a scan
        (ref: Singler's per-sensor index, scan_source_utils.cpp)."""
        if self._index is None:
            self._index = \
                self._parent.individual_index()[self._idx]
        return self._index

    def __len__(self) -> int:
        """Number of this sensor's scans (ref: Singler length —
        per-sensor, not the parent's set count)."""
        return len(self._sensor_index())

    def __getitem__(self, i):
        """i-th scan OF THIS SENSOR on an indexed parent
        (ref: scan_source.cpp Singler indexing)."""
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        idx = self._sensor_index()
        if i < 0:
            i += len(idx)
        if not 0 <= i < len(idx):
            raise IndexError(f"scan {i} out of range for sensor "
                             f"{self._idx} ({len(idx)} scans)")
        return self._parent[idx[i]][self._idx]

    def close(self) -> None:
        self._parent.close()


DEFAULT_COLLATION_DT_NS = 210_000_000  # 210 ms (ref: scan_source_utils.h:22)


def _collation_ts(scan: LidarScan) -> int:
    return scan.first_valid_column_timestamp() or \
        scan.first_valid_packet_timestamp()


def collate_scans(
    scans: Iterator, n_sensors: int,
    dt_ns: int = DEFAULT_COLLATION_DT_NS,
) -> Iterator[LidarScanSet]:
    """Time-collate an iterator of (sensor_idx, LidarScan) into
    LidarScanSets, cutting a set when dt_ns elapses or a sensor repeats
    (ref: scan_source_utils.cpp Collator).

    A set's first scan is only kept; its time is read when a second scan
    comes. The collator's work on each later scan (the times read, the
    cut, the set built) and on the last set is the tracer's span
    `source.collate`: one a set of two sensors. The pull of the next scan
    lies outside it."""
    pending: List[Optional[LidarScan]] = [None] * n_sensors
    start: Optional[LidarScan] = None
    start_ts: Optional[int] = None

    for idx, scan in scans:
        if start is None:
            start = pending[idx] = scan
            if n_sensors == 1:
                yield LidarScanSet(pending)
                pending, start = [None], None
            continue
        done = None
        with profiling.span("source.collate"):
            if start_ts is None:
                start_ts = _collation_ts(start)
            ts = _collation_ts(scan)
            if pending[idx] is not None or (ts - start_ts) > dt_ns:
                done = LidarScanSet(pending)
                pending = [None] * n_sensors
                start, start_ts = scan, ts
            pending[idx] = scan
            if all(s is not None for s in pending):
                done = LidarScanSet(pending)
                pending = [None] * n_sensors
                start = start_ts = None
        if done is not None:
            yield done

    if any(s is not None for s in pending):
        with profiling.span("source.collate"):
            last = LidarScanSet(pending)
        yield last


class Slicer(ScanSource):
    """ScanSource view applying [start:stop:step] forward-slice
    semantics (ref: scan_source.cpp Slicer, util/forward_slicer.py)."""

    def __init__(self, source: ScanSource, key: slice):
        super().__init__(source.sensor_info)
        if (key.step or 1) <= 0:
            raise ValueError("Slicer requires a positive step")
        if (key.start or 0) < 0 or (key.stop is not None
                                    and key.stop < 0):
            raise ValueError("Slicer requires non-negative bounds")
        self._source = source
        self._key = key

    @property
    def is_indexed(self) -> bool:
        return self._source.is_indexed

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        import itertools

        return itertools.islice(iter(self._source), self._key.start,
                                self._key.stop, self._key.step)

    def __len__(self) -> int:
        return len(range(*self._key.indices(len(self._source))))

    def __getitem__(self, i):
        rng = range(*self._key.indices(len(self._source)))
        return self._source[rng[i]]

    def close(self) -> None:
        self._source.close()


class Collator(ScanSource):
    """ScanSource wrapper that time-collates an uncollated source
    (ref: scan_source_utils.h Collator; python binding
    processing/scan_source.cpp "collate")."""

    def __init__(self, source: ScanSource,
                 dt_ns: int = DEFAULT_COLLATION_DT_NS):
        super().__init__(source.sensor_info)
        self._source = source
        self._dt = dt_ns

    @property
    def is_live(self) -> bool:
        return self._source.is_live

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        def pairs():
            for ls_set in self._source:
                for k, s in enumerate(ls_set):
                    if s is not None:
                        yield k, s

        return collate_scans(pairs(), len(self.sensor_info), self._dt)

    def close(self) -> None:
        self._source.close()


#: Reference binding class name for the single-sensor view
#: (ref: scan_source.cpp Singler).
Singler = SingleScanSource


def collate(source: ScanSource,
            dt: int = DEFAULT_COLLATION_DT_NS) -> Collator:
    """Collate scans from a scan source (ref: scan_source.cpp
    "collate" binding; dt in nanoseconds, default 210 ms)."""
    return Collator(source, dt)


class MultiScanSource(ScanSource):
    """Merge several non-collated scan sources into one stream ordered
    by first valid packet timestamp, deduplicating identical sensors
    (ref: multi_scan_source.cpp:193-233 constructor,
    :140-170 earliest-timestamp merge)."""

    def __init__(self, sources: Sequence[ScanSource]):
        infos: List[SensorInfo] = []
        self._maps: List[List[int]] = []  # per source: local -> global idx
        for src in sources:
            m = []
            for info in src.sensor_info:
                for gi, existing in enumerate(infos):
                    if existing == info:
                        m.append(gi)
                        break
                else:
                    m.append(len(infos))
                    infos.append(info)
            self._maps.append(m)
        super().__init__(infos)
        self._sources = list(sources)

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        iters = [iter(s) for s in self._sources]
        heads: Dict[int, LidarScanSet] = {}
        for i, it in enumerate(iters):
            v = next(it, None)
            if v is not None:
                heads[i] = v
        n = len(self.sensor_info)

        def _ts(ls_set: LidarScanSet) -> int:
            for s in ls_set:
                if s is not None:
                    return s.first_valid_packet_timestamp()
            return 2 ** 64 - 1

        while heads:
            i = min(heads, key=lambda k: _ts(heads[k]))
            ls_set = heads[i]
            if len(ls_set.valid()) > 1:
                raise RuntimeError(
                    "MultiScanSource can only be used with non-collated "
                    "sources.")
            out: List[Optional[LidarScan]] = [None] * n
            for k, s in enumerate(ls_set):
                if s is not None:
                    out[self._maps[i][k]] = s
            v = next(iters[i], None)
            if v is None:
                del heads[i]
            else:
                heads[i] = v
            yield LidarScanSet(out)

    def size_hint(self) -> int:
        return sum(s.size_hint() for s in self._sources)

    def close(self) -> None:
        for s in self._sources:
            s.close()


# ---------------------------------------------------------------------------
# Options + registry (ref: open_source.h:26-100, impl/open_source_impl.h)
# ---------------------------------------------------------------------------

class _Unused:
    pass


@dataclass
class ScanSourceOptions:
    """Construction options with check-on-unused semantics
    (ref: open_source.h:26-100, open_source.cpp:281-318): every option a
    backend does not consume raises, so callers learn immediately when an
    option is meaningless for a given backend."""

    extrinsics_file: Optional[str] = None
    extrinsics: Optional[List[np.ndarray]] = None
    field_names: Optional[List[str]] = None
    soft_id_check: Optional[bool] = None
    index: Optional[bool] = None
    meta: Optional[List[str]] = None
    lidar_port: Optional[int] = None
    imu_port: Optional[int] = None
    do_not_reinitialize: Optional[bool] = None
    no_auto_udp_dest: Optional[bool] = None
    timeout: Optional[float] = None
    config_timeout: Optional[float] = None
    queue_size: Optional[int] = None
    sensor_info: Optional[List[SensorInfo]] = None
    sensor_config: Optional[Any] = None
    raw_headers: Optional[bool] = None
    raw_fields: Optional[bool] = None
    error_handler: Optional[Callable] = None
    device: Optional[str] = None

    def __post_init__(self) -> None:
        self._consumed: set = set()

    def take(self, name: str):
        self._consumed.add(name)
        return getattr(self, name)

    def check(self, context: str) -> None:
        """Raise if a set option was never consumed
        (ref: open_source.cpp:281-318; reference surfaces this as a
        SourceURLException 'Parameter X not supported by Y')."""
        for name, value in vars(self).items():
            if name.startswith("_") or value is None:
                continue
            if name not in self._consumed:
                raise RuntimeError(
                    f"Parameter '{name}' not supported by {context}.")


_SCAN_SOURCE_CTORS: Dict[IoType, Callable] = {}
_PACKET_SOURCE_CTORS: Dict[IoType, Callable] = {}


def register_scan_source(iotype: IoType):
    def deco(fn):
        _SCAN_SOURCE_CTORS[iotype] = fn
        return fn
    return deco


def register_packet_source(iotype: IoType):
    def deco(fn):
        _PACKET_SOURCE_CTORS[iotype] = fn
        return fn
    return deco


def open_source(source: str, *, sensor_idx: int = -1, collate: bool = True,
                **options):
    """URL -> ScanSource (ref: open_source.cpp:205-245, sdk/open_source.py).

    sensor_idx >= 0 returns a single-sensor view; otherwise the collated
    multi-sensor source. `device` (an option) is where the engine decodes
    (pcap, a live sensor) or the projector runs (OSF): CUDA unless named,
    and an error without a GPU (a live source raises when opened, the
    others at iteration).
    """
    # the backends register their constructors when imported
    from . import osf_source  # noqa: F401
    from . import pcap_scan_source  # noqa: F401
    from ..sensor import sensor_scan_source  # noqa: F401
    from . import bag_source  # noqa: F401
    from . import cloud_source  # noqa: F401

    if len(source) == 0:
        raise ValueError("No valid source specified")
    opts = ScanSourceOptions(**options)
    try:
        t = io_type(source)
        if t not in _SCAN_SOURCE_CTORS:
            raise NotImplementedError(
                f"Could not open scan source. Unhandled source type "
                f"{t.name}.")
        src = _SCAN_SOURCE_CTORS[t](source, opts)
        opts.check(f"{t.value} scan source")
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as ex:
        raise SourceURLException(ex, [source], False) from ex
    if sensor_idx >= 0:
        return src.single(sensor_idx)
    return src


def open_packet_source(source: str, **options):
    """URL -> PacketSource, with open_source's options and errors."""
    # the backends register their constructors when imported
    from . import pcap_scan_source  # noqa: F401
    from . import bag_source  # noqa: F401

    if len(source) == 0:
        raise ValueError("No valid source specified")
    opts = ScanSourceOptions(**options)
    try:
        t = io_type(source)
        if t not in _PACKET_SOURCE_CTORS:
            raise NotImplementedError(
                f"Could not open packet source. Unhandled source type "
                f"{t.name}.")
        src = _PACKET_SOURCE_CTORS[t](source, opts)
        opts.check(f"{t.value} packet source")
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as ex:
        raise SourceURLException(ex, [source], True) from ex
    return src


def populate_extrinsics(infos: List[SensorInfo],
                        extrinsics: Optional[List[np.ndarray]] = None,
                        extrinsics_file: Optional[str] = None) -> None:
    """Apply extrinsics overrides to sensor infos
    (ref: open_source.h:214, sdk/util/extrinsics.py)."""
    if extrinsics is not None:
        for info, ext in zip(infos, extrinsics):
            info.extrinsic = np.asarray(ext, dtype=np.float64).reshape(4, 4)
    elif extrinsics_file is not None:
        from ..utils.extrinsics import resolve_extrinsics

        resolved = resolve_extrinsics(extrinsics_file, infos)
        for info, ext in zip(infos, resolved):
            if ext is not None:
                info.extrinsic = ext
