"""ZRB (Zone Rendered Binary) format: near/far range images per zone.

The reference Zrb (ref: ouster_client/include/ouster/zrb.h:22-168,
src/zrb.cpp:95-275, src/zone_header.h). Byte-compatible layout:

  CacheHeaderInfo (39 B):  char[7] version "ZONE03\\0", sha256[32]
  CacheRenderMetadata (540 B): char[16] serial, u32 n_cols, u32 n_rows,
    f32 m_per_zmbin, sha256 stl_hash, sha256 bounds_hash,
    f32[16] beam_to_lidar, f32[16] lidar_to_sensor, f32[16] sensor_to_body
    (each COLUMN-major, i.e. raw Eigen mat4d .data() order, zrb.cpp:227-236),
    2048-bit valid-column mask (bitset<2048>, little-endian bit order)
  data: n_cols * n_rows u32, column-major, (far_bins << 16) | near_bins

Bin quantization is float32 (`mm_per_bin = m_per_zmbin * 1000.f`,
zrb.cpp:97,245) — kept in f32 here so bins round identically.
A numpy copy of the JAX package's zone/zrb.py: blobs are byte-identical.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional, Union

import numpy as np

#: default zone-monitor bin size (ref: zrb.h:19)
DEFAULT_M_PER_ZMBIN = 0.0074927621875

ZONE_CACHE_VERSION = b"ZONE03\x00"
_INFO_SIZE = 39
_META_SIZE = 540
_META_HASHED_PREFIX = 16 + 4 + 4 + 4 + 32 + 32  # up to beam_to_lidar


class Zrb:
    """Near/far range images (mm) + render metadata.

    Constructor overloads mirror the reference binding
    (ref: client.pyi:1775-1803): ``Zrb()``, ``Zrb(file_path)``,
    ``Zrb(blob_bytes_or_list)`` — plus the keyword form used by the
    renderer.
    """

    def __init__(self, n_rows=0, n_cols: int = 0,
                 m_per_zmbin: float = 0.004,
                 serial_number: int = 0,
                 stl_hash: bytes = b"\x00" * 32,
                 beam_to_lidar: Optional[np.ndarray] = None,
                 lidar_to_sensor: Optional[np.ndarray] = None,
                 sensor_to_body: Optional[np.ndarray] = None):
        if isinstance(n_rows, str):
            # Zrb(file_path) (ref: client.pyi:1789)
            try:
                with open(n_rows, "rb") as f:
                    blob = f.read()
            except OSError as exc:
                raise RuntimeError(
                    "Zrb read error: could not open file") from exc
            self.__init__()
            self._load(blob)
            return
        if isinstance(n_rows, (bytes, bytearray, list)):
            # Zrb(blob) (ref: client.pyi:1802)
            self.__init__()
            self._load(bytes(n_rows))
            return
        self.near_range_mm = np.zeros((n_rows, n_cols), dtype=np.uint32)
        self.far_range_mm = np.zeros((n_rows, n_cols), dtype=np.uint32)
        self.m_per_zmbin = float(m_per_zmbin)
        self.serial_number = serial_number
        self.stl_hash = stl_hash  # property setter normalizes to bytes
        self.beam_to_lidar_transform = (
            np.eye(4) if beam_to_lidar is None else beam_to_lidar)
        self.lidar_to_sensor_transform = (
            np.eye(4) if lidar_to_sensor is None else lidar_to_sensor)
        self.sensor_to_body_transform = (
            np.eye(4) if sensor_to_body is None else sensor_to_body)
        # unset until save()/blob() computes it, or a blob load restores
        # it (ref: zrb.h:149, zone_render_test.cpp "valid column mask is
        # not set until save/blob is called")
        self.valid_col_mask = np.zeros(2048, dtype=bool)

    @property
    def stl_hash(self):
        """Source STL sha256 as a hex string; None when unset — the
        reference binding surfaces the optional the same way
        (ref: client.pyi:1818 `stl_hash -> str`;
        python/tests/test_zrb.py `zrb.stl_hash is None`)."""
        if self._stl_hash == b"\x00" * 32:
            return None
        return self._stl_hash.hex()

    @stl_hash.setter
    def stl_hash(self, value) -> None:
        if value is None:
            self._stl_hash = b"\x00" * 32
        elif isinstance(value, str):
            self._stl_hash = bytes.fromhex(value)
        else:
            self._stl_hash = bytes(value)
        if len(self._stl_hash) != 32:
            raise ValueError("Zrb: stl_hash must be 32 bytes")

    @property
    def stl_hash_bytes(self) -> bytes:
        """Raw digest form, as stored in the blob."""
        return self._stl_hash

    @property
    def hash(self) -> str:
        """sha256 hex of the full serialized blob
        (ref: client.pyi:1822 Zrb.hash; zrb.cpp Zrb::hash)."""
        return hashlib.sha256(self.blob()).hexdigest()

    def __eq__(self, other: object) -> bool:
        """Field-wise equality (ref: zrb.cpp operator== — images, bin
        size, stl hash, serial, all three transforms)."""
        if not isinstance(other, Zrb):
            return NotImplemented
        return (np.array_equal(self.near_range_mm, other.near_range_mm)
                and np.array_equal(self.far_range_mm, other.far_range_mm)
                and np.float32(self.m_per_zmbin)
                == np.float32(other.m_per_zmbin)
                and self._stl_hash == other._stl_hash
                and self.serial_number == other.serial_number
                and np.array_equal(self.beam_to_lidar_transform,
                                   other.beam_to_lidar_transform)
                and np.array_equal(self.lidar_to_sensor_transform,
                                   other.lidar_to_sensor_transform)
                and np.array_equal(self.sensor_to_body_transform,
                                   other.sensor_to_body_transform))

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    @classmethod
    def from_blob(cls, blob: Union[bytes, bytearray]) -> "Zrb":
        z = cls()
        z._load(bytes(blob))
        return z

    @classmethod
    def from_file(cls, path: str) -> "Zrb":
        try:
            with open(path, "rb") as f:
                return cls.from_blob(f.read())
        except OSError as exc:
            # (ref: zrb_test.cpp from_file_bad error text)
            raise RuntimeError(
                "Zrb read error: could not open file") from exc

    # ------------------------------------------------------------------
    def blob(self) -> bytes:
        n_rows, n_cols = self.near_range_mm.shape
        # error type + text match the reference binding
        # (ref: python/tests/test_zrb.py:9-18 pytest.raises(RuntimeError))
        if self.serial_number == 0:
            raise RuntimeError("Zrb::save: serial number not set")
        if self.near_range_mm.size == 0:
            raise RuntimeError("Zrb::save: near image data missing")
        if self.far_range_mm.size == 0:
            raise RuntimeError("Zrb::save: far image data missing")

        # f32 bin math, exactly like the reference (zrb.cpp:97-105)
        mm_per_bin = np.float32(self.m_per_zmbin) * np.float32(1000.0)
        near_bins = np.round(self.near_range_mm.astype(np.float32)
                             / mm_per_bin)
        far_bins = np.round(self.far_range_mm.astype(np.float32)
                            / mm_per_bin)
        if near_bins.max(initial=0) > 0xFFFF or \
                far_bins.max(initial=0) > 0xFFFF:
            raise ValueError("Zrb: range value exceeds maximum encodable "
                             "distance")
        packed = ((far_bins.astype(np.uint32) << 16)
                  | near_bins.astype(np.uint32))
        # column-major data layout (ref: zrb.cpp:116)
        data = np.ascontiguousarray(packed.T).tobytes()

        valid_cols = np.zeros(2048, dtype=bool)
        valid_cols[:n_cols] = (far_bins > 0).any(axis=0)
        self.valid_col_mask = valid_cols
        mask_bytes = np.packbits(valid_cols, bitorder="little").tobytes()

        serial = str(self.serial_number).encode()[:16].ljust(16, b"\x00")
        bounds_hash = hashlib.sha256(data).digest()

        meta = bytearray(_META_SIZE)
        meta[0:16] = serial
        struct.pack_into("<IIf", meta, 16, n_cols, n_rows, self.m_per_zmbin)
        meta[28:60] = self._stl_hash
        meta[60:92] = bounds_hash
        # transforms serialize COLUMN-major (raw Eigen .data() order)
        struct.pack_into("<16f", meta, 92,
                         *np.asarray(self.beam_to_lidar_transform,
                                     dtype=np.float32).reshape(-1,
                                                               order="F"))
        struct.pack_into("<16f", meta, 156,
                         *np.asarray(self.lidar_to_sensor_transform,
                                     dtype=np.float32).reshape(-1,
                                                               order="F"))
        struct.pack_into("<16f", meta, 220,
                         *np.asarray(self.sensor_to_body_transform,
                                     dtype=np.float32).reshape(-1,
                                                               order="F"))
        meta[284:284 + 256] = mask_bytes

        total_hash = hashlib.sha256(bytes(meta[:_META_HASHED_PREFIX])) \
            .digest()
        info = ZONE_CACHE_VERSION + total_hash
        assert len(info) == _INFO_SIZE
        return bytes(info) + bytes(meta) + data

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.blob())

    # ------------------------------------------------------------------
    def _load(self, blob: bytes) -> None:
        if len(blob) < _INFO_SIZE + _META_SIZE:
            raise ValueError("Zrb: blob too short")
        if blob[:7] != ZONE_CACHE_VERSION:
            raise ValueError("Zrb: bad cache version")
        stored_hash = blob[7:39]
        meta = blob[_INFO_SIZE:_INFO_SIZE + _META_SIZE]
        if hashlib.sha256(meta[:_META_HASHED_PREFIX]).digest() != stored_hash:
            raise ValueError("Zrb: metadata hash mismatch")

        serial = meta[0:16].split(b"\x00", 1)[0].decode(errors="replace")
        n_cols, n_rows, m_per_zmbin = struct.unpack_from("<IIf", meta, 16)
        self.serial_number = int(serial) if serial.isdigit() else 0
        self.m_per_zmbin = m_per_zmbin
        self._stl_hash = bytes(meta[28:60])
        bounds_hash = meta[60:92]
        # transforms are stored column-major (raw Eigen .data() order)
        self.beam_to_lidar_transform = np.array(
            struct.unpack_from("<16f", meta, 92), dtype=np.float64
        ).reshape(4, 4, order="F")
        self.lidar_to_sensor_transform = np.array(
            struct.unpack_from("<16f", meta, 156), dtype=np.float64
        ).reshape(4, 4, order="F")
        self.sensor_to_body_transform = np.array(
            struct.unpack_from("<16f", meta, 220), dtype=np.float64
        ).reshape(4, 4, order="F")
        self.valid_col_mask = np.unpackbits(
            np.frombuffer(meta[284:284 + 256], dtype=np.uint8),
            bitorder="little").astype(bool)

        data = blob[_INFO_SIZE + _META_SIZE:
                    _INFO_SIZE + _META_SIZE + 4 * n_rows * n_cols]
        if len(data) < 4 * n_rows * n_cols:
            raise ValueError("Zrb: truncated bounds data")
        if hashlib.sha256(data).digest() != bytes(bounds_hash):
            raise ValueError("Zrb: bounds hash mismatch")
        packed = np.frombuffer(data, dtype="<u4").reshape(n_cols, n_rows).T
        # f32 de-quantization, exactly like the reference (zrb.cpp:245-263)
        mm_per_bin = np.float32(self.m_per_zmbin) * np.float32(1000.0)
        self.near_range_mm = np.round(
            (packed & 0xFFFF).astype(np.float32) * mm_per_bin
        ).astype(np.uint32)
        self.far_range_mm = np.round(
            (packed >> 16).astype(np.float32) * mm_per_bin
        ).astype(np.uint32)
