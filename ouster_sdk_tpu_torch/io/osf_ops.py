"""OSF file-level operations: inspect, slice, update metadata.

The reference OSF operations (ref: ouster_osf/src/operations.cpp:295 —
get/set metadata, file slicing, index backup).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..core.metadata import sensor_info_from_metadata
from ..core.types import SDK_NAME
from .osf import Reader, Writer, _METADATA_ENTRY_LIDAR_SENSOR


def osf_info(path: str) -> Dict[str, Any]:
    """File summary (ref: operations.cpp dump_metadata)."""
    r = Reader(path)
    streams = {}
    for sid in r.scan_streams:
        streams[sid] = sum(1 for m in r.messages() if m.id == sid)
    return {
        "version": r.version,
        "metadata_id": r.metadata_id,
        "start_ts": r.start_ts,
        "end_ts": r.end_ts,
        "chunk_count": len(r.chunk_offsets),
        "sensors": [
            {"sn": i.sn, "prod_line": i.prod_line,
             "profile": i.format.udp_profile_lidar.value,
             "mode": f"{i.format.pixels_per_column}x"
                     f"{i.format.columns_per_frame}"}
            for i in r.sensor_info],
        "scan_messages": streams,
    }


def osf_slice(src_path: str, dst_path: str, *,
              start_ts: int = 0, end_ts: int = 2**64 - 1,
              start_index: Optional[int] = None,
              end_index: Optional[int] = None) -> int:
    """Copy a time/index range of scans into a new OSF
    (ref: operations.cpp file slicing; CLI `osf slice`)."""
    r = Reader(src_path)
    with Writer(dst_path) as w:
        ids = [w.add_sensor(info) for info in r.sensor_info]
        n = 0
        scan_i = 0
        for msg in r.messages(start_ts, end_ts):
            if not msg.is_lidar_scan():
                continue
            if start_index is not None and scan_i < start_index:
                scan_i += 1
                continue
            if end_index is not None and scan_i >= end_index:
                break
            scan = msg.decode()
            if scan is not None:
                w.save(ids[msg.sensor_idx], scan, ts=msg.ts)
                n += 1
            scan_i += 1
    return n


def osf_get_sensor_metadata(path: str) -> List[str]:
    """Raw sensor metadata json strings stored in the file."""
    r = Reader(path)
    out = []
    from ..utils import flatbuf as fb

    for ent in sorted(r.entries.values(), key=lambda e: e.id):
        if ent.type == _METADATA_ENTRY_LIDAR_SENSOR:
            out.append(fb.root_auto(ent.buffer).string(0))
    return out


def osf_update_sensor_metadata(src_path: str, dst_path: str,
                               new_metadata: List[str]) -> None:
    """Rewrite the file with replacement sensor metadata
    (ref: operations.cpp metadata update ops)."""
    r = Reader(src_path)
    infos = [sensor_info_from_metadata(m) for m in new_metadata]
    if len(infos) != len(r.sensor_info):
        raise ValueError("sensor count mismatch")
    with Writer(dst_path) as w:
        ids = [w.add_sensor(info) for info in infos]
        for msg in r.messages():
            if msg.is_lidar_scan():
                scan = msg.decode()
                if scan is not None:
                    w.save(ids[msg.sensor_idx], scan, ts=msg.ts)


# -- reference-named file ops (ref: operations.cpp:229-291, _osf.cpp:104+) --

def _header_block(version: int, status: int, metadata_offset: int,
                  file_length: int) -> bytes:
    """Serialize a header block (mirror of Writer._build_header;
    ref: writer.cpp header finalize)."""
    from ..utils import flatbuf as fb
    from .osf import HEADER_IDENT, _frame_block

    b = fb.Builder()
    b.start_table()
    b.slot_scalar(0, "Q", version)
    b.slot_scalar(1, "B", status)
    b.slot_scalar(2, "Q", metadata_offset, default=1)
    b.slot_scalar(3, "Q", file_length, default=1)
    root = b.end_table()
    return _frame_block(b.finish(root, HEADER_IDENT, size_prefix=True))


def _finish_osf_file(path: str, metadata_offset: int,
                     metablob_size: int, version: int) -> None:
    """Patch status/metadata_offset/file_length in the existing header
    block in place and refresh its CRC — works on headers written by
    this writer AND by the reference C++ writer, whose flatbuffer layout
    differs in size (ref: operations.cpp finish_osf_file)."""
    import struct as _struct
    import zlib as _zlib

    from ..utils import flatbuf as fb
    from .osf import STATUS_VALID

    with open(path, "r+b") as f:
        head = bytearray(f.read(4096))
        hdr_size = _struct.unpack_from("<I", head, 0)[0]
        tbl = fb.root_size_prefixed(bytes(head), None)
        file_length = metadata_offset + metablob_size
        for slot, fmt, value in ((1, "B", STATUS_VALID),
                                 (2, "Q", metadata_offset),
                                 (3, "Q", file_length)):
            off = tbl._field_off(slot)
            if off == 0:
                raise RuntimeError(
                    f"header slot {slot} stored as default; cannot patch")
            # tbl positions are relative to the post-size-prefix view
            _struct.pack_into("<" + fmt, head, 4 + tbl.pos + off, value)
        crc = _zlib.crc32(bytes(head[: 4 + hdr_size]))
        _struct.pack_into("<I", head, 4 + hdr_size, crc)
        f.seek(0)
        f.write(head[: 4 + hdr_size + 4])


def backup_osf_file_metablob(file: str, backup_file_name: str) -> int:
    """Copy the trailing metadata blob to a backup file
    (ref: operations.cpp:229-240). Returns bytes copied."""
    r = Reader(file)
    off = r.metadata_offset
    r.close()
    with open(file, "rb") as f:
        f.seek(off)
        blob = f.read()
    with open(backup_file_name, "wb") as f:
        f.write(blob)
    return len(blob)


def restore_osf_file_metablob(file: str, backup_file_name: str) -> int:
    """Truncate the file at its metadata offset and append a backed-up
    metadata blob (ref: operations.cpp:242-265). Returns the new file
    length."""
    import os as _os
    import struct as _struct

    from ..utils import flatbuf as fb
    from .osf import HEADER_IDENT, _block_crc_ok

    with open(file, "rb") as f:
        head = f.read(4096)
    hdr_size = _struct.unpack_from("<I", head, 0)[0]
    if bytes(head[8:12]) != HEADER_IDENT or \
            not _block_crc_ok(memoryview(head)[:4 + hdr_size + 4]):
        raise ValueError("invalid OSF file: bad header")
    hdr = fb.root_size_prefixed(head, HEADER_IDENT)
    version = hdr.scalar(0, "Q")
    metadata_offset = hdr.scalar(2, "Q", 1)
    if metadata_offset == 0:
        raise RuntimeError(
            "File had invalid metadata and cannot be restored.")
    with open(backup_file_name, "rb") as f:
        blob = f.read()
    with open(file, "r+b") as f:
        f.truncate(metadata_offset)
        f.seek(metadata_offset)
        f.write(blob)
    _finish_osf_file(file, metadata_offset, len(blob), version)
    return _os.path.getsize(file)


def osf_file_modify_metadata(file_name: str, new_metadata) -> int:
    """Replace the sensor_info metadata entries in place, keeping chunk
    data verbatim (ref: operations.cpp:267-291). Returns the size of the
    new metadata blob."""
    import struct as _struct

    from ..utils import flatbuf as fb
    from .osf import METADATA_IDENT, _frame_block

    r = Reader(file_name)
    sensor_ids = list(r._sensor_meta_ids)
    if len(new_metadata) != len(sensor_ids):
        r.close()
        raise ValueError("sensor count mismatch")
    entries = {eid: ent for eid, ent in r.entries.items()}
    for eid, info in zip(sensor_ids, new_metadata):
        b = fb.Builder()
        s = b.string(info.to_json_string()
                     if hasattr(info, "to_json_string") else str(info))
        b.start_table()
        b.slot_offset(0, s)
        root = b.end_table()
        ent = entries[eid]
        entries[eid] = type(ent)(ent.id, ent.type,
                                 b.finish(root, b"oLS_", size_prefix=True))

    # rebuild the metadata block with untouched chunk index + timestamps
    mb = fb.Builder()
    id_off = mb.string(r.metadata_id or SDK_NAME)
    entry_offs = []
    for ent in sorted(entries.values(), key=lambda e: e.id):
        type_off = mb.string(ent.type)
        buf_off = mb.vector_bytes(bytes(ent.buffer))
        mb.start_table()
        mb.slot_scalar(0, "I", ent.id)
        mb.slot_offset(1, type_off)
        mb.slot_offset(2, buf_off)
        entry_offs.append(mb.end_table())
    entries_vec = mb.vector_offsets(entry_offs)
    chunks_packed = b"".join(
        _struct.pack("<QQQ", int(s), int(e), int(o))
        for s, e, o in r.chunk_offsets)
    chunks_vec = mb.vector_structs(chunks_packed, len(r.chunk_offsets),
                                   align=8) if len(r.chunk_offsets) else None
    mb.start_table()
    mb.slot_offset(0, id_off)
    mb.slot_scalar(1, "Q", r.start_ts or 0)
    mb.slot_scalar(2, "Q", r.end_ts)
    if chunks_vec:
        mb.slot_offset(3, chunks_vec)
    mb.slot_offset(4, entries_vec)
    m_root = mb.end_table()
    blob = _frame_block(mb.finish(m_root, METADATA_IDENT,
                                  size_prefix=True))
    metadata_offset, version = r.metadata_offset, r.version
    r.close()

    with open(file_name, "r+b") as f:
        f.truncate(metadata_offset)
        f.seek(metadata_offset)
        f.write(blob)
    _finish_osf_file(file_name, metadata_offset, len(blob), version)
    return len(blob)


def dump_metadata(file: str, full: bool = True) -> str:
    """OSF metadata/session info as a JSON string
    (ref: _osf.cpp:104 dump_metadata / operations.cpp)."""
    info = osf_info(file)
    if full:
        info["sensor_metadata"] = [json.loads(m) for m in
                                   osf_get_sensor_metadata(file)]
    return json.dumps(info, indent=2, default=str)


def parse_and_print(file: str, with_decoding: bool = False) -> None:
    """Print message types, timestamps and counts
    (ref: _osf.cpp:112 parse_and_print)."""
    r = Reader(file)
    counts: Dict[int, int] = {}
    for msg in r.messages():
        counts[msg.id] = counts.get(msg.id, 0) + 1
        kind = "LidarScan" if msg.is_lidar_scan() else "other"
        line = f"  ts={msg.ts} stream={msg.id} [{kind}]"
        if with_decoding and msg.is_lidar_scan():
            scan = msg.decode()
            line += f" -> {scan!r}" if scan is not None else " -> <none>"
        print(line)
    print(f"streams: {counts}")


def slice_and_cast(lidar_scan, field_types):
    """Copy of a scan restricted/cast to the given field types
    (ref: stream_lidar_scan.h:40 slice_with_cast). Raises when a
    requested field is absent."""
    import numpy as np

    from ..core.lidar_scan import LidarScan

    src = lidar_scan
    if src.sensor_info is not None:
        out = LidarScan(src.sensor_info, field_types=list(field_types))
    else:
        out = LidarScan(w=src.w, h=src.h, field_types=list(field_types))
    for ft in field_types:
        if not src.has_field(ft.name):
            raise ValueError(
                f"cannot slice: source scan has no field {ft.name}")
        out.field(ft.name)[:] = src.field(ft.name).astype(
            ft.storage_dtype, copy=False)
    out.frame_id = src.frame_id
    out.frame_status = src.frame_status
    out.timestamp[:] = src.timestamp
    out.measurement_id[:] = src.measurement_id
    out.status[:] = src.status
    out.packet_timestamp[:] = src.packet_timestamp
    out.pose[:] = src.pose
    return out
