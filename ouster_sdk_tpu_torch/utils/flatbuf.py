"""Minimal flatbuffers runtime (read + write) for the OSF container.

The OSF format is flatbuffers-framed (ref: ouster_osf/fb/*.fbs). Rather than
depending on the flatbuffers package (not a dependency), this module
implements the subset of the wire format OSF needs: tables with scalar /
string / vector / struct / table fields, size prefixes and file identifiers.

Wire format summary (little-endian throughout):
  - root: u32 offset to root table, then 4-byte file identifier
  - table: i32 soffset at table start; vtable at (table_pos - soffset):
    [u16 vtable_bytes][u16 table_bytes][u16 field_off ...] (0 = absent)
  - scalar fields inline; string/vector/table fields hold a u32 relative
    offset (from the field location) to their data
  - string: u32 length + bytes + NUL; vector: u32 length + elements
  - structs are stored inline
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")


class Table:
    """Read-only view of a flatbuffers table."""

    __slots__ = ("buf", "pos", "_vt", "_vt_size")

    def __init__(self, buf: Union[bytes, memoryview], pos: int):
        self.buf = buf
        self.pos = pos
        soffset = _I32.unpack_from(buf, pos)[0]
        self._vt = pos - soffset
        self._vt_size = _U16.unpack_from(buf, self._vt)[0]

    def _field_off(self, slot: int) -> int:
        """Byte offset of field `slot` within the table, or 0 if absent."""
        vt_entry = 4 + slot * 2
        if vt_entry >= self._vt_size:
            return 0
        off = _U16.unpack_from(self.buf, self._vt + vt_entry)[0]
        return off

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._field_off(slot)
        if off == 0:
            return default
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0]

    def _indirect(self, slot: int) -> Optional[int]:
        off = self._field_off(slot)
        if off == 0:
            return None
        p = self.pos + off
        return p + _U32.unpack_from(self.buf, p)[0]

    def string(self, slot: int, default: str = "") -> str:
        p = self._indirect(slot)
        if p is None:
            return default
        n = _U32.unpack_from(self.buf, p)[0]
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8",
                                                       errors="replace")

    def table(self, slot: int) -> Optional["Table"]:
        p = self._indirect(slot)
        return None if p is None else Table(self.buf, p)

    def struct_pos(self, slot: int) -> Optional[int]:
        off = self._field_off(slot)
        return None if off == 0 else self.pos + off

    def vector_len(self, slot: int) -> int:
        p = self._indirect(slot)
        if p is None:
            return 0
        return _U32.unpack_from(self.buf, p)[0]

    def vector_np(self, slot: int, dtype) -> np.ndarray:
        """Vector of scalars (or structs via structured dtype), zero-copy."""
        p = self._indirect(slot)
        dt = np.dtype(dtype)
        if p is None:
            return np.empty(0, dt)
        n = _U32.unpack_from(self.buf, p)[0]
        return np.frombuffer(self.buf, dt, count=n, offset=p + 4)

    def vector_bytes(self, slot: int) -> bytes:
        return self.vector_np(slot, np.uint8).tobytes()

    def vector_view(self, slot: int):
        """Zero-copy view of a [ubyte] vector (valid only while the
        underlying buffer/mmap is alive)."""
        return self.vector_np(slot, np.uint8)

    def vector_tables(self, slot: int) -> List["Table"]:
        p = self._indirect(slot)
        if p is None:
            return []
        n = _U32.unpack_from(self.buf, p)[0]
        out = []
        base = p + 4
        for i in range(n):
            ep = base + i * 4
            out.append(Table(self.buf, ep + _U32.unpack_from(self.buf,
                                                             ep)[0]))
        return out

    def vector_strings(self, slot: int) -> List[str]:
        p = self._indirect(slot)
        if p is None:
            return []
        n = _U32.unpack_from(self.buf, p)[0]
        out = []
        base = p + 4
        for i in range(n):
            ep = base + i * 4
            sp = ep + _U32.unpack_from(self.buf, ep)[0]
            ln = _U32.unpack_from(self.buf, sp)[0]
            out.append(bytes(self.buf[sp + 4:sp + 4 + ln]).decode("utf-8"))
        return out


def root(buf: Union[bytes, memoryview], expect_ident: Optional[bytes] = None
         ) -> Table:
    if expect_ident is not None and bytes(buf[4:8]) != expect_ident:
        raise ValueError(
            f"bad file identifier: {bytes(buf[4:8])!r} != {expect_ident!r}")
    return Table(buf, _U32.unpack_from(buf, 0)[0])


def root_size_prefixed(buf, expect_ident: Optional[bytes] = None) -> Table:
    size = _U32.unpack_from(buf, 0)[0]
    return root(memoryview(buf)[4:4 + size], expect_ident)


def root_auto(buf) -> Table:
    """Root of a buffer that may or may not carry a size prefix
    (heuristic: a leading u32 equal to the remaining length IS the
    prefix)."""
    size = _U32.unpack_from(buf, 0)[0]
    if size == len(buf) - 4:
        return root(memoryview(buf)[4:4 + size])
    return root(memoryview(buf))


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

class Builder:
    """Bottom-up flatbuffers builder.

    Data grows downward: we append to an internal bytearray and reverse at
    finish, tracking offsets from the end like the reference implementation.
    """

    def __init__(self):
        self._buf = bytearray()  # built back-to-front; index 0 = file end
        self._minalign = 1
        self._vtables: dict = {}
        # current table state
        self._slots: List[Tuple[int, int]] = []  # (slot, offset_from_end)
        self._inline_slots: List[Tuple[int, bytes, int]] = []

    # -- low-level --------------------------------------------------------
    def _align(self, size: int, extra: int = 0) -> None:
        self._minalign = max(self._minalign, size)
        total = len(self._buf) + extra
        pad = (size - total % size) % size
        self._buf.extend(b"\x00" * pad)

    def offset(self) -> int:
        return len(self._buf)

    def _push(self, data: bytes) -> None:
        self._buf.extend(data[::-1])

    def push_scalar(self, fmt: str, value) -> int:
        data = struct.pack("<" + fmt, value)
        self._align(len(data))
        self._push(data)
        return self.offset()

    def push_u32_at_offset(self, target_off: int) -> None:
        """Append a u32 relative offset pointing at target_off."""
        self._align(4)
        rel = self.offset() + 4 - target_off
        self._push(_U32.pack(rel))

    # -- strings / vectors ------------------------------------------------
    def string(self, s: Union[str, bytes]) -> int:
        data = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        self._push(b"\x00")
        self._align(4, extra=len(data) + 4)
        self._push(data)
        self._push(_U32.pack(len(data)))
        return self.offset()

    def vector_scalar(self, arr, dtype) -> int:
        a = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        data = a.tobytes()
        elem = a.dtype.itemsize
        self._minalign = max(self._minalign, elem, 4)
        if elem >= 8:
            # element start must be 8-aligned; the u32 length lands 4-aligned
            self._align(elem, extra=len(data))
        else:
            self._align(4, extra=len(data) + 4)
        self._push(data)
        self._push(_U32.pack(a.size))
        return self.offset()

    def vector_bytes(self, data: bytes) -> int:
        return self.vector_scalar(np.frombuffer(data, np.uint8), np.uint8)

    def vector_structs(self, packed: bytes, count: int,
                       align: int = 8) -> int:
        self._minalign = max(self._minalign, align, 4)
        if align >= 8:
            self._align(align, extra=len(packed))
        else:
            self._align(4, extra=len(packed) + 4)
        self._push(packed)
        self._push(_U32.pack(count))
        return self.offset()

    def vector_offsets(self, offsets: Sequence[int]) -> int:
        self._align(4, extra=len(offsets) * 4 + 4)
        for off in reversed(list(offsets)):
            rel = self.offset() + 4 - off
            self._push(_U32.pack(rel))
        self._push(_U32.pack(len(offsets)))
        return self.offset()

    # -- tables -----------------------------------------------------------
    def start_table(self) -> None:
        self._slots = []
        self._inline_slots = []

    def slot_scalar(self, slot: int, fmt: str, value, default=0) -> None:
        if value == default:
            return
        self._inline_slots.append((slot, struct.pack("<" + fmt, value), 0))

    def slot_struct(self, slot: int, packed: bytes, align: int = 8) -> None:
        self._inline_slots.append((slot, packed, align))

    def slot_offset(self, slot: int, off: Optional[int]) -> None:
        if off is None or off == 0:
            return
        self._inline_slots.append((slot, None, off))

    def end_table(self) -> int:
        tail_before = self.offset()

        # emit inline field data back-to-front (ascending slot -> the lowest
        # slot ends up closest to the table start, like flatc output)
        field_offsets: dict = {}
        for slot, data, extra in sorted(self._inline_slots,
                                        key=lambda e: -e[0]):
            if data is None:
                self.push_u32_at_offset(extra)
            else:
                align = extra if extra else len(data)
                self._minalign = max(self._minalign, align)
                self._align(align, extra=len(data))
                self._push(data)
            field_offsets[slot] = self.offset()

        # table soffset
        self._align(4)
        self._push(b"\x00\x00\x00\x00")
        table_off = self.offset()

        max_slot = max(field_offsets) if field_offsets else -1
        vt = bytearray()
        vt += _U16.pack(4 + (max_slot + 1) * 2)
        vt += _U16.pack(table_off - tail_before)
        for s in range(max_slot + 1):
            vt += _U16.pack(table_off - field_offsets[s]
                            if s in field_offsets else 0)

        vt_bytes = bytes(vt)
        if vt_bytes in self._vtables:
            vt_off = self._vtables[vt_bytes]
        else:
            self._push(vt_bytes)
            vt_off = self.offset()
            self._vtables[vt_bytes] = vt_off

        # soffset stored at table start: vtable_pos = table_pos - soffset
        # => soffset = vt_off - table_off in offset-from-end space.
        # The table's 4 soffset bytes live at reversed indices
        # [table_off-4, table_off), byte-reversed.
        soff = vt_off - table_off
        self._buf[table_off - 4:table_off] = _I32.pack(soff)[::-1]
        return table_off

    def finish(self, root_off: int, file_ident: Optional[bytes] = None,
               size_prefix: bool = False) -> bytes:
        # like flatbuffers FinishSizePrefixed: when a size prefix is
        # emitted it counts toward the final alignment, so 8-byte data
        # stays 8-aligned from the START of the emitted block (C++
        # readers mmap at that offset and do aligned loads)
        self._align(self._minalign,
                    extra=(4 if size_prefix else 0) + 4
                    + (4 if file_ident else 0))
        if file_ident is not None:
            assert len(file_ident) == 4
            self._push(file_ident)
        self.push_u32_at_offset(root_off)
        out = bytes(self._buf[::-1])
        if size_prefix:
            out = _U32.pack(len(out)) + out
        return out
