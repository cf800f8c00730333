"""ctypes bindings to the native host library (native/ouster_native.cpp).

The library is the host staging of every path: one pass over a capture
with IPv4 reassembly (pcap_scan), packets grouped into packet-layout frame
slots (group_frames) or into word planes with the scan headers
(group_frames_planar), the packet footer's CRC64, the PNG scanline
unfilter of the OSF field codec (utils/png.py), and the live receive
path's drain of a UDP socket with one recvmmsg (udp_recv_batch,
sensor/scan_source.py). It is built with g++
at first use into kernels/_build/ (git-ignored), keyed by a hash of the
source and of the machine (-march=native binaries are machine-specific), and
written to a temporary file that is renamed into place, so that several
processes may build at once.

`get_lib()` is None only when no g++ is on PATH: the staging then runs in
numpy (io.frames keeps those versions, with the same contracts), and the
live receive path reads one datagram a recv. A build
or load that starts and fails raises with the compiler's output. Every
wrapper checks the dtype, shape and C-contiguity of each array it hands to
C before the call, and counts its calls in `calls`.

The wire stagings of io.frames run through it too: the bit-packed
grouper (group_frames_packed) and the BP64 encoder (bp64_encode).
stage_frame places one frame's packets into their slots by measurement
id, as the JAX package's wrapper does; no path of either package stages
through it. The library also exports onat_crc64_check_batch, bound with
its signature and without a wrapper, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "ouster_native.cpp")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

#: calls into the library, by wrapper (reset with reset_calls)
calls: Dict[str, int] = {"crc64": 0, "pcap_scan": 0, "group_frames": 0,
                         "group_frames_planar": 0, "group_frames_packed": 0,
                         "bp64_encode": 0, "png_unfilter": 0,
                         "udp_recv_batch": 0, "stage_frame": 0}
#: seconds the build took in this process (None: loaded from disk, or not
#: loaded yet)
build_seconds: Optional[float] = None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_no_compiler = False


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _machine_tag() -> str:
    """CPU identity folded into the library's name: a -march=native
    binary must never load on another CPU (SIGILL)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:8]


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libouster_native-"
                        f"{digest.hexdigest()[:16]}-{_machine_tag()}.so")


def _build(out: str, cxx: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stderr}")
        os.replace(tmp, out)   # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    p, i64, u64, i32 = c.c_void_p, c.c_int64, c.c_uint64, c.c_int
    sigs = {
        "onat_crc64": (u64, [p, u64]),
        "onat_crc64_check_batch": (i64, [p, i64, i64, p]),
        "onat_png_unfilter": (i32, [p, p, i64, i64, i64]),
        "onat_pcap_scan": (i64, [p, i64, i32, i32, i32, p, i64, p, p, p, p,
                                 p, i64]),
        "onat_stage_frame": (i64, [p, p, p, i64, i64, i64, i64, p, i64]),
        "onat_udp_recv_batch": (i64, [i32, p, i64, i64, p, p]),
        "onat_group_frames": (i64, [p, p, p, i64, i64, i64, i32, u64, i64,
                                    i64, i64, p, p, p, i64, p, p]),
        "onat_group_frames_planar": (i64, [
            p, p, p, i64, i64, i64, i32, u64, i64, i64, i64, i64, i64, i64,
            i64, i64, p, p, p, p, i64, p, p, i64, p, p, p, p, i64]),
        "onat_group_frames_packed": (i64, [
            p, p, p, i64, i64, i64, i32, u64, i64, i64, i64, i64, i64, i64,
            i64, i64, p, p, i64, i64, p, p, p, p, i64, p, p]),
        "onat_bp64_encode": (i64, [p, i64, i64, i64, p, i64, p, i64, p, p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None only when it is not
    built yet and no g++ is on PATH. A failing build or load raises."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    with _lock:
        if _lib is not None or _no_compiler:
            return _lib
        out = lib_path()
        if not os.path.exists(out):
            cxx = shutil.which("g++")
            if cxx is None:
                _no_compiler = True
                return None
            _build(out, cxx)
        lib = ctypes.CDLL(out)
        _bind(lib)
        _lib = lib
        return _lib


# -- argument checks ----------------------------------------------------------

def _arr(a: np.ndarray, name: str, dtype, shape=None) -> np.ndarray:
    """`a` as handed to C: of `dtype`, C-contiguous, of `shape` where given
    (None entries match any size). Raises instead of converting: a copy
    would leave an output unwritten."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{name}: numpy array expected, got {type(a)}")
    if a.dtype != np.dtype(dtype):
        raise ValueError(f"{name}: dtype {a.dtype}, expected "
                         f"{np.dtype(dtype)}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name}: not C-contiguous")
    if shape is not None and (a.ndim != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, a.shape))):
        raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    return a


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _packets(payloads: np.ndarray, offsets: np.ndarray, pkt_bytes: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Payload buffer and offsets of packets of `pkt_bytes` each, checked
    to lie inside the buffer."""
    payloads = _arr(payloads, "payloads", np.uint8, (None,))
    offsets = np.ascontiguousarray(offsets, np.int64)
    if offsets.ndim != 1:
        raise ValueError(f"offsets: shape {offsets.shape}, expected (n,)")
    if offsets.size and (int(offsets.min()) < 0 or int(offsets.max())
                         + pkt_bytes > payloads.size):
        raise ValueError("offsets: a packet lies outside the payload buffer")
    return payloads, offsets


def _timestamps(ts: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    if ts is None:
        return None
    ts = np.ascontiguousarray(ts, np.uint64)
    if ts.shape != (n,):
        raise ValueError(f"ts: shape {ts.shape}, expected ({n},)")
    return ts


def _frame_id_layout(fid_byte: int, pkt_bytes: int) -> None:
    # the frame id is read as an 8-byte little-endian load
    if not 0 <= fid_byte <= pkt_bytes - 8:
        raise ValueError(f"frame id byte {fid_byte} outside a packet of "
                         f"{pkt_bytes} bytes")


def _released(io_released: Optional[np.ndarray]) -> Optional[np.ndarray]:
    return (None if io_released is None
            else _arr(io_released, "io_released", np.int64, (1,)))


# -- wrappers ---------------------------------------------------------------

def crc64(data) -> Optional[int]:
    """CRC64 (ECMA-182, reflected) of `data`; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    buf = (np.ascontiguousarray(data).view(np.uint8).reshape(-1)
           if isinstance(data, np.ndarray)
           else np.frombuffer(data, dtype=np.uint8))
    calls["crc64"] += 1
    return int(lib.onat_crc64(_ptr(buf), buf.size))


def png_unfilter(rows: np.ndarray, h: int, stride: int, bpp: int
                 ) -> Optional[np.ndarray]:
    """PNG scanline unfiltering (filters None, Sub, Up, Average, Paeth) of
    `rows`, (h, stride + 1) u8 with each row's filter byte first: the
    (h, stride) reconstructed bytes, or None without the library. A filter
    byte above 4 raises."""
    lib = get_lib()
    if lib is None:
        return None
    rows = _arr(rows, "rows", np.uint8, (h, stride + 1))
    if h and not 1 <= bpp <= stride:
        raise ValueError(f"bpp {bpp} outside 1..stride ({stride})")
    out = np.empty((h, stride), dtype=np.uint8)
    calls["png_unfilter"] += 1
    if lib.onat_png_unfilter(_ptr(out), _ptr(rows), h, stride, bpp) != 0:
        raise ValueError("bad PNG filter byte")
    return out


def pcap_scan(data, swap_endian: bool, ts_nano: bool,
              linktype: int, workspace: Optional[dict] = None):
    """One pass over a whole capture file's bytes `data` (a u8 array or any
    bytes-like object, the 24-byte file header included): (payloads u8,
    offsets i64, sizes i64, ts u64,
    ports u32, dst_ips u32) of every reassembled UDP datagram, the
    contract of io.frames.pcap_scan. `payloads` ends with the last
    datagram's bytes.

    `workspace` (a dict the caller owns) keeps the large outputs across
    calls: fresh allocations of that size are page-faulted on first touch.
    The returned arrays are views into it, valid until the next call with
    the same workspace."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _arr(data if isinstance(data, np.ndarray)
               else np.frombuffer(data, dtype=np.uint8), "data", np.uint8,
               (None,))
    cap = buf.size
    # every datagram takes >= 44 file bytes (16 B record header + IP and
    # UDP headers), so cap // 32 slots cannot run out; payloads are a
    # subset of the file's bytes
    max_out = cap // 32 + 64

    def ws(name, n, dtype):
        if workspace is None:
            return np.empty(n, dtype=dtype)
        a = workspace.get(name)
        if a is None or a.size < n:
            a = workspace[name] = np.empty(n, dtype=dtype)
        return a[:n]

    payloads = ws("payloads", cap, np.uint8)
    offsets = ws("offsets", max_out, np.int64)
    sizes = ws("sizes", max_out, np.int64)
    ts = ws("ts", max_out, np.uint64)
    ports = ws("ports", max_out, np.uint32)
    dst_ips = ws("dst_ips", max_out, np.uint32)
    calls["pcap_scan"] += 1
    n = lib.onat_pcap_scan(
        _ptr(buf), cap, int(swap_endian), int(ts_nano), int(linktype),
        _ptr(payloads), payloads.size, _ptr(offsets), _ptr(sizes), _ptr(ts),
        _ptr(ports), _ptr(dst_ips), max_out)
    if n == -1:
        raise RuntimeError("native pcap scan failed")
    if n < -1:  # early stop: -(count + 2) datagrams were emitted
        n = -n - 2
        warnings.warn(f"native pcap scan stopped after {n} datagrams "
                      "(output capacity reached); the tail of the capture "
                      "was dropped", RuntimeWarning, stacklevel=2)
    end = int(offsets[n - 1] + sizes[n - 1]) if n else 0
    return (payloads[:end], offsets[:n], sizes[:n], ts[:n], ports[:n],
            dst_ips[:n])


def stage_frame(payloads: np.ndarray, offsets: np.ndarray,
                sizes: np.ndarray, pkt_bytes: int, mid_off: int,
                cols_per_packet: int, n_slots: int
                ) -> Optional[np.ndarray]:
    """One frame's packets at `offsets` (`sizes` bytes each, int64) placed
    into a zeroed (n_slots, pkt_bytes) u8 frame, each at the slot of its
    first column's measurement id (the u16 at byte `mid_off`) divided by
    cols_per_packet; packets of another size than pkt_bytes and slots
    past the frame are dropped, and a later packet of a slot wins. None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    payloads = _arr(payloads, "payloads", np.uint8, (None,))
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = _arr(sizes, "sizes", np.int64, offsets.shape)
    # the measurement id is read as a 2-byte load inside each packet
    if not 0 <= mid_off <= pkt_bytes - 2:
        raise ValueError(f"measurement id byte {mid_off} outside a packet "
                         f"of {pkt_bytes} bytes")
    if n_slots < 1 or cols_per_packet < 1:
        raise ValueError(f"n_slots ({n_slots}) and cols_per_packet "
                         f"({cols_per_packet}) must be positive")
    # only the packets of pkt_bytes are read
    _packets(payloads, offsets[sizes == pkt_bytes], pkt_bytes)
    frame = np.zeros((n_slots, pkt_bytes), dtype=np.uint8)
    calls["stage_frame"] += 1
    lib.onat_stage_frame(_ptr(payloads), _ptr(offsets), _ptr(sizes),
                         offsets.size, pkt_bytes, mid_off, cols_per_packet,
                         _ptr(frame), n_slots)
    return frame


def group_frames(payloads: np.ndarray, offsets: np.ndarray,
                 ts: Optional[np.ndarray], pkt_bytes: int, fid_byte: int,
                 fid_shift: int, fid_mask: int, mid_byte: int,
                 cols_per_packet: int, n_slots: int, out_frames: np.ndarray,
                 out_fids: np.ndarray, out_ts: np.ndarray,
                 io_released: Optional[np.ndarray] = None
                 ) -> Optional[Tuple[int, int]]:
    """Packet-layout grouping of the packets at `offsets` (each pkt_bytes
    long) into out_frames (max_frames, n_slots, pkt_bytes // 4) u32, each
    packet at the slot of its first column's measurement id, the frames
    emitted zeroed first, with frame id and first packet's timestamp.
    Grouping, drops and the resume contract (io_released, (1,) i64, -1 =
    none) are io.frames._group's. Returns (packets consumed, frames
    emitted), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    payloads, offsets = _packets(payloads, offsets, pkt_bytes)
    ts = _timestamps(ts, offsets.size)
    _frame_id_layout(fid_byte, pkt_bytes)
    if not 0 <= mid_byte <= pkt_bytes - 2 or pkt_bytes % 4:
        raise ValueError("measurement id outside the packet")
    out_frames = _arr(out_frames, "out_frames", np.uint32,
                      (None, n_slots, pkt_bytes // 4))
    m = out_frames.shape[0]
    out_fids = _arr(out_fids, "out_fids", np.int64)
    out_ts = _arr(out_ts, "out_ts", np.uint64)
    if out_fids.size < m or out_ts.size < m:
        raise ValueError("out_fids / out_ts shorter than out_frames")
    io_released = _released(io_released)
    nframes = np.zeros(1, dtype=np.int64)
    calls["group_frames"] += 1
    consumed = lib.onat_group_frames(
        _ptr(payloads), _ptr(offsets), _ptr(ts), offsets.size, pkt_bytes,
        fid_byte, fid_shift, fid_mask, mid_byte, cols_per_packet, n_slots,
        _ptr(out_frames), _ptr(out_fids), _ptr(out_ts), m, _ptr(nframes),
        _ptr(io_released))
    return int(consumed), int(nframes[0])


def group_frames_planar(payloads: np.ndarray, offsets: np.ndarray,
                        ts: Optional[np.ndarray], pkt_bytes: int,
                        fid_byte: int, fid_shift: int, fid_mask: int,
                        hw_bytes: int, cw_bytes: int, chw_bytes: int,
                        mid_byte_in_col: int, cpp: int, h: int, pw: int,
                        w: int, out_planes: np.ndarray,
                        out_colhdr: np.ndarray, out_fids: np.ndarray,
                        out_ts: np.ndarray,
                        word_sel: Optional[np.ndarray] = None,
                        out_pkt_ts: Optional[np.ndarray] = None,
                        out_pkt_hdrs: Optional[np.ndarray] = None,
                        out_first_hdr: Optional[np.ndarray] = None,
                        io_released: Optional[np.ndarray] = None,
                        ftr_words: int = 0) -> Optional[Tuple[int, int]]:
    """Word-planar grouping of the packets at `offsets`, the contract of
    io.frames.group_frames_planar: out_planes (max_frames, pw |
    len(word_sel), h, w) u32, out_colhdr (max_frames, chw + ftr_words, w)
    u32 (`ftr_words` stages the last u32 of each column block, LEGACY's
    status footer), out_fids / out_ts (>= max_frames,); optional scan
    headers out_pkt_ts (max_frames, w // cpp) u64, out_pkt_hdrs
    (max_frames, w // cpp, hw) u32, out_first_hdr (max_frames, hw) u32;
    io_released (1,) i64 carries the released frame id across resumed
    calls. Returns (packets consumed, frames emitted), or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    payloads, offsets = _packets(payloads, offsets, pkt_bytes)
    ts = _timestamps(ts, offsets.size)
    _frame_id_layout(fid_byte, pkt_bytes)
    if (hw_bytes % 4 or cw_bytes % 4 or chw_bytes % 4
            or hw_bytes + cpp * cw_bytes > pkt_bytes
            or chw_bytes + h * pw * 4 + ftr_words * 4 > cw_bytes
            or not 0 <= mid_byte_in_col <= chw_bytes - 2 or w % cpp):
        raise ValueError("column geometry does not fit the packet")
    if word_sel is not None:
        word_sel = np.ascontiguousarray(word_sel, np.int64)
        if word_sel.ndim != 1 or word_sel.size == 0 or (
                word_sel.min() < 0 or word_sel.max() >= pw):
            raise ValueError(f"word_sel {word_sel} outside 0..{pw - 1}")
    n_planes = pw if word_sel is None else word_sel.size
    out_planes = _arr(out_planes, "out_planes", np.uint32,
                      (None, n_planes, h, w))
    m = out_planes.shape[0]
    out_colhdr = _arr(out_colhdr, "out_colhdr", np.uint32,
                      (m, chw_bytes // 4 + ftr_words, w))
    out_fids = _arr(out_fids, "out_fids", np.int64)
    out_ts = _arr(out_ts, "out_ts", np.uint64)
    if out_fids.size < m or out_ts.size < m:
        raise ValueError("out_fids / out_ts shorter than out_planes")
    n_pkts, hw = w // cpp, hw_bytes // 4
    if out_pkt_ts is not None:
        _arr(out_pkt_ts, "out_pkt_ts", np.uint64, (m, n_pkts))
    if out_pkt_hdrs is not None:
        _arr(out_pkt_hdrs, "out_pkt_hdrs", np.uint32, (m, n_pkts, hw))
    if out_first_hdr is not None:
        _arr(out_first_hdr, "out_first_hdr", np.uint32, (m, hw))
    io_released = _released(io_released)
    nframes = np.zeros(1, dtype=np.int64)
    calls["group_frames_planar"] += 1
    consumed = lib.onat_group_frames_planar(
        _ptr(payloads), _ptr(offsets), _ptr(ts), offsets.size, pkt_bytes,
        fid_byte, fid_shift, fid_mask, hw_bytes, cw_bytes, chw_bytes,
        mid_byte_in_col, cpp, h, pw, w, _ptr(out_planes), _ptr(out_colhdr),
        _ptr(out_fids), _ptr(out_ts), m, _ptr(nframes), _ptr(word_sel),
        0 if word_sel is None else word_sel.size, _ptr(out_pkt_ts),
        _ptr(out_pkt_hdrs), _ptr(out_first_hdr), _ptr(io_released),
        ftr_words)
    return int(consumed), int(nframes[0])


def udp_recv_batch(sock, stride: int, max_msgs: int = 256,
                   workspace: Optional[dict] = None):
    """Drain up to `max_msgs` datagrams of a non-blocking UDP socket with
    one recvmmsg: (payloads (n, stride) u8, sizes (n,) i64, ts_ns), one
    host timestamp for the whole batch, taken after the call returned. A
    datagram longer than `stride` is cut to it. None without the library
    or when nothing is pending. `workspace`, a dict the caller keeps,
    holds the receive buffers across calls (fresh allocations of this
    size are page-faulted on every drain); the returned arrays are views
    into it, valid until the next call with the same workspace."""
    lib = get_lib()
    if lib is None:
        return None
    if not 0 < max_msgs <= 1024 or stride <= 0:
        raise ValueError(f"max_msgs {max_msgs} outside 1..1024 or stride "
                         f"{stride} not positive")
    ws = workspace if workspace is not None else {}
    buf = ws.get("buf")
    if buf is None or buf.shape != (max_msgs, stride):
        buf = ws["buf"] = np.empty((max_msgs, stride), dtype=np.uint8)
        ws["sizes"] = np.empty(max_msgs, dtype=np.int64)
        ws["ts"] = np.zeros(1, dtype=np.uint64)
    sizes, ts = ws["sizes"], ws["ts"]
    calls["udp_recv_batch"] += 1
    n = lib.onat_udp_recv_batch(sock.fileno(), _ptr(buf), stride, max_msgs,
                                _ptr(sizes), _ptr(ts))
    if n <= 0:
        return None
    return buf[:n], sizes[:n], int(ts[0])


def group_frames_packed(payloads: np.ndarray, offsets: np.ndarray,
                        ts: Optional[np.ndarray], pkt_bytes: int,
                        fid_byte: int, fid_shift: int, fid_mask: int,
                        hw_bytes: int, cw_bytes: int, chw_bytes: int,
                        mid_byte_in_col: int, cpp: int, h: int, pw: int,
                        w: int, field_words: np.ndarray,
                        field_bits: np.ndarray, nbits: int,
                        out_planes: np.ndarray, out_colhdr: np.ndarray,
                        out_fids: np.ndarray, out_ts: np.ndarray,
                        io_released: Optional[np.ndarray] = None
                        ) -> Optional[Tuple[int, int]]:
    """Bit-packed grouping of the packets at `offsets`: out_planes
    (max_frames, n_fields, h, w * nbits // 32) u32 holds, per selected
    field (field_words[k], field_bits[k]) and pixel row, a dense LSB-first
    bitstream of each pixel's nbits bits; out_colhdr (max_frames, chw, w)
    u32 the column headers. Grouping, drops and the resume contract are
    group_frames_planar's. The caller checks that every packet's first
    measurement id is a multiple of cpp (a packet that is not is skipped
    here). Returns (packets consumed, frames emitted), or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    payloads, offsets = _packets(payloads, offsets, pkt_bytes)
    ts = _timestamps(ts, offsets.size)
    _frame_id_layout(fid_byte, pkt_bytes)
    if (hw_bytes % 4 or cw_bytes % 4 or chw_bytes % 4
            or hw_bytes + cpp * cw_bytes > pkt_bytes
            or chw_bytes + h * pw * 4 > cw_bytes
            or not 0 <= mid_byte_in_col <= chw_bytes - 2 or w % cpp):
        raise ValueError("column geometry does not fit the packet")
    if not 1 <= nbits <= 32 or w % 32 or (cpp * nbits) % 8:
        raise ValueError(f"packed staging needs 1 <= nbits <= 32, w % 32 "
                         f"== 0 and cpp * nbits % 8 == 0 (nbits {nbits}, "
                         f"w {w}, cpp {cpp})")
    field_words = np.ascontiguousarray(field_words, np.int64)
    field_bits = np.ascontiguousarray(field_bits, np.int64)
    if (field_words.ndim != 1 or field_words.size == 0
            or field_bits.shape != field_words.shape
            or field_words.min() < 0 or field_words.max() >= pw
            or field_bits.min() < 0 or field_bits.max() + nbits > 32):
        raise ValueError(f"fields {field_words}/{field_bits} outside the "
                         f"{pw} pixel words or crossing a word boundary")
    out_planes = _arr(out_planes, "out_planes", np.uint32,
                      (None, field_words.size, h, w * nbits // 32))
    m = out_planes.shape[0]
    out_colhdr = _arr(out_colhdr, "out_colhdr", np.uint32,
                      (m, chw_bytes // 4, w))
    out_fids = _arr(out_fids, "out_fids", np.int64)
    out_ts = _arr(out_ts, "out_ts", np.uint64)
    if out_fids.size < m or out_ts.size < m:
        raise ValueError("out_fids / out_ts shorter than out_planes")
    io_released = _released(io_released)
    nframes = np.zeros(1, dtype=np.int64)
    calls["group_frames_packed"] += 1
    consumed = lib.onat_group_frames_packed(
        _ptr(payloads), _ptr(offsets), _ptr(ts), offsets.size, pkt_bytes,
        fid_byte, fid_shift, fid_mask, hw_bytes, cw_bytes, chw_bytes,
        mid_byte_in_col, cpp, h, pw, w, _ptr(field_words), _ptr(field_bits),
        field_words.size, nbits, _ptr(out_planes), _ptr(out_colhdr),
        _ptr(out_fids), _ptr(out_ts), m, _ptr(nframes), _ptr(io_released))
    return int(consumed), int(nframes[0])


def bp64_encode(planes: np.ndarray, field_bits: np.ndarray, nbits: int,
                payload: np.ndarray, widths: np.ndarray,
                anchors: np.ndarray) -> int:
    """BP64-encode one frame's selected word planes (F, h, w) u32, field k
    being (planes[k] >> field_bits[k]) & (2**nbits - 1), into `payload`
    (u32, its length the capacity); widths u8 and anchors u32 are flat
    (F * h * (w // 64),). The format is ops/bp64.py's. Returns the payload
    words written, -1 when the capacity is too small (nothing past it is
    written), or -2 without the library."""
    lib = get_lib()
    if lib is None:
        return -2
    planes = _arr(planes, "planes", np.uint32, (None, None, None))
    F, h, w = planes.shape
    if w % 64 or not 1 <= nbits <= 30:
        raise ValueError(f"bp64 needs w % 64 == 0 and 1 <= nbits <= 30 "
                         f"(w {w}, nbits {nbits})")
    fb = np.ascontiguousarray(field_bits, np.int64)
    if fb.shape != (F,) or (F and (fb.min() < 0 or fb.max() > 31)):
        raise ValueError(f"field_bits {fb}: expected {F} bit offsets in "
                         f"0..31")
    payload = _arr(payload, "payload", np.uint32, (None,))
    widths = _arr(widths, "widths", np.uint8, (F * h * (w // 64),))
    anchors = _arr(anchors, "anchors", np.uint32, (F * h * (w // 64),))
    calls["bp64_encode"] += 1
    return int(lib.onat_bp64_encode(
        _ptr(planes), F, h, w, _ptr(fb), nbits, _ptr(payload), payload.size,
        _ptr(widths), _ptr(anchors)))
