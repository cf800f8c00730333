"""Point-cloud file IO: PLY, PCD, CSV, LAS.

Rebuild of the reference cloud_io (ref: ouster_client/src/cloud_io.cpp:281 —
PLY/PCD ASCII+binary read for localization maps; CLI save adds CSV/LAS,
ref: plugins/source_save.py).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "ushort": np.uint16, "uint16": np.uint16,
    "short": np.int16, "int16": np.int16,
    "uint": np.uint32, "uint32": np.uint32,
    "int": np.int32, "int32": np.int32,
}
_INV_PLY = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
            np.dtype(np.uint8): "uchar", np.dtype(np.uint16): "ushort",
            np.dtype(np.uint32): "uint", np.dtype(np.int32): "int"}


def read_pointcloud(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read points + named attributes; dispatch on extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return _read_ply(path)
    if ext == ".pcd":
        return _read_pcd(path)
    if ext == ".csv":
        data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        return data[:, :3], {}
    if ext == ".las":
        return _read_las(path)
    raise ValueError(f"unsupported point cloud format {ext}")


def write_pointcloud(path: str, points: np.ndarray, *, kind: str = None,
                     attributes: Optional[Dict[str, np.ndarray]] = None,
                     binary: bool = True) -> None:
    kind = kind or os.path.splitext(path)[1].lstrip(".").lower()
    attributes = attributes or {}
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if kind == "ply":
        _write_ply(path, points, attributes, binary)
    elif kind == "pcd":
        _write_pcd(path, points, attributes, binary)
    elif kind == "csv":
        cols = [points]
        header = "x,y,z"
        for name, a in attributes.items():
            cols.append(np.asarray(a, dtype=np.float64).reshape(-1, 1))
            header += f",{name}"
        np.savetxt(path, np.hstack(cols), delimiter=",", header=header,
                   comments="")
    elif kind == "las":
        _write_las(path, points, attributes)
    else:
        raise ValueError(f"unsupported point cloud format {kind}")


# -- PLY --------------------------------------------------------------------

def _read_ply(path: str):
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        props = []
        count = 0
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(
                    "truncated PLY header (no end_header)")
            line = line.strip()
            if not line:
                continue
            tok = line.split()
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                props.append((tok[2].decode(),
                              _PLY_DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break

        dt = np.dtype([(n, t) for n, t in props])
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            rec = np.zeros(count, dtype=dt)
            for i, (n, _) in enumerate(props):
                rec[n] = rows[:, i]
        else:
            if fmt == "binary_big_endian":
                dt = dt.newbyteorder(">")
            rec = np.frombuffer(f.read(count * dt.itemsize), dtype=dt,
                                count=count)
        pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(
            np.float64)
        attrs = {n: np.asarray(rec[n]) for n, _ in props
                 if n not in ("x", "y", "z")}
        return pts, attrs


def _write_ply(path, points, attributes, binary):
    n = points.shape[0]
    props = [("x", np.dtype(np.float32)), ("y", np.dtype(np.float32)),
             ("z", np.dtype(np.float32))]
    cols = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    for name, a in attributes.items():
        a = np.asarray(a)
        dt = a.dtype if a.dtype in _INV_PLY else np.dtype(np.float32)
        props.append((name, dt))
        cols[name] = a.astype(dt)
    with open(path, "wb") as f:
        fmt = "binary_little_endian" if binary else "ascii"
        header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
        header += [f"property {_INV_PLY[dt]} {name}" for name, dt in props]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        rec = np.zeros(n, dtype=np.dtype(props))
        for name, _ in props:
            rec[name] = cols[name]
        if binary:
            f.write(rec.tobytes())
        else:
            np.savetxt(f, np.stack([cols[name] for name, _ in props],
                                   axis=1), fmt="%.6f")


# -- PCD --------------------------------------------------------------------

_PCD_TYPES = {("F", 4): np.float32, ("F", 8): np.float64,
              ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
              ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32}


def _read_pcd(path: str):
    with open(path, "rb") as f:
        fields = sizes = types = counts = None
        n = 0
        data_kind = "ascii"
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError("truncated PCD header (no DATA line)")
            line = raw.decode(errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            tok = line.split()
            key = tok[0].upper()
            if key == "FIELDS":
                fields = tok[1:]
            elif key == "SIZE":
                sizes = [int(x) for x in tok[1:]]
            elif key == "TYPE":
                types = tok[1:]
            elif key == "COUNT":
                counts = [int(x) for x in tok[1:]]
            elif key == "POINTS":
                n = int(tok[1])
            elif key == "DATA":
                data_kind = tok[1]
                break
        dt_items = []
        for i, name in enumerate(fields):
            base = _PCD_TYPES[(types[i], sizes[i])]
            cnt = counts[i] if counts else 1
            dt_items.append((name, base, (cnt,)) if cnt > 1
                            else (name, base))
        dt = np.dtype(dt_items)
        if data_kind == "ascii":
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            rec = np.zeros(n, dtype=dt)
            for i, name in enumerate(fields):
                rec[name] = rows[:, i]
        elif data_kind == "binary":
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        else:
            raise ValueError(f"unsupported PCD data {data_kind}")
        pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(
            np.float64)
        attrs = {name: np.asarray(rec[name]) for name in fields
                 if name not in ("x", "y", "z")}
        return pts, attrs


def _write_pcd(path, points, attributes, binary):
    n = points.shape[0]
    fields = ["x", "y", "z"] + list(attributes)
    cols = {"x": points[:, 0].astype(np.float32),
            "y": points[:, 1].astype(np.float32),
            "z": points[:, 2].astype(np.float32)}
    for name, a in attributes.items():
        cols[name] = np.asarray(a, dtype=np.float32)
    with open(path, "wb") as f:
        hdr = [
            "# .PCD v0.7 - Point Cloud Data file format",
            "VERSION 0.7",
            "FIELDS " + " ".join(fields),
            "SIZE " + " ".join("4" for _ in fields),
            "TYPE " + " ".join("F" for _ in fields),
            "COUNT " + " ".join("1" for _ in fields),
            f"WIDTH {n}", "HEIGHT 1",
            "VIEWPOINT 0 0 0 1 0 0 0",
            f"POINTS {n}",
            "DATA " + ("binary" if binary else "ascii"),
        ]
        f.write(("\n".join(hdr) + "\n").encode())
        stacked = np.stack([cols[name] for name in fields], axis=1)
        if binary:
            f.write(np.ascontiguousarray(stacked, dtype="<f4").tobytes())
        else:
            np.savetxt(f, stacked, fmt="%.6f")


# -- LAS (1.2, point format 0/1) -------------------------------------------

def _write_las(path, points, attributes):
    n = points.shape[0]
    scale = 0.001
    mins = points.min(axis=0) if n else np.zeros(3)
    maxs = points.max(axis=0) if n else np.zeros(3)
    with open(path, "wb") as f:
        header = bytearray(227)
        header[0:4] = b"LASF"
        header[24] = 1   # version major
        header[25] = 2   # version minor
        struct.pack_into("<H", header, 94, 227)       # header size
        struct.pack_into("<I", header, 96, 227)       # offset to points
        struct.pack_into("<I", header, 100, 0)        # n VLRs
        header[104] = 0                               # point format 0
        struct.pack_into("<H", header, 105, 20)       # point record length
        struct.pack_into("<I", header, 107, n)        # legacy point count
        struct.pack_into("<ddd", header, 131, scale, scale, scale)
        # offset = per-axis minimum so int32-coded residuals stay small
        # even for georeferenced (e.g. UTM) coordinates
        struct.pack_into("<ddd", header, 155, *mins)
        struct.pack_into("<dd", header, 179, maxs[0], mins[0])
        struct.pack_into("<dd", header, 195, maxs[1], mins[1])
        struct.pack_into("<dd", header, 211, maxs[2], mins[2])
        f.write(header)
        coded = np.round((points - mins) / scale)
        if coded.size and (np.abs(coded) > np.iinfo(np.int32).max).any():
            raise ValueError(
                "LAS int32 overflow: point extent too large for scale "
                f"{scale}")
        xyz = coded.astype(np.int32)
        rec = np.zeros(n, dtype=np.dtype([
            ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
            ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
            ("rank", "i1"), ("user", "u1"), ("src", "<u2")]))
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        if "reflectivity" in attributes:
            rec["intensity"] = np.asarray(
                attributes["reflectivity"]).astype(np.uint16)
        f.write(rec.tobytes())


def _read_las(path: str):
    with open(path, "rb") as f:
        header = f.read(227)
        if header[:4] != b"LASF":
            raise ValueError("not a LAS file")
        offset = struct.unpack_from("<I", header, 96)[0]
        point_len = struct.unpack_from("<H", header, 105)[0]
        n = struct.unpack_from("<I", header, 107)[0]
        sx, sy, sz = struct.unpack_from("<ddd", header, 131)
        ox, oy, oz = struct.unpack_from("<ddd", header, 155)
        f.seek(offset)
        raw = np.frombuffer(f.read(n * point_len), dtype=np.uint8)
        raw = raw.reshape(n, point_len)
        xyz_i = raw[:, :12].copy().view("<i4").reshape(n, 3)
        pts = xyz_i.astype(np.float64) * [sx, sy, sz] + [ox, oy, oz]
        intensity = raw[:, 12:14].copy().view("<u2").reshape(n)
        return pts, {"intensity": intensity}
