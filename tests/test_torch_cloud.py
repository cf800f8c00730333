"""The port's point-cloud files (io/cloud_io.py: PLY, PCD, LAS read and
write, CSV write and read) and their scan source (io/cloud_source.py:
scan_from_points, CloudScanSource behind open_source for .ply/.pcd/.las/
.csv) against the JAX package's, on the CPU, with clouds made from a seed:
written files byte-equal, files read equal through both packages (and the
JAX package's files read equal in the port), one-scan sources equal scan
for scan. Tolerance: exact (equal bytes, arrays and dtypes)."""

import os

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.cloud_io as jcio
import ouster_sdk_tpu.io.cloud_source as jcs
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.cloud_io as pcio
import ouster_sdk_tpu_torch.io.cloud_source as pcs
from _torch_helpers import assert_scans_equal


def _cloud(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=20.0, size=(n, 3))
    attrs = {"reflectivity": rng.integers(0, 256, n).astype(np.uint8),
             "signal": rng.integers(0, 65536, n).astype(np.uint16),
             "range": rng.integers(0, 2**20, n).astype(np.uint32),
             "t": rng.random(n).astype(np.float64)}
    return pts, attrs


WRITES = [(kind, binary, with_attrs)
          for kind in ("ply", "pcd", "las", "csv")
          for binary in ((True, False) if kind in ("ply", "pcd") else (True,))
          for with_attrs in (False, True)]


@pytest.mark.parametrize("kind, binary, with_attrs", WRITES)
def test_write_byte_equal_and_read_equal(tmp_path, kind, binary,
                                         with_attrs):
    pts, attrs = _cloud()
    attrs = attrs if with_attrs else None
    p, j = str(tmp_path / f"p.{kind}"), str(tmp_path / f"j.{kind}")
    pt.io.write_pointcloud(p, pts, attributes=attrs, binary=binary)
    jcio.write_pointcloud(j, pts, attributes=attrs, binary=binary)
    with open(p, "rb") as a, open(j, "rb") as b:
        assert a.read() == b.read()
    for path in (p, j):
        got, gattrs = pcio.read_pointcloud(path)
        want, wattrs = jcio.read_pointcloud(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert sorted(gattrs) == sorted(wattrs)
        for k in gattrs:
            assert gattrs[k].dtype == wattrs[k].dtype
            assert np.array_equal(gattrs[k], wattrs[k]), k


def test_read_variants_equal(tmp_path):
    """A big-endian PLY with comments and another element, a PCD with
    comments and a multi-count field, a LAS with a longer record."""
    pts, _ = _cloud(50, seed=2)
    ply = str(tmp_path / "be.ply")
    rec = np.zeros(50, np.dtype([("x", ">f4"), ("y", ">f4"), ("z", ">f4"),
                                 ("intensity", ">u2")]))
    rec["x"], rec["y"], rec["z"] = pts.T
    rec["intensity"] = np.arange(50)
    with open(ply, "wb") as f:
        f.write(b"ply\nformat binary_big_endian 1.0\ncomment made here\n"
                b"element vertex 50\nproperty float x\nproperty float y\n"
                b"property float z\nproperty ushort intensity\n"
                b"element face 0\nproperty list uchar int vertex_indices\n"
                b"end_header\n" + rec.tobytes())
    pcd = str(tmp_path / "multi.pcd")
    body = np.zeros(50, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                  ("n", "<f4", (3,)), ("rgb", "<u4")]))
    body["x"], body["y"], body["z"] = pts.T
    body["n"] = pts[:, ::-1]
    body["rgb"] = np.arange(50) * 77
    with open(pcd, "wb") as f:
        f.write(b"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z n rgb\n"
                b"SIZE 4 4 4 4 4\nTYPE F F F F U\nCOUNT 1 1 1 3 1\n"
                b"WIDTH 50\nHEIGHT 1\n\nPOINTS 50\nDATA binary\n"
                + body.tobytes())
    las = str(tmp_path / "x.las")
    jcio.write_pointcloud(las, pts, attributes={
        "reflectivity": np.arange(50, dtype=np.uint8)})
    for path in (ply, pcd, las):
        got, gattrs = pcio.read_pointcloud(path)
        want, wattrs = jcio.read_pointcloud(path)
        assert np.array_equal(got, want)
        assert sorted(gattrs) == sorted(wattrs)
        for k in gattrs:
            assert gattrs[k].dtype == wattrs[k].dtype
            assert np.array_equal(gattrs[k], wattrs[k]), k


def test_errors_equal(tmp_path):
    bad = {"x.xyz": b"", "x.ply": b"plx\n", "t.ply": b"ply\nformat ascii 1.0\n",
           "t.pcd": b"VERSION 0.7\n", "x.las": b"NOPE" + bytes(300)}
    for name, data in bad.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError) as pe:
            pcio.read_pointcloud(path)
        with pytest.raises(ValueError) as je:
            jcio.read_pointcloud(path)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError):
        pcio.write_pointcloud(str(tmp_path / "x.stl"), np.zeros((2, 3)))


@pytest.mark.parametrize("n, h", [(1000, None), (77, None), (1, None),
                                  (300, 16)])
def test_scan_from_points_equal(n, h):
    pts, attrs = _cloud(n, seed=n)
    attrs["near_ir"] = attrs.pop("signal")
    attrs["ambient"] = attrs["near_ir"]
    got = pcs.scan_from_points(pts, attrs, h=h)
    want = jcs.scan_from_points(pts, attrs, h=h)
    assert_scans_equal(got, want)
    assert got.sensor_info.to_json_string() == \
        want.sensor_info.to_json_string()


@pytest.mark.parametrize("kind", ["ply", "pcd", "las", "csv"])
def test_cloud_scan_source_equal(tmp_path, kind):
    pts, attrs = _cloud(500, seed=4)
    path = str(tmp_path / f"c.{kind}")
    jcio.write_pointcloud(path, pts, attributes=attrs)
    ext = np.eye(4)
    ext[:3, 3] = (1.0, -2.0, 0.5)
    for kw in ({}, {"extrinsics": [ext]}, {"index": True}):
        src = pt.open_source(path, **kw)
        jsrc = jx.open_source(path, **kw)
        assert type(src).__name__ == "CloudScanSource"
        assert src.is_indexed and len(src) == 1 and src.scans_num == [1]
        got, want = list(src), list(jsrc)
        assert len(got) == len(want) == 1
        assert_scans_equal(got[0][0], want[0][0], kind)
        assert_scans_equal(src[0][0], want[0][0], kind)
        assert_scans_equal(src[-1][0], src[0:1][0][0], kind)
        assert np.array_equal(src.sensor_info[0].extrinsic,
                              jsrc.sensor_info[0].extrinsic)
        with pytest.raises(IndexError):
            src[1]
    # the XYZ field holds the file's points (f32), RANGE their norm in mm
    scan = pt.open_source(path)[0][0]
    xyz = scan.field("XYZ").transpose(1, 0, 2).reshape(-1, 3)[:500]
    want_pts = pt.read_pointcloud(path)[0]
    assert np.array_equal(xyz, want_pts.astype(np.float32))
    with pytest.raises(Exception, match="not supported"):
        pt.open_source(path, device="cpu")
