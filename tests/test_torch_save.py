"""The port's save sink (io/save.py: save_scans and its writers) against the
JAX package's, on the CPU: the same scans, read from a capture synthesized
from a seed (32x256 dual, one sensor and two), saved by both packages to
every format save_scans writes (OSF, pcap, ROS1 bag, rosbag2 .db3 and
directory, MCAP, PNG, PLY, PCD, LAS, CSV) with its options (codec, message
timestamps, --split, field filters, point-cloud decimation, z band, files
of at most N points, ascii). Every file is byte-equal to the JAX
package's, except the rosbag2 sqlite storage, whose rows are compared;
every file that has a reader reads back equal through both packages, and
a file the JAX package wrote reads equal in the port. Tolerance: exact
(equal bytes, rows, arrays and dtypes)."""

import glob
import os
import sqlite3

import numpy as np
import pytest

import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.save as jsave
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.io.save as psave
from _torch_helpers import (DUAL, assert_scans_equal, engine_infos,
                            frame_packets, lidar_stream, write_pcap)

ENV = "OUSTER_SDK_TPU_DEVICE_DECODE"


def _read(root, path, **kw):
    """Every set of a source of `root` (the port: its engine or projector
    on the CPU; the JAX package: its numpy batcher)."""
    if root is pt:
        os.environ.pop(ENV, None)
        if os.path.splitext(path)[1] in (".pcap", ".osf"):
            kw["device"] = "cpu"
    else:
        os.environ[ENV] = "0"
    try:
        return list(root.open_source(path, **kw))
    finally:
        os.environ.pop(ENV, None)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """Two sensors' scans as (port infos, JAX infos, port sets, JAX sets):
    the one-sensor stream is each set's first slot."""
    d = tmp_path_factory.mktemp("save_in")
    jis, pis, pscans, jscans = [], [], [], []
    for k, (sn, port, fids) in enumerate(((1001, 7502, (1, 2, 3)),
                                          (2002, 7512, (40, 41)))):
        jinfo, pinfo = engine_infos(DUAL, init_id=11 * (k + 1), sn=sn,
                                    lidar_port=port)
        frames = [frame_packets(jinfo, fid, seed=k, alert_flags=k)
                  for fid in fids]
        path = write_pcap(str(d / f"s{k}.pcap"), lidar_stream(
            frames, t0=10**9 + k * 5 * 10**5), ports={"lidar": port})
        pscans.append([ls[0] for ls in _read(pt, path, sensor_info=[pinfo])])
        jscans.append([ls[0] for ls in _read(jx, path, sensor_info=[jinfo])])
        jis.append(jinfo)
        pis.append(pinfo)
    psets, jsets = [], []
    for scans, sets, mod in ((pscans, psets, pt), (jscans, jsets, jx)):
        for i in range(3):
            sets.append(mod.LidarScanSet(
                [s[i] if i < len(s) else None for s in scans]))
    for a, b in zip(psets, jsets):
        for x, y in zip(a, b):
            if x is not None:
                assert_scans_equal(x, y)
    return pis, jis, psets, jsets


def _one(stream):
    pis, jis, psets, jsets = stream
    return ([pis[0]], [jis[0]],
            [pt.LidarScanSet([ls[0]]) for ls in psets],
            [jx.LidarScanSet([ls[0]]) for ls in jsets])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _rows(path):
    con = sqlite3.connect(path)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("schema", "metadata", "topics", "messages")}
    finally:
        con.close()


def _same_file(a, b):
    if a.endswith(".db3"):
        assert _rows(a) == _rows(b), a
    else:
        assert _bytes(a) == _bytes(b), a


def _save_both(tmp_path, name, infos_sets, **kw):
    pis, jis, psets, jsets = infos_sets
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    pdir.mkdir(exist_ok=True)
    jdir.mkdir(exist_ok=True)
    n = psave.save_scans(str(pdir / name), pis, psets, **kw)
    m = jsave.save_scans(str(jdir / name), jis, jsets, **kw)
    assert n == m
    pfiles = sorted(os.path.relpath(f, pdir) for f in glob.glob(
        str(pdir / "**"), recursive=True) if os.path.isfile(f))
    jfiles = sorted(os.path.relpath(f, jdir) for f in glob.glob(
        str(jdir / "**"), recursive=True) if os.path.isfile(f))
    assert pfiles == jfiles and pfiles
    for f in pfiles:
        _same_file(str(pdir / f), str(jdir / f))
    return n, str(pdir), str(jdir), pfiles


CASES = {
    "osf": ("x.osf", {}),
    "osf_zpng_lidar_ts": ("x.osf", dict(encoder="zpng", ts_mode="lidar",
                                        compression_level=3)),
    "osf_fields_split": ("x.osf", dict(fields=["RANGE", "SIGNAL", "EXTRA"],
                                       split_mb=0.05, chunk_size=20000)),
    "pcap": ("x.pcap", {}),
    "pcap_split": ("x.pcap", dict(split_mb=0.15)),
    "bag": ("x.bag", {}),
    "bag_ros2": ("x.bag", dict(ros2=True)),
    "db3": ("x.db3", {}),
    "mcap": ("x.mcap", {}),
    "mcap_split": ("x.mcap", dict(split_mb=0.15)),
    "rosbag2_dir": ("rec", dict(ros2=True)),
}


@pytest.mark.parametrize("sensors", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_writers_byte_equal_and_read_back(tmp_path, stream, case, sensors):
    name, kw = CASES[case]
    data = stream if sensors == 2 else _one(stream)
    pis, jis = data[0], data[1]
    if case == "rosbag2_dir":
        n = psave._save_bag(str(tmp_path / "p" / name), pis, data[2],
                            ros2=True)
        m = jsave._save_bag(str(tmp_path / "j" / name), jis, data[3],
                            ros2=True)
        assert n == m
        pd, jd = tmp_path / "p" / name, tmp_path / "j" / name
        files = sorted(os.listdir(pd))
        assert files == sorted(os.listdir(jd)) == ["metadata.yaml",
                                                   "rec_0.db3"]
        assert _bytes(str(pd / files[0])) == _bytes(str(jd / files[0]))
        _same_file(str(pd / files[1]), str(jd / files[1]))
        outs = [(str(pd), str(jd))]
    else:
        n, pdir, jdir, files = _save_both(tmp_path, name, data, **kw)
        outs = [(os.path.join(pdir, f), os.path.join(jdir, f))
                for f in files]
        assert ("split" in case) == (len(files) > 1)
    assert n == (6 if sensors == 2 else 3) - (sensors == 2)
    want_sets = data[2]
    got_sets = []
    for pfile, jfile in outs:
        kw_read = {"sensor_info": pis} if pfile.endswith(".pcap") else {}
        jkw = {"sensor_info": jis} if pfile.endswith(".pcap") else {}
        mine = _read(pt, pfile, **kw_read)
        theirs = _read(jx, pfile, **jkw)
        cross = _read(pt, jfile, **kw_read)
        assert len(mine) == len(theirs) == len(cross)
        for a, b, c in zip(mine, theirs, cross):
            for x, y, z in zip(a, b, c):
                assert (x is None) == (y is None) == (z is None)
                if x is not None:
                    assert_scans_equal(x, y, pfile)
                    assert_scans_equal(z, y, jfile)
        got_sets += mine
    if case in ("osf", "bag", "db3", "mcap", "rosbag2_dir") and sensors == 1:
        # what was saved comes back; a bag's packets carry new receive
        # times (the first valid one plus their index)
        assert len(got_sets) == len(want_sets)
        for a, b in zip(got_sets, want_sets):
            if case != "osf":
                ts = b[0].packet_timestamp
                first = ts[ts != 0][0]
                np.testing.assert_array_equal(
                    a[0].packet_timestamp,
                    first + np.arange(len(ts), dtype=np.uint64))
                a[0].packet_timestamp[:] = ts
            assert_scans_equal(a[0], b[0], case)


PNG_CASES = {
    "all": dict(),
    "fields": dict(fields=["RANGE", "REFLECTIVITY2", "NEAR_IR"]),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_series_byte_equal(tmp_path, stream, case):
    n, pdir, _, files = _save_both(tmp_path, "shot.png", stream,
                                   **PNG_CASES[case])
    assert n == 5
    per_scan = 3 if case == "fields" else 9
    assert len(files) == 5 * per_scan
    assert all(f.startswith("shot_") for f in files)
    with pytest.raises(FileExistsError):
        psave.save_scans(os.path.join(pdir, "shot.png"), stream[0],
                         stream[2][:1], overwrite=False)


POINT_CASES = {
    "default": dict(),
    "decimate": dict(decimate=True, voxel_size=0.5),
    "z_band": dict(min_z=-2.0, max_z=1.0, field="SIGNAL"),
    "no_field_ascii": dict(field="NONE", ascii_out=True),
    "split": dict(pts_per_file=4000),
    "missing_field": dict(field="NOT_A_FIELD"),
}


@pytest.mark.parametrize("ext, case", [
    (ext, case) for ext in ("ply", "pcd", "las", "csv")
    for case in sorted(POINT_CASES)
    # csv writes text slowly: its decimation and splitting are the binary
    # formats' code
    if ext != "csv" or case not in ("decimate", "split")])
def test_point_clouds_byte_equal(tmp_path, stream, ext, case):
    data = _one(stream)
    n, pdir, jdir, files = _save_both(tmp_path, f"cloud.{ext}", data,
                                      cloud_opts=POINT_CASES[case])
    assert n == 3
    # a file a scan once the buffer passes pts_per_file
    assert len(files) == (3 if case == "split" else 1)
    for f in files:
        pts, attrs = pt.read_pointcloud(os.path.join(pdir, f))
        jpts, jattrs = jx.read_pointcloud(os.path.join(jdir, f))
        assert pts.dtype == jpts.dtype and np.array_equal(pts, jpts)
        assert sorted(attrs) == sorted(jattrs)
        for k in attrs:
            assert attrs[k].dtype == jattrs[k].dtype
            assert np.array_equal(attrs[k], jattrs[k])


def test_unsupported_and_bad_options_equal(tmp_path, stream):
    for path, kw in (("x.stl", {}), ("x.pcap", dict(ts_mode="wall"))):
        with pytest.raises(ValueError) as pe:
            psave.save_scans(str(tmp_path / path), stream[0], stream[2],
                             **kw)
        with pytest.raises(ValueError) as je:
            jsave.save_scans(str(tmp_path / path), stream[1], stream[3],
                             **kw)
        assert str(pe.value) == str(je.value)
    assert [p.tobytes() for p in psave.scan_to_packets(
        stream[2][0][0], stream[0][0])] == [p.tobytes() for p in
                                            jsave.scan_to_packets(
        stream[3][0][0], stream[1][0])]
