"""The port's device engine (io/device_engine.py) on the CPU against its
oracles, on captures synthesized from a seed: the port's ScanBatcher over
the same packet stream (with the scan sources' trailing flush), the JAX
package's ScanBatcher, and the JAX package's own DeviceScanIterator,
LiveDeviceBatcher and OsfDeviceProjector on the same file or packets.
Scans are compared field by field and header by header, dtypes included,
and by `==` after conversion; `released_at` must agree too. Tolerance 0.
"""

import time

import numpy as np
import pytest
import torch

import ouster_sdk_tpu as jx
import ouster_sdk_tpu_torch as pt
from _torch_helpers import (DUAL, SINGLE, assert_scans_equal, aux_packet,
                            batcher_scans, engine_infos, frame_packets,
                            has_nan, lidar_stream, stage_planar, write_pcap)
from ouster_sdk_tpu.io import device_engine as jde
from ouster_sdk_tpu.utils import native
from ouster_sdk_tpu_torch.io import device_engine as de
from ouster_sdk_tpu_torch.io.frames import FrameReader
from ouster_sdk_tpu_torch.ops import planar_kernels as pk

# The JAX package's engine needs its native library (g++ at first use);
# where it is absent those comparisons are left out and the batchers'
# remain.
EOF_RELEASE = de._FrameInstance.EOF_RELEASE


def _released(oracle):
    return [EOF_RELEASE if k is None else k for k, _ in oracle]


def _hold(got, want, pinfo, tag):
    """[(released_at, scan)] of the port against any oracle's."""
    assert [(r, s.frame_id) for r, s in got] == \
        [(r, s.frame_id) for r, s in want], tag
    for (r, a), (_, b) in zip(got, want):
        assert not a.fields_deferred
        assert_scans_equal(a, b, f"{tag}[{r}]")
        if not has_nan(a):
            b = b if isinstance(b, pt.LidarScan) else \
                pt.lidar_scan_from_jax(pinfo, b)
            assert a == b, f"{tag}[{r}]"


def _check_pcap(tmp_path, jinfo, pinfo, stream, oracle_stream=None,
                field_types=None, jax_field_types=None, ports=None, **kw):
    """The port's DeviceScanIterator on the capture of `stream` against
    the two batchers over `oracle_stream` (default: the same stream, whose
    positions are then the capture's datagram indices) and the JAX
    package's iterator on the same file. Returns the port's scans."""
    path = write_pcap(str(tmp_path / "capture.pcap"), stream, ports)
    de.stats.update(batches=0, scans=0)
    it = de.DeviceScanIterator(path, pinfo, device="cpu",
                               field_types=field_types, **kw)
    got = list(it.iter_released())
    assert de.stats["scans"] == len(got)
    assert de.stats["batches"] > 0 or not any(
        i.has_lidar for i in it._instances)
    own = oracle_stream is None
    oracle_stream = stream if own else oracle_stream
    for pkg, info, fts in ((pt, pinfo, field_types),
                           (jx, jinfo, jax_field_types)):
        want = batcher_scans(pkg, info, oracle_stream, field_types=fts)
        if own:
            want = list(zip(_released(want), (s for _, s in want)))
        else:       # positions differ: hold the scans alone
            want = [(r, s) for (r, _), (_, s) in zip(got, want)]
            assert len(want) == len(got)
        _hold(got, want, pinfo, pkg.__name__)
    if native.get_lib() is not None:
        jit = jde.DeviceScanIterator(path, jinfo,
                                     field_types=jax_field_types, **kw)
        _hold(got, list(jit.iter_released()), pinfo, "jax engine")
        assert it.id_error_count == jit.id_error_count
    return [s for _, s in got], it


def _frames(jinfo, fids, **kw):
    return [frame_packets(jinfo, fid, **kw) for fid in fids]


# -- DeviceScanIterator -----------------------------------------------------

@pytest.mark.parametrize("profile,size", [
    (DUAL, (32, 256)), (SINGLE, (128, 512)), ("LEGACY", (32, 256)),
    ("RNG19_RFL8_SIG16_NIR16_RGB16_DUAL", (32, 256)),
    ("FUSA_RNG15_RFL8_NIR8_DUAL", (32, 256)), ("RNG15_RFL8_WIN8", (32, 256)),
], ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_iterator_clean_capture(tmp_path, profile, size):
    """Whole frames and an open last frame, over profiles that differ in
    staging: dual words, LEGACY's footer status row (as
    test_legacy_profile_device_eligible), multi-element RGB, the FUSA
    header."""
    h, w = size
    jinfo, pinfo = engine_infos(profile, w=w, h=h)
    assert de.supports_device_decode(pinfo)
    frames = _frames(jinfo, (3, 4, 5, 6), alert_flags=3)
    stream = lidar_stream(frames)[:-2]          # the last frame stays open
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, stream)
    assert [s.frame_id for s in scans] == [3, 4, 5, 6]


def test_iterator_boundary_semantics(tmp_path):
    """Reordered stragglers and post-release duplicates drop exactly as in
    the batcher; a dropped packet leaves its columns zero."""
    jinfo, pinfo = engine_infos(DUAL)
    f1, f2, f3, f4 = _frames(jinfo, (10, 11, 12, 13))
    del f3[6]
    seq = (f1[:-1] + [f2[0]] + [f1[-1]]        # straggler while f2 builds
           + f2[1:4] + [f1[2]]                  # another straggler
           + f2[4:] + [f2[5]]                   # duplicate after release
           + f3 + f4)
    scans, it = _check_pcap(tmp_path, jinfo, pinfo, lidar_stream([seq]))
    assert [s.frame_id for s in scans] == [10, 11, 12, 13]
    assert (scans[2].status[96:112] == 0).all()
    assert [i.lidar_n for i in it._instances] == [15, 16, 15, 16]


def test_iterator_frame_id_wrap(tmp_path):
    jinfo, pinfo = engine_infos(SINGLE)
    fids = (0xFFFE, 0xFFFF, 0, 1)
    frames = _frames(jinfo, fids)
    frames[2].insert(3, frames[1][5])       # straggler across the wrap
    del frames[1][7]
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, lidar_stream(frames))
    assert [s.frame_id for s in scans] == list(fids)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_iterator_id_check(tmp_path, soft):
    """Packets whose init id or serial contradicts the metadata are
    dropped and counted unless soft_id_check."""
    jinfo, pinfo = engine_infos(DUAL, init_id=1234, sn=99887766)
    frames = _frames(jinfo, (5, 6))
    writer = jx.PacketWriter(jinfo.format)
    for k in (2, 3):
        writer.set_packet_header(frames[0][k], init_id=1241,
                                 prod_sn=99887767)
    stream = lidar_stream(frames)
    oracle = None if soft else [s for i, s in enumerate(stream)
                                if i not in (2, 3)]
    scans, it = _check_pcap(tmp_path, jinfo, pinfo, stream,
                            oracle_stream=oracle, soft_id_check=soft)
    assert it.id_error_count == 2
    assert [s.frame_id for s in scans] == [5, 6]
    assert bool(scans[0].packet_timestamp[2]) == soft


def test_iterator_zero_ts_duplicate_unstamps_slot(tmp_path):
    """The batcher writes packet_timestamp unconditionally and counts the
    NONZERO entries for completion: a zero-ts duplicate of a stamped slot
    reopens the frame until the slot is stamped again."""
    jinfo, pinfo = engine_infos(SINGLE)
    f1, f2 = _frames(jinfo, (10, 11))
    T, dt = 10**9, 10**5
    stream = [("lidar", p, T + k * dt) for k, p in enumerate(f1[:-1])]
    stream.append(("lidar", f1[0], 0))          # un-stamps slot 0
    stream.append(("lidar", f1[-1], 2 * T))     # stamps the last slot
    stream.append(("lidar", f1[0], 3 * T))      # restamp: releases here
    stream += [("lidar", p, 4 * T + k * dt) for k, p in enumerate(f2)]
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, stream)
    assert [s.frame_id for s in scans] == [10, 11]
    assert int(scans[0].packet_timestamp[0]) == 3 * T


def test_iterator_raw_fields(tmp_path):
    """RAW32_WORDk side-channels ride the device route, one staged plane
    each."""
    jinfo, pinfo = engine_infos(DUAL)
    fts = pt.resolve_field_types(pinfo, raw_fields=True)[0]
    jfts = jx.core.lidar_scan.resolve_field_types(jinfo, raw_fields=True)[0]
    assert de.supports_device_decode(pinfo, raw_fields=True)
    assert not de.supports_device_decode(pinfo, raw_headers=True)
    stream = lidar_stream(_frames(jinfo, (1, 2, 3)))
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, stream, field_types=fts,
                           jax_field_types=jfts, raw_fields=True)
    raw = [f for f in scans[0].fields if f.startswith("RAW32")]
    assert len(raw) == 4 and scans[0].field(raw[0]).any()


def test_iterator_field_names_subset(tmp_path):
    jinfo, pinfo = engine_infos(DUAL)
    names = ["RANGE", "SIGNAL2"]
    assert de.supports_device_decode(pinfo, field_names=names)
    assert not de.supports_device_decode(pinfo, field_names=["RANGE", "R"])
    fts = pt.resolve_field_types(pinfo, field_names=names)[0]
    jfts = jx.core.lidar_scan.resolve_field_types(
        jinfo, field_names=names)[0]
    stream = lidar_stream(_frames(jinfo, (1, 2, 3)))
    scans, it = _check_pcap(tmp_path, jinfo, pinfo, stream, field_types=fts,
                            jax_field_types=jfts, field_names=names)
    assert sorted(scans[0].fields) == names
    assert [f.name for f in it.plan.fields] == names


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "inline"])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_iterator_batch_sizes(tmp_path, batch, pipelined):
    """Five frames in batches of 1, of 4 and of a size that does not
    divide them; the short last batch decodes just its frames."""
    jinfo, pinfo = engine_infos(DUAL)
    stream = lidar_stream(_frames(jinfo, (1, 2, 3, 4, 5)))
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, stream, batch=batch,
                           pipelined=pipelined)
    assert len(scans) == 5
    assert de.stats["batches"] == -(-5 // batch)


def test_iterator_numbers_every_datagram(tmp_path):
    """released_at counts EVERY datagram of the capture, another sensor's
    and foreign ports' too, and the strict port filter keeps a sensor
    whose packets are absent from claiming a size-matching stream."""
    jinfo, pinfo = engine_infos(DUAL)
    frames = _frames(jinfo, (1, 2))
    stream, t = [], 10**9
    for k, p in enumerate(frames[0] + frames[1]):
        stream.append(("lidar", p, t + 2 * k))
        stream.append((7512, p, t + 2 * k + 1))     # another sensor's port
    path = write_pcap(str(tmp_path / "two.pcap"), stream)
    got = list(de.DeviceScanIterator(path, pinfo,
                                     device="cpu").iter_released())
    n = len(frames[0])
    assert [r for r, _ in got] == [2 * (n - 1), 2 * (2 * n - 1)]
    if native.get_lib() is not None:
        want = list(jde.DeviceScanIterator(path, jinfo).iter_released())
        _hold(got, want, pinfo, "jax engine")
    pinfo.config.udp_port_lidar = 7999               # absent from the file
    assert list(de.DeviceScanIterator(path, pinfo, device="cpu")) == []
    # the lenient reader (direct FrameReader use) falls back to size alone
    assert FrameReader(path, pinfo)._lidar_packets()[0].shape[0] == 4 * n


def test_iterator_empty_and_lidarless_captures(tmp_path):
    jinfo, pinfo = engine_infos(SINGLE)
    path = write_pcap(str(tmp_path / "empty.pcap"), [])
    assert list(de.DeviceScanIterator(path, pinfo, device="cpu")) == []
    # one packet with no valid column: the open frame never emits
    p = frame_packets(jinfo, 3, invalid=1.0)[0]
    path = write_pcap(str(tmp_path / "one.pcap"), [("lidar", p, 5)])
    it = de.DeviceScanIterator(path, pinfo, device="cpu")
    assert list(it) == [] and len(it._instances) == 1
    assert len(de.DeviceScanIndex(it)) == 0


def test_pipelined_pool_checkin_deferred(tmp_path):
    """Pools must not return to the freelist while yielded batches still
    sit in the pipelined queue: iterations started after the producer
    exhausted (but before the consumer drained) stage into DIFFERENT
    buffers."""
    jinfo, pinfo = engine_infos(SINGLE)
    stream = lidar_stream(_frames(jinfo, (5, 6, 7)))
    path = write_pcap(str(tmp_path / "pool.pcap"), stream)
    fr = FrameReader(path, pinfo, strict_ports=True)
    (lidx, lfid, _, _), aux = fr.hybrid_streams()
    assert aux == []
    groups = [lidx[lfid == fid] for fid in (5, 6, 7)]

    it_a = fr.iter_instance_batches_pipelined(groups, chunk=1, depth=4)
    first_a = next(it_a).planes.copy()
    time.sleep(0.3)         # A's producer stages everything and exhausts
    expected = [b.planes.copy() for b in
                fr.iter_instance_batches(groups, chunk=1)]
    got_b = [b.planes.copy() for b in
             fr.iter_instance_batches_pipelined(groups, chunk=1, depth=4)]
    got_a = [first_a] + [b.planes.copy() for b in it_a]
    assert len(got_a) == len(got_b) == len(expected) == 3
    for k in range(3):
        np.testing.assert_array_equal(got_b[k], expected[k], f"B[{k}]")
        np.testing.assert_array_equal(got_a[k], expected[k], f"A[{k}]")
    # everything checked back in: A's and B's pools were out together,
    # the inline pass had its own
    assert {k: len(v) for k, v in fr._pools.items()
            if isinstance(k, tuple)} == {("inst", 1, 6): 2, ("inst", 1, 2): 1}


def test_iterator_checks_its_pools_back_in(tmp_path):
    """A finished iteration leaves its pools on the freelist, and a
    second one over the same iterator reuses them and the cached scan."""
    jinfo, pinfo = engine_infos(SINGLE)
    path = write_pcap(str(tmp_path / "again.pcap"),
                      lidar_stream(_frames(jinfo, (1, 2, 3))))
    it = de.DeviceScanIterator(path, pinfo, device="cpu", batch=2)
    first = list(it)
    pools = {k: [id(p) for p in v] for k, v in it._reader._pools.items()
             if isinstance(k, tuple)}
    assert pools and all(len(v) == 1 for v in pools.values())
    scan_cache = it._reader._pools["scan_cache"][1]
    second = list(it)
    assert it._reader._pools["scan_cache"][1] is scan_cache
    assert {k: [id(p) for p in v] for k, v in it._reader._pools.items()
            if isinstance(k, tuple)} == pools
    assert first == second and len(first) == 3


# -- DeviceScanIndex --------------------------------------------------------

@pytest.mark.parametrize("open_valid", [True, False],
                         ids=["open-frame-valid", "open-frame-invalid"])
def test_index_random_access(tmp_path, open_valid):
    """len, frame_ids, scan_at in any order, the LRU bound, timestamps,
    and a frame left open at the end of the capture with and without a
    valid column."""
    jinfo, pinfo = engine_infos(DUAL)
    frames = _frames(jinfo, (1, 2, 3, 4, 5))
    frames.append(frame_packets(jinfo, 6,
                                invalid=0.05 if open_valid else 1.0)[:3])
    path = write_pcap(str(tmp_path / "index.pcap"), lidar_stream(frames))
    it = de.DeviceScanIterator(path, pinfo, device="cpu", batch=4)
    scans = list(it)
    index = de.DeviceScanIndex(it, cache_scans=2)
    n = 6 if open_valid else 5
    assert len(index) == len(scans) == n
    assert index.frame_ids == [s.frame_id for s in scans]
    for i in (4, 0, 3, 0, n - 1, 2, 1):
        assert index.scan_at(i) == scans[i]
        assert len(index._cache) <= 2 and len(index._order) <= 2
    hit = index.scan_at(1)
    assert index.scan_at(1) is hit                  # served from the LRU
    assert index.timestamps() == [
        s.first_valid_packet_timestamp() or s.first_valid_column_timestamp()
        for s in scans]
    assert index.timestamps() is index.timestamps()
    if native.get_lib() is not None:
        jindex = jde.DeviceScanIndex(jde.DeviceScanIterator(path, jinfo))
        assert len(jindex) == n and jindex.frame_ids == index.frame_ids
        assert jindex.timestamps() == index.timestamps()
        assert_scans_equal(index.scan_at(n - 1), jindex.scan_at(n - 1))


# -- LiveDeviceBatcher ------------------------------------------------------

def _push_all(batcher, stream):
    out = []
    for kind, payload, ts in stream:
        if kind == "lidar":
            out.extend(batcher.push(payload, ts))
        else:
            out.extend(batcher.push_aux(kind, payload, ts))
    return out


def _check_live(jinfo, pinfo, stream):
    """LiveDeviceBatcher.push over the stream: scans come out deferred,
    headers already filled, and equal the batchers' and the JAX package's
    live batcher's once touched. Returns the scans."""
    de.stats.update(batches=0, scans=0)
    live = de.LiveDeviceBatcher(pinfo, device="cpu")
    got = _push_all(live, stream)
    assert de.stats["scans"] == len(got)
    want = [s for _, s in batcher_scans(pt, pinfo, stream,
                                        trailing_flush=False)]
    assert [s.frame_id for s in got] == [s.frame_id for s in want]
    for a, b in zip(got, want):
        if a.fields_deferred:
            # headers are there before any field is touched
            for attr in ("timestamp", "measurement_id", "status",
                         "packet_timestamp", "alert_flags"):
                np.testing.assert_array_equal(getattr(a, attr),
                                              getattr(b, attr), attr)
            assert a.fields_deferred
    deferred = [s.fields_deferred for s in got]
    wantj = [s for _, s in batcher_scans(jx, jinfo, stream,
                                         trailing_flush=False)]
    for a, b, c in zip(got, want, wantj):
        assert_scans_equal(a, b, "port batcher")
        assert_scans_equal(a, c, "jax batcher")
        assert not a.fields_deferred
    if native.get_lib() is not None:
        for a, b in zip(got, _push_all(jde.LiveDeviceBatcher(jinfo),
                                       stream), strict=True):
            assert_scans_equal(a, b, "jax live batcher")
    return got, deferred


def test_live_clean_and_boundary_stream():
    jinfo, pinfo = engine_infos(DUAL)
    f1, f2, f3, f4 = _frames(jinfo, (10, 11, 12, 13), alert_flags=7,
                             shot_limiting=2, countdown_shot=9)
    del f3[6]
    seq = (f1[:-1] + [f2[0]] + [f1[-1]] + f2[1:4] + [f1[2]] + f2[4:]
           + [f2[5]] + f3 + f4)
    got, deferred = _check_live(jinfo, pinfo, lidar_stream([seq]))
    assert [s.frame_id for s in got] == [10, 11, 12, 13]
    assert all(deferred)
    assert got[0].shot_limiting_countdown == 9
    assert de.stats["batches"] == 4


def test_live_admit_releases_before_stale_drop_rules():
    """A packet that closes the open frame flushes it even when the
    PREVIOUSLY released frame's drop rules match the new id: 5*, 10, 4*,
    11* emits [5, 10, 4, 11]; released=5 matching (4+1) must NOT drop
    frame 4."""
    jinfo, pinfo = engine_infos(SINGLE)
    f5, f10, f4, f11 = _frames(jinfo, (5, 10, 4, 11))
    stream = lidar_stream([f5, f10[:1], f4, f11])
    got, _ = _check_live(jinfo, pinfo, stream)
    assert [s.frame_id for s in got] == [5, 10, 4, 11]


def test_live_legacy_bit_equal():
    """LEGACY through the live batcher: the footer status row and the
    header-less packet geometry ride the same staging."""
    jinfo, pinfo = engine_infos("LEGACY")
    got, deferred = _check_live(jinfo, pinfo,
                                lidar_stream(_frames(jinfo, (1, 2, 3))))
    assert len(got) == 3 and all(deferred)


def test_live_zero_ts_and_window():
    jinfo, pinfo = engine_infos(SINGLE, column_window=(32, 95))
    f1, f2 = ([frame_packets(jinfo, fid, invalid=0)[s] for s in range(2, 6)]
              for fid in (10, 11))
    T = 10**9
    stream = [("lidar", p, T + k) for k, p in enumerate(f1[:-1])]
    stream += [("lidar", f1[0], 0), ("lidar", f1[-1], 2 * T),
               ("lidar", f1[0], 3 * T)]
    stream += [("lidar", p, 4 * T + k) for k, p in enumerate(f2)]
    got, _ = _check_live(jinfo, pinfo, stream)
    assert [s.frame_id for s in got] == [10, 11]
    assert int(got[0].packet_timestamp[2]) == 3 * T


def test_live_duplicate_storm_grows_the_slab():
    jinfo, pinfo = engine_infos(SINGLE)
    f1, f2 = _frames(jinfo, (1, 2))
    storm = f1[:-1] + [f1[3]] * 40 + f1[-1:] + f2
    live = de.LiveDeviceBatcher(pinfo, device="cpu")
    cap = live._slab.shape[0]
    got, _ = _check_live(jinfo, pinfo, lidar_stream([storm]))
    assert [s.frame_id for s in got] == [1, 2]
    out = _push_all(live, lidar_stream([storm]))
    assert live._slab.shape[0] > cap and len(out) == 2


def test_live_dropped_scan_costs_no_readback():
    """A scan that is dropped before a field is touched never runs its
    fill; touching one scan resolves that scan alone."""
    jinfo, pinfo = engine_infos(DUAL)
    live = de.LiveDeviceBatcher(pinfo, device="cpu")
    a, b = _push_all(live, lidar_stream(_frames(jinfo, (1, 2))))
    assert a.fields_deferred and b.fields_deferred
    assert a.first_valid_column() >= 0 and a.complete() in (True, False)
    assert a.fields_deferred
    assert b.field("RANGE").any()
    assert a.fields_deferred and not b.fields_deferred
    del a


# -- OsfDeviceProjector -----------------------------------------------------

_EXT = np.array([[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -0.25],
                 [0.0, 0.0, 1.0, 1.5], [0.0, 0.0, 0.0, 1.0]])


def _range_scans(pkg_scan, info, n, seed=11):
    rng = np.random.default_rng(seed)
    scans = []
    for k in range(n):
        ls = pkg_scan(info)
        ls.frame_id = k
        for name in ("RANGE", "RANGE2"):
            if ls.has_field(name):
                r = rng.integers(1, 1 << 19, (ls.h, ls.w), dtype=np.uint32)
                r[rng.random(r.shape) < 0.05] = 0
                ls.field(name)[:] = r
        scans.append(ls)
    return scans


@pytest.mark.parametrize("profile", [SINGLE, DUAL])
@pytest.mark.parametrize("extrinsic", [None, _EXT],
                         ids=["identity", "extrinsic"])
@pytest.mark.parametrize("n,batch", [(4, 4), (5, 3)],
                         ids=["divides", "remainder"])
def test_projector_attach_and_wrap(profile, extrinsic, n, batch):
    """attach/wrap against the JAX package's projector and against the
    port's plain planar projection of the same ranges: cached_xyz for
    every (return, frame) key, bit for bit."""
    jinfo, pinfo = engine_infos(profile, extrinsic=extrinsic)
    assert de.supports_osf_device_projection(pinfo, None)
    assert not de.supports_osf_device_projection(pinfo, ["SIGNAL"])
    scans = _range_scans(pt.LidarScan, pinfo, n)
    jscans = _range_scans(jx.core.lidar_scan.LidarScan, jinfo, n)
    de.stats.update(batches=0, osf_batches=0)
    pk.reset_launches()
    proj = de.OsfDeviceProjector([pinfo], batch=batch, device="cpu")
    out = list(proj.wrap(iter([(0, s) for s in scans])))
    assert [s for _, s in out] == scans
    assert de.stats["osf_batches"] == -(-n // batch)
    assert sum(pk.launches.values()) == 0           # the CPU has no kernel
    jproj = jde.OsfDeviceProjector([jinfo], batch=batch)
    list(jproj.wrap(iter([(0, s) for s in jscans])))

    returns = ["RANGE"] + (["RANGE2"] if scans[0].has_field("RANGE2") else [])
    for use_ext in (False, True):
        lut = pt.PlanarLut(pt.make_xyz_lut(pinfo, use_ext), "cpu").stack
        for ret, name in enumerate(returns):
            for ls, jls in zip(scans, jscans):
                rng = ls.field(name)
                xyz = ls.cached_xyz(ret, use_ext, rng)
                assert xyz is not None and xyz.shape == (ls.h, ls.w, 3) \
                    and xyz.dtype == np.float32
                want = pk._proj_lean(
                    torch.from_numpy(rng.astype(np.int64))[None], lut,
                    precision="dd")[0].movedim(0, -1).numpy()
                assert np.array_equal(xyz.view(np.uint32),
                                      want.view(np.uint32))
                jxyz = jls.cached_xyz(ret, use_ext, jls.field(name))
                assert np.array_equal(xyz.view(np.uint32),
                                      np.asarray(jxyz).view(np.uint32))
                assert (xyz[rng == 0] == 0).all()
    # a mutated RANGE is refused, for both frames' keys
    rng = scans[0].field("RANGE")
    rng[1, 1] ^= 1
    assert scans[0].cached_xyz(0, False, rng) is None
    assert scans[0].cached_xyz(0, True, rng) is None
    assert scans[1].cached_xyz(0, False, scans[1].field("RANGE")) is not None


def test_projector_matches_the_planar_path():
    """The projector's XYZ of a decoded scan equals the planar path's
    projection of the staged frame it was decoded from."""
    jinfo, pinfo = engine_infos(DUAL)
    stream = lidar_stream(_frames(jinfo, (1, 2)))
    live = de.LiveDeviceBatcher(pinfo, device="cpu")
    scans = _push_all(live, stream)
    de.OsfDeviceProjector([pinfo], device="cpu").attach(
        [(0, s) for s in scans])
    pipe = pt.ScanPipeline(pinfo, device="cpu")
    frames = np.stack([np.stack(f).view("<u4") for f in
                       _frames(jinfo, (1, 2))])
    for k, ls in enumerate(scans):
        planes, hdrs = stage_planar(frames[k], pipe.plan)
        xyz1, xyz2 = pipe.project_planar(planes[None], hdrs[None])
        for ret, (name, x) in enumerate((("RANGE", xyz1), ("RANGE2", xyz2))):
            got = ls.cached_xyz(ret, False, ls.field(name))
            assert np.array_equal(
                got.view(np.uint32),
                x[0].movedim(0, -1).contiguous().numpy().view(np.uint32))


def test_projector_skips_what_it_cannot_project():
    jinfo, pinfo = engine_infos(SINGLE)
    ok = _range_scans(pt.LidarScan, pinfo, 1)[0]
    no_range = pt.LidarScan(pinfo, field_types=[
        pt.FieldType("SIGNAL", np.uint16)])
    other = pt.LidarScan(w=64, h=8)
    de.stats.update(batches=0, osf_batches=0)
    proj = de.OsfDeviceProjector([pinfo], device="cpu")
    proj.attach([(0, None), (0, no_range), (0, other)])
    assert de.stats["osf_batches"] == 0             # an empty window
    proj.attach([(0, no_range), (0, ok)])
    assert de.stats["osf_batches"] == 1
    assert ok.cached_xyz(0, True, ok.field("RANGE")) is not None


def test_project_ranges_checks_its_operands():
    lut = torch.zeros((18, 4, 16))
    assert pk.project_ranges(torch.zeros((0, 4, 16), dtype=torch.int32),
                             lut).shape == (0, 3, 4, 16)
    with pytest.raises(ValueError):
        pk.project_ranges(torch.zeros((1, 4, 16), dtype=torch.int64), lut)
    with pytest.raises(ValueError):
        pk.project_ranges(torch.zeros((4, 16), dtype=torch.int32), lut)
    with pytest.raises(ValueError):
        pk.project_ranges(torch.zeros((1, 4, 16), dtype=torch.int32), lut,
                          precision="f64")


# -- the hybrid route: IMU and zone packets mixed into lidar frames -----------

def _hybrid(zone_port=7504):
    return engine_infos("RNG19_RFL8_SIG16_NIR16_ZONE16", nmea_imu=True,
                        zone_port=zone_port)


def _aux_set(jinfo, fid, seed=0):
    """The aux packets a whole frame carries: 2 IMU packets and a zone
    packet."""
    return [("imu", aux_packet(jinfo, "imu", fid, seed, m_id0=0)),
            ("imu", aux_packet(jinfo, "imu", fid, seed, m_id0=128)),
            ("zone", aux_packet(jinfo, "zone", fid, seed))]


def _timed(items, t0=10**9, dt=10**5):
    return [(kind, p, t0 + k * dt) for k, (kind, p) in enumerate(items)]


def _lidar(pkts):
    return [("lidar", p) for p in pkts]


def _check_hybrid(tmp_path, jinfo, pinfo, items, ports=None):
    stream = _timed(items)
    scans, _ = _check_pcap(tmp_path, jinfo, pinfo, stream, ports=ports)
    live, _ = _check_live(jinfo, pinfo, stream)
    return scans, live


def test_hybrid_frames_complete_on_their_aux_packets(tmp_path):
    jinfo, pinfo = _hybrid()
    assert de._AuxApplier.wanted(pinfo)
    f1, f2 = _frames(jinfo, (1, 2))
    items = []
    for fid, f in ((1, f1), (2, f2)):
        mix = _lidar(f)
        a, b, z = _aux_set(jinfo, fid)
        mix.insert(3, a)
        mix.insert(9, z)
        items += mix + [b]
    scans, live = _check_hybrid(tmp_path, jinfo, pinfo, items)
    assert [s.frame_id for s in scans] == [1, 2] == \
        [s.frame_id for s in live]
    assert (scans[0].field("IMU_PACKET_TIMESTAMP") > 0).all()
    assert scans[0].field("ZONE_PACKET_TIMESTAMP")[0] > 0


def test_hybrid_aux_only_frame_midstream(tmp_path):
    """A frame whose packets are ALL aux is emitted with zeroed lidar
    fields in release order, not silently discarded."""
    jinfo, pinfo = _hybrid()
    f1, f3 = _frames(jinfo, (1, 3))
    items = _lidar(f1) + _aux_set(jinfo, 2) + _lidar(f3)
    scans, _ = _check_hybrid(tmp_path, jinfo, pinfo, items)
    assert [s.frame_id for s in scans] == [1, 2, 3]
    assert (scans[1].field("RANGE") == 0).all()
    assert (scans[1].field("IMU_PACKET_TIMESTAMP") > 0).any()
    assert scans[1].field("ZONE_PACKET_TIMESTAMP")[0] > 0


def test_hybrid_straggler_aux_dropped(tmp_path):
    """An aux packet of frame N arriving after frame N+1 opened is a
    reordered straggler the batcher drops."""
    jinfo, pinfo = _hybrid()
    f1, f2, f3 = _frames(jinfo, (1, 2, 3))
    zone = ("zone", aux_packet(jinfo, "zone", 1, seed=1))
    straggler = ("zone", aux_packet(jinfo, "zone", 1, seed=2))
    items = (_lidar(f1[:-1]) + [zone] + _lidar(f1[-1:]) + _lidar(f2[:1])
             + [straggler] + _lidar(f2[1:]) + _lidar(f3))
    scans, _ = _check_hybrid(tmp_path, jinfo, pinfo, items)
    assert [s.frame_id for s in scans] == [1, 2, 3]


def test_hybrid_malformed_imu_does_not_complete(tmp_path):
    """An IMU packet with a corrupt measurement id is rejected by the
    batcher's writer WITHOUT counting toward completion: the frame stays
    open for the genuine packet that follows."""
    jinfo, pinfo = _hybrid()
    f2, f3 = _frames(jinfo, (2, 3))
    a, b, z = _aux_set(jinfo, 2)
    bad = ("imu", aux_packet(jinfo, "imu", 2, seed=5, m_id0=0xFF00))
    items = _lidar(f2) + [z, a, bad, b] + _lidar(f3)
    scans, _ = _check_hybrid(tmp_path, jinfo, pinfo, items)
    assert [s.frame_id for s in scans] == [2, 3]
    n = len(f2)
    path = write_pcap(str(tmp_path / "again.pcap"), _timed(items))
    released = [r for r, _ in de.DeviceScanIterator(
        path, pinfo, device="cpu").iter_released()]
    assert released[0] == n + 3          # the genuine packet, not `bad`


def test_hybrid_aux_opener_frame_status(tmp_path):
    """When an aux packet OPENS the frame, its header supplies
    frame_status and the countdowns, not the first lidar packet's."""
    jinfo, pinfo = _hybrid()
    pf = pt.PacketFormat.from_info(pinfo)
    zone = aux_packet(jinfo, "zone", 2)
    words = zone[:pf.packet_header_size].view("<u4")
    from ouster_sdk_tpu_torch.ops.packet_format import write_bits
    for finfo, value in ((pf.geom.shot_limiting, 3),
                         (pf.geom.countdown_shot_limiting, 77),
                         (pf.geom.thermal_shutdown, 0),
                         (pf.geom.countdown_thermal_shutdown, 0)):
        write_bits(words, finfo, value)
    f1, f2, f3 = _frames(jinfo, (1, 2, 3))
    items = _lidar(f1) + [("zone", zone)] + _lidar(f2) + _lidar(f3)
    scans, live = _check_hybrid(tmp_path, jinfo, pinfo, items)
    for got in (scans, live):
        s2 = next(s for s in got if s.frame_id == 2)
        assert s2.frame_status == 3 << 4
        assert s2.shot_limiting_countdown == 77


def test_hybrid_foreign_port_rejected(tmp_path):
    """IMU-size datagrams on a port other than the configured
    udp_port_imu are rejected: no size-only fallback for aux streams."""
    jinfo, pinfo = _hybrid()
    f1, f2 = _frames(jinfo, (1, 2))
    lidar_only = _timed(_lidar(f1) + _lidar(f2))
    stream = []
    for k, item in enumerate(lidar_only):
        stream.append(item)
        if k % 8 == 0:
            stream.append((7599, aux_packet(jinfo, "imu", 1, seed=k),
                           item[2] + 1))
    path = write_pcap(str(tmp_path / "foreign.pcap"), stream)
    got = list(de.DeviceScanIterator(path, pinfo, device="cpu"))
    want = [s for _, s in batcher_scans(pt, pinfo, lidar_only)]
    assert [s.frame_id for s in got] == [s.frame_id for s in want] == [1, 2]
    for a, b in zip(got, want):
        assert_scans_equal(a, b)
    assert all((s.field("IMU_PACKET_TIMESTAMP") == 0).all() for s in got)
    if native.get_lib() is not None:
        for a, b in zip(got, jde.DeviceScanIterator(path, jinfo),
                        strict=True):
            assert_scans_equal(a, b)


def test_hybrid_aux_boundary_splits_lidar_frame(tmp_path):
    """An aux packet of the NEXT frame closes the current one: lidar
    packets of the old frame arriving after it are stragglers. Grouping
    the lidar stream alone would merge them back into the frame."""
    jinfo, pinfo = _hybrid()
    f1, f2, f3 = _frames(jinfo, (1, 2, 3))
    imu = ("imu", aux_packet(jinfo, "imu", 2, m_id0=0))
    items = (_lidar(f1[:-1]) + [imu] + _lidar(f1[-1:]) + _lidar(f2)
             + _lidar(f3))
    scans, _ = _check_hybrid(tmp_path, jinfo, pinfo, items)
    assert [s.frame_id for s in scans] == [1, 2, 3]
    assert scans[0].packet_timestamp[-1] == 0


# -- devices ----------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("shows the raise on a host without a GPU")
    jinfo, pinfo = engine_infos(SINGLE)
    path = write_pcap(str(tmp_path / "a.pcap"),
                      lidar_stream(_frames(jinfo, (1,))))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        de.DeviceScanIterator(path, pinfo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        de.LiveDeviceBatcher(pinfo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        de.OsfDeviceProjector([pinfo])
    assert de.DeviceScanIterator(path, pinfo,
                                 device="cpu").device.type == "cpu"
