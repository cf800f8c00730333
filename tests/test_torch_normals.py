"""The port's surface normals (ouster_sdk_tpu_torch/ops/normals.py and
normals_device.py) against the JAX package's on the same seeded range
images (the box room of tests/test_normals_jax.py).

Tolerances: the numpy `normals` is a copy and equal to the JAX package's
bit for bit. normals_device in float64 on the CPU matches the numpy
normals within 1e-12 on every pixel (the JAX package's x64 claim; these
scenes have no exact neighbour-distance ties). In float32 it matches
normals_jax within 1e-6 but for f32 decision flips: at most 0.05 % of the
pixels (8 of 16384) may pick another neighbour or case (measured: 2, 2
and 1 on the three scenes).
"""

import copy

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
from ouster_sdk_tpu.ops.normals import normals as jax_pkg_normals
from ouster_sdk_tpu.ops.normals_jax import normals_jax
from ouster_sdk_tpu_torch.ops.normals import normals, scan_normals
from ouster_sdk_tpu_torch.ops.normals_device import normals_device
from test_normals_jax import _synth_scene

CASES = {"single": dict(dual=False, seed=3, search=1),
         "dual": dict(dual=True, seed=3, search=1),
         "search_range_3": dict(dual=False, seed=9, search=3)}


def _inputs(case):
    c = CASES[case]
    rng_mm, xyz, rng2, xyz2 = _synth_scene(dual=c["dual"], seed=c["seed"])
    return rng_mm, xyz, rng2, xyz2, np.zeros((rng_mm.shape[1], 3)), \
        c["search"]


def _f32(a):
    return None if a is None else np.asarray(a, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_copy_equals_the_jax_package(case):
    rng_mm, xyz, rng2, xyz2, origins, search = _inputs(case)
    got = normals(xyz, rng_mm, origins, xyz2, rng2, search)
    want = jax_pkg_normals(xyz, rng_mm, origins, xyz2, rng2, search)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_matches_numpy(case):
    rng_mm, xyz, rng2, xyz2, origins, search = _inputs(case)
    want = normals(xyz, rng_mm, origins, xyz2, rng2, search)
    got = normals_device(xyz, rng_mm, origins, xyz2, rng2, search,
                         device="cpu")
    assert (got[1] is None) == (want[1] is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float64 and g.device.type == "cpu"
            assert np.abs(g.numpy() - w).max() <= 1e-12
            assert (np.linalg.norm(w, axis=-1) > 0.5).mean() > 0.3


@pytest.mark.parametrize("case", sorted(CASES))
def test_float32_matches_normals_jax(case):
    rng_mm, xyz, rng2, xyz2, origins, search = _inputs(case)
    want = normals_jax(xyz, rng_mm, origins, xyz2, rng2, search)
    got = normals_device(_f32(xyz), rng_mm, _f32(origins), _f32(xyz2),
                         rng2, search, device="cpu")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32
        diff = np.abs(g.numpy() - np.asarray(w)).max(axis=-1)
        assert int((diff > 1e-6).sum()) <= 8, int((diff > 1e-6).sum())


def test_tensors_in_tensors_out_and_validation():
    rng_mm, xyz, _, _, origins, _ = _inputs("single")
    t = torch.from_numpy(xyz.astype(np.float32))
    got, none = normals_device(t, torch.from_numpy(rng_mm.astype(np.int64)),
                               torch.zeros((rng_mm.shape[1], 3)))
    assert none is None and got.device.type == "cpu"   # the tensors' device
    want, _ = normals_device(xyz.astype(np.float32), rng_mm,
                             origins.astype(np.float32), device="cpu")
    assert torch.equal(got, want)
    empty = np.zeros((8, 16), np.uint32)
    out, _ = normals_device(np.zeros((8, 16, 3)), empty, np.zeros((16, 3)),
                            device="cpu")
    assert not out.any()
    for bad in (dict(target_distance_m=0), dict(min_angle_of_incidence_rad=0)):
        with pytest.raises(ValueError):
            normals_device(xyz, rng_mm, origins, device="cpu", **bad)
    with pytest.raises(ValueError):
        normals_device(xyz, rng_mm, np.zeros((7, 3)), device="cpu")
    with pytest.raises(ValueError):
        normals_device(xyz.astype(np.int32), rng_mm, origins, device="cpu")


def _scan():
    """A 512x10 scan of random ranges through the port's writer and
    batcher (the JAX package's test_scan_normals_jax_backend input)."""
    import ouster_sdk_tpu_torch as pt
    from ouster_sdk_tpu_torch.core.packets import LidarPacket

    info = pt.default_sensor_info(pt.LidarMode(512, 10))
    pw = pt.PacketWriter(info.format)
    b, scan = pt.ScanBatcher(info), pt.LidarScan(info)
    rng = np.random.default_rng(5)
    w, cpp, h = info.format.columns_per_frame, \
        info.format.columns_per_packet, info.format.pixels_per_column
    for p in range(w // cpp):
        buf = pw.new_packet()
        pw.set_packet_header(buf, init_id=info.init_id, prod_sn=info.sn)
        pw.set_frame_id(buf, 1)
        m0 = p * cpp
        pw.set_col_headers(buf, np.arange(cpp, dtype=np.uint64) + m0 * 1000,
                           np.arange(cpp, dtype=np.uint16) + m0,
                           np.ones(cpp, dtype=np.uint32))
        pw.set_field(buf, "RANGE", rng.integers(2000, 40000, size=(h, cpp)))
        b(LidarPacket(buf.tobytes()), scan)
    return scan


def test_scan_normals_backends():
    """scan_normals(backend="device") on the CPU writes the NORMALS field
    the numpy backend writes, up to f32 flips (<= 2 % of pixels off by
    more than 0.5 degree, the JAX package's bound for its jax backend);
    "jax" and unknown backends raise."""
    scan = _scan()
    s_np, s_dev = copy.deepcopy(scan), copy.deepcopy(scan)
    scan_normals(s_np, backend="numpy")
    scan_normals(s_dev, backend="device", device="cpu")
    a = s_np.field("NORMALS").astype(np.float64)
    b = s_dev.field("NORMALS").astype(np.float64)
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    cos = np.sum(a * b, axis=-1) / np.maximum(na * nb, 1e-300)
    both = (na > 0.5) & (nb > 0.5)
    agree = both & (np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5)
    either = (na > 0.5) | (nb > 0.5)
    assert either.sum() > 0.5 * a.shape[0] * a.shape[1]
    assert 1.0 - agree.sum() / either.sum() <= 0.02
    with pytest.raises(ValueError, match="device"):
        scan_normals(copy.deepcopy(scan), backend="jax")
    with pytest.raises(ValueError):
        scan_normals(copy.deepcopy(scan), backend="bogus")


def test_device_none_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    rng_mm, xyz, _, _, origins, _ = _inputs("single")
    with pytest.raises(RuntimeError, match="CUDA"):
        normals_device(xyz, rng_mm, origins)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_normals(_scan(), backend="device")
