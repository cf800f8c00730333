"""The port's packet-layout projection (ops/packet_kernels.py) and the
field-level projections of ops/xyzlut.py against the JAX package.

Tolerance: bit-exact (0 ulp) for precision='dd' against the JAX package's
packet-layout Pallas kernels run in interpret mode, against its op-by-op
and jitted cartesian functions, and against the port's own planar
projection on the restaged frame: both sides evaluate the double-single
chain one rounding per op. precision='f32' is two roundings in the port
and one fused multiply-add in the JAX package's CPU lowering, so those
differ by at most one rounding of the product plus one of the sum.
Against the float64 LUT the projection is within 1 f32 ulp.

On the CPU the wrapper takes the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (DUAL, DUAL_SPLIT, SINGLE, frames_batch, infos,
                            stage_planar, words)
from ouster_sdk_tpu.ops.pallas_kernels import PlanarLut as JaxPlanarLut
from ouster_sdk_tpu.ops.pallas_kernels import \
    unpack_project as jax_unpack_project
from ouster_sdk_tpu.ops.pallas_kernels import \
    unpack_project_pallas as jax_project_one
from ouster_sdk_tpu.ops.pallas_kernels import \
    unpack_project_pallas_batched as jax_project
from ouster_sdk_tpu.ops.unpack import decode_frame_batch as jax_decode
from ouster_sdk_tpu.ops.unpack import make_decode_plan as jax_plan
from ouster_sdk_tpu.ops import xyzlut as jx
from ouster_sdk_tpu_torch.ops import packet_kernels as pkt
from ouster_sdk_tpu_torch.ops import planar_kernels as pk
from ouster_sdk_tpu_torch.ops import xyzlut as px
from ouster_sdk_tpu_torch.state import (decode_plan_from_jax_fields,
                                        planar_lut_from_numpy,
                                        xyz_lut_device_from_numpy)

PROFILES = {"single": SINGLE, "dual": DUAL, "dual_split": DUAL_SPLIT}
LUT_FIELDS = ("dir_hi", "dir_lo", "off_hi", "off_lo")


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _carry(jlut) -> px.XYZLutDevice:
    """The JAX package's XYZLutDevice, carried into the port."""
    return xyz_lut_device_from_numpy(
        *(np.asarray(getattr(jlut, f)) for f in LUT_FIELDS), "cpu")


def _setup(profile):
    jinfo, pinfo = infos(profile)
    jplan = jax_plan(jinfo)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    jlut = JaxPlanarLut(jx.make_xyz_lut(jinfo))
    lut = planar_lut_from_numpy(np.asarray(jlut.stack), "cpu")
    return jinfo, pinfo, jplan, plan, jlut, lut, frames_batch(jinfo, jplan)


def _jax_planes(jlut):
    return jlut.dir_hi, jlut.dir_lo, jlut.off_hi, jlut.off_lo


@pytest.mark.parametrize("profile", sorted(PROFILES.values()))
def test_to_device_lut_bit_equal(profile):
    jinfo, pinfo = infos(profile)
    for ext in (False, True):
        want = jx.to_device_lut(jx.make_xyz_lut(jinfo, ext))
        got = px.to_device_lut(px.make_xyz_lut(pinfo, ext), "cpu")
        carried = _carry(want)
        for f in LUT_FIELDS:
            g, w = getattr(got, f), np.asarray(getattr(want, f))
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert g.is_contiguous()
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
            np.testing.assert_array_equal(
                _bits(getattr(carried, f).numpy()), _bits(w))


def test_to_device_lut_defaults_to_cuda():
    _, pinfo = infos(SINGLE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            px.to_device_lut(px.make_xyz_lut(pinfo))


def test_state_bridge_rejects_other_shapes():
    with pytest.raises(ValueError, match=r"\(h, w, 3\)"):
        xyz_lut_device_from_numpy(*[np.zeros((3, 4, 5), np.float32)] * 4,
                                  "cpu")


def test_xyz_lut_float_matches():
    jinfo, pinfo = infos(SINGLE)
    want, got = jx.make_xyz_lut_float(jinfo), px.make_xyz_lut_float(pinfo)
    assert got.direction.dtype == np.float32
    np.testing.assert_array_equal(_bits(got.direction), _bits(want.direction))
    np.testing.assert_array_equal(_bits(got.offset), _bits(want.offset))
    r = np.random.default_rng(0).integers(0, 1 << 19, (32, 256)) \
        .astype(np.uint32)
    r[r % 7 == 0] = 0
    np.testing.assert_array_equal(_bits(got(r)), _bits(want(r)))


@pytest.mark.parametrize("batched", [False, True], ids=["hw", "bhw"])
def test_cartesian_matches(batched):
    """cartesian_dd / cartesian_f32 against the op-by-op JAX functions and
    cartesian against the jitted one, bit for bit, from uint32, int32 and
    int64 range images."""
    jinfo, pinfo = infos(DUAL)
    jlut = jx.to_device_lut(jx.make_xyz_lut(jinfo))
    lut = _carry(jlut)
    shape = (3, 32, 256) if batched else (32, 256)
    r = np.random.default_rng(1).integers(0, 1 << 20, shape).astype(np.uint32)
    r[r % 5 == 0] = 0
    jr = jnp.asarray(r)
    want_dd = np.asarray(jx.cartesian_dd(jr, jlut))
    want_f32 = np.asarray(jx.cartesian_f32(jr, jlut))
    want_jit = np.asarray(jx.cartesian(jr, jlut))
    np.testing.assert_array_equal(_bits(want_dd), _bits(want_jit))
    for t in (torch.from_numpy(r), torch.from_numpy(r.astype(np.int32)),
              torch.from_numpy(r.astype(np.int64))):
        got = px.cartesian_dd(t, lut)
        assert got.dtype == torch.float32 and got.shape == (*shape, 3)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_dd))
        np.testing.assert_array_equal(_bits(px.cartesian(t, lut).numpy()),
                                      _bits(want_jit))
        np.testing.assert_array_equal(
            _bits(px.cartesian_f32(t, lut).numpy()), _bits(want_f32))
    assert (px.cartesian_dd(torch.from_numpy(r), lut).numpy()[r == 0]
            == 0).all()


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_packet_projection_matches_pallas(kind):
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(PROFILES[kind])
    dual = kind != "single"
    want = jax_project(jnp.asarray(frames), *_jax_planes(jlut), jplan,
                       tile_w=128, dual=dual, interpret=True)
    pkt.reset_launches()
    got = pkt.unpack_project_packet_batched(
        words(frames), *pkt.lut_planes(lut), plan, dual=dual)
    assert all(n == 0 for n in pkt.launches.values())   # CPU: no kernel
    want = want if dual else (want,)
    got = got if dual else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == np.asarray(w).shape == (2, 3, plan.h, plan.w)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    if dual:
        # the single-return call on a dual profile is the first return
        one = pkt.unpack_project_packet_batched(
            words(frames), *pkt.lut_planes(lut), plan)
        np.testing.assert_array_equal(_bits(one.numpy()), _bits(want[0]))


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_single_frame_wrappers_match(kind):
    """unpack_project_packet against unpack_project_pallas, and
    unpack_project with either LUT form against the JAX package's."""
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(PROFILES[kind])
    frame = frames[1]
    want = jax_project_one(jnp.asarray(frame), *_jax_planes(jlut), jplan,
                           tile_w=128, interpret=True)
    got = pkt.unpack_project_packet(words(frame), *pkt.lut_planes(lut), plan)
    assert tuple(got.shape) == (3, plan.h, plan.w)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    jdev = jx.to_device_lut(jx.make_xyz_lut(jinfo))
    for jl, pl in ((jlut, lut), (jdev, _carry(jdev))):
        want = jax_unpack_project(jnp.asarray(frame), jl, jplan, tile_w=128,
                                  interpret=True)
        got = pkt.unpack_project(words(frame), pl, plan)
        assert tuple(got.shape) == (plan.h, plan.w, 3)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_packet_projection_equals_planar_projection(kind):
    """One frame, two stagings, the same XYZ bit for bit: the generic
    double-single chain of the packet projection and the pre-split chain
    of the planar projection are both correctly rounded."""
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(PROFILES[kind])
    dual = kind != "single"
    staged = [stage_planar(f, plan) for f in frames]
    planes = np.stack([p for p, _ in staged])
    hdrs = np.stack([h for _, h in staged])
    for precision in ("dd", "f32"):
        want = pk.unpack_project_planar_batched(
            words(planes), words(hdrs), lut.stack, plan, dual=dual,
            precision=precision)
        got = pkt.unpack_project_packet_batched(
            words(frames), *pkt.lut_planes(lut), plan, dual=dual,
            precision=precision)
        for g, w in zip(got if dual else (got,), want if dual else (want,)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_packet_projection_vs_f64_lut(kind):
    """<= 1 f32 ulp of the float64 projection (floor 1e-7 m, as the JAX
    package's own parity gate)."""
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(PROFILES[kind])
    dual = kind != "single"
    lut64 = px.make_xyz_lut(pinfo)
    got = pkt.unpack_project_packet_batched(
        words(frames), *pkt.lut_planes(pk.PlanarLut(lut64, "cpu")), plan,
        dual=dual)
    fields = jax_decode(jnp.asarray(frames), jplan, True, True)
    for g, name in zip(got if dual else (got,), ("RANGE", "RANGE2")):
        ref = np.moveaxis(lut64(np.asarray(fields[name])), -1, 1)
        ulp = np.maximum(np.spacing(np.abs(ref).astype(np.float32))
                         .astype(np.float64), 1e-7)
        err = np.abs(g.numpy().astype(np.float64) - ref)
        assert (err <= ulp).all(), err.max()


def test_f32_precision_within_one_rounding():
    """precision='f32' evaluates r * dir_hi + off_hi with two roundings;
    the JAX package's CPU lowering contracts it into one fused
    multiply-add. The two differ by at most the product's rounding plus
    the sum's: 1 f32 ulp of |r * dir_hi| and of the result."""
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(DUAL)
    want = jax_project(jnp.asarray(frames), *_jax_planes(jlut), jplan,
                       tile_w=128, dual=True, interpret=True,
                       precision="f32")
    got = pkt.unpack_project_packet_batched(
        words(frames), *pkt.lut_planes(lut), plan, dual=True,
        precision="f32")
    fields = jax_decode(jnp.asarray(frames), jplan, True, True)
    dir_hi = lut.stack[0:3].numpy()
    for g, w, name in zip(got, want, ("RANGE", "RANGE2")):
        g, w = g.numpy(), np.asarray(w)
        r = np.asarray(fields[name]).astype(np.float32)[:, None]
        tol = np.spacing(np.abs(r * dir_hi[None])) + np.spacing(np.abs(g))
        assert (np.abs(g - w) <= tol).all()
        assert ((g == 0) == (w == 0)).all()


def test_per_pixel_angle_tables():
    """A DF-style sensor: azimuth and altitude tables with one entry per
    pixel (w * h), whose LUT does not factorize into per-row and
    per-column tables. The packet projection serves it like any LUT."""
    jinfo, pinfo = infos(SINGLE)
    h, w = 32, 256
    rng = np.random.default_rng(5)
    az = rng.uniform(-60, 60, h * w)
    alt = rng.uniform(-35, 35, h * w)
    kw = dict(h=h, beam_to_lidar_transform=pinfo.beam_to_lidar_transform,
              transform=pinfo.lidar_to_sensor_transform,
              azimuth_angles_deg=az, altitude_angles_deg=alt)
    lut64 = px.make_xyz_lut(w, **kw)
    want64 = jx.make_xyz_lut(w, **kw)
    np.testing.assert_array_equal(lut64.direction, want64.direction)
    np.testing.assert_array_equal(lut64.offset, want64.offset)
    # the encoder does not sweep: columns differ only through the tables
    assert not np.allclose(lut64.direction[:, 0], lut64.direction[:, 1])

    jplan = jax_plan(jinfo)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    frames = frames_batch(jinfo, jplan)
    jlut = JaxPlanarLut(want64)
    want = jax_project(jnp.asarray(frames), *_jax_planes(jlut), jplan,
                       tile_w=128, interpret=True)
    lut = pk.PlanarLut(lut64, "cpu")
    got = pkt.unpack_project_packet_batched(words(frames),
                                            *pkt.lut_planes(lut), plan)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    r = np.asarray(jax_decode(jnp.asarray(frames), jplan, True,
                              True)["RANGE"])
    ref = np.moveaxis(lut64(r), -1, 1)
    ulp = np.maximum(np.spacing(np.abs(ref).astype(np.float32))
                     .astype(np.float64), 1e-7)
    assert (np.abs(got.numpy().astype(np.float64) - ref) <= ulp).all()


def test_wrapper_rejects_what_it_does_not_take():
    jinfo, pinfo, jplan, plan, jlut, lut, frames = _setup(DUAL)
    planes = pkt.lut_planes(lut)
    with pytest.raises(ValueError, match="precision"):
        pkt.unpack_project_packet_batched(words(frames), *planes, plan,
                                          precision="f64")
    with pytest.raises(ValueError, match="int32"):
        pkt.unpack_project_packet_batched(
            torch.from_numpy(frames.astype(np.int64)), *planes, plan)
    with pytest.raises(ValueError, match="n_pkts, pkt_words"):
        pkt.unpack_project_packet_batched(words(frames)[:, :-1], *planes,
                                          plan)
    with pytest.raises(ValueError, match="not meta"):
        pkt.unpack_project_packet_batched(words(frames).to("meta"), *planes,
                                          plan)
    _, _, _, splan, _, slut, sframes = _setup(SINGLE)
    with pytest.raises(ValueError, match="RANGE2"):
        pkt.unpack_project_packet_batched(words(sframes),
                                          *pkt.lut_planes(slut), splan,
                                          dual=True)
