"""The port's planar projection (ouster_sdk_tpu_torch.ops.planar_kernels)
against the JAX package's Pallas kernels run in interpret mode.

Tolerance: bit-exact (0 ulp) in all six kernel cases. The projection is a
chain of error-free transforms that both sides evaluate one rounding per
op; the dewarp is contracted into fused multiply-adds by the JAX package's
CPU lowering, which the port's plain version reproduces with a correctly
rounded fma. Against the float64 LUT the projection is within 1 f32 ulp.

On the CPU the wrapper takes the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (DUAL, DUAL_SPLIT, SINGLE, batch, infos, poses,
                            words)
from ouster_sdk_tpu.ops.destagger import destagger as jax_destagger
from ouster_sdk_tpu.ops.destagger import destagger_jnp
from ouster_sdk_tpu.ops.pallas_kernels import PlanarLut as JaxPlanarLut
from ouster_sdk_tpu.ops.pallas_kernels import \
    status_valid_mask_batched as jax_valid_mask
from ouster_sdk_tpu.ops.pallas_kernels import \
    unpack_project_planar_batched as jax_project
from ouster_sdk_tpu.ops.unpack import make_decode_plan as jax_plan
from ouster_sdk_tpu.ops.xyzlut import make_xyz_lut as jax_make_xyz_lut
from ouster_sdk_tpu_torch.ops import planar_kernels as pk
from ouster_sdk_tpu_torch.ops.destagger import destagger, destagger_torch
from ouster_sdk_tpu_torch.ops.unpack import make_decode_plan
from ouster_sdk_tpu_torch.ops.xyzlut import make_xyz_lut
from ouster_sdk_tpu_torch.state import (decode_plan_from_jax_fields,
                                        planar_lut_from_numpy)

PROFILES = {"single": SINGLE, "dual": DUAL, "dual_split": DUAL_SPLIT}


def _setup(profile):
    jinfo, pinfo = infos(profile)
    jplan = jax_plan(jinfo)
    jlut = JaxPlanarLut(jax_make_xyz_lut(jinfo))
    planes, hdrs = batch(jinfo, jplan)
    return jinfo, pinfo, jplan, jlut, planes, hdrs


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("profile", sorted(PROFILES.values()))
def test_xyz_lut_matches(profile):
    jinfo, pinfo = infos(profile)
    for ext in (False, True):
        want = jax_make_xyz_lut(jinfo, ext)
        got = make_xyz_lut(pinfo, ext)
        np.testing.assert_array_equal(got.direction, want.direction)
        np.testing.assert_array_equal(got.offset, want.offset)


@pytest.mark.parametrize("profile", sorted(PROFILES.values()))
def test_planar_lut_stack_bit_equal(profile):
    jinfo, pinfo = infos(profile)
    want = np.asarray(JaxPlanarLut(jax_make_xyz_lut(jinfo)).stack)
    got = pk.PlanarLut(make_xyz_lut(pinfo), "cpu").stack
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.is_contiguous()        # the layout the CUDA kernel takes
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the state bridge carries the JAX package's stack unchanged
    carried = planar_lut_from_numpy(want, "cpu").stack
    np.testing.assert_array_equal(_bits(carried.numpy()), _bits(want))


def test_state_bridge_plan():
    jinfo, pinfo = infos(DUAL)
    jplan = jax_plan(jinfo)
    assert decode_plan_from_jax_fields(dataclasses.asdict(jplan)) == \
        make_decode_plan(pinfo)


@pytest.mark.parametrize("profile", sorted(PROFILES.values()))
def test_status_valid_mask_matches(profile):
    _, _, jplan, _, _, hdrs = _setup(profile)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    want = np.asarray(jax_valid_mask(jnp.asarray(hdrs), jplan)) != 0
    got = pk.status_valid_mask_batched(words(hdrs), plan)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("dewarp", [False, True], ids=["plain", "dewarp"])
@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_planar_projection_bit_exact(kind, dewarp):
    """The six kernel cases: single, dual aligned, dual split, each with
    and without per-column poses, B=2."""
    _, pinfo, jplan, jlut, planes, hdrs = _setup(PROFILES[kind])
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    lut = planar_lut_from_numpy(np.asarray(jlut.stack), "cpu")
    dual = kind != "single"
    P = poses(2, plan.w) if dewarp else None
    want = jax_project(jnp.asarray(planes), jnp.asarray(hdrs), jlut.stack,
                       jplan, dual=dual, interpret=True, tile_w=128,
                       poses=None if P is None else jnp.asarray(P))
    before = dict(pk.launches)
    got = pk.unpack_project_planar_batched(
        words(planes), words(hdrs), lut.stack, plan, dual=dual,
        poses=None if P is None else torch.from_numpy(P))
    assert pk.launches == before      # CPU tensors launch no kernel
    want = want if dual else (want,)
    got = got if dual else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        assert (g.numpy() == 0).any() and (g.numpy() != 0).any()
    case = pk._case(plan, dual, dewarp, plan.pw,
                    tuple(f.word for f in pk._range_fields(plan, dual)))
    assert case == "planar" + ("" if kind == "single" else "_" + kind) + \
        ("_dewarp" if dewarp else "")


def _pose_operand(kind: str, P: np.ndarray) -> torch.Tensor:
    """The same poses as operands the wrapper must treat alike."""
    t = torch.from_numpy(P)
    if kind == "f64":
        return t.double()
    if kind == "strided":       # every other column of a tensor twice as wide
        wide = torch.zeros((P.shape[0], 2 * P.shape[1], 4, 4))
        wide[:, ::2] = t
        assert not wide[:, ::2].is_contiguous()
        return wide[:, ::2]
    if kind == "bottom_row":    # not (0, 0, 0, 1): never used in arithmetic
        t = t.clone()
        t[..., 3, :] = torch.tensor([float("nan"), 7.0, -3.0, 0.5])
    return t


@pytest.mark.parametrize("operand", ["f32", "f64", "strided", "bottom_row"])
@pytest.mark.parametrize("kind", ["single", "dual"])
def test_planar_dewarp_pose_operands(kind, operand):
    """float32 contiguous poses, float64 poses, a non-contiguous view and
    poses whose bottom row is garbage (with a NaN) give the same XYZ: the
    JAX package's, on the clean float32 poses, bit for bit."""
    _, _, jplan, jlut, planes, hdrs = _setup(PROFILES[kind])
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    dual = kind != "single"
    P = poses(2, plan.w, seed=11)
    want = jax_project(jnp.asarray(planes), jnp.asarray(hdrs), jlut.stack,
                       jplan, dual=dual, interpret=True, tile_w=128,
                       poses=jnp.asarray(P))
    got = pk.unpack_project_planar_batched(
        words(planes), words(hdrs), torch.from_numpy(np.array(jlut.stack)),
        plan, dual=dual, poses=_pose_operand(operand, P))
    for g, w in zip(got if dual else (got,), want if dual else (want,)):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        assert (g.numpy() != 0).any()


@pytest.mark.parametrize("kind", ["dual", "dual_split"])
def test_planar_words_subset(kind):
    """Planes carrying only the range words give the same XYZ as the full
    staging, in the JAX package and in the port."""
    _, _, jplan, jlut, planes, hdrs = _setup(PROFILES[kind])
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    ws = tuple(f.word for f in pk._range_fields(plan, True))
    sub = np.ascontiguousarray(planes[:, list(ws)])
    want = jax_project(jnp.asarray(sub), jnp.asarray(hdrs), jlut.stack,
                       jplan, dual=True, interpret=True, tile_w=128, words=ws)
    stack = torch.from_numpy(np.array(jlut.stack))
    got = pk.unpack_project_planar_batched(words(sub), words(hdrs), stack,
                                           plan, dual=True, words=ws)
    full = pk.unpack_project_planar_batched(words(planes), words(hdrs), stack,
                                            plan, dual=True)
    for g, f, w in zip(got, full, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(f.numpy()))


def test_planar_words_errors_match():
    _, _, jplan, jlut, planes, hdrs = _setup(DUAL)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    stack = torch.from_numpy(np.array(jlut.stack))
    sub = np.ascontiguousarray(planes[:, 2:3])
    for ws, msg in (((2,), "needs packet word"), (None, "pass words=")):
        with pytest.raises(ValueError, match=msg) as jerr:
            jax_project(jnp.asarray(sub), jnp.asarray(hdrs), jlut.stack,
                        jplan, dual=True, interpret=True, tile_w=128,
                        words=ws)
        with pytest.raises(ValueError, match=msg) as perr:
            pk.unpack_project_planar_batched(words(sub), words(hdrs), stack,
                                             plan, dual=True, words=ws)
        assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_planar_projection_vs_f64_lut(kind):
    """<= 1 f32 ulp of the float64 projection (floor 1e-7 m, as the JAX
    package's own parity gate)."""
    _, pinfo, _, _, planes, hdrs = _setup(PROFILES[kind])
    plan = make_decode_plan(pinfo)
    lut64 = make_xyz_lut(pinfo)
    dual = kind != "single"
    lut = pk.PlanarLut(lut64, "cpu")
    got = pk.unpack_project_planar_batched(words(planes), words(hdrs),
                                           lut.stack, plan, dual=dual)
    got = got if dual else (got,)
    valid = pk.status_valid_mask_batched(words(hdrs), plan).numpy()
    for g, f in zip(got, pk._range_fields(plan, dual)):
        r = ((planes[:, f.word] >> np.uint32(f.bit))
             & np.uint32((1 << f.size) - 1)) << np.uint32(f.upshift)
        r = np.where(valid, r, 0)
        ref = np.moveaxis(lut64(r), -1, 1)
        ulp = np.maximum(np.spacing(np.abs(ref).astype(np.float32))
                         .astype(np.float64), 1e-7)
        err = np.abs(g.numpy().astype(np.float64) - ref)
        assert (err <= ulp).all(), err.max()


def test_f32_precision_within_one_rounding():
    """precision='f32' evaluates r * dir_hi + off_hi with two roundings, as
    the TPU does; the JAX package's CPU lowering contracts it into one
    fused multiply-add. The two differ by at most the product's rounding
    plus the sum's: 1 f32 ulp of |r * dir_hi| and of the result."""
    _, _, jplan, jlut, planes, hdrs = _setup(DUAL)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    stack = np.array(jlut.stack)
    want = jax_project(jnp.asarray(planes), jnp.asarray(hdrs), jlut.stack,
                       jplan, dual=True, interpret=True, tile_w=128,
                       precision="f32")
    got = pk.unpack_project_planar_batched(
        words(planes), words(hdrs), torch.from_numpy(stack), plan,
        dual=True, precision="f32")
    valid = pk.status_valid_mask_batched(words(hdrs), plan).numpy()
    for g, w, f in zip(got, want, pk._range_fields(plan, True)):
        g, w = g.numpy(), np.asarray(w)
        r = ((planes[:, f.word] >> np.uint32(f.bit))
             & np.uint32((1 << f.size) - 1)) << np.uint32(f.upshift)
        r = np.where(valid, r, 0).astype(np.float32)[:, None]
        tol = np.spacing(np.abs(r * stack[None, 0:3])) + np.spacing(np.abs(g))
        assert (np.abs(g - w) <= tol).all()
        assert ((g == 0) == (w == 0)).all()


def test_destagger_matches():
    jinfo, pinfo = infos(DUAL)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 1 << 20, (32, 256)).astype(np.uint32)
    shifts = pinfo.format.pixel_shift_by_row
    for inverse in (False, True):
        want = jax_destagger(jinfo, img, inverse=inverse)
        np.testing.assert_array_equal(
            destagger(pinfo, img, inverse=inverse), want)
        got = destagger_torch(torch.from_numpy(img[None]), shifts,
                              inverse=inverse)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy()[0], want)
    xyz = rng.normal(0, 1, (2, 3, 32, 256)).astype(np.float32)
    want = destagger_jnp(jnp.asarray(xyz), tuple(shifts))
    np.testing.assert_array_equal(
        destagger_torch(torch.from_numpy(xyz), shifts).numpy(),
        np.asarray(want))
