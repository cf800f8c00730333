"""The port's LUT-free projection (ops/lutfree_kernels.py) against the JAX
package's ops/pallas_lutfree.py, whose Pallas kernels run in interpret
mode with a small tile.

Tolerance: 0 (bit-exact) for the factor tables and for the three
double-single cases (packet layout one return, both returns, planar
staging): both sides evaluate the error-free transforms one rounding per
op. The f32 case is one rounding an op in the port and is contracted into
three fused multiply-adds by the JAX package's CPU lowering; that
contraction is shown to be the whole difference, and the port's result is
held within a stated bound of it (test_f32_differs_by_contraction_alone).
Against the float64 LUT the double-single cases are within 1 f32 ulp.

On the CPU the wrappers take the plain versions; the CUDA kernels are held
against them on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (DUAL, DUAL_SPLIT, PROFILES, SINGLE, frames_batch,
                            infos, perturb_frame, stage_planar, synth_frame,
                            words)
from ouster_sdk_tpu.ops import pallas_lutfree as jl
from ouster_sdk_tpu.ops import profiles as jprofiles
from ouster_sdk_tpu.ops.unpack import decode_frame_batch as jax_decode
from ouster_sdk_tpu.ops.unpack import make_decode_plan as jax_plan
from ouster_sdk_tpu_torch.ops import lutfree_kernels as lf
from ouster_sdk_tpu_torch.ops import profiles as pprofiles
from ouster_sdk_tpu_torch.ops import xyzlut as px
from ouster_sdk_tpu_torch.ops.precision import fma_f32
from ouster_sdk_tpu_torch.state import (decode_plan_from_jax_fields,
                                        factor_tables_from_numpy)

#: every profile whose scan field set has a RANGE plane (all of them in one
#: u32 word): FIVE_WORD_PIXEL decodes raw words only
ELIGIBLE = tuple(p for p in PROFILES if p != "FIVE_WORD_PIXEL")
DUAL_PROFILES = (DUAL, DUAL_SPLIT, "RNG15_RFL8_NIR8_DUAL",
                 "FUSA_RNG15_RFL8_NIR8_DUAL")
LEAVES = jl.FactorTables._LEAVES
TILE = dict(tile_w=128, interpret=True)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _leaves(jtables) -> dict:
    return {n: np.asarray(getattr(jtables, n)) for n in LEAVES}


def _random_frames(jinfo, jplan, seeds=(1, 2)) -> np.ndarray:
    """(B, n_pkts, pkt_words) frames whose pixel words are random in every
    bit, then some columns' status cleared and some ranges zeroed."""
    frame = synth_frame(jinfo)
    rng = np.random.default_rng(11)
    cols = frame[:, jplan.hw:jplan.hw + jplan.cpp * jplan.cw].reshape(
        jplan.w, jplan.cw)
    cols[:, jplan.chw:jplan.chw + jplan.h * jplan.pw] = rng.integers(
        0, 1 << 32, (jplan.w, jplan.h * jplan.pw), dtype=np.uint32)
    frame[:, jplan.hw:jplan.hw + jplan.cpp * jplan.cw] = cols.reshape(
        jplan.n_pkts, jplan.cpp * jplan.cw)
    return np.stack([perturb_frame(frame, jplan, s) for s in seeds])


def _setup(profile, w=256, h=32, random_words=True):
    jinfo, pinfo = infos(profile, w=w, h=h)
    jplan = jax_plan(jinfo)
    plan = decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    jtables = jl.FactorTables(jinfo)
    tables = factor_tables_from_numpy(_leaves(jtables), "cpu")
    frames = (_random_frames(jinfo, jplan) if random_words
              else frames_batch(jinfo, jplan))
    return jinfo, pinfo, jplan, plan, jtables, tables, frames


def _restage(frames, plan):
    staged = [stage_planar(f, plan) for f in frames]
    return (np.stack([p for p, _ in staged]),
            np.stack([h for _, h in staged]))


# -- FactorTables and lutfree_supported --------------------------------------

@pytest.mark.parametrize("ext", [False, True], ids=["sensor", "extrinsics"])
@pytest.mark.parametrize("profile", [SINGLE, DUAL])
def test_factor_tables_bit_equal(profile, ext):
    jinfo, pinfo = infos(profile)
    c, s = np.cos(0.3), np.sin(0.3)
    extrinsic = np.array([[c, -s, 0, 1.5], [s, c, 0, -0.25], [0, 0, 1, 2.0],
                          [0, 0, 0, 1]])
    jinfo.extrinsic = extrinsic.copy()
    pinfo.extrinsic = extrinsic.copy()
    want = _leaves(jl.FactorTables(jinfo, use_extrinsics=ext))
    got = lf.FactorTables(pinfo, use_extrinsics=ext, device="cpu")
    carried = factor_tables_from_numpy(want, "cpu")
    h, w = pinfo.format.pixels_per_column, pinfo.format.columns_per_frame
    for n in LEAVES:
        for t in (getattr(got, n), getattr(carried, n)):
            assert t.dtype == torch.float32 and t.is_contiguous()
            assert tuple(t.shape) == want[n].shape == (
                (1, w) if n[:2] in ("ce", "se") else (3, h, 1))
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(want[n]))
    # the packed buffers hold the same values where the kernels read them
    for t in (got, carried):
        assert tuple(t.rows.shape) == (h, 36) and t.rows.is_contiguous()
        assert tuple(t.cols.shape) == (w, 4) and t.cols.is_contiguous()
        for k, n in enumerate(LEAVES[:12]):
            np.testing.assert_array_equal(
                _bits(t.rows[:, 3 * k:3 * k + 3].numpy()),
                _bits(want[n][:, :, 0].T))
        for k, n in enumerate(LEAVES[12:]):
            np.testing.assert_array_equal(_bits(t.cols[:, k].numpy()),
                                          _bits(want[n][0]))
    if ext:   # the extrinsic reached the tables
        plain = _leaves(jl.FactorTables(jinfo))
        assert (plain["G"] != want["G"]).any()


def test_factor_tables_default_to_cuda_and_check_their_leaves():
    jinfo, pinfo = infos(SINGLE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lf.FactorTables(pinfo)
    leaves = _leaves(jl.FactorTables(jinfo))
    with pytest.raises(ValueError, match="missing"):
        factor_tables_from_numpy({k: v for k, v in leaves.items()
                                  if k != "se_lo"}, "cpu")
    with pytest.raises(ValueError, match="must be"):
        factor_tables_from_numpy({**leaves, "Q": leaves["Q"][:, :, 0]},
                                 "cpu")


def _per_pixel(info):
    h, w = info.format.pixels_per_column, info.format.columns_per_frame
    rng = np.random.default_rng(9)
    info.beam_azimuth_angles = list(rng.uniform(-3, 3, h * w))
    info.beam_altitude_angles = list(rng.uniform(-20, 20, h * w))
    return info


def test_factor_tables_reject_per_pixel_angle_tables():
    jinfo, pinfo = infos(SINGLE)
    with pytest.raises(ValueError, match="per-row beam angles"):
        jl.FactorTables(_per_pixel(jinfo))
    with pytest.raises(ValueError, match="per-row beam angles"):
        lf.FactorTables(_per_pixel(pinfo), device="cpu")
    assert not jl.lutfree_supported(jinfo)
    assert not lf.lutfree_supported(pinfo)


@pytest.mark.parametrize("profile", PROFILES)
def test_lutfree_supported_matches(profile):
    jinfo, pinfo = infos(profile)
    want = jl.lutfree_supported(jinfo)
    assert lf.lutfree_supported(pinfo) == want == (profile in ELIGIBLE)


def test_lutfree_supported_refuses_a_word_spanning_range(monkeypatch):
    """A profile whose RANGE crosses a u32 word boundary (bits 20..38 of
    the pixel block) is ineligible in both packages."""
    jinfo, pinfo = infos(SINGLE)
    assert lf.lutfree_supported(pinfo) and jl.lutfree_supported(jinfo)
    for mod, info in ((jprofiles, jinfo), (pprofiles, pinfo)):
        profile = info.format.udp_profile_lidar
        entry = mod.PROFILES[profile]
        fields = dict(entry.fields)
        fields["RANGE"] = mod.fi(20, 19)
        monkeypatch.setitem(mod.PROFILES, profile,
                            dataclasses.replace(entry, fields=fields))
    assert not jl.lutfree_supported(jinfo)
    assert not lf.lutfree_supported(pinfo)
    plan = lf.make_decode_plan(pinfo)
    with pytest.raises(NotImplementedError, match="word-spanning"):
        lf.unpack_project_lutfree_dd(
            torch.zeros((1, plan.n_pkts, plan.pkt_words), dtype=torch.int32),
            lf.FactorTables(pinfo, device="cpu"), plan)


# -- the double-single cases, bit for bit ------------------------------------

@pytest.mark.parametrize("profile", ELIGIBLE)
def test_dd_matches_pallas(profile):
    """_lutfree_dd_kernel, B=2, every eligible profile (pw from 1 to 5,
    upshifts, the LEGACY status word in the column footer)."""
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(profile)
    want = np.asarray(jl.unpack_project_lutfree_dd(
        jnp.asarray(frames), jt, jplan, **TILE))
    lf.reset_launches()
    got = lf.unpack_project_lutfree_dd(words(frames), tables, plan)
    assert all(n == 0 for n in lf.launches.values())    # CPU: no kernel
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, 3, plan.h, plan.w)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # cleared columns and zero ranges are there, and sit at the origin
    r = np.asarray(jax_decode(jnp.asarray(frames), jplan, True,
                              True)["RANGE"])
    assert 0 < (r == 0).sum() < r.size
    assert (got.numpy()[np.broadcast_to((r == 0)[:, None], want.shape)]
            == 0).all()


@pytest.mark.parametrize("profile", [SINGLE, DUAL, "LEGACY"])
def test_dd_single_frame_matches_pallas(profile):
    """A 2-D frame is one frame: (3, h, w), from the port's own tables."""
    jinfo, pinfo, jplan, plan, jt, _, frames = _setup(profile)
    tables = lf.FactorTables(pinfo, device="cpu")
    want = np.asarray(jl.unpack_project_lutfree_dd(
        jnp.asarray(frames[1]), jt, jplan, **TILE))
    got = lf.unpack_project_lutfree_dd(words(frames[1]), tables, plan)
    assert tuple(got.shape) == want.shape == (3, plan.h, plan.w)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("profile", DUAL_PROFILES)
def test_dd_dual_matches_pallas(profile):
    """_lutfree_dd_dual_kernel: both returns, B=2 and a single 2-D frame;
    dual=False on the same profile projects RANGE alone."""
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(profile)
    want = jl.unpack_project_lutfree_dd(jnp.asarray(frames), jt, jplan,
                                        dual=True, **TILE)
    got = lf.unpack_project_lutfree_dd(words(frames), tables, plan,
                                       dual=True)
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 3, plan.h, plan.w)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert not torch.equal(got[0], got[1])
    one = lf.unpack_project_lutfree_dd(words(frames), tables, plan)
    assert torch.equal(one.view(torch.int32), got[0].view(torch.int32))
    want1 = jl.unpack_project_lutfree_dd(jnp.asarray(frames[0]), jt, jplan,
                                         dual=True, **TILE)
    got1 = lf.unpack_project_lutfree_dd(words(frames[0]), tables, plan,
                                        dual=True)
    for g, w in zip(got1, want1):
        assert tuple(g.shape) == (3, plan.h, plan.w)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("profile", [SINGLE, DUAL, DUAL_SPLIT, "LEGACY",
                                     "RNG15_RFL8_NIR8"])
def test_planar_matches_pallas_and_the_packet_layout(profile):
    """_lutfree_dd_planar_kernel on the restaged frames: bit-equal to the
    JAX package and to the packet-layout double-single case; 3-D planes
    are one frame and keep the batch axis."""
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(profile)
    planes, hdrs = _restage(frames, plan)
    want = np.asarray(jl.unpack_project_lutfree_planar(
        jnp.asarray(planes), jnp.asarray(hdrs), jt, jplan, **TILE))
    lf.reset_launches()
    got = lf.unpack_project_lutfree_planar(words(planes), words(hdrs),
                                           tables, plan)
    assert all(n == 0 for n in lf.launches.values())
    assert tuple(got.shape) == want.shape == (2, 3, plan.h, plan.w)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    packet = lf.unpack_project_lutfree_dd(words(frames), tables, plan)
    assert torch.equal(got.view(torch.int32), packet.view(torch.int32))
    one = lf.unpack_project_lutfree_planar(words(planes[1]), words(hdrs[1]),
                                           tables, plan)
    want1 = np.asarray(jl.unpack_project_lutfree_planar(
        jnp.asarray(planes[1]), jnp.asarray(hdrs[1]), jt, jplan, **TILE))
    assert tuple(one.shape) == want1.shape == (1, 3, plan.h, plan.w)
    np.testing.assert_array_equal(_bits(one.numpy()), _bits(want1))


def test_dd_matches_pallas_at_128_rows():
    """128 x 512 dual-return, the frame as the synthesizer writes it."""
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(
        DUAL, w=512, h=128, random_words=False)
    want = jl.unpack_project_lutfree_dd(jnp.asarray(frames[:1]), jt, jplan,
                                        dual=True, **TILE)
    got = lf.unpack_project_lutfree_dd(words(frames[:1]), tables, plan,
                                       dual=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("profile", [SINGLE, DUAL, "RNG15_RFL8_NIR8_DUAL"])
def test_dd_within_one_ulp_of_f64_lut(profile):
    """<= 1 f32 ulp of the float64 projection (floor 1e-7 m, as the JAX
    package's own parity gate), both stagings, both returns."""
    jinfo, pinfo, jplan, plan, jt, _, frames = _setup(profile)
    tables = lf.FactorTables(pinfo, device="cpu")
    lut64 = px.make_xyz_lut(pinfo)
    dual = profile != SINGLE
    got = lf.unpack_project_lutfree_dd(words(frames), tables, plan,
                                       dual=dual)
    planes, hdrs = _restage(frames, plan)
    planar = lf.unpack_project_lutfree_planar(words(planes), words(hdrs),
                                              tables, plan)
    fields = jax_decode(jnp.asarray(frames), jplan, True, True)
    outs = dict(zip(("RANGE", "RANGE2"), got if dual else (got,)))
    for name, g in [*outs.items(), ("RANGE", planar)]:
        ref = np.moveaxis(lut64(np.asarray(fields[name])), -1, 1)
        ulp = np.maximum(np.spacing(np.abs(ref).astype(np.float32))
                         .astype(np.float64), 1e-7)
        err = np.abs(g.numpy().astype(np.float64) - ref)
        assert (err <= ulp).all(), (name, (err / ulp).max())


# -- the f32 case ------------------------------------------------------------

@pytest.mark.parametrize("profile,w,h", [(SINGLE, 256, 32), (DUAL, 512, 128),
                                         ("RNG15_RFL8_NIR8", 256, 32)])
def test_f32_differs_by_contraction_alone(profile, w, h):
    """_lutfree_kernel. The port evaluates dir = (ce*P + se*Q) + S,
    off = (ce*E + se*F) + G, xyz = r*dir + off with one rounding an op, as
    the Pallas source reads. The JAX package's CPU lowering contracts three
    of the multiply-adds: dir = fma(ce, P, se*Q) + S,
    off = fma(ce, E, se*F) + G, xyz = fma(r, dir, off). Built with those
    fmas from the port's tables and the port's extracted range, the chain
    equals the JAX result bit for bit, so contraction is the whole
    difference.

    Bound of the port's own result against it. Each contraction removes
    one rounding, so with u = 2**-24 the two dirs differ by at most
    5u * D, D = |ce*P| + |se*Q| + |S| (the product's rounding, then two
    roundings on either side), the two offs by 5u * O,
    O = |ce*E| + |se*F| + |G|, and the results by
    r * 5u * D + u * r * D + 5u * O + 2u * (r * D + O) <= 8u * M to first
    order, M = r * D + O: that is 8 f32 ulp of |r*dir| + |off| with the
    absolute values taken term by term (a component of dir may cancel to
    far less than its terms, so ulps of the result itself bound nothing).
    """
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(
        profile, w=w, h=h, random_words=h == 32)
    frames = frames[:1] if h == 128 else frames
    want = np.asarray(jl.unpack_project_lutfree(jnp.asarray(frames), jt,
                                                jplan, **TILE))
    lf.reset_launches()
    got = lf.unpack_project_lutfree(words(frames), tables, plan)
    assert all(n == 0 for n in lf.launches.values())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    one = lf.unpack_project_lutfree(words(frames[0]), tables, plan)
    assert torch.equal(one.view(torch.int32), got[0].view(torch.int32))

    t = tables
    (r,) = lf.packet_ranges(words(frames), plan, False)
    r = lf._range_f32(r)                                    # (B, 1, h, w)
    ce, se = t.ce[None], t.se[None]
    dirs = fma_f32(ce, t.P, se * t.Q) + t.S
    off = fma_f32(ce, t.E, se * t.F) + t.G
    contracted = torch.where(r != 0, fma_f32(r, dirs, off),
                             torch.zeros((), dtype=torch.float32))
    np.testing.assert_array_equal(_bits(contracted.numpy()), _bits(want))

    d = lambda x: x.to(torch.float64)   # noqa: E731
    D = (d(ce) * d(t.P)).abs() + (d(se) * d(t.Q)).abs() + d(t.S).abs()
    O = (d(ce) * d(t.E)).abs() + (d(se) * d(t.F)).abs() + d(t.G).abs()
    M = (d(r) * D + O).numpy()
    bound = 8 * np.spacing(M.astype(np.float32)).astype(np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), (err / bound).max()
    assert ((got.numpy() == 0) == (want == 0)).all()
    assert (err > 0).any()      # the two chains do differ
    # and within the f32 budget of the float64 LUT the reference states
    # for this case: ~r * 3e-7 (twice that, floor 2e-6 m)
    rng = np.asarray(jax_decode(jnp.asarray(frames), jplan, True,
                                True)["RANGE"])
    ref = np.moveaxis(px.make_xyz_lut(pinfo)(rng), -1, 1)
    r_m = rng.astype(np.float64)[:, None] * 1e-3
    budget = np.maximum(3e-7 * np.maximum(r_m, 1.0) * 2, 2e-6)
    assert (np.abs(got.numpy() - ref) <= budget).all()


# -- what the wrappers refuse ------------------------------------------------

def test_wrappers_reject_what_they_do_not_take():
    jinfo, pinfo, jplan, plan, jt, tables, frames = _setup(DUAL)
    planes, hdrs = _restage(frames, plan)
    with pytest.raises(ValueError, match="int32"):
        lf.unpack_project_lutfree_dd(
            torch.from_numpy(frames.astype(np.int64)), tables, plan)
    with pytest.raises(ValueError, match="n_pkts, pkt_words"):
        lf.unpack_project_lutfree(words(frames)[:, :-1], tables, plan)
    with pytest.raises(ValueError, match="not meta"):
        lf.unpack_project_lutfree_dd(words(frames).to("meta"), tables, plan)
    with pytest.raises(ValueError, match=r"\(B, pw, h, w\)"):
        lf.unpack_project_lutfree_planar(words(planes)[:, :1], words(hdrs),
                                         tables, plan)
    with pytest.raises(ValueError, match="col_hdrs"):
        lf.unpack_project_lutfree_planar(words(planes), words(hdrs)[:1],
                                         tables, plan)
    with pytest.raises(ValueError, match="int32"):
        lf.unpack_project_lutfree_planar(
            torch.from_numpy(planes.astype(np.int64)), words(hdrs), tables,
            plan)
    _, _, _, splan, _, stables, sframes = _setup(SINGLE)
    with pytest.raises(ValueError, match="RANGE2"):
        lf.unpack_project_lutfree_dd(words(sframes), stables, splan,
                                     dual=True)
    _, _, _, fplan, _, ftables, fframes = _setup("FIVE_WORD_PIXEL")
    with pytest.raises(ValueError, match="RANGE"):
        lf.unpack_project_lutfree_dd(words(fframes), ftables, fplan)
