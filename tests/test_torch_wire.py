"""The port's wire stagings (ops/packed.py, ops/bp64.py, the packed and BP64
iterators and ChunkFuser of io/frames.py, the native encoder and packer)
against the JAX package on the same seeded inputs.

Tolerance: 0 differing bytes or elements everywhere but precision='f32',
which is held within one rounding of the product and one of the sum (the
JAX package's CPU lowering contracts r * dir + off into one fma; the port
rounds twice, as tests/test_torch_planar.py states for the planar path).
The projections with poses are bit-equal too: both packages dewarp after
the projection in the order of `einsum("bwij,bjhw->bihw") + t`, which the
port writes as ops/pose.rotate_translate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (DUAL, SINGLE, engine_infos, frame_packets,
                            lidar_stream, poses, write_pcap)
from test_bp64 import _cases
from ouster_sdk_tpu.io.frames import ChunkFuser as JaxChunkFuser
from ouster_sdk_tpu.io.frames import FrameReader as JaxFrameReader
from ouster_sdk_tpu.ops import bp64 as jbp64
from ouster_sdk_tpu.ops import packed as jpacked
from ouster_sdk_tpu.ops.pallas_kernels import PlanarLut as JaxPlanarLut
from ouster_sdk_tpu.ops.unpack import make_decode_plan as jax_plan
from ouster_sdk_tpu.ops.xyzlut import make_xyz_lut as jax_make_xyz_lut
from ouster_sdk_tpu_torch.io.frames import (ChunkFuser, FrameReader,
                                            fused_pipelined)
from ouster_sdk_tpu_torch.ops import bp64, packed
from ouster_sdk_tpu_torch.ops import planar_kernels as pk
from ouster_sdk_tpu_torch.ops.unpack import make_decode_plan
from ouster_sdk_tpu_torch.ops.xyzlut import make_xyz_lut
from ouster_sdk_tpu_torch.utils import native

CAPTURES = [(SINGLE, 256), (DUAL, 256), (SINGLE, 512), (DUAL, 512)]


def _t(x: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor, u32 as its int32 view (the port's words)."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _np_unpack(packed_row, nbits, w):
    """Independent numpy bit reader of one LSB-first stream."""
    bits = np.unpackbits(packed_row.view(np.uint8), bitorder="little")
    weights = (1 << np.arange(nbits, dtype=np.uint64))
    return bits[: w * nbits].reshape(w, nbits).astype(np.uint64) \
        .dot(weights).astype(np.uint32)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """6 frames of each (profile, w) at h = 32, written by both packages'
    PcapWriters (held byte-equal)."""
    out = {}
    for profile, w in CAPTURES:
        jinfo, pinfo = engine_infos(profile, w=w)
        stream = lidar_stream([frame_packets(jinfo, fid, seed=3)
                               for fid in range(1, 7)])
        path = write_pcap(str(tmp_path_factory.mktemp("wire")
                              / f"{profile}_{w}.pcap"), stream)
        out[(profile, w)] = (jinfo, pinfo, path)
    return out


# -- unpack_bits --------------------------------------------------------------

@pytest.mark.parametrize("nbits", [15, 19, 1, 30])
def test_unpack_bits(nbits):
    rng = np.random.default_rng(nbits)
    w = 128
    vals = rng.integers(0, 1 << nbits, size=(2, 3, w), dtype=np.uint64)
    bits = ((vals[..., None] >> np.arange(nbits, dtype=np.uint64)) & 1
            ).astype(np.uint8).reshape(2, 3, -1)
    stream = np.packbits(bits, axis=-1, bitorder="little").view("<u4")
    got = packed.unpack_bits(_t(stream), nbits, w)
    assert got.dtype == torch.int64
    want = np.asarray(jpacked.unpack_bits(jnp.asarray(stream), nbits, w))
    _same(got.numpy().astype(np.uint32), want)
    _same(want, vals.astype(np.uint32))
    _same(_np_unpack(stream[1, 2], nbits, w), want[1, 2])
    with pytest.raises(ValueError, match="multiple of 32"):
        packed.unpack_bits(_t(stream), nbits, w - 1)


# -- BP64 ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_cases()))
def test_bp64_encoder_byte_equal(name):
    v, _ = _cases()[name]
    for got, want in zip(bp64.bp64_encode_numpy(v, 19),
                         jbp64.bp64_encode_numpy(v, 19)):
        assert got.dtype == want.dtype
        _same(got, want, name)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_bp64_decode_equals_jnp(name):
    """The torch decode equals bp64_decode_jnp with the decoder's two slack
    words and without them (the clamped gathers). An empty payload (every
    block constant) makes jnp's gather raise; the port decodes it to the
    anchors, the values."""
    v, w = _cases()[name]
    pay, wid, anc = bp64.bp64_encode_numpy(v, 19)
    slack = np.concatenate([pay, np.zeros(2, np.uint32)])
    want = np.asarray(jbp64.bp64_decode_jnp(
        jnp.asarray(slack), jnp.asarray(wid), jnp.asarray(anc), w))
    _same(want, v)
    _same(bp64.bp64_decode_numpy(pay, wid, anc, w), v)
    got = bp64.bp64_decode_torch(_t(slack), _t(wid), _t(anc), w)
    _same(got.numpy().astype(np.uint32), want)
    got = bp64.bp64_decode_torch(_t(pay), _t(wid), _t(anc), w)
    if pay.size:
        _same(got.numpy().astype(np.uint32), np.asarray(
            jbp64.bp64_decode_jnp(jnp.asarray(pay), jnp.asarray(wid),
                                  jnp.asarray(anc), w)))
    else:
        with pytest.raises(TypeError):
            jbp64.bp64_decode_jnp(jnp.asarray(pay), jnp.asarray(wid),
                                  jnp.asarray(anc), w)
        _same(got.numpy().astype(np.uint32), v)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_bp64_native_encoder_equals_numpy(name):
    """The native encoder reads (word >> 4) & (2**19 - 1) out of words with
    other bits set around the value and writes the numpy encoder's bytes."""
    if native.get_lib() is None:
        pytest.skip("no g++: bp64_encode reads -2 and the numpy encoder runs")
    v, w = _cases()[name]
    F, h = v.shape[0], v.shape[1]
    rng = np.random.default_rng(5)
    planes = ((v << 4) | rng.integers(0, 16, v.shape, dtype=np.uint32)
              | (rng.integers(0, 256, v.shape, dtype=np.uint32) << 24)
              ).astype(np.uint32)
    ref = bp64.bp64_encode_numpy(v, 19)
    nb = F * h * (w // 64)
    pay = np.zeros(ref[0].size + 16, np.uint32)
    wid, anc = np.zeros(nb, np.uint8), np.zeros(nb, np.uint32)
    native.reset_calls()
    used = native.bp64_encode(planes, np.full(F, 4), 19, pay, wid, anc)
    assert native.calls["bp64_encode"] == 1
    assert used == ref[0].size
    _same(pay[:used], ref[0])
    _same(wid, ref[1].reshape(-1))
    _same(anc, ref[2].reshape(-1))
    if used:    # too small a capacity reads -1
        small = np.full(used - 1, 7, np.uint32)
        assert native.bp64_encode(planes, np.full(F, 4), 19, small, wid,
                                  anc) == -1


def test_native_wrappers_check_their_arguments(monkeypatch):
    if native.get_lib() is None:
        pytest.skip("no g++")
    planes = np.zeros((1, 2, 64), np.uint32)
    pay, wid, anc = (np.zeros(64, np.uint32), np.zeros(2, np.uint8),
                     np.zeros(2, np.uint32))
    bad = [
        (planes.astype(np.int32), [0], 19, pay, wid, anc),
        (np.zeros((1, 2, 96), np.uint32), [0], 19, pay, wid, anc),
        (planes, [0], 31, pay, wid, anc),
        (planes, [0, 0], 19, pay, wid, anc),
        (planes, [0], 19, pay[::2], wid, anc),
        (planes, [0], 19, pay, np.zeros(3, np.uint8), anc),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            native.bp64_encode(*args)
    with pytest.raises(ValueError, match="crossing a word"):
        native.group_frames_packed(
            np.zeros(160, np.uint8), np.zeros(0, np.int64), None, 160, 0, 0,
            0xFFFF, 16, 16, 8, 0, 8, 1, 2, 32, [0], [20], 19,
            np.zeros((1, 1, 1, 19), np.uint32),
            np.zeros((1, 2, 32), np.uint32), np.zeros(1, np.int64),
            np.zeros(1, np.uint64))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.bp64_encode(planes, [0], 19, pay, wid, anc) == -2
    assert native.group_frames_packed(None, None, None, *[0] * 15, None,
                                      None, None, None) is None


# -- the stagings -------------------------------------------------------------

def _fields(pinfo, profile):
    plan = make_decode_plan(pinfo)
    return (plan,) + packed.packed_range_fields(plan, profile == DUAL)


@pytest.mark.parametrize("profile,w", CAPTURES)
def test_stagings_equal_the_jax_reader(captures, profile, w):
    """iter_packed_chunks and iter_bp64_chunks give the JAX FrameReader's
    arrays, and the locked ship width; the packed bits are the planar
    words' fields."""
    jinfo, pinfo, path = captures[(profile, w)]
    plan, fields, nbits, _ = _fields(pinfo, profile)
    assert (fields, nbits) == jpacked.packed_range_fields(
        jax_plan(jinfo), profile == DUAL)[:2]
    native.reset_calls()
    got = [[a.copy() for a in c] for c in FrameReader(path, pinfo)
           .iter_packed_chunks(4, fields=fields, nbits=nbits)]
    assert native.calls["group_frames_packed"] == 2
    want = list(JaxFrameReader(path, info=jinfo).iter_packed_chunks(
        4, fields=fields, nbits=nbits))
    assert [c[0].tolist() for c in got] == [[1, 2, 3, 4], [5, 6]]
    for g, x in zip(got, want):
        for a, b in zip(g, x):
            _same(a, b, "packed")
    planar = list(FrameReader(path, pinfo).iter_planar_chunks(
        4, words=tuple(f[0] for f in fields)))
    for (_, pks, _, _), (_, planes, _, _) in zip(got, planar):
        for k, (_, bit) in enumerate(fields):
            vals = (planes[:, k] >> np.uint32(bit)) & np.uint32(
                (1 << nbits) - 1)
            _same(_np_unpack(pks[1, k, 5], nbits, w), vals[1, 5])

    reader, jreader = FrameReader(path, pinfo), JaxFrameReader(path,
                                                               info=jinfo)
    for _ in range(2):     # the ship width survives a second iteration
        got = [[a.copy() for a in c] for c in reader.iter_bp64_chunks(
            4, fields=fields, nbits=nbits)]
        want = list(jreader.iter_bp64_chunks(4, fields=fields, nbits=nbits))
        assert len(got) == len(want) == 2
        for g, x in zip(got, want):
            for a, b in zip(g, x):
                _same(a, b, "bp64")
        assert reader._bp64_ship == jreader._bp64_ship
        assert {c[1].shape[1] for c in got} == set(
            reader._bp64_ship.values())


def test_bp64_poisoned_tail_is_never_read(captures):
    """Every word past a frame's coded payload, slack words included, set to
    0xDEADBEEF: the decode still gives the planar staging's ranges."""
    jinfo, pinfo, path = captures[(DUAL, 512)]
    plan, fields, nbits, ups = _fields(pinfo, DUAL)
    planar = list(FrameReader(path, pinfo).iter_planar_chunks(
        4, words=tuple(f[0] for f in fields)))
    chunks = list(FrameReader(path, pinfo).iter_bp64_chunks(
        4, fields=fields, nbits=nbits))
    for (fids, pay, wid, anc, _, _), (_, planes, _, _) in zip(chunks,
                                                              planar):
        pay = pay.copy()
        w_ = (wid & 0x1F).astype(np.int64)
        used = (2 * w_ + 2 * (wid >> 7)).reshape(wid.shape[0], -1).sum(1)
        for i, u in enumerate(used):
            pay[i, u:] = 0xDEADBEEF
        for i in range(fids.size):
            vals = bp64.bp64_decode_torch(_t(pay[i]), _t(wid[i]),
                                          _t(anc[i]), plan.w).numpy()
            for k, (_, bit) in enumerate(fields):
                want = (planes[i, k] >> np.uint32(bit)) & np.uint32(
                    (1 << nbits) - 1)
                _same(vals[k].astype(np.uint32), want)


def test_bp64_staging_without_the_library(captures, monkeypatch):
    """Without g++ bp64_encode reads -2 and the numpy encoder codes the same
    bytes; packed staging refuses, as the JAX package does."""
    _, pinfo, path = captures[(DUAL, 256)]
    _, fields, nbits, _ = _fields(pinfo, DUAL)
    want = [[a.copy() for a in c] for c in FrameReader(path, pinfo)
            .iter_bp64_chunks(4, fields=fields, nbits=nbits)]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = list(FrameReader(path, pinfo).iter_bp64_chunks(
        4, fields=fields, nbits=nbits))
    for g, x in zip(got, want):
        for a, b in zip(g, x):
            _same(a, b)
    with pytest.raises(RuntimeError, match="needs the native library"):
        list(FrameReader(path, pinfo).iter_packed_chunks(
            4, fields=fields, nbits=nbits))


def test_packed_refusals(captures, tmp_path):
    jinfo, pinfo, path = captures[(SINGLE, 256)]
    plan, fields, nbits, _ = _fields(pinfo, SINGLE)
    reader = FrameReader(path, pinfo)
    with pytest.raises(ValueError, match="non-empty"):
        list(reader.iter_packed_chunks(4, fields=(), nbits=nbits))
    with pytest.raises(RuntimeError, match="crosses a word"):
        list(reader.iter_packed_chunks(4, fields=((0, 20),), nbits=nbits))
    with pytest.raises(ValueError, match="1 <= nbits <= 30"):
        list(reader.iter_bp64_chunks(4, fields=fields, nbits=31))
    # a packet whose first measurement id is not a multiple of cpp
    frames = [frame_packets(jinfo, fid, seed=3) for fid in (1, 2)]
    buf = frames[0][1].copy()
    off = FrameReader(path, pinfo).pf.packet_header_size + plan.mid_word * 4
    buf[off] = 3
    frames[0][1] = buf
    bad = write_pcap(str(tmp_path / "misaligned.pcap"), lidar_stream(frames))
    with pytest.raises(RuntimeError, match="non-aligned"):
        list(FrameReader(bad, pinfo).iter_packed_chunks(
            4, fields=fields, nbits=nbits))


# -- the projections ---------------------------------------------------------

def _chunk(captures, profile):
    """The first chunk (4 frames) of the 32x256 capture through the three
    stagings, and both packages' LUT stacks."""
    jinfo, pinfo, path = captures[(profile, 256)]
    plan, fields, nbits, ups = _fields(pinfo, profile)
    pks = next(FrameReader(path, pinfo).iter_packed_chunks(
        4, fields=fields, nbits=nbits))
    b64 = next(FrameReader(path, pinfo).iter_bp64_chunks(
        4, fields=fields, nbits=nbits))
    planar = next(FrameReader(path, pinfo).iter_planar_chunks(4))
    jlut = JaxPlanarLut(jax_make_xyz_lut(jinfo))
    stack = pk.PlanarLut(make_xyz_lut(pinfo), "cpu").stack
    return (jax_plan(jinfo), plan, nbits, ups, [a.copy() for a in pks],
            [a.copy() for a in b64], planar, jlut, stack)


@pytest.mark.parametrize("profile", [SINGLE, DUAL])
@pytest.mark.parametrize("with_poses", [False, True])
def test_projections_equal_jax(captures, profile, with_poses):
    jplan, plan, nbits, ups, pks, b64, planar, jlut, stack = _chunk(
        captures, profile)
    dual = profile == DUAL
    P = poses(4, plan.w, seed=11) if with_poses else None
    jP = None if P is None else jnp.asarray(P)
    tP = None if P is None else torch.from_numpy(P)
    kw = dict(upshifts=ups, dual=dual)
    got_p = packed.project_packed_batched(_t(pks[1]), _t(pks[2]), stack,
                                          plan, nbits, poses=tP, **kw)
    want_p = jpacked.project_packed_batched(
        jnp.asarray(pks[1]), jnp.asarray(pks[2]), jlut.stack, jplan, nbits,
        poses=jP, **kw)
    got_b = bp64.project_bp64_batched(*map(_t, b64[1:5]), stack, plan,
                                      nbits, poses=tP, **kw)
    want_b = jbp64.project_bp64_batched(*map(jnp.asarray, b64[1:5]),
                                        jlut.stack, jplan, nbits, poses=jP,
                                        **kw)
    as_t = (lambda x: x) if dual else (lambda x: (x,))
    for g, x in zip(as_t(got_p) + as_t(got_b), as_t(want_p) + as_t(want_b)):
        assert g.dtype == torch.float32
        _same(g.numpy(), np.asarray(x))
    if not with_poses:     # the same bits as the planar staging's
        ref = pk.unpack_project_planar_batched(
            _t(planar[1]), _t(planar[2]), stack, plan, dual=dual)
        for g, x in zip(as_t(got_b), as_t(ref)):
            _same(g.numpy(), x.numpy())


def test_f32_precision_within_one_rounding(captures):
    jplan, plan, nbits, ups, pks, _, _, jlut, stack = _chunk(captures, DUAL)
    got = packed.project_packed_batched(_t(pks[1]), _t(pks[2]), stack, plan,
                                        nbits, upshifts=ups, dual=True,
                                        precision="f32")
    want = jpacked.project_packed_batched(
        jnp.asarray(pks[1]), jnp.asarray(pks[2]), jlut.stack, jplan, nbits,
        upshifts=ups, dual=True, precision="f32")
    valid = pk.status_valid_mask_batched(_t(pks[2]), plan).numpy()
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        r = packed.unpack_bits(_t(pks[1][:, k]), nbits, plan.w).numpy()
        r = np.where(valid, r << ups[k], 0).astype(np.float32)[:, None]
        tol = (np.spacing(np.abs(r * stack.numpy()[None, 0:3]))
               + np.spacing(np.abs(g)))
        assert (np.abs(g - w) <= tol).all()
        assert ((g == 0) == (w == 0)).all()


def test_single_frame_and_argument_checks(captures):
    _, plan, nbits, ups, pks, b64, _, _, stack = _chunk(captures, DUAL)
    batch = bp64.project_bp64_batched(*map(_t, b64[1:5]), stack, plan,
                                      nbits, upshifts=ups, dual=True)
    one = bp64.project_bp64_batched(*(_t(a[2]) for a in b64[1:5]), stack,
                                    plan, nbits, upshifts=ups, dual=True)
    for b, o in zip(batch, one):
        _same(o.numpy(), b.numpy()[2:3])
    with pytest.raises(ValueError, match="upshifts"):
        packed.project_packed_batched(_t(pks[1]), _t(pks[2]), stack, plan,
                                      nbits, upshifts=(0,), dual=True)
    with pytest.raises(ValueError, match="precision"):
        pk.project_ranges_batched([torch.zeros(1, plan.h, plan.w,
                                               dtype=torch.int64)],
                                  _t(pks[2][:1]), stack, plan,
                                  precision="f16")


# -- ChunkFuser, unfuse_words, fused_pipelined --------------------------------

def test_pack_unfuse_roundtrip():
    rng = np.random.default_rng(0)
    pool = np.arange(8 * 16, dtype=np.uint32).reshape(8, 16)
    arrs = [
        rng.integers(0, 2**32, (3, 5), dtype=np.uint32),
        rng.integers(0, 255, (7, 3), dtype=np.uint8),     # pads to words
        rng.integers(0, 2**16, (5,), dtype=np.uint16),    # odd count
        rng.normal(size=(2, 3)).astype(np.float32),
        pool[:4, :10],                                     # strided view
        rng.integers(0, 255, (4, 2), dtype=np.uint8)[:, ::2],
    ]
    fused, layout = ChunkFuser().pack(arrs)
    jfused, jlayout = JaxChunkFuser().pack(arrs)
    assert layout == jlayout
    _same(fused, jfused)
    hash(layout)
    back = packed.unfuse_words(_t(fused), layout)
    for a, b in zip(arrs, back):
        b = b.numpy()
        if a.dtype == np.uint32:
            assert b.dtype == np.int32
            b = b.view(np.uint32)
        assert b.dtype == a.dtype
        _same(b, a)


def test_pool_ring_and_unsupported_dtype():
    f = ChunkFuser(pool_depth=3)
    outs = [f.pack([np.full((4,), i, np.uint32)])[0] for i in range(3)]
    for i, o in enumerate(outs):     # three packs, three buffers, all valid
        assert (o == i).all()
    fused, layout = ChunkFuser().pack([np.zeros(2, np.uint64)])
    with pytest.raises(ValueError, match="unsupported dtype"):
        packed.unfuse_words(_t(fused), layout)


def test_fused_pipelined_order_and_layout():
    def make_iter():
        for i in range(5):
            yield i, np.full((3,), i, np.uint32)

    def select(item):
        i, arr = item
        return i, [arr, np.uint8([i, i + 1, i + 2])]

    seen = []
    for i, fused, layout in fused_pipelined(make_iter, select, depth=2):
        seen.append(i)
        back = packed.unfuse_words(_t(fused), layout)
        assert (back[0].numpy() == i).all()
        _same(back[1].numpy(), np.uint8([i, i + 1, i + 2]))
    assert seen == list(range(5))


def test_fused_bp64_projection_equals_direct(captures):
    """pack -> unfuse_words -> project_bp64_batched gives the bits of the
    staged arrays fed directly (the wire replay's pass)."""
    _, pinfo, path = captures[(DUAL, 512)]
    plan, fields, nbits, ups = _fields(pinfo, DUAL)
    stack = pk.PlanarLut(make_xyz_lut(pinfo), "cpu").stack
    reader = FrameReader(path, pinfo)

    def select(item):
        fids, pay, wid, anc, hds, _ = item
        return fids, [pay, wid, anc, hds]

    n = 0
    direct = [[a.copy() for a in c] for c in FrameReader(path, pinfo)
              .iter_bp64_chunks(4, fields=fields, nbits=nbits)]
    for (fids, fused, layout), d in zip(fused_pipelined(
            lambda: reader.iter_bp64_chunks(4, fields=fields, nbits=nbits,
                                            pool_depth=4), select), direct):
        _same(fids, d[0])
        parts = packed.unfuse_words(_t(fused), layout)
        assert parts[1].dtype == torch.uint8
        via = bp64.project_bp64_batched(*parts, stack, plan, nbits,
                                        upshifts=ups, dual=True)
        ref = bp64.project_bp64_batched(*map(_t, d[1:5]), stack, plan,
                                        nbits, upshifts=ups, dual=True)
        for v, r in zip(via, ref):
            _same(v.numpy(), r.numpy())
        n += fids.size
    assert n == 6
