"""The port's CUDA kernels (kernels/csrc/planar_project.cu,
packet_project.cu, lutfree_project.cu, icp_nn.cu, voxel_map.cu,
slam_gather.cu and xyz_project.cu) against
their plain PyTorch versions on the card. Needs an NVIDIA GPU and skips without one.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: bit-exact, for the projection (both sides round once per op,
never contracted) and for the dewarp (the kernel's hardware fma against
the plain version's correctly rounded emulation). The packet-layout kernel
is also bit-exact against the planar kernel on the same frames restaged. The four LUT-free cases are bit-exact against their
plain versions on the card and against the plain versions on the CPU, and
the planar LUT-free kernel against the packet-layout one. The device engine
at a small size: the iterator's and the live batcher's scans equal the
port's ScanBatcher's (0 differing elements), a live scan is copied back
only when a field is touched, and the projector's XYZ comes from the
planar kernel, bit-exact against `_proj_lean`. OSF replay: a file the
port's Writer made, read back through open_source, gives the scans
written, with XYZ caches from the planar kernel (one launch a window and
frame), bit-exact against `_proj_lean`, that XYZLut serves. Live sensors:
the port's emulator on loopback -> open_source on CUDA gives scans whose
fields, touched on the main thread, equal the ScanBatcher's over the
packets received; the planar ingest launches planar_project once a
released frame. Wire stagings: unpack_bits and the BP64 decode on the card
equal the CPU's, project_packed_batched / project_bp64_batched launch
planar_project once a call with XYZ bit-equal to the planar path (and with
poses to the CPU's plain route); ShardedScanPipeline.project on a mesh of
the one card launches once a shard, bit-equal to project_planar. SLAM:
the device voxel map's admission kernel (kernels/csrc/voxel_map.cu) gives
the bits of voxel_admit_reference, and the map on the card the host
VoxelHashMap's;
icp_nn's kernels (a voxel index once a map, one search a call) give the
indices and the bits of icp_nn_reference, on the card and on the CPU, on
dense, tied, masked, empty and saturated inputs too; register_points_device on the card is within 1e-4 m
of the CPU and gives the same bits with TF32 allowed, and its CUDA graph
(one capture a registration, one replay an iteration) gives the eager
step's bits after every iteration; the SLAM engine's device backend
captures once a registration and replays once an iteration, and gathers
every scan's frame through kernels/csrc/slam_gather.cu, whose count, mask
and order equal its plain version's bit for bit (points within 1e-12 m)
and whose LUT product is XYZLut's bits; normals and
voxel downsampling on the card agree with the CPU within stated bounds.
XYZLut on the card: kernels/csrc/xyz_project.cu gives the host XYZLut's
float64 bits; engine scans decoded on the card project there through
XYZLut, both returns, as fresh unpinned arrays with the host's bits."""

import numpy as np
import pytest
import torch

import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.core.types import (DataFormat, LidarMode,
                                             UDPProfileLidar)
from ouster_sdk_tpu_torch.ops import lutfree_kernels as lf
from ouster_sdk_tpu_torch.ops import packet_kernels as pkt
from ouster_sdk_tpu_torch.ops import planar_kernels as pk

PROFILES = {"planar": "RNG19_RFL8_SIG16_NIR16",
            "planar_dual": "RNG19_RFL8_SIG16_NIR16_DUAL",
            "planar_dual_split": "RNG19_RFL8_SIG16_NIR16_RGB16_DUAL"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _info(profile: str, h: int = 32, w: int = 512):
    info = pt.default_sensor_info(LidarMode(1024, 10))
    info.format = DataFormat(
        pixels_per_column=h, columns_per_packet=16, columns_per_frame=w,
        pixel_shift_by_row=[12, 8, 4, 0] * (h // 4), column_window=(0, w - 1),
        udp_profile_lidar=UDPProfileLidar(profile), fps=10)
    info.config.lidar_mode = LidarMode(w, 10)
    info.beam_azimuth_angles = [3.164, 1.055, -1.055, -3.164] * (h // 4)
    info.beam_altitude_angles = list(np.linspace(22.5, -22.5, h))
    return info


def _inputs(plan, B: int, seed: int):
    """Random words with about 5% of ranges zero and 10% of columns'
    status cleared, as (B, pw, h, w) and (B, schw, w) u32."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 1 << 32, (B, plan.pw, plan.h, plan.w),
                          dtype=np.uint32)
    for f in pk._range_fields(plan, "RANGE2" in {g.name for g in plan.fields}):
        mask = np.uint32(~(((1 << f.size) - 1) << f.bit) & 0xFFFFFFFF)
        zero = rng.random((B, plan.h, plan.w)) < 0.05
        planes[:, f.word][zero] &= mask
    hdrs = rng.integers(0, 1 << 32, (B, plan.schw, plan.w), dtype=np.uint32)
    off = rng.random((B, plan.w)) < 0.1
    bit = np.uint32(1 << plan.status_bit)
    hdrs[:, plan.staged_status_word] |= bit
    hdrs[:, plan.staged_status_word][off] &= ~bit
    return planes, hdrs


def _poses(B: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, w, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    a, b, c, d = np.moveaxis(q, -1, 0)
    T = np.zeros((B, w, 4, 4))
    T[..., :3, :3] = np.stack([
        np.stack([a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)], -1),
        np.stack([2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)], -1),
        np.stack([2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d], -1),
    ], -2)
    T[..., :3, 3] = rng.normal(0, 3, (B, w, 3))
    T[..., 3, 3] = 1
    return T.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dewarp", [False, True], ids=["proj", "dewarp"])
@pytest.mark.parametrize("case", sorted(PROFILES))
def test_kernel_matches_plain(cuda, case, dewarp):
    pipe = pt.ScanPipeline(_info(PROFILES[case]), device=cuda)
    planes, hdrs = _inputs(pipe.plan, 3, seed=1)
    P = torch.from_numpy(_poses(3, pipe.plan.w, 2)).to(cuda) \
        if dewarp else None
    args = (pk.words_tensor(planes, cuda), pk.words_tensor(hdrs, cuda),
            pipe.planar_lut.stack, pipe.plan)
    name = case + ("_dewarp" if dewarp else "")
    before = pk.launches[name]
    got = pk.unpack_project_planar_batched(*args, dual=pipe.dual, poses=P)
    assert pk.launches[name] == before + 1
    want = pk.unpack_project_planar_batched_plain(*args, dual=pipe.dual,
                                                  poses=P)
    torch.cuda.synchronize()
    got = got if pipe.dual else (got,)
    want = want if pipe.dual else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 3, pipe.plan.h, pipe.plan.w)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _pose_operand(kind: str, P: np.ndarray, device) -> torch.Tensor:
    """The same poses as operands the wrapper must treat alike: float32
    contiguous, float64, a non-contiguous view (every other column of a
    tensor twice as wide), a float32 view that starts 4 bytes past a
    16-byte boundary, and a bottom row that is not (0, 0, 0, 1)."""
    t = torch.from_numpy(P).to(device)
    if kind == "f64":
        return t.double()
    if kind == "strided":
        wide = torch.zeros((P.shape[0], 2 * P.shape[1], 4, 4),
                           dtype=torch.float32, device=device)
        wide[:, ::2] = t
        return wide[:, ::2]
    if kind == "offset":
        flat = torch.zeros(t.numel() + 1, dtype=torch.float32, device=device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    if kind == "bottom_row":
        t = t.clone()
        t[..., 3, :] = torch.tensor([float("nan"), 7.0, -3.0, 0.5],
                                    device=device)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "f64", "strided", "offset",
                                  "bottom_row"])
@pytest.mark.parametrize("B", [11, 1])
@pytest.mark.parametrize("case", ["planar", "planar_dual"])
def test_kernel_with_poses_off_the_tiles(cuda, case, B, kind):
    """With poses, bit-exact against the plain version at 40 rows x 496
    columns and 11 frames (no multiple of the kernel's tile, of its rows a
    block or of its frames a block) and at one frame, for every pose
    operand; one launch, counted once."""
    pipe = pt.ScanPipeline(_info(PROFILES[case], h=40, w=496), device=cuda)
    planes, hdrs = _inputs(pipe.plan, B, seed=20)
    P = _poses(B, pipe.plan.w, 21)
    args = (pk.words_tensor(planes, cuda), pk.words_tensor(hdrs, cuda),
            pipe.planar_lut.stack, pipe.plan)
    pk.reset_launches()
    got = pk.unpack_project_planar_batched(
        *args, dual=pipe.dual, poses=_pose_operand(kind, P, cuda))
    assert pk.launches[case + "_dewarp"] == 1
    assert sum(pk.launches.values()) == 1
    want = pk.unpack_project_planar_batched_plain(
        *args, dual=pipe.dual, poses=torch.from_numpy(P).to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got if pipe.dual else (got,),
                    want if pipe.dual else (want,)):
        assert g.shape == w.shape == (B, 3, 40, 496)
        assert torch.isfinite(g).all()
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["dd", "f32"])
@pytest.mark.parametrize("dewarp", [False, True], ids=["proj", "dewarp"])
def test_kernel_one_column_a_thread(cuda, dewarp, precision):
    """The kernel's instantiation with 4-byte accesses (one column a
    thread), which it takes where a row does not start on a 16-byte
    boundary (here an LUT stack one float off): the same bits as with
    16-byte accesses."""
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"], h=40, w=496),
                           device=cuda, precision=precision)
    planes, hdrs = _inputs(pipe.plan, 5, seed=22)
    P = torch.from_numpy(_poses(5, 496, 23)).to(cuda) if dewarp else None
    wide = pipe.project_planar(planes, hdrs, poses=P)
    lut = pipe.planar_lut.stack
    flat = torch.zeros(lut.numel() + 1, dtype=lut.dtype, device=cuda)
    flat[1:] = lut.reshape(-1)
    narrow = pk.unpack_project_planar_batched(
        pk.words_tensor(planes, cuda), pk.words_tensor(hdrs, cuda),
        flat[1:].view(lut.shape), pipe.plan, dual=True, poses=P,
        precision=precision)
    torch.cuda.synchronize()
    want = pk.unpack_project_planar_batched_plain(
        pk.words_tensor(planes, cuda), pk.words_tensor(hdrs, cuda),
        pipe.planar_lut.stack, pipe.plan, dual=True, poses=P,
        precision=precision)
    for a, b, w in zip(wide, narrow, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
        assert torch.equal(b.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_kernel_f32_precision_matches_plain(cuda):
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"]), device=cuda,
                           precision="f32")
    planes, hdrs = _inputs(pipe.plan, 2, seed=3)
    got = pipe.project_planar(planes, hdrs)
    want = pk.unpack_project_planar_batched_plain(
        pk.words_tensor(planes, cuda), pk.words_tensor(hdrs, cuda),
        pipe.planar_lut.stack, pipe.plan, dual=True, precision="f32")
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"]), device=cuda)
    planes, hdrs = _inputs(pipe.plan, 2, seed=4)
    planes = pk.words_tensor(planes, cuda)
    hdrs = pk.words_tensor(hdrs, cuda)
    lut = pipe.planar_lut.stack
    with pytest.raises(ValueError, match="int32"):
        pk.unpack_project_planar_batched(planes.float(), hdrs, lut, pipe.plan,
                                         dual=True)
    with pytest.raises(ValueError, match="contiguous"):
        pk.unpack_project_planar_batched(
            planes.transpose(2, 3).contiguous().transpose(2, 3), hdrs, lut,
            pipe.plan, dual=True)
    with pytest.raises(ValueError, match="is on cpu"):
        pk.unpack_project_planar_batched(planes, hdrs, lut.cpu(), pipe.plan,
                                         dual=True)
    # poses are the function's own operand, (B, w, 4, 4): the wrapper
    # refuses packed planes, the binding anything but float32 contiguous
    # poses on a 16-byte boundary
    from ouster_sdk_tpu_torch.kernels.planar_project import launch

    w = pipe.plan.w
    P = torch.from_numpy(_poses(2, w, 5)).to(cuda)
    pk.reset_launches()
    with pytest.raises(ValueError, match=r"poses must be \(B, w, 4, 4\)"):
        pk.unpack_project_planar_batched(
            planes, hdrs, lut, pipe.plan, dual=True,
            poses=torch.zeros((2, 12, w), device=cuda))
    with pytest.raises(ValueError, match=r"poses must be \(B, w, 4, 4\)"):
        pk.unpack_project_planar_batched(planes, hdrs, lut, pipe.plan,
                                         dual=True, poses=P[:1])
    fields, idx = pk._range_fields(pipe.plan, True), (0, 1)
    for bad, msg in ((torch.zeros((2, 12, w), device=cuda), "shape"),
                     (P.double(), "float32"),
                     (P.transpose(2, 3), "contiguous"),
                     (P.cpu(), "is on cpu"),
                     (_pose_operand("offset", P.cpu().numpy(), cuda),
                      "16-byte")):
        with pytest.raises(ValueError, match=msg):
            launch(planes, hdrs, lut, bad, pipe.plan, fields, idx, "dd")
    assert sum(pk.launches.values()) == 0


# -- the packet-layout kernel -----------------------------------------------

def _frames(plan, B: int, seed: int) -> np.ndarray:
    """Random packet-layout words (B, n_pkts, pkt_words) u32 with about 5%
    of ranges zero and 10% of columns' status cleared."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 1 << 32, (B, plan.n_pkts, plan.pkt_words),
                          dtype=np.uint32)
    cols = frames[:, :, plan.hw:plan.hw + plan.cpp * plan.cw].reshape(
        B, plan.w, plan.cw)
    for f in pk._range_fields(plan, "RANGE2" in {g.name for g in plan.fields}):
        idx = plan.chw + np.arange(plan.h) * plan.pw + f.word
        mask = np.uint32(~(((1 << f.size) - 1) << f.bit) & 0xFFFFFFFF)
        sub = cols[:, :, idx]
        sub[rng.random(sub.shape) < 0.05] &= mask
        cols[:, :, idx] = sub
    bit = np.uint32(1 << plan.status_bit)
    cols[:, :, plan.status_word] |= bit
    off = rng.random((B, plan.w)) < 0.1
    cols[:, :, plan.status_word][off] &= ~bit
    frames[:, :, plan.hw:plan.hw + plan.cpp * plan.cw] = cols.reshape(
        B, plan.n_pkts, plan.cpp * plan.cw)
    return frames


def _restage(frames: np.ndarray, plan):
    """Packet-layout frames -> planes (B, pw, h, w), col_hdrs (B, schw, w)."""
    B = frames.shape[0]
    cols = frames[:, :, plan.hw:plan.hw + plan.cpp * plan.cw].reshape(
        B, plan.w, plan.cw)
    pix = cols[:, :, plan.chw:plan.chw + plan.h * plan.pw].reshape(
        B, plan.w, plan.h, plan.pw)
    hdr = cols[:, :, :plan.chw]
    if plan.schw > plan.chw:
        hdr = np.concatenate(
            [hdr, cols[:, :, plan.cw - (plan.schw - plan.chw):]], axis=2)
    return (np.ascontiguousarray(pix.transpose(0, 3, 2, 1)),
            np.ascontiguousarray(hdr.transpose(0, 2, 1)))


PACKET_PROFILES = {"single": PROFILES["planar"],
                   "dual": PROFILES["planar_dual"],
                   "dual_split": PROFILES["planar_dual_split"],
                   "legacy": "LEGACY"}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["dd", "f32"])
@pytest.mark.parametrize("kind", sorted(PACKET_PROFILES))
def test_packet_kernel_matches_plain_and_planar(cuda, kind, precision):
    """Bit-exact against the plain version and against the planar kernel on
    the restaged frames; a CUDA tensor launches the kernel, counted once.
    40 rows x 496 columns: neither a multiple of the kernel's tile."""
    pipe = pt.ScanPipeline(_info(PACKET_PROFILES[kind], h=40, w=496),
                           device=cuda, precision=precision)
    plan, dual = pipe.plan, pipe.dual
    frames = _frames(plan, 11, seed=5)     # 11: not a multiple of the
    words = pk.words_tensor(frames, cuda)  # kernel's frames per block
    planes = pt.lut_planes(pipe.planar_lut)
    case = "packet_dual" if dual else "packet"
    pkt.reset_launches()
    got = pt.unpack_project_packet_batched(words, *planes, plan, dual=dual,
                                           precision=precision)
    assert pkt.launches[case] == 1 and sum(pkt.launches.values()) == 1
    want = pkt.unpack_project_packet_batched_plain(
        words, *planes, plan, dual=dual, precision=precision)
    planar = pipe.project_planar(*_restage(frames, plan))
    torch.cuda.synchronize()
    got, want, planar = (x if dual else (x,) for x in (got, want, planar))
    for g, w, p in zip(got, want, planar):
        assert g.shape == w.shape == (11, 3, plan.h, plan.w)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.cuda
def test_packet_single_frame_wrappers_launch_the_kernel(cuda):
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"]), device=cuda,
                           destagger=False)
    frames = pk.words_tensor(_frames(pipe.plan, 2, seed=6), cuda)
    pkt.reset_launches()
    one = pt.unpack_project_packet(frames[0], *pt.lut_planes(pipe.planar_lut),
                                   pipe.plan)
    hw3 = pt.unpack_project(frames[0], pipe.lut, pipe.plan)
    assert pkt.launches == {"packet": 2, "packet_dual": 0}
    assert torch.equal(one.movedim(0, -1), hw3)
    # the pipeline's own XYZ (tensor ops on the card) carries the same bits
    out = pipe.batch(frames)
    assert pkt.launches == {"packet": 2, "packet_dual": 0}
    assert torch.equal(out["XYZ"][0].view(torch.int32),
                       hw3.view(torch.int32))


@pytest.mark.cuda
def test_packet_pipeline_on_the_card_matches_the_cpu(cuda):
    """ScanPipeline.batch with poses: the card's tensor ops give the CPU's
    bits (the dewarp's fma is emulated in float64 on both)."""
    info = _info(PROFILES["planar_dual"])
    frames = _frames(pt.make_decode_plan(info), 2, seed=7)
    P = _poses(2, 512, 8)
    on_card = pt.ScanPipeline(info, device=cuda).batch(frames, P)
    on_cpu = pt.ScanPipeline(info, device="cpu").batch(frames, P)
    assert sorted(on_card) == sorted(on_cpu)
    for k, v in on_cpu.items():
        assert on_card[k].device.type == "cuda"
        assert torch.equal(on_card[k].cpu().view(torch.uint8),
                           v.view(torch.uint8)), k
    scat = pt.decode_frame_batch(pk.words_tensor(frames, cuda),
                                 pt.make_decode_plan(info), dense=False)
    ref = pt.decode_frame_batch(pk.words_tensor(frames, "cpu"),
                                pt.make_decode_plan(info), dense=False)
    for k, v in ref.items():
        assert torch.equal(scat[k].cpu().view(torch.uint8),
                           v.view(torch.uint8)), k


@pytest.mark.cuda
def test_packet_kernel_rejects_what_it_does_not_take(cuda):
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"]), device=cuda)
    frames = pk.words_tensor(_frames(pipe.plan, 2, seed=9), cuda)
    planes = pt.lut_planes(pipe.planar_lut)
    pkt.reset_launches()
    with pytest.raises(ValueError, match="int32"):
        pt.unpack_project_packet_batched(frames.float(), *planes, pipe.plan)
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_packet_batched(
            frames.transpose(1, 2).contiguous().transpose(1, 2), *planes,
            pipe.plan)
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_packet_batched(
            frames, planes[0].movedim(0, -1).contiguous().movedim(-1, 0),
            *planes[1:], pipe.plan)
    with pytest.raises(ValueError, match="is on cpu"):
        pt.unpack_project_packet_batched(frames, planes[0].cpu(),
                                         *planes[1:], pipe.plan)
    assert sum(pkt.launches.values()) == 0


@pytest.mark.cuda
def test_an_empty_batch_launches_nothing_and_counts_nothing(cuda):
    pipe = pt.ScanPipeline(_info(PROFILES["planar_dual"]), device=cuda)
    plan = pipe.plan
    pkt.reset_launches()
    pk.reset_launches()
    frames = torch.empty((0, plan.n_pkts, plan.pkt_words), dtype=torch.int32,
                         device=cuda)
    xyz, xyz2 = pt.unpack_project_packet_batched(
        frames, *pt.lut_planes(pipe.planar_lut), plan, dual=True)
    assert xyz.shape == xyz2.shape == (0, 3, plan.h, plan.w)
    planes = torch.empty((0, plan.pw, plan.h, plan.w), dtype=torch.int32,
                         device=cuda)
    hdrs = torch.empty((0, plan.schw, plan.w), dtype=torch.int32, device=cuda)
    xyz, xyz2 = pipe.project_planar(planes, hdrs)
    assert xyz.shape == xyz2.shape == (0, 3, plan.h, plan.w)
    assert sum(pkt.launches.values()) == sum(pk.launches.values()) == 0


# -- the LUT-free kernels ----------------------------------------------------

LUTFREE_PROFILES = {**PACKET_PROFILES, "low_bandwidth": "RNG15_RFL8_NIR8"}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LUTFREE_PROFILES))
def test_lutfree_kernels_match_plain_and_the_cpu(cuda, kind):
    """Every LUT-free case the profile has, through its wrapper on CUDA
    tensors: bit-exact against the plain version on the card and against
    the plain version on the CPU (the CPU's bits on the card), each
    launch counted once; the planar kernel equals the packet-layout one.
    40 rows x 496 columns and 11 frames: no multiple of the kernel's tile
    or of its frames per block."""
    info = _info(LUTFREE_PROFILES[kind], h=40, w=496)
    plan = pt.make_decode_plan(info)
    dual = any(f.name == "RANGE2" for f in plan.fields)
    frames = _frames(plan, 11, seed=12)
    planes, hdrs = _restage(frames, plan)
    tables = pt.FactorTables(info)
    assert tables.rows.device.type == "cuda"
    cpu_tables = pt.FactorTables(info, device="cpu")
    on_card = dict(f=pk.words_tensor(frames, cuda),
                   p=pk.words_tensor(planes, cuda),
                   h=pk.words_tensor(hdrs, cuda))
    on_cpu = dict(f=pk.words_tensor(frames, "cpu"),
                  p=pk.words_tensor(planes, "cpu"),
                  h=pk.words_tensor(hdrs, "cpu"))

    def calls(x, t):
        out = {
            "lutfree": lambda fn=lf.unpack_project_lutfree: fn(
                x["f"], t, plan),
            "lutfree_dd": lambda fn=lf.unpack_project_lutfree_dd: fn(
                x["f"], t, plan),
            "lutfree_dd_planar":
                lambda fn=lf.unpack_project_lutfree_planar: fn(
                    x["p"], x["h"], t, plan),
        }
        if dual:
            out["lutfree_dd_dual"] = \
                lambda fn=lf.unpack_project_lutfree_dd: fn(
                    x["f"], t, plan, dual=True)
        return out

    plain = {
        "lutfree": lambda: lf.unpack_project_lutfree_plain(
            on_card["f"], tables, plan),
        "lutfree_dd": lambda: lf.unpack_project_lutfree_dd_plain(
            on_card["f"], tables, plan),
        "lutfree_dd_dual": lambda: lf.unpack_project_lutfree_dd_plain(
            on_card["f"], tables, plan, dual=True),
        "lutfree_dd_planar": lambda: lf.unpack_project_lutfree_planar_plain(
            on_card["p"], on_card["h"], tables, plan),
    }
    cpu = calls(on_cpu, cpu_tables)
    got = {}
    for case, fn in calls(on_card, tables).items():
        lf.reset_launches()
        out = fn()
        assert lf.launches[case] == 1 and sum(lf.launches.values()) == 1
        want, ref = plain[case](), cpu[case]()
        torch.cuda.synchronize()
        assert sum(lf.launches.values()) == 1     # neither of those counts
        got[case] = out
        for g, w, c in zip(*((x if isinstance(x, tuple) else (x,))
                             for x in (out, want, ref))):
            assert g.shape == w.shape == (11, 3, plan.h, plan.w)
            assert g.device.type == "cuda" and torch.isfinite(g).all()
            assert _same_bits(g, w), case
            assert _same_bits(g, c), case
    assert _same_bits(got["lutfree_dd_planar"], got["lutfree_dd"])
    if dual:
        assert _same_bits(got["lutfree_dd_dual"][0], got["lutfree_dd"])
        assert not _same_bits(*got["lutfree_dd_dual"])


@pytest.mark.cuda
def test_lutfree_single_frames_launch_the_kernels(cuda):
    info = _info(PROFILES["planar_dual"])
    plan = pt.make_decode_plan(info)
    frames = _frames(plan, 2, seed=13)
    planes, hdrs = (pk.words_tensor(x, cuda) for x in _restage(frames, plan))
    words = pk.words_tensor(frames, cuda)
    tables = pt.FactorTables(info)
    lf.reset_launches()
    both = pt.unpack_project_lutfree_dd(words, tables, plan, dual=True)
    one, two = pt.unpack_project_lutfree_dd(words[1], tables, plan, dual=True)
    assert one.shape == two.shape == (3, plan.h, plan.w)
    assert _same_bits(one, both[0][1]) and _same_bits(two, both[1][1])
    f32 = pt.unpack_project_lutfree(words[0], tables, plan)
    assert f32.shape == (3, plan.h, plan.w)
    planar = pt.unpack_project_lutfree_planar(planes[1], hdrs[1], tables,
                                              plan)
    assert planar.shape == (1, 3, plan.h, plan.w)
    assert _same_bits(planar[0], one)
    assert lf.launches == {"lutfree": 1, "lutfree_dd": 0,
                           "lutfree_dd_dual": 2, "lutfree_dd_planar": 1}


@pytest.mark.cuda
def test_lutfree_kernels_reject_what_they_do_not_take(cuda):
    info = _info(PROFILES["planar_dual"])
    plan = pt.make_decode_plan(info)
    frames = _frames(plan, 2, seed=14)
    planes, hdrs = (pk.words_tensor(x, cuda) for x in _restage(frames, plan))
    words = pk.words_tensor(frames, cuda)
    tables = pt.FactorTables(info)
    lf.reset_launches()
    with pytest.raises(ValueError, match="int32"):
        pt.unpack_project_lutfree_dd(words.float(), tables, plan)
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_lutfree_dd(
            words.transpose(1, 2).contiguous().transpose(1, 2), tables, plan)
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_lutfree_planar(
            planes.transpose(2, 3).contiguous().transpose(2, 3), hdrs,
            tables, plan)
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_lutfree_planar(
            planes, hdrs.transpose(1, 2).contiguous().transpose(1, 2),
            tables, plan)
    with pytest.raises(ValueError, match="is on cpu"):
        pt.unpack_project_lutfree(words, pt.FactorTables(info, device="cpu"),
                                  plan)
    strided = pt.FactorTables(info)
    strided.cols = strided.cols.T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        pt.unpack_project_lutfree_dd(words, strided, plan, dual=True)
    assert sum(lf.launches.values()) == 0


@pytest.mark.cuda
def test_an_empty_lutfree_batch_launches_nothing(cuda):
    info = _info(PROFILES["planar_dual"])
    plan = pt.make_decode_plan(info)
    tables = pt.FactorTables(info)
    lf.reset_launches()
    frames = torch.empty((0, plan.n_pkts, plan.pkt_words), dtype=torch.int32,
                         device=cuda)
    xyz, xyz2 = pt.unpack_project_lutfree_dd(frames, tables, plan, dual=True)
    assert xyz.shape == xyz2.shape == (0, 3, plan.h, plan.w)
    assert pt.unpack_project_lutfree(frames, tables, plan).shape == xyz.shape
    planes = torch.empty((0, plan.pw, plan.h, plan.w), dtype=torch.int32,
                         device=cuda)
    hdrs = torch.empty((0, plan.schw, plan.w), dtype=torch.int32, device=cuda)
    assert pt.unpack_project_lutfree_planar(planes, hdrs, tables,
                                            plan).shape == xyz.shape
    assert sum(lf.launches.values()) == 0


# -- ops/pose.py on the card -------------------------------------------------

@pytest.mark.cuda
def test_pose_functions_on_the_card_match_the_cpu(cuda):
    """exp_pose, log_pose, interp_pose (torch.linalg.solve) and
    interp_trajectory on the card against the CPU: rtol 1e-5, atol 1e-6
    (sin, cos, arccos and the 4x4 solve are other implementations there).
    With numpy inputs and no device named, the entry points run on the
    card. Rotation angles stay at or under 2.5 rad: towards pi the
    logarithm's condition number grows as 1 / sin(angle), and two correct
    float32 implementations part by more than this tolerance."""
    from ouster_sdk_tpu_torch.ops import pose as pp

    tol = dict(rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(10)
    xi = np.concatenate([rng.normal(0, 1, (64, 3)), rng.normal(0, 2, (64, 3))],
                        axis=1).astype(np.float32)
    angle = np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    xi[:, :3] *= np.minimum(1.0, 2.5 / angle)
    xi[:8, :3] *= 1e-7                      # the small-angle branches
    xi[0, :3] = 0
    T_cpu = pp.exp_pose(torch.from_numpy(xi))
    T = pp.exp_pose(torch.from_numpy(xi).to(cuda))
    assert T.device.type == "cuda" and torch.isfinite(T).all()
    torch.testing.assert_close(T.cpu(), T_cpu, **tol)
    back = pp.log_pose(T_cpu.to(cuda))
    assert back.device.type == "cuda" and torch.isfinite(back).all()
    torch.testing.assert_close(back.cpu(), pp.log_pose(T_cpu), **tol)

    knots = pp.exp_pose(torch.from_numpy(xi[8:13] * 0.3)).numpy()
    knot_ts = np.array([0.0, 1.0, 2.5, 2.5, 4.0], np.float32)
    query = np.concatenate([np.linspace(-1, 5, 61),
                            knot_ts]).astype(np.float32)
    for clamp in (False, True):
        want = pp.interp_trajectory(query, knot_ts, knots, clamp=clamp,
                                    device="cpu")
        got = pp.interp_trajectory(query, knot_ts, knots, clamp=clamp)
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, **tol)
        on_card = pp.interp_trajectory(query, knot_ts,
                                       torch.from_numpy(knots).to(cuda),
                                       clamp=clamp)
        assert torch.equal(on_card, got)
    t = np.linspace(-0.5, 1.5, 33).astype(np.float32)
    got = pp.interp_pose_np(t, knots[0], knots[1])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, pp.interp_pose_np(t, knots[0], knots[1], device="cpu"), **tol)
    pts = rng.normal(0, 30, (32, 512, 3)).astype(np.float32)
    P = _poses(1, 512, 11)[0]
    on_card = pp.dewarp(torch.from_numpy(pts).to(cuda),
                        torch.from_numpy(P).to(cuda))
    assert torch.equal(on_card.cpu().view(torch.int32),
                       pp.dewarp(torch.from_numpy(pts),
                                 torch.from_numpy(P)).view(torch.int32))


# -- the device engine on the card --------------------------------------------

def _engine_capture(tmp_path, profile="RNG19_RFL8_SIG16_NIR16_DUAL", n=4):
    """A small capture with the chip smoke run's faults (a lost packet, a
    straggler, an open last frame) from its jax-free synthesizer, and the
    port's ScanBatcher's scans of it."""
    import chip_smoke as cs

    info = cs.synth_info(profile, w=512, h=32)
    main = str(tmp_path / "main.pcap")
    cs.synth_capture(main, info, n)
    path = str(tmp_path / "engine.pcap")
    assert cs.engine_capture(path, main, info, n) == n + 3
    packets = cs.capture_packets(pt, info, path)
    return cs, info, path, packets, cs.batcher_scans(pt, info, packets)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_engine_iterator_on_the_card_equals_the_batcher(cuda, tmp_path,
                                                        batch):
    from ouster_sdk_tpu_torch.io import device_engine as de

    cs, info, path, _, oracle = _engine_capture(tmp_path)
    de.stats.update(batches=0, scans=0)
    it = pt.DeviceScanIterator(path, info, batch=batch)
    assert it.device.type == "cuda"
    got = list(it.iter_released())
    assert de.stats["batches"] == -(-7 // batch)
    assert [(r, s.frame_id) for r, s in got] == \
        [(r, s.frame_id) for r, s in oracle]
    for (_, a), (_, b) in zip(got, oracle):
        assert cs.scans_differ(a, b) == 0 and a == b
    index = pt.DeviceScanIndex(it, cache_scans=2)
    assert len(index) == 7
    for i in (6, 0, 4):
        assert index.scan_at(i) == got[i][1]


@pytest.mark.cuda
def test_engine_live_scan_stays_on_the_card_until_touched(cuda, tmp_path):
    cs, info, _, packets, oracle = _engine_capture(tmp_path, n=3)
    live = pt.LiveDeviceBatcher(info)
    assert live.device.type == "cuda" and live._ring[0][0].is_pinned()
    scans = []
    for _, pkt in packets:
        scans.extend(live.push(pkt.buf, pkt.host_timestamp))
    assert len(scans) == 5 and all(s.fields_deferred for s in scans)
    # five flushes over four ring slots: the first slot's fence was waited
    # on and set again
    assert all(e is not None for e in live._ring_events)
    from ouster_sdk_tpu_torch.io import device_engine as de

    with cs.count_calls(de, "_to_host") as readbacks:
        trace = cs.device_trace(torch, lambda: scans[1].status.sum())
    assert cs.copies(trace, "DtoH") == 0 and readbacks.n == 0
    assert scans[1].fields_deferred
    with cs.count_calls(de, "_to_host") as readbacks:
        trace = cs.device_trace(torch, lambda: scans[1].field("SIGNAL"))
    # the profiler's count is a lower bound (it can lose records); the
    # call count is exact
    assert readbacks.n == 1 and cs.copies(trace, "HtoD") == 0
    assert not scans[1].fields_deferred and scans[0].fields_deferred
    for a, (_, b) in zip(scans, oracle):
        assert cs.scans_differ(a, b) == 0 and a == b


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["dd", "f32"])
def test_project_ranges_launches_the_planar_kernel(cuda, precision):
    info = _info(PROFILES["planar_dual"])
    lut = pt.PlanarLut(pt.make_xyz_lut(info), cuda).stack
    rng = np.random.default_rng(4)
    r = rng.integers(0, 1 << 19, (5, 32, 512), dtype=np.uint32)
    r[rng.random(r.shape) < 0.05] = 0
    rngs = pk.words_tensor(r, cuda)
    pk.reset_launches()
    got = pt.project_ranges(rngs, lut, precision=precision)
    assert pk.launches["planar"] == 1 and sum(pk.launches.values()) == 1
    want = pk._proj_lean(rngs.to(torch.int64), lut, precision=precision)
    cpu = pt.project_ranges(rngs.cpu(), lut.cpu(), precision=precision)
    torch.cuda.synchronize()
    assert got.shape == (5, 3, 32, 512)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    assert pk.launches["planar"] == 1           # the plain calls launch none
    # an empty window launches nothing and counts nothing
    out = pt.project_ranges(rngs[:0], lut)
    assert out.shape == (0, 3, 32, 512) and pk.launches["planar"] == 1
    with pytest.raises(ValueError):
        pt.project_ranges(rngs, lut.cpu())


@pytest.mark.cuda
def test_projector_on_the_card_goes_through_the_kernel(cuda, tmp_path):
    import copy

    from ouster_sdk_tpu_torch.io import device_engine as de

    cs, info, path, _, oracle = _engine_capture(tmp_path, n=2)
    info_ext = copy.deepcopy(info)
    info_ext.extrinsic = np.array(
        [[0.0, -1.0, 0.0, 500.0], [1.0, 0.0, 0.0, -250.0],
         [0.0, 0.0, 1.0, 1500.0], [0.0, 0.0, 0.0, 1.0]])
    scans = [s for _, s in oracle]
    de.stats.update(batches=0, osf_batches=0)
    pk.reset_launches()
    proj = pt.OsfDeviceProjector([info, info_ext], batch=3)
    proj.attach([])                                 # an empty window
    proj.attach([(0, None)])
    assert sum(pk.launches.values()) == 0 and de.stats["osf_batches"] == 0
    out = list(proj.wrap(iter([(k % 2, s) for k, s in enumerate(scans)])))
    assert [s for _, s in out] == scans
    # windows of 3, 2 scans: sensor 0 launches once a window it is in,
    # sensor 1 twice (its extrinsics frame too)
    assert de.stats["osf_batches"] == 4
    assert pk.launches["planar"] == 2 * 1 + 2 * 2
    assert sum(pk.launches.values()) == pk.launches["planar"]
    for k, ls in enumerate(scans):
        for use_ext in (False, True):
            lut = pt.PlanarLut(pt.make_xyz_lut(
                (info, info_ext)[k % 2], use_ext), cuda).stack
            for ret, name in enumerate(("RANGE", "RANGE2")):
                rng = ls.field(name)
                xyz = ls.cached_xyz(ret, use_ext, rng)
                want = pk._proj_lean(
                    torch.from_numpy(rng.astype(np.int64)).to(cuda)[None],
                    lut, precision="dd")[0].movedim(0, -1).contiguous()
                assert np.array_equal(xyz.view(np.uint32),
                                      want.cpu().numpy().view(np.uint32))
    rng = scans[0].field("RANGE")
    rng[0, 0] += 1
    assert scans[0].cached_xyz(0, False, rng) is None


@pytest.mark.cuda
def test_osf_replay_projects_through_the_kernel(cuda, tmp_path):
    import copy

    from ouster_sdk_tpu_torch.io import device_engine as de

    cs, info, _, _, oracle = _engine_capture(tmp_path, n=3)
    scans = [s for _, s in oracle]
    info_ext = copy.deepcopy(info)
    info_ext.extrinsic = cs.OSF_EXTRINSIC.copy()
    for sinfo, frames in ((info, 1), (info_ext, 2)):
        path = str(tmp_path / f"x{frames}.osf")
        cs.write_osf(path, [sinfo], scans)
        de.stats.update(batches=0, osf_batches=0)
        pk.reset_launches()
        src = pt.open_source(path)
        got = [ls[0] for ls in src]
        assert src._projector().device.type == "cuda"
        # 6 scans: windows of 4 and 2, one launch a window and frame
        assert de.stats["osf_batches"] == 2
        assert pk.launches["planar"] == 2 * frames
        assert sum(pk.launches.values()) == pk.launches["planar"]
        assert all(cs.scans_differ(a, b) == 0 for a, b in zip(got, scans))
        n_diff, worst, n_img = cs.hold_osf_xyz(torch, pt, pk, cuda, sinfo,
                                               got, f64_every=2)
        assert n_diff == 0 and worst <= 1.0 and n_img == 6 * 2 * frames
        lut = pt.XYZLut(sinfo)
        for ls in got:
            cache = ls.cached_xyz(0, False, ls.field("RANGE"))
            assert np.array_equal(lut(ls), cache.astype(np.float64))


# -- live sensors on the card -------------------------------------------------

@pytest.mark.cuda
def test_live_scans_on_the_card_equal_the_batcher(cuda):
    """The port's emulator -> open_source("127.0.0.1:<port>") on CUDA:
    scans arrive with their fields left on the card, and touched on the
    main thread (the batcher thread decoded them) they equal the
    ScanBatcher's over the packets received, headers included."""
    import chip_smoke as cs

    info, frames = cs.live_sensor("RNG19_RFL8_SIG16_NIR16_DUAL", 512,
                                  992240000050, 6, seed=3, h=32)
    got, _, _, src, seen = cs.live_run(pt, [info], [frames], 1.0,
                                       touch=False)
    assert src.engine_used == ["device"] and src.device.type == "cuda"
    assert got and all(s.fields_deferred for _, s in got)
    for _, s in got:
        s.field("RANGE")
    assert sum(cs.whole(s) for _, s in got) > 0
    assert cs.hold_live(pt, [info], got, seen, "card") >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["RNG19_RFL8_SIG16_NIR16",
                                     "RNG19_RFL8_SIG16_NIR16_DUAL"])
def test_live_planar_ingest_launches_the_kernel(cuda, profile):
    """emulator -> SensorPacketSource -> PlanarStreamAssembler ->
    project_planar on CUDA tensors: one planar_project launch a released
    frame, bit-equal to the plain version (checked inside)."""
    import chip_smoke as cs

    info, frames = cs.live_sensor(profile, 512, 992240000051, 4, seed=5,
                                  h=32)
    launched = cs._live_planar_ingest(torch, pt, pk, cuda, info, frames)
    case = "planar_dual" if profile.endswith("DUAL") else "planar"
    assert list(launched) == [case] and launched[case] >= 1


# -- wire stagings and the multi-device face on the card ------------------------

@pytest.mark.cuda
def test_wire_decodes_on_the_card_equal_the_cpu(cuda):
    from ouster_sdk_tpu_torch.ops import bp64, packed

    rng = np.random.default_rng(7)
    for nbits in (1, 15, 19, 30):
        stream = rng.integers(0, 1 << 32, (3, 4, 64 * nbits // 32),
                              dtype=np.uint32).view(np.int32)
        t = torch.from_numpy(stream)
        assert torch.equal(packed.unpack_bits(t.to(cuda), nbits, 64).cpu(),
                           packed.unpack_bits(t, nbits, 64))
    v = rng.integers(0, 1 << 19, (2, 32, 512), dtype=np.uint32)
    v[rng.random(v.shape) < 0.1] = 0
    v[0, 3] = 1234                               # constant rows
    pay, wid, anc = bp64.bp64_encode_numpy(v, 19)
    args = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a) for a in (pay, wid, anc)]
    got = bp64.bp64_decode_torch(*(a.to(cuda) for a in args), 512)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), bp64.bp64_decode_torch(*args, 512))
    assert np.array_equal(got.cpu().numpy().astype(np.uint32), v)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["packed", "bp64"])
@pytest.mark.parametrize("profile", ["RNG19_RFL8_SIG16_NIR16",
                                     "RNG19_RFL8_SIG16_NIR16_DUAL"])
def test_wire_projections_launch_the_kernel_once(cuda, tmp_path, codec,
                                                 profile):
    """pcap -> iter_packed_chunks / iter_bp64_chunks -> fused upload ->
    project_*_batched on the card: one planar_project launch a call, XYZ
    bit-equal to the planar path on the same frames and, with poses, to the
    CPU's plain route."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.ops import bp64, packed

    info = cs.synth_info(profile, w=512, h=32)
    path = str(tmp_path / "wire.pcap")
    cs.synth_capture(path, info, 6)
    pipe = pt.ScanPipeline(info)
    plan, lut = pipe.plan, pipe.planar_lut.stack
    fields, nbits, ups = packed.packed_range_fields(plan, pipe.dual)
    reader = pt.FrameReader(path, info)
    it = (reader.iter_bp64_chunks if codec == "bp64"
          else reader.iter_packed_chunks)
    fn = (bp64.project_bp64_batched if codec == "bp64"
          else packed.project_packed_batched)
    planar = list(pt.FrameReader(path, info).iter_planar_chunks(4))
    case = "planar_dual" if pipe.dual else "planar"
    for item, (_, planes, hdrs, _) in zip(it(4, fields=fields, nbits=nbits),
                                          planar):
        fused, layout = pt.ChunkFuser().pack(list(item[1:-1]))
        parts = packed.unfuse_words(
            torch.from_numpy(fused.view(np.int32)).to(cuda), layout)
        pk.reset_launches()
        got = fn(*parts, lut, plan, nbits, upshifts=ups, dual=pipe.dual)
        assert pk.launches[case] == 1 and sum(pk.launches.values()) == 1
        want = pipe.project_planar(planes, hdrs)
        for g, w in zip(*(x if pipe.dual else (x,) for x in (got, want))):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        P = torch.from_numpy(cs.random_poses(item[0].size, 512, seed=2))
        got = fn(*parts, lut, plan, nbits, upshifts=ups, dual=pipe.dual,
                 poses=P.to(cuda))
        want = fn(*(p.cpu() for p in parts), lut.cpu(), plan, nbits,
                  upshifts=ups, dual=pipe.dual, poses=P)
        for g, w in zip(*(x if pipe.dual else (x,) for x in (got, want))):
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_sharded_project_on_a_one_card_mesh(cuda):
    """ScanPipeline.sharded(make_mesh()) on the card, and on the card
    listed twice: one launch a shard, joined bit-equal to project_planar."""
    info = _info("RNG19_RFL8_SIG16_NIR16_DUAL")
    pipe = pt.ScanPipeline(info)
    planes, hdrs = _inputs(pipe.plan, 8, seed=4)
    want = pipe.project_planar(planes, hdrs)
    for mesh in (pt.make_mesh(), pt.make_mesh(devices=[cuda, cuda])):
        sp = pipe.sharded(mesh)
        pk.reset_launches()
        got = sp.project(sp.shard(planes), sp.shard(hdrs))
        assert pk.launches["planar_dual"] == sp.n_shards
        for g, w in zip(got, want):
            assert all(s.device.type == "cuda" for s in g.shards)
            assert torch.equal(g.join().view(torch.int32),
                               w.view(torch.int32))


# -- SLAM on the card: icp_nn, register_points_device, normals, downsample ----

@pytest.mark.cuda
@pytest.mark.parametrize("n,m,masked", [(1000, 30000, False),
                                        (6000, 200000, True), (1, 7, False)])
def test_icp_nn_matches_plain_on_the_card(cuda, n, m, masked):
    """icp_nn's kernel against icp_nn_reference on the same card tensors:
    indices equal, distances bit-equal, one launch a call."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn

    rng = np.random.default_rng(n)
    world = cs.icp_world(max(m, 4), seed=1)[:m]
    src = world[rng.integers(0, m, n)] + rng.normal(0, 0.3, (n, 3))
    src_t = torch.from_numpy(src.astype(np.float32)).to(cuda)
    map_t = torch.from_numpy(world.astype(np.float32)).to(cuda)
    valid = (torch.from_numpy(rng.random(m) > 0.3).to(cuda) if masked
             else None)
    for voxel in (0.5, 1.0):
        nn.reset_launches()
        d2, idx = nn.icp_nn(src_t, map_t, valid, voxel)
        assert nn.launches["icp_nn"] == 1
        assert nn.launches["icp_nn_index"] == 1
        want_d2, want_idx = nn.icp_nn_reference(src_t, map_t, valid, voxel)
        assert torch.equal(idx, want_idx)
        assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
        assert bool(torch.isfinite(d2).any())
        # the CPU's plain version agrees too
        cpu = nn.icp_nn(src_t.cpu(), map_t.cpu(),
                        None if valid is None else valid.cpu(), voxel)
        assert torch.equal(idx.cpu(), cpu[1])
        assert torch.equal(d2.cpu().view(torch.int32),
                           cpu[0].view(torch.int32))


@pytest.mark.cuda
def test_icp_nn_edge_cases_and_refusals(cuda):
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn

    src = torch.randn(5, 3, device=cuda)
    d2, idx = nn.icp_nn(src, torch.zeros((0, 3), device=cuda), None, 1.0)
    assert torch.isinf(d2).all() and (idx == 0).all()
    far = torch.full((3, 3), 100.0, device=cuda)
    d2, idx = nn.icp_nn(src, far, None, 1.0)       # no candidate
    assert torch.isinf(d2).all() and (idx == 0).all()
    nn.reset_launches()
    d2, idx = nn.icp_nn(torch.zeros((0, 3), device=cuda), far, None, 1.0)
    assert d2.shape == (0,) and nn.launches["icp_nn"] == 0
    with pytest.raises(ValueError):
        nn.icp_nn(src.double(), far, None, 1.0)
    with pytest.raises(ValueError):
        nn.icp_nn(src, far.cpu(), None, 1.0)
    with pytest.raises(ValueError):
        nn.icp_nn(src, far[:, :2].contiguous(), None, 1.0)
    with pytest.raises(ValueError):
        nn.icp_nn(src, far, None, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(12))
def test_icp_nn_cases_match_plain_on_the_card(cuda, case):
    """chip_smoke.icp_nn_cases on the card: dense cells of 500 points in one
    voxel, duplicated map points at equal distance (ties), masked points,
    queries with no candidate, saturated and wrapped voxels, voxels of
    0.05 and 2.0 m, N = 0, M = 0 and an all-invalid map. Both forms (a
    prebuilt index, the one call) give the indices and the bits of
    icp_nn_reference on the card; one index build and one search a call
    (none for N = 0)."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn

    cases = cs.icp_nn_cases()
    assert len(cases) == 12
    name, src, mp, valid, voxel = cases[case]
    s = torch.from_numpy(src).to(cuda)
    m = torch.from_numpy(mp).to(cuda)
    v = None if valid is None else torch.from_numpy(valid).to(cuda)
    want = nn.icp_nn_reference(s, m, v, voxel)
    nn.reset_launches()
    index = nn.build_icp_index(m, v, voxel)
    assert nn.launches == {"icp_nn": 0, "icp_nn_index": 1}
    for got in (nn.icp_nn(s, index=index), nn.icp_nn(s, m, v, voxel)):
        assert torch.equal(got[1], want[1]), name
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), name
    n = src.shape[0]
    assert nn.launches == {"icp_nn": 2 if n else 0,
                           "icp_nn_index": 2 if n else 1}
    # packed points: every valid point once, voxel by voxel
    count = int(index.cells[:, 3].sum())
    assert count == (mp.shape[0] if valid is None else int(valid.sum()))
    idx = index.points[:count, 3].view(torch.int32).long().sort().values
    want_idx = torch.arange(mp.shape[0], device=cuda) if valid is None \
        else torch.nonzero(v).flatten()
    assert torch.equal(idx, want_idx)


def _warm_graphs(cuda):
    """One registration on this thread: its first capture on the card runs
    one eager step to make the libraries' lazy state, and launches icp_nn
    once more than it captures; the counts of a test start after it."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.slam.device_icp import register_points_device

    pts = torch.from_numpy(cs.icp_world(400).astype(np.float32)).to(cuda)
    register_points_device(pts, None, pts, None, torch.eye(4, device=cuda),
                           1.0, 0.3, voxel_size=1.0)


def _counted(fn):
    """fn() with the program's tracer on: (its result, counter -> sum)."""
    from ouster_sdk_tpu_torch.utils import profiling

    profiling.clear()
    try:
        with profiling.tracing(True):
            out = fn()
        counts = {}
        for c in profiling.snapshot().counts:
            counts[c.name] = counts.get(c.name, 0) + c.n
    finally:
        profiling.clear()
    return out, counts


@pytest.mark.cuda
def test_register_points_device_on_the_card_matches_the_cpu(cuda):
    """register_points_device on the card against the CPU: translation
    within 1e-4 m and rotation within 1e-5 (sums in another order on the
    card); with allow_tf32 the card gives the same bits. On the card the
    iteration is one CUDA graph a registration: icp_nn is launched once,
    at its capture, and every iteration is a replay."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.slam.device_icp import register_points_device
    from ouster_sdk_tpu_torch.slam.kiss_icp import VoxelHashMap, se3_exp

    world = cs.icp_world()
    vm = VoxelHashMap(1.0, 200.0, 20)
    vm.add_points(world)
    T = se3_exp(np.array([0.3, -0.2, 0.1, 0.02, -0.01, 0.03]))
    scan = ((world - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    mp = vm.pointcloud().astype(np.float32)

    def run(device):
        st = {}
        out = register_points_device(
            torch.from_numpy(scan).to(device), None,
            torch.from_numpy(mp).to(device), None,
            torch.eye(4, device=device), 1.0, 0.3, voxel_size=1.0,
            stats=st)
        return out.cpu().numpy(), st

    _warm_graphs(cuda)
    nn.reset_launches()
    (got, st), counts = _counted(lambda: run(cuda))
    assert nn.launches["icp_nn"] == counts["icp.graph_captures"] == 1
    assert counts["icp.graph_replays"] == st["iterations"] > 0
    assert counts["icp.gn_iterations"] == st["iterations"]
    assert nn.launches["icp_nn_index"] == 1     # one index a registration
    want, _ = run("cpu")
    assert np.linalg.norm(got[:3, 3] - want[:3, 3]) <= 1e-4
    assert np.abs(got[:3, :3] - want[:3, :3]).max() <= 1e-5
    assert np.linalg.norm(got[:3, 3] - T[:3, 3]) < 0.02
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        again, _ = run(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert np.array_equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sizes", "first", "few", "max_iters",
                                  "masks"])
def test_graph_replay_is_bit_equal_to_the_eager_step(cuda, case):
    """register_points_device on the card (one CUDA graph a registration,
    replayed) against _gn_step run eagerly on the card from the same
    inputs: the pose after every iteration bit-equal (the registration
    cut at that iteration by max_iters), and the same stop. One capture
    and one icp_nn launch a registration, one replay an iteration."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.slam import device_icp as di

    def on_card(a):
        return None if a is None else torch.from_numpy(a).to(cuda)

    _warm_graphs(cuda)
    for src, sv, mp, mv, init, mcd, ks, max_iters in cs.gn_cases(case):
        src, sv, mp, mv, init = map(on_card, (src, sv, mp, mv, init))
        cur, T_icp, stop, fx = di._setup(src, sv, mp, mv, init, mcd, ks,
                                         1.0, 1e-4)
        eager = []
        for _ in range(max_iters):
            di._gn_step(cur, T_icp, stop, fx)
            eager.append(di._mm(T_icp, init))
            if bool(stop):
                break
        cuts = sorted({1, len(eager) // 2 or 1, len(eager)}) \
            if case == "sizes" else range(1, len(eager) + 1)
        for k in cuts:
            nn.reset_launches()
            st = {}
            got, counts = _counted(lambda: di.register_points_device(
                src, sv, mp, mv, init, mcd, ks, voxel_size=1.0,
                max_iters=max_iters if k == len(eager) else k, stats=st))
            assert st["iterations"] == k
            assert torch.equal(got.view(torch.int32),
                               eager[k - 1].view(torch.int32)), (case, k)
            assert nn.launches["icp_nn"] == counts["icp.graph_captures"] == 1
            assert counts["icp.graph_replays"] == k
        if case == "first" or case == "few":
            assert len(eager) == 1
        if case == "few":
            assert torch.equal(eager[0], init)
        if case == "max_iters":
            assert len(eager) == 3 and not bool(stop)


@pytest.mark.cuda
def test_slam_engine_device_backend_runs_on_the_card(cuda, tmp_path):
    """open_source -> SlamEngine(backend="device") on a small yard capture:
    every registration captures its iteration once (one icp_nn launch) and
    replays it once an iteration, and the device trajectory stays within
    0.05 m of the host backend's."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import icp_nn as nn
    from ouster_sdk_tpu_torch.kernels import slam_gather as sg
    from ouster_sdk_tpu_torch.slam import SlamConfig, SlamEngine

    info = cs.synth_info(cs.MAIN_PROFILE, w=512, h=32)
    path = str(tmp_path / "yard.pcap")
    cs.yard_capture(pt, path, info, 6)
    poses = {}
    _warm_graphs(cuda)
    for backend in ("device", "host"):
        eng = SlamEngine([info], SlamConfig(backend=backend, voxel_size=1.0))
        nn.reset_launches()
        sg.reset_launches()
        iters, regs, out = 0, 0, []

        def drive():
            nonlocal iters, regs
            for scans in pt.open_source(path, sensor_info=[info]):
                eng.update(scans)
                out.append(eng.last_pose.copy())
                last = getattr(eng._kiss, "last_frame", {})
                iters += last.get("iterations", 0)
                regs += last.get("m", 0) > 0
        _, counts = _counted(drive)
        poses[backend] = np.stack(out)
        if backend == "device":
            assert eng.device.type == "cuda"
            assert nn.launches["icp_nn"] == counts["icp.graph_captures"] \
                == regs > 0
            assert counts["icp.graph_replays"] == iters > 0
            # every scan's frame gathered on the card, one launch a scan
            assert sg.launches["slam_gather"] == \
                counts["slam.device_gathers"] == len(out) > 0
        else:
            assert sg.launches["slam_gather"] == 0
            assert "slam.device_gathers" not in counts
    assert np.abs(poses["device"][:, :3, 3]
                  - poses["host"][:, :3, 3]).max() <= 0.05


def _gather_operands(h: int, w: int, seed: int):
    """One sensor's gather on the CPU: ranges up to 120 m (a tenth zero,
    every seventh at or one unit beside 5 m and 100 m), a fifth of the
    columns invalid, per-column poses 100 m from the origin, a random
    LUT; returns (XYZLut, range, status, (range, status, poses, mid_inv,
    lut) tensors)."""
    from ouster_sdk_tpu_torch.ops.xyzlut import XYZLut

    rng = np.random.default_rng(seed)
    r = rng.integers(1, 120_000, (h, w)).astype(np.uint32)
    r[rng.random((h, w)) < 0.1] = 0
    r.flat[::7] = np.resize([4999, 5000, 5001, 99999, 100000, 100001],
                            r.flat[::7].size)
    status = (rng.random(w) >= 0.2).astype(np.uint32) | 6
    direction = rng.normal(size=(h, w, 3))
    direction *= 1e-3 / np.linalg.norm(direction, axis=-1, keepdims=True)
    lut = XYZLut(direction=direction,
                 offset=rng.normal(0.0, 1e-3, (h, w, 3)))
    poses = _poses(1, w, seed)[0].astype(np.float64)
    poses[:, :3, 3] += 100.0
    mid_inv = np.linalg.inv(poses[w // 2])
    planes = np.ascontiguousarray(np.concatenate(
        [np.moveaxis(lut.direction, -1, 0), np.moveaxis(lut.offset, -1, 0)]))
    ops = (torch.from_numpy(r.view(np.int32)),
           torch.from_numpy(status.view(np.int32)), torch.from_numpy(poses),
           torch.from_numpy(mid_inv), torch.from_numpy(planes))
    return lut, r, status, ops


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(128, 2048), (40, 496)])
def test_slam_gather_matches_plain_on_the_card(cuda, h, w):
    """kernels/csrc/slam_gather.cu against its plain version on the CPU:
    the same count; the points within 1e-12 m; with identity poses the
    points are XYZLut's product of the pixels the host's mask keeps, in
    numpy's order, bit for bit (the mask, the order and the projection)."""
    from ouster_sdk_tpu_torch.kernels import slam_gather as sg

    lut, r, status, ops = _gather_operands(h, w, h + w)
    want, n_want = sg.slam_gather(*ops, 5.0, 100.0)
    dev = [t.to(cuda) for t in ops]
    sg.reset_launches()
    got, n_got = sg.slam_gather(*dev, 5.0, 100.0)
    eye = torch.eye(4, dtype=torch.float64, device=cuda)
    ident, n_ident = sg.slam_gather(dev[0], dev[1],
                                    eye.expand(w, 4, 4).contiguous(), eye,
                                    dev[4], 5.0, 100.0)
    torch.cuda.synchronize()
    assert sg.launches["slam_gather"] == 2
    n = int(n_got[0])
    assert n == int(n_want[0]) == int(n_ident[0]) == want.shape[0] > 0
    assert (got[:n].cpu() - want).abs().max() <= 1e-12
    r_m = r * 0.001
    valid = (r > 0) & (status & 1).astype(bool)[None, :] & (r_m > 5.0) \
        & (r_m < 100.0)
    assert np.array_equal(ident[:n].cpu().numpy(), lut(r)[valid])


@pytest.mark.cuda
def test_slam_gather_rejects_what_it_does_not_take(cuda):
    """A wrong dtype, device or shape is refused with check_operand's
    message, and nothing is launched."""
    from ouster_sdk_tpu_torch.kernels import slam_gather as sg

    _, _, _, ops = _gather_operands(16, 64, 3)
    dev = [t.to(cuda) for t in ops]
    sg.reset_launches()
    for k, bad, message in (
            (0, dev[0].to(torch.int64),
             "range must be torch.int32, got torch.int64"),
            (1, ops[1], "status is on cpu, the frames on cuda:0"),
            (2, dev[2].to(torch.float32),
             "poses must be torch.float64, got torch.float32"),
            (4, dev[4][:, :, 1:].contiguous(),
             "lut must have shape (6, 16, 64), got (6, 16, 63)"),
            (4, dev[4].transpose(1, 2).contiguous().transpose(1, 2),
             "lut must be contiguous")):
        args = list(dev)
        args[k] = bad
        with pytest.raises(ValueError) as e:
            sg.slam_gather(*args, 5.0, 100.0)
        assert str(e.value) == message
    assert sg.launches["slam_gather"] == 0


@pytest.mark.cuda
def test_voxel_admit_matches_plain_on_the_card(cuda, monkeypatch):
    """The device voxel map's admission kernel against its plain version
    on the inputs of a run of map updates (held, full and fresh voxels,
    candidates inside the admission radius): the same keys, counts, points
    and admitted counts, bit for bit; and the map on the card equals the
    host VoxelHashMap after every update."""
    from ouster_sdk_tpu_torch.kernels import voxel_map as vm
    from ouster_sdk_tpu_torch.slam import device_map
    from ouster_sdk_tpu_torch.slam.kiss_icp import VoxelHashMap, se3_exp

    calls = []

    def kept(*args):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return vm.voxel_admit(*args)

    monkeypatch.setattr(device_map, "voxel_admit", kept)
    rng = np.random.default_rng(5)
    host = VoxelHashMap(1.0, 30.0, 5)
    maps = [device_map.DeviceVoxelMap(1.0, 30.0, 5, d)
            for d in (torch.device("cpu"), cuda)]
    vm.reset_launches()
    for _ in range(6):
        p = rng.uniform(-15, 15, (4000, 3))
        p = np.concatenate([p, p[:800] + rng.normal(0, 0.2, (800, 3)),
                            np.repeat(p[:50], 30, axis=0)
                            + rng.uniform(-0.5, 0.5, (1500, 3))])
        pose = se3_exp(rng.normal(0, 0.5, 6))
        host.update(p, pose)
        for m in maps:
            m.update(p, pose)
            assert list(m._voxels) == list(host._voxels)
            assert np.array_equal(m.pointcloud(), host.pointcloud())
    assert vm.launches["voxel_admit"] == 6
    assert max(len(v) for v in host._voxels.values()) == 5
    for args in calls[::2]:                    # the CPU map's calls
        want = [a.clone() if torch.is_tensor(a) else a for a in args]
        got = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
        added_want = vm.voxel_admit_reference(*want)
        added_got = vm.voxel_admit(*got)
        torch.cuda.synchronize()
        assert torch.equal(added_got.cpu(), added_want)
        for k in (7, 8, 9):                    # keys, map points, counts
            assert torch.equal(got[k].cpu(), want[k])


@pytest.mark.cuda
def test_normals_and_downsample_on_the_card_match_the_cpu(cuda):
    """normals_device (f32) on the card against the CPU: at most 0.1 % of
    the pixels differ by more than 1e-5 (transcendentals and division by a
    scalar round differently there, which can flip a neighbour decision);
    voxel_downsample_device: the same mask, centroids within 4 f32 ulp of
    32 m (atomics sum in no fixed order)."""
    from ouster_sdk_tpu_torch.ops.downsample import voxel_downsample_device
    from ouster_sdk_tpu_torch.ops.normals_device import normals_device

    h, w = 32, 256
    rng = np.random.default_rng(3)
    alt = np.deg2rad(np.linspace(20, -20, h))[:, None]
    az = (2 * np.pi * np.arange(w) / w)[None, :]
    d = np.stack([np.cos(alt) * np.cos(az), np.cos(alt) * np.sin(az),
                  np.broadcast_to(np.sin(alt), (h, w))], axis=-1)
    r = (8000 + 2000 * np.sin(3 * az) + rng.integers(0, 50, (h, w))
         ).astype(np.uint32)
    r[rng.random((h, w)) < 0.03] = 0
    xyz = (d * (r[..., None] * 0.001)).astype(np.float32)
    origins = np.zeros((w, 3), np.float32)
    got, none = normals_device(xyz, r, origins)
    assert none is None and got.device.type == "cuda"
    want, _ = normals_device(xyz, r, origins, device="cpu")
    diff = (got.cpu() - want).abs().amax(dim=-1)
    assert int((diff > 1e-5).sum()) <= 0.001 * h * w
    pts = torch.from_numpy(rng.uniform(-30, 30, (20000, 3))
                           .astype(np.float32))
    c_gpu, m_gpu = voxel_downsample_device(pts.to(cuda), 1.0, 32768)
    c_cpu, m_cpu = voxel_downsample_device(pts, 1.0, 32768)
    assert torch.equal(m_gpu.cpu(), m_cpu)
    assert float((c_gpu.cpu() - c_cpu).abs().max()) <= 4 * float(
        np.spacing(np.float32(32.0)))


# -- XYZLut's float64 product on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(128, 2048), (16, 256)])
def test_xyz_project_is_the_host_lut_bit_for_bit(cuda, h, w):
    """kernels/csrc/xyz_project.cu against ops.xyzlut.XYZLut.__call__ and
    against its plain version on the same card tensors (the plain version
    is held to the JAX package's LUT in tests/test_torch_xyz_project.py):
    zero ranges, ranges of 2**19 and above, the largest uint32, a LUT with
    an extrinsic; one launch a call."""
    from test_torch_xyz_project import extrinsic_lut, hard_ranges
    from ouster_sdk_tpu_torch.kernels import xyz_project as xp

    lut = extrinsic_lut(h, w)
    r = hard_ranges(h, w, h * w)
    planes = xp.lut_tensor(lut.direction, lut.offset).to(cuda)
    xp.reset_launches()
    rd = torch.from_numpy(r.view(np.int32)).to(cuda)
    got = xp.xyz_project(rd, planes)
    plain = xp.xyz_project_reference(rd, planes)
    torch.cuda.synchronize()
    assert xp.launches["xyz_project"] == 1 and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int64), plain.view(torch.int64))
    assert np.array_equal(got.cpu().numpy().view(np.uint64),
                          lut(r).view(np.uint64))


@pytest.mark.cuda
def test_xyz_project_rejects_what_it_does_not_take(cuda):
    from ouster_sdk_tpu_torch.kernels import xyz_project as xp

    lut = pt.make_xyz_lut(_info(PROFILES["planar_dual"], h=16, w=64))
    r = torch.zeros((16, 64), dtype=torch.int32, device=cuda)
    planes = xp.lut_tensor(lut.direction, lut.offset).to(cuda)
    xp.reset_launches()
    for args, message in (
            ((r.to(torch.int64), planes),
             "range must be torch.int32, got torch.int64"),
            ((r, planes.cpu()), "lut is on cpu, the frames on cuda:0"),
            ((r, planes.float()),
             "lut must be torch.float64, got torch.float32"),
            ((r, planes[:, :, 1:].contiguous()),
             "lut must have shape (2, 16, 64, 3), got (2, 16, 63, 3)")):
        with pytest.raises(ValueError) as e:
            xp.xyz_project(*args)
        assert str(e.value) == message
    assert xp.launches["xyz_project"] == 0


@pytest.mark.cuda
def test_engine_scans_project_on_the_card_as_on_the_host(cuda, tmp_path):
    """open_source on the card, XYZLut of both returns (the scan, then its
    RANGE2 as a bare image) with the sensor's extrinsic: the host's float64
    bits, every return on the card (two launches and two
    `xyzlut.device_returns` a frame), fresh unpinned arrays that no later
    call overwrites. A CPU-decoded scan, a bare image before any card
    scan, and a bare image that is no range field of the last card scan
    take the host path."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.kernels import xyz_project as xp

    info = cs.synth_info(cs.MAIN_PROFILE, w=512, h=32)
    info.extrinsic = np.array([[0.0, -1, 0, 1.5], [1, 0, 0, -0.25],
                               [0, 0, 1, 0.2], [0, 0, 0, 1]])
    path = str(tmp_path / "main.pcap")
    cs.synth_capture(path, info, 4)
    host = pt.make_xyz_lut(info, use_extrinsics=True)

    lut = pt.XYZLut(info, use_extrinsics=True)
    xp.reset_launches()
    cpu_scans = [s[0] for s in pt.open_source(path, sensor_info=[info],
                                              device="cpu")]
    lut(cpu_scans[0].field("RANGE2"))
    for s in cpu_scans:
        assert s.decode_device.type == "cpu"
        lut(s)
    assert xp.launches["xyz_project"] == 0

    def drive():
        out = []
        for scans in pt.open_source(path, sensor_info=[info]):
            s = scans[0]
            assert s.decode_device.type == "cuda"
            out.append((s, lut(s), lut(s.field("RANGE2"))))
        return out

    got, counts = _counted(drive)
    assert len(got) == 4
    assert xp.launches["xyz_project"] == counts["xyzlut.device_returns"] \
        == 2 * len(got)
    for s, xyz, xyz2 in got:
        assert np.array_equal(xyz, host(s.field("RANGE")))
        assert np.array_equal(xyz2, host(s.field("RANGE2")))
        assert not torch.from_numpy(xyz).is_pinned()
        assert xyz.flags.owndata and xyz.flags.writeable
    first, keep = got[0][1], got[0][1].copy()
    first[:] = -1.0
    again = lut(got[0][0])
    assert np.array_equal(again, keep)
    assert not np.shares_memory(again, first)
    assert all(not np.shares_memory(a[1], b[2]) for a in got for b in got)
    n = xp.launches["xyz_project"]
    for img in (got[0][0].field("RANGE2").copy(), got[-1][0].field("RANGE2")):
        assert np.array_equal(lut(img), host(img))
    assert xp.launches["xyz_project"] == n
