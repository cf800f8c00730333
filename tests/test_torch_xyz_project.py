"""XYZLut's float64 product on a device (kernels/xyz_project,
ops/xyzlut.XYZLutCard) and XYZLutFactory's routes to it, on the CPU.

- The kernel's plain version is the host XYZLut's product bit for bit, and
  the JAX package's XYZLut of the same sensor's: zero ranges, ranges of
  2**19 and above, the largest uint32, a LUT with an extrinsic.
- XYZLutCard returns a fresh array a call: the caller owns it, the next
  call does not overwrite it; it takes only images of its LUT's (h, w)
  whose dtype the kernel's uint32 operand holds exactly.
- The device engine marks each scan with the device it decoded on; the
  factory projects a scan decoded on CUDA on that card (here a stand-in
  that records the device and computes on the CPU), then a bare range
  image of the LUT's shape on the same card, and counts each return in
  `xyzlut.device_returns`; a CPU-decoded scan, a bare image before any
  card scan, a bare image that is no range field of the last card scan,
  and any scan in a process forked after CUDA was initialised take the
  host path and count nothing. The bits are the JAX package's on either
  route.

The card's own kernel is held to the host in tests/test_torch_cuda.py.
"""

import copy

import numpy as np
import pytest
import torch
from _torch_helpers import jax_sensor_info
from ouster_sdk_tpu.ops.xyzlut import make_xyz_lut as jax_make_xyz_lut

import chip_smoke as cs
import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.kernels import xyz_project as xp
from ouster_sdk_tpu_torch.ops.xyzlut import XYZLutCard
from ouster_sdk_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def hard_ranges(h: int, w: int, seed: int) -> np.ndarray:
    """Ranges up to 2**20 mm with a tenth zero, every ninth at 2**19 or
    above (to the largest uint32)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 1 << 20, (h, w)).astype(np.uint32)
    r[rng.random((h, w)) < 0.1] = 0
    r.flat[::9] = np.resize(np.array([1 << 19, (1 << 19) + 1, 1 << 24,
                                      0xFFFFFFFF], np.uint32),
                            r.flat[::9].size)
    return r


def with_extrinsic(info):
    """A copy of `info` with a rotation about z and a translation."""
    info = copy.deepcopy(info)
    ext = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    ext[:2, :2] = [[c, -s], [s, c]]
    ext[:3, 3] = [1.5, -0.25, 0.2]
    info.extrinsic = ext
    return info


def extrinsic_info(h: int, w: int):
    return with_extrinsic(cs.synth_info(cs.MAIN_PROFILE, w=w, h=h))


def extrinsic_lut(h: int, w: int):
    return pt.make_xyz_lut(extrinsic_info(h, w), use_extrinsics=True)


def jax_lut(info):
    """The JAX package's float64 XYZLut of the same sensor, with its
    extrinsic, parsed from the port's metadata string."""
    return jax_make_xyz_lut(jax_sensor_info(info.to_json_string()),
                            use_extrinsics=True)


def bits(xyz: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(xyz, np.float64).view(np.uint64)


@pytest.mark.parametrize("h,w", [(16, 256), (128, 2048)])
def test_plain_version_is_the_host_lut_bit_for_bit(h, w):
    lut = extrinsic_lut(h, w)
    r = hard_ranges(h, w, h + w)
    want = lut(r)
    got = xp.xyz_project(torch.from_numpy(r.view(np.int32)),
                         xp.lut_tensor(lut.direction, lut.offset))
    assert got.dtype == torch.float64 and tuple(got.shape) == (h, w, 3)
    assert np.array_equal(got.numpy().view(np.uint64),
                          want.view(np.uint64))
    assert (got.numpy()[r == 0] == 0).all()


@pytest.mark.parametrize("h,w", [(16, 256), (128, 2048)])
def test_plain_version_is_the_jax_packages_lut_bit_for_bit(h, w):
    info = extrinsic_info(h, w)
    r = hard_ranges(h, w, h * w)
    lut = pt.make_xyz_lut(info, use_extrinsics=True)
    got = xp.xyz_project(torch.from_numpy(r.view(np.int32)),
                         xp.lut_tensor(lut.direction, lut.offset))
    assert np.array_equal(bits(got.numpy()), bits(jax_lut(info)(r)))


def test_card_projection_returns_a_fresh_array_a_call():
    lut = extrinsic_lut(16, 256)
    card = XYZLutCard(lut)
    r = hard_ranges(16, 256, 5)
    a = card(r, CPU)
    b = card(r[::-1].copy(), CPU)
    assert np.array_equal(a, lut(r)) and np.array_equal(b, lut(r[::-1]))
    assert not np.shares_memory(a, b)
    a[:] = -1.0                           # the caller's to write
    assert np.array_equal(card(r, CPU), lut(r))
    assert np.array_equal(b, lut(r[::-1]))
    # a uint16 image widens exactly; the LUT and buffers are made once
    assert np.array_equal(card(r.astype(np.uint16), CPU),
                          lut(r.astype(np.uint16)))
    assert list(card._on) == [CPU]


def test_card_takes_what_its_operand_holds_exactly():
    card = XYZLutCard(extrinsic_lut(16, 256))
    r = hard_ranges(16, 256, 6)
    assert card.takes(r) and card.takes(r.astype(np.uint8))
    assert not card.takes(r.view(np.int32))      # negative where r >= 2**31
    assert not card.takes(r.astype(np.float64))
    assert not card.takes(r.astype(np.uint64))
    assert not card.takes(r[:8])


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """(info, the device engine's scans of a 3-frame 16 x 256 dual capture
    decoded on the CPU)."""
    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    path = str(tmp_path_factory.mktemp("xyz_project") / "main.pcap")
    cs.synth_capture(path, info, 3)
    got = list(pt.DeviceScanIterator(path, info, device="cpu"))
    assert len(got) == 3
    return info, got


@pytest.fixture
def tracer():
    profiling.clear()
    with profiling.tracing(True):
        yield profiling
    profiling.clear()


def device_returns(tracer) -> int:
    return sum(c.n for c in tracer.snapshot().counts
               if c.name == "xyzlut.device_returns")


def test_engine_scans_are_marked_and_batcher_scans_are_not(scans):
    info, got = scans
    assert all(s.decode_device == CPU for s in got)
    assert pt.LidarScan(info).decode_device is None
    live = pt.LiveDeviceBatcher(info, device="cpu")
    assert live.device == CPU


def test_a_cpu_decoded_scan_takes_the_host_path(scans, tracer):
    info, got = scans
    lut, host = pt.XYZLut(info), pt.make_xyz_lut(info)
    bare = got[0].field("RANGE2")
    assert np.array_equal(lut(bare), host(bare))  # before any scan
    for s in got:
        assert np.array_equal(lut(s), host(s.field("RANGE")))
        assert np.array_equal(lut(s.field("RANGE2")),
                              host(s.field("RANGE2")))
    assert device_returns(tracer) == 0
    assert "xyzlut.device_returns" not in {
        c.name for c in tracer.snapshot().counts}


@pytest.fixture
def stand_in(monkeypatch):
    """XYZLutCard on a stand-in card: records the device each call asks
    for and computes on the CPU (the kernel's plain version)."""
    seen = []
    real = XYZLutCard.__call__

    def call(self, range_img, device):
        seen.append(device)
        return real(self, range_img, CPU)

    monkeypatch.setattr(XYZLutCard, "__call__", call)
    return seen


@pytest.fixture
def on_card(scans):
    """The fixture's scans marked as decoded on CUDA device 0, for the
    test's length."""
    _, got = scans
    card_dev = torch.device("cuda", 0)
    for s in got:
        s._decode_device = card_dev
    yield card_dev
    for s in got:
        s._decode_device = CPU


def test_scans_decoded_on_a_card_project_there(scans, tracer, stand_in,
                                               on_card):
    """Routes 2 and 3 with a stand-in card: the scan's RANGE goes to the
    device the scan names, its RANGE2 as a bare image after it; both count,
    and the bits are the JAX package's."""
    info, got = scans
    linfo = with_extrinsic(info)
    lut = pt.XYZLut(linfo, use_extrinsics=True)
    want_lut = jax_lut(linfo)
    want = [(want_lut(s.field("RANGE")), want_lut(s.field("RANGE2")))
            for s in got]
    for s, (xyz, xyz2) in zip(got, want):
        a, b = lut(s), lut(s.field("RANGE2"))
        assert np.array_equal(bits(a), bits(xyz))
        assert np.array_equal(bits(b), bits(xyz2))
        assert np.array_equal(bits(lut.return_xyz(s, 1)), bits(xyz2))
    # a float image, or another shape, stays on the host
    lut(got[0].field("RANGE").astype(np.float64))
    with pytest.raises(ValueError, match="broadcast"):
        lut(got[0].field("RANGE")[:8])
    assert stand_in == [on_card] * (3 * len(got))
    assert device_returns(tracer) == 3 * len(got)
    # one span a call, either route: the bare images' card calls too
    spans = [s for s in tracer.snapshot().spans if s.name == "xyzlut"]
    assert len(spans) == 3 * len(got) + 2


def test_a_bare_image_goes_to_the_card_only_from_the_last_card_scan(
        scans, tracer, stand_in, on_card):
    """Route 3 follows the input, not the LUT's history: before any card
    scan, and after one for an image that is no range field of it (a copy
    of its RANGE2, another scan's RANGE2, a fresh image), the host path."""
    info, got = scans
    lut = pt.XYZLut(info)
    want_lut = jax_lut(info)
    first, other = got[0], got[1]
    r2 = first.field("RANGE2")
    assert np.array_equal(bits(lut(r2)), bits(want_lut(r2)))
    assert stand_in == []                      # no card scan yet
    lut(first)
    fresh = np.random.default_rng(3).integers(
        0, 1 << 20, r2.shape).astype(np.uint32)
    for img in (r2.copy(), other.field("RANGE2"), fresh):
        assert np.array_equal(bits(lut(img)), bits(want_lut(img)))
    assert stand_in == [on_card]
    assert np.array_equal(bits(lut(r2)), bits(want_lut(r2)))
    assert np.array_equal(bits(lut(first.field("RANGE"))),
                          bits(want_lut(first.field("RANGE"))))
    assert stand_in == [on_card] * 3
    assert device_returns(tracer) == 3


def test_a_forked_process_projects_card_scans_on_the_host(
        scans, tracer, stand_in, on_card, monkeypatch):
    """Where CUDA cannot be used again (a process forked after it was
    initialised), a card scan and its RANGE2 take the host path."""
    info, got = scans
    monkeypatch.setattr(torch.cuda, "_is_in_bad_fork", lambda: True)
    lut = pt.XYZLut(info)
    want_lut = jax_lut(info)
    for s in got:
        assert np.array_equal(bits(lut(s)), bits(want_lut(s.field("RANGE"))))
        r2 = s.field("RANGE2")
        assert np.array_equal(bits(lut(r2)), bits(want_lut(r2)))
    assert stand_in == [] and device_returns(tracer) == 0
