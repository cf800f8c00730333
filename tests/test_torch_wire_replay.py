"""The wire-codec replay as the benchmark's wire cell drives it
(portbench/drivers/wire_replay.py), at 16 x 256 on the CPU, for a dual and
a single profile on a yard capture (portbench/lib/yard.py):

    FrameReader.iter_bp64_chunks -> fused_pipelined -> words_tensor
      -> unfuse_words -> project_bp64_batched

- The benchmark's plain BP64 decoder (portbench/reference/bp64.py), on each
  shipped buffer split by its layout, gives back the written ranges
  exactly.
- The XYZ equals ScanPipeline.project_planar's of the same frames bit for
  bit (neither has poses), and lies within 6 float32 ulps of the float64
  reference (portbench/reference/lut.py).
- The reference decoder holds to bp64_encode_numpy on edge blocks: all
  dropouts, a constant block (width 0), width 20, and a dropout in each
  half of the mask.
"""

import json
import os

import numpy as np
import pytest
import torch

import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu_torch.ops import bp64, packed
from ouster_sdk_tpu_torch.ops.planar_kernels import words_tensor
from portbench.lib import synth, yard
from portbench.reference import bp64 as ref
from portbench.reference import compare, lut

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"dual": "os2-128-2048x10-dual-bp64.json",
           "single": "os2-128-1024x10-single.json"}
H, W, N, CHUNK, SEED = 16, 256, 6, 4, 2**31 + 4099
DRIVE = {"speed_m": 1.0, "yaw_deg": 1.0, "ramp_frames": 2}
DATA = {"noise_mm": 5.0, "dropout_share": 0.02, "second_share": 0.15}


def tiny_metadata(name):
    """A configuration's metadata cut to H x W (as the benchmark's tests
    cut it)."""
    m = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                    name)))["metadata"]
    f = m["lidar_data_format"]
    f["pixels_per_column"], f["columns_per_frame"] = H, W
    f["column_window"] = [0, W - 1]
    f["pixel_shift_by_row"] = f["pixel_shift_by_row"][:H]
    b = m["beam_intrinsics"]
    b["beam_altitude_angles"] = b["beam_altitude_angles"][::128 // H]
    b["beam_azimuth_angles"] = b["beam_azimuth_angles"][:H]
    m["config_params"]["lidar_mode"] = f"{W * 2}x10"
    return m


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def replayed(request, tmp_path_factory):
    """(metadata, the yard's frames, the replay's chunks as the driver
    keeps them: frame ids, the shipped buffer, its layout and the XYZ of
    each return, and the planar projection's XYZ of the same chunks)."""
    meta = tiny_metadata(CONFIGS[request.param])
    sensor = synth.Sensor(meta)
    dist = yard.distances(meta, DRIVE, N)
    frames = [yard.frame(sensor, dist[k], DATA, SEED, k) for k in range(N)]
    path = synth.write_capture(str(tmp_path_factory.mktemp(request.param)),
                               meta, frames)
    info = pt.SensorInfo(open(path[:-len(".pcap")] + ".json").read())
    pipe = pt.ScanPipeline(info, device="cpu")
    fields, nbits, ups = packed.packed_range_fields(pipe.plan, pipe.dual)
    reader = pt.FrameReader(path, info)

    def select(item):
        fids, payload, widths, anchors, hdrs, _ = item
        return fids, [payload, widths, anchors, hdrs]

    chunks = []
    for fids, fused, layout in pt.fused_pipelined(
            lambda: reader.iter_bp64_chunks(CHUNK, fields, nbits,
                                            pool_depth=4), select, 2):
        parts = packed.unfuse_words(words_tensor(fused, "cpu"), layout)
        out = bp64.project_bp64_batched(
            *parts, pipe.planar_lut.stack, pipe.plan, nbits, upshifts=ups,
            dual=pipe.dual)
        # on the CPU the parts are views of the fuser's ring: copy now
        chunks.append((fids, fused.copy(), layout,
                       [x.clone() for x in (out if pipe.dual else (out,))]))
    planar = []
    for _, planes, hdrs, _ in pt.FrameReader(path, info).iter_planar_chunks(
            CHUNK):
        out = pipe.project_planar(planes, hdrs)
        planar.append(list(out) if pipe.dual else [out])
    return meta, sensor, frames, chunks, planar


def test_the_reference_decodes_each_shipped_buffer_to_the_ranges(replayed):
    _, sensor, frames, chunks, _ = replayed
    assert np.concatenate([c[0] for c in chunks]).tolist() == \
        list(range(1, N + 1))
    for fids, fused, layout, _ in chunks:
        payload, widths, anchors, _ = ref.split(fused, layout)
        assert widths.dtype == np.uint8 and len(payload) == len(fids)
        for b, fid in enumerate(fids):
            got = ref.decode(payload[b], widths[b], anchors[b]).numpy()
            want = np.stack([frames[fid - 1]["fields"][name]
                             for name in sensor.returns])
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_the_xyz_is_the_planar_projection_bit_for_bit(replayed):
    *_, chunks, planar = replayed
    assert len(chunks) == len(planar)
    for (_, _, _, xyz), want in zip(chunks, planar):
        assert len(xyz) == len(want)
        for got, w in zip(xyz, want):
            assert got.dtype == torch.float32
            assert torch.equal(got, w)


def test_the_xyz_is_within_6_ulps_of_the_f64_reference(replayed):
    meta, sensor, frames, chunks, _ = replayed
    ref_lut = lut.Lut(meta)
    worst = 0.0
    for fids, _, _, xyz in chunks:
        for b, fid in enumerate(fids):
            for k, name in enumerate(sensor.returns):
                want = ref_lut(frames[fid - 1]["fields"][name])
                worst = max(worst, compare.ulp_error(
                    np.moveaxis(xyz[k][b].numpy(), 0, -1), want))
    assert 0 < worst <= 6


def _edge(kind, rng):
    """One 64-pixel block of the named kind."""
    v = rng.integers(1, 1 << 19, 64).astype(np.uint32)
    if kind == "all_dropouts":
        v[:] = 0
    elif kind == "constant":
        v[:] = 777_777
    elif kind == "width_20":
        v[:] = 1000
        v[1:] = 1000 + 300_000          # zigzag 600 000: 20 bits
    elif kind == "dropout_in_each_half":
        v[5] = v[40] = 0
    return v


@pytest.mark.parametrize("kind", ["all_dropouts", "constant", "width_20",
                                  "dropout_in_each_half"])
def test_the_reference_decoder_on_edge_blocks(kind):
    rng = np.random.default_rng(17)
    # the edge block first in one row and last in the next, beside random
    # blocks, so that the blocks after it are found from its width byte
    row = lambda first: np.concatenate(
        [_edge(kind, rng), rng.integers(0, 1 << 19, 64).astype(np.uint32)]
        [::1 if first else -1])
    values = np.stack([row(True), row(False)])[None]       # (1, 2, 128)
    payload, widths, anchors = bp64.bp64_encode_numpy(values, 19)
    w, flag = widths & 0x1F, widths >> 7
    edge = (w[0, 0, 0], flag[0, 0, 0])
    assert edge == (w[0, 1, 1], flag[0, 1, 1])
    assert edge == {"all_dropouts": (0, 1), "constant": (0, 0),
                    "width_20": (20, 0),
                    "dropout_in_each_half": (edge[0], 1)}[kind]
    got = ref.decode(np.concatenate([payload, np.zeros(2, np.uint32)]),
                     widths, anchors).numpy()
    np.testing.assert_array_equal(got, values)
    # and the port's own decode of the same words
    np.testing.assert_array_equal(
        bp64.bp64_decode_numpy(payload, widths, anchors, 128), values)
