"""The OSF codecs of the PyTorch port (ouster_sdk_tpu_torch) against the
JAX package's on the same inputs: the flatbuffers builder and reader, the
PNG and zPNG field codecs (decode of every PNG scanline filter, the native
unfilter against the numpy one), stagger / destagger with the typed
aliases, and the sensor json an OSF file stores.

Inputs are small (32x256, 32x512) and made from seeds with numpy."""

import json
import struct
import zlib

import numpy as np
import pytest

import ouster_sdk_tpu.ops.destagger as jdst
import ouster_sdk_tpu.utils.flatbuf as jfb
import ouster_sdk_tpu.utils.png as jpng
import ouster_sdk_tpu.utils.zpng as jzpng
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.ops.destagger as pdst
import ouster_sdk_tpu_torch.utils.flatbuf as pfb
import ouster_sdk_tpu_torch.utils.png as ppng
import ouster_sdk_tpu_torch.utils.zpng as pzpng
from _torch_helpers import DUAL, engine_metadata, jax_sensor_info
from ouster_sdk_tpu_torch.utils import native

SHAPES = ((32, 256), (32, 512))
DTYPES = (np.uint8, np.uint16, np.uint32, np.uint64)


def _image(shape, dtype, seed):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, info.max, size=shape, dtype=dtype,
                       endpoint=True)
    img[rng.random(shape) < 0.3] = 0      # runs that compress
    return img


# -- flatbuffers --------------------------------------------------------------

def _build(fb):
    """One buffer through every builder call the OSF codec makes."""
    b = fb.Builder()
    s = b.string("ouster/v1/os_sensor/LidarSensor")
    raw = b.vector_bytes(bytes(range(37)))
    u64 = b.vector_scalar(np.arange(5, dtype=np.uint64) * 10**12, np.uint64)
    u16 = b.vector_scalar([1, 2, 3], np.uint16)
    f64 = b.vector_scalar(np.linspace(0, 1, 16), np.float64)
    structs = b.vector_structs(b"".join(struct.pack("<I4xQ", i, 7 * i)
                                        for i in range(3)), 3, align=8)
    pairs = b.vector_structs(bytes([1, 3, 2, 2]), 2, align=1)
    inner = []
    for k in range(3):
        name = b.string(f"field{k}")
        b.start_table()
        b.slot_offset(0, name)
        b.slot_scalar(1, "B", k + 1)
        b.slot_scalar(3, "q", -k, default=0)
        inner.append(b.end_table())
    tables = b.vector_offsets(inner)
    b.start_table()
    b.slot_offset(0, s)
    b.slot_offset(1, raw)
    b.slot_offset(2, u64)
    b.slot_offset(3, u16)
    b.slot_offset(4, f64)
    b.slot_offset(5, structs)
    b.slot_offset(6, pairs)
    b.slot_offset(7, tables)
    b.slot_scalar(8, "Q", 2**63 + 5)
    b.slot_scalar(9, "i", -3)
    b.slot_scalar(10, "B", 0)          # the default: not stored
    root = b.end_table()
    return b.finish(root, b"OSF!", size_prefix=True)


def _read(fb, buf):
    t = fb.root_size_prefixed(buf, b"OSF!")
    ids = np.dtype({"names": ["a", "b"], "formats": [np.uint32, np.uint64],
                    "offsets": [0, 8], "itemsize": 16})
    return (t.string(0), t.vector_bytes(1), t.vector_np(2, np.uint64),
            t.vector_np(3, np.uint16), t.vector_np(4, np.float64),
            t.vector_np(5, ids).tolist(), t.vector_np(6, np.uint8),
            [(x.string(0), x.scalar(1, "B"), x.scalar(3, "q"))
             for x in t.vector_tables(7)],
            t.scalar(8, "Q"), t.scalar(9, "i"), t.scalar(10, "B", 9),
            t.vector_len(2), t.table(11))


def test_flatbuf_builder_byte_equal_and_readers_agree():
    buf = _build(pfb)
    assert buf == _build(jfb)
    mine, theirs = _read(pfb, buf), _read(jfb, buf)
    for a, b in zip(mine, theirs):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert mine[0] == "ouster/v1/os_sensor/LidarSensor"
    assert mine[1] == bytes(range(37)) and mine[8] == 2**63 + 5
    assert mine[10] == 9 and mine[12] is None
    # root_auto takes the buffer with and without its size prefix
    for fb in (pfb, jfb):
        assert fb.root_auto(buf).string(0) == mine[0]
    with pytest.raises(ValueError, match="bad file identifier"):
        pfb.root_size_prefixed(buf, b"OSF$")


# -- PNG and zPNG field codecs -------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_field_codecs_byte_equal(shape, dtype):
    img = _image(shape, dtype, seed=np.dtype(dtype).itemsize + shape[1])
    png = ppng.encode_field_png(img)
    assert png == jpng.encode_field_png(img)
    got = ppng.decode_field_png(png)
    assert got.dtype == img.dtype and np.array_equal(got, img)
    np.testing.assert_array_equal(got, jpng.decode_field_png(png))
    z = pzpng.encode(img, 3)
    assert z == jzpng.encode(img, 3) and pzpng.is_zpng(z)
    got = pzpng.decode(z)
    assert got.dtype == img.dtype and np.array_equal(got, img)
    np.testing.assert_array_equal(got, jzpng.decode(z))


def test_field_codecs_reject_what_the_jax_package_rejects():
    img = np.zeros((4, 8), np.int32)
    for mod in (ppng, jpng):
        with pytest.raises(ValueError, match="unsupported field dtype"):
            mod.encode_field_png(img)
        with pytest.raises(ValueError, match="not a PNG"):
            mod.decode(b"nope" * 4)
    for mod in (pzpng, jzpng):
        with pytest.raises(ValueError, match="unsupported zpng dtype"):
            mod.encode(img)


def _filter_rows(raw: np.ndarray, filters, bpp: int) -> np.ndarray:
    """The PNG encoder's side of the five scanline filters, written per
    byte from the specification: (h, stride) -> (h, stride + 1)."""
    h, stride = raw.shape
    out = np.zeros((h, stride + 1), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f = filters[y]
        cur = raw[y].astype(np.int64)
        out[y, 0] = f
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            out[y, 1 + i] = (cur[i] - pred) & 0xFF
        prev = cur
    return out


def _png(filtered: np.ndarray, w: int, h: int, depth: int, ctype: int
         ) -> bytes:
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + chunk(b"IEND", b""))


# (dtype, bytes a pixel, sample depth, color type): GRAY 8, GRAY 16,
# RGBA 8 (u32), RGBA 16 (u64)
LAYOUTS = ((np.uint8, 1, 8, 0), (np.uint16, 2, 16, 0),
           (np.uint32, 4, 8, 6), (np.uint64, 8, 16, 6))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: str(x[1]))
def test_png_decode_every_filter(filt, layout):
    """A hand-built PNG whose rows carry each filter type decodes to the
    image in both packages, through the native unfilter and without it."""
    dtype, bpp, depth, ctype = layout
    h, w = 6, 40
    img = _image((h, w), dtype, seed=bpp)
    # the PNG sample order: big-endian 16-bit samples, LE byte lanes
    if depth == 8:
        raw = np.ascontiguousarray(img).view(np.uint8).reshape(h, w * bpp)
    else:
        raw = (np.ascontiguousarray(img).view(np.uint16)
               .astype(">u2").view(np.uint8).reshape(h, w * bpp))
    filters = (list(np.random.default_rng(5).integers(0, 5, h))
               if filt == "mixed" else [filt] * h)
    data = _png(_filter_rows(raw, filters, bpp), w, h, depth, ctype)
    native.reset_calls()
    got = ppng.decode_field_png(data)
    assert native.calls["png_unfilter"] == (native.get_lib() is not None)
    assert got.dtype == img.dtype and np.array_equal(got, img)
    np.testing.assert_array_equal(got, jpng.decode_field_png(data))
    orig = native.get_lib
    native.get_lib = lambda: None
    try:
        np.testing.assert_array_equal(ppng.decode_field_png(data), img)
    finally:
        native.get_lib = orig


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    if native.get_lib() is None:
        pytest.skip("no g++: the numpy unfilter is the only route")
    rng = np.random.default_rng(bpp)
    h, stride = 24, bpp * 37
    rows = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    native.reset_calls()
    got = native.png_unfilter(rows, h, stride, bpp)
    assert native.calls["png_unfilter"] == 1
    np.testing.assert_array_equal(got, ppng._unfilter_py(rows, h, stride,
                                                         bpp))
    np.testing.assert_array_equal(got, jpng._unfilter_py(rows, h, stride,
                                                         bpp))


def test_native_unfilter_checks_its_arguments():
    if native.get_lib() is None:
        pytest.skip("no g++: the numpy unfilter is the only route")
    rows = np.zeros((4, 9), np.uint8)
    with pytest.raises(ValueError, match="shape"):
        native.png_unfilter(rows, 4, 9, 1)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.png_unfilter(np.zeros((4, 18), np.uint8)[:, ::2], 4, 8, 1)
    with pytest.raises(ValueError, match="bpp"):
        native.png_unfilter(rows, 4, 8, 9)
    rows[2, 0] = 5
    with pytest.raises(ValueError, match="bad PNG filter byte"):
        native.png_unfilter(rows, 4, 8, 1)
    with pytest.raises(ValueError, match="bad PNG filter"):
        ppng._unfilter_py(rows, 4, 8, 1)


# -- stagger / destagger ---------------------------------------------------------

ALIASES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float", "double")
ALIAS_DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
                np.uint16, np.uint32, np.uint64, np.float32, np.float64)


@pytest.mark.parametrize("shape", SHAPES)
def test_stagger_destagger_equal_to_the_jax_package(shape):
    h, w = shape
    rng = np.random.default_rng(w)
    shifts = list(rng.integers(-40, 3 * w, h))
    for name, dtype in zip(ALIASES, ALIAS_DTYPES):
        img = rng.integers(0, 100, (h, w)).astype(dtype)
        for extra in ((), (3,)):
            x = rng.integers(0, 100, (h, w) + extra).astype(dtype)
            for inv in (False, True):
                np.testing.assert_array_equal(
                    pdst.destagger(shifts, x, inv),
                    jdst.destagger(shifts, x, inv))
        fn = getattr(pdst, f"destagger_{name}")
        got = fn(shifts, img)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(
            got, getattr(jdst, f"destagger_{name}")(shifts, img))
        st = pdst.stagger(shifts, img)
        np.testing.assert_array_equal(st, jdst.stagger(shifts, img))
        np.testing.assert_array_equal(pdst.destagger(shifts, st), img)
    # a view that is not C-contiguous, and a SensorInfo's shifts
    _, pinfo = _infos()
    jinfo = jax_sensor_info(engine_metadata(DUAL))
    x = rng.integers(0, 1 << 19, (pinfo.h, 2 * pinfo.w)).astype(np.uint32)
    np.testing.assert_array_equal(pt.stagger(pinfo, x[:, ::2]),
                                  jdst.stagger(jinfo, x[:, ::2]))
    with pytest.raises(ValueError, match="does not match shifts"):
        pdst.stagger(shifts, np.zeros((h + 1, w)))


def test_stagger_index_map_is_cached_and_read_only():
    pdst._flat_index_map.cache_clear()
    x = np.arange(32 * 64, dtype=np.uint16).reshape(32, 64)
    shifts = [3, 2, 1, 0] * 8
    a = pdst.stagger(shifts, x)
    b = pdst.stagger(np.asarray(shifts), x)
    assert pdst._flat_index_map.cache_info().hits == 1
    np.testing.assert_array_equal(a, b)
    idx = pdst._flat_index_map(tuple(shifts), 64, True)
    with pytest.raises(ValueError, match="read-only"):
        idx[0, 0] = 1
    a[0, 0] = 7          # the result is the caller's own
    np.testing.assert_array_equal(pdst.stagger(shifts, x), b)


# -- the sensor json an OSF file stores ---------------------------------------

def _infos(**knobs):
    meta = engine_metadata(DUAL, **knobs)
    return jax_sensor_info(meta), pt.sensor_info_from_metadata(meta)


def _full_metadata() -> str:
    """Every config param, calibration status, user data, an unknown
    config key and the FUSA header type."""
    meta = json.loads(engine_metadata(DUAL, column_window=(4, 200),
                                      init_id=77, sn=991122, nmea_imu=True,
                                      zone_port=7510,
                                      extrinsic=np.arange(16.0) / 7))
    meta["config_params"].update({
        "udp_multicast_ttl": 3, "timestamp_mode": "TIME_FROM_PTP_1588",
        "operating_mode": "NORMAL",
        "multipurpose_io_mode": "OUTPUT_FROM_ENCODER_ANGLE",
        "azimuth_window": [1000, 359000], "lidar_frame_azimuth_offset": 12,
        "signal_multiplier": 2, "nmea_in_polarity": "ACTIVE_LOW",
        "nmea_ignore_valid_char": 1, "nmea_baud_rate": "BAUD_115200",
        "nmea_leap_seconds": 18, "sync_pulse_in_polarity": "ACTIVE_HIGH",
        "sync_pulse_out_polarity": "ACTIVE_LOW", "sync_pulse_out_angle": 360,
        "sync_pulse_out_pulse_width": 10, "sync_pulse_out_frequency": 1,
        "phase_lock_enable": False, "phase_lock_offset": 0,
        "columns_per_packet": 16, "udp_profile_lidar": DUAL,
        "udp_profile_imu": "LEGACY", "header_type": "FUSA",
        "gyro_fsr": "EXTENDED", "accel_fsr": "NORMAL",
        "return_order": "FARTHEST_TO_NEAREST", "min_range_threshold_cm": 30,
        "imu_packets_per_frame": 8,
        "bloom_reduction_optimization": "BALANCED",
        "some_new_knob": {"a": [1, 2]}})
    meta["lidar_data_format"]["header_type"] = "FUSA"
    meta["calibration_status"] = {
        "reflectivity": {"valid": True, "timestamp": "2024-01-01T00:00:00"}}
    meta["user_data"] = "rig 7"
    meta["sensor_info"].update({"build_date": "2024-05-06T07:08:09Z",
                                "prod_pn": "840-102145-D",
                                "status": "RUNNING",
                                "image_rev": "ousteros-image-prod-aries-v3.1.0"})
    return json.dumps(meta)


@pytest.mark.parametrize("knobs", [
    {}, {"nmea_imu": True}, {"zone_port": 7504},
    {"extrinsic": np.diag([1.0, -1.0, -1.0, 1.0])},
    {"column_window": (10, 100), "init_id": 5, "sn": 12345}, "full",
    "legacy"], ids=["plain", "nmea", "zone", "extrinsic", "window", "full",
                    "legacy"])
def test_sensor_info_json_equal(knobs):
    if knobs == "full":
        meta = _full_metadata()
    elif knobs == "legacy":
        jinfo, _ = _infos()
        d = json.loads(jinfo.to_json_string())
        meta = json.dumps({**d["sensor_info"], **d["beam_intrinsics"],
                           **d["config_params"], "lidar_mode": "1024x10"})
    else:
        meta = engine_metadata(DUAL, **knobs)
    jinfo, pinfo = jax_sensor_info(meta), pt.sensor_info_from_metadata(meta)
    assert pinfo.to_json_string() == jinfo.to_json_string()
    assert pinfo.config.to_json_dict() == jinfo.config.to_json_dict()
    # and back: the port parses its own json to the same json
    again = pt.sensor_info_from_metadata(pinfo.to_json_string())
    assert again.to_json_string() == pinfo.to_json_string()
    assert again == pinfo
