"""The reduction of a trace to the idle share, the breakdown and the
roofline share, on a hand-made trace; the comparison's arithmetic."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, ROOT
from portbench.lib import roofline, spec, trace
from portbench.reference import compare

# device operations and benchmark spans (s) of a 10 s window starting at 100
DEVICE = [("Memcpy HtoD (Pageable -> Device)", 101.0, 102.0),
          ("void planar_project<true, false>(int const*, float*)",
           101.5, 102.5),
          ("void planar_project<true, false>(int const*, float*)",
           105.0, 105.5),
          ("void at::native::gather(int)", 120.0, 121.0)]   # outside
SPANS = [(trace.WINDOW, 100.0, 110.0), ("staging", 100.0, 101.0),
         ("project", 101.0, 103.0), ("wait", 102.0, 102.6),
         ("staging", 103.0, 109.0), ("project", 109.0, 110.0)]
# a cell that reports each per-layer metric
CELL_OF = {m["name"]: m["workloads"][0] for m in json.load(open(
    os.path.join(ROOT, "BENCHMARK.json")))["per_layer"]}


class FakeRun:
    def __init__(self, config, calls, units=16):
        self.cell = type("C", (), {"config": config})
        self.device, self.host_spans = DEVICE, SPANS
        self.lo, self.hi = 100.0, 110.0
        self.calls, self.units = calls, units


def test_busy_union_and_idle_share():
    assert trace.busy_s(DEVICE, 100.0, 110.0) == pytest.approx(2.0)
    for name in ("device_idle_pct.replay", "device_idle_pct.slam"):
        reader = spec.find_cell(CELL_OF[name]).reader(name)
        assert reader.read(FakeRun({}, {})) == pytest.approx(80.0)


def test_idle_gaps_go_to_the_innermost_open_span():
    gaps = dict(trace.idle_by_span(DEVICE, SPANS, 100.0, 110.0))
    # 100-101 staging; 102.5-105 (mid 103.75) staging; 105.5-110 (mid
    # 107.75) staging
    assert gaps == pytest.approx({"staging": 1.0 + 2.5 + 4.5})
    assert trace.idle_by_span([], [], 0.0, 2.0) == [["none", 2.0]]


def test_time_by_operation_and_kernel():
    ops = dict(trace.by_name(DEVICE, 100.0, 110.0))
    assert ops == pytest.approx({"void planar_project<true, false>": 1.5,
                                 "Memcpy HtoD": 1.0})
    assert trace.kernel_time(DEVICE, "planar_project", 100.0, 110.0) == \
        (pytest.approx(1.5), 2)
    assert trace.kernel_count(DEVICE, 100.0, 110.0) == 2


def test_roofline_share_from_bytes_and_kernel_time():
    meta = {"lidar_data_format": {
        "udp_profile_lidar": "RNG19_RFL8_SIG16_NIR16_DUAL",
        "pixels_per_column": 128, "columns_per_frame": 2048,
        "columns_per_packet": 16, "pixel_shift_by_row": [0] * 128},
        "sensor_info": {"initialization_id": 1, "prod_sn": "1"}}
    reader = spec.load_module(BENCH + "/metrics/planar_project_roofline.py",
                              "t.roof")
    nbytes = 2 * roofline.planar_project_bytes(8, 128, 2048, 2)
    want = nbytes / roofline.PEAK_BYTES_PER_S / 1.5 * 100
    assert reader.read(FakeRun({"metadata": meta}, {"planar_project":
                                                    [8, 8]})) == \
        pytest.approx(want)
    # a call the trace lost, or none at all: nothing to read
    assert reader.read(FakeRun({"metadata": meta},
                               {"planar_project": [8, 8, 8]})) is None
    assert reader.read(FakeRun({"metadata": meta}, {})) is None
    # 8 dual frames of 128 x 2048: range words, status, LUT, XYZ
    hw = 128 * 2048
    assert roofline.planar_project_bytes(8, 128, 2048, 2) == \
        2 * 8 * hw * 4 + 8 * 2048 * 4 + 18 * hw * 4 + 2 * 8 * 3 * hw * 4


def test_span_readers_divide_by_the_units():
    spans = trace.Spans(on=True)
    for _ in range(4):
        with spans.span("staging"):
            pass
    spans.times["staging"] = [0.5, 0.5, 0.5, 0.5]
    run = type("R", (), {"spans": spans, "units": 8})
    reader = spec.find_cell(CELL_OF["staging_ms_per_frame"]).reader(
        "staging_ms_per_frame")
    assert reader.read(run) == pytest.approx(250.0)
    run.spans = trace.Spans(on=False)
    assert reader.read(run) is None


def test_spans_wrap_and_unwrap():
    class K:
        def f(self, x):
            return x + 1
    orig = K.__dict__["f"]
    spans = trace.Spans(on=True)
    spans.wrap(K, "f", "eff")
    assert K().f(1) == 2 and len(spans.times["eff"]) == 1
    spans.unwrap()
    assert K.__dict__["f"] is orig


def test_short_names():
    assert trace.short_name("void k<1, 2>(int (*)(int), float)") == \
        "void k<1, 2>"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"
    assert trace.short_name("aten::add") == "aten::add"


def test_ulp_error():
    ref = np.array([1.0, 100.0, 0.0, 1e-7])
    got = np.float32(ref).astype(np.float64)
    assert compare.ulp_error(got, ref) <= 0.5
    ulp100 = float(np.spacing(np.float32(100.0)))
    assert compare.ulp_error(ref + [0, 2 * ulp100, 0, 0], ref) == \
        pytest.approx(2.0)
    # below a millimetre the unit is a millimetre's
    ulp_mm = float(np.spacing(np.float32(1e-3)))
    assert compare.ulp_error(ref + [0, 0, ulp_mm, 0], ref) == \
        pytest.approx(1.0)


def test_mismatches():
    want = {"a": np.arange(4), "b": np.zeros(3)}
    assert compare.mismatches({"a": np.arange(4), "b": np.zeros(3)}, want) \
        == 0
    assert compare.mismatches({"a": np.array([0, 1, 2, 9])}, want) == 1 + 3
    assert compare.mismatches({"a": np.arange(4)}, want, {"b"}) == 0
