"""The OSF replay cell at 16 x 256 on the CPU: `correct` false under its
control and under each planted fault, the program's OSF spans and
counters in a traced run, and osf_project_roofline's byte count."""

import numpy as np
import pytest

from conftest import run_cell
from portbench.lib import spec

CELL = "os2-128-2048x10-dual-osf.osf_xyz"
FIELDS = 9                  # the channels a scan of the profile records


def test_the_cell_is_correct_and_its_control_is_not(tiny):
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["checks"]["xyz_ulp"]["value"] <= 0.5 + 1e-3
    rc, line = run_cell(tiny, CELL, "--variant", "control")
    assert rc == 0 and line["correct"] is False
    checks = line["checks"]
    assert checks["xyz_ulp"]["value"] > checks["xyz_ulp"]["limit"]
    assert checks["field_mismatches"]["value"] == 0


def _byte_flipped(monkeypatch):
    from ouster_sdk_tpu_torch.io import osf

    decode = osf._decode_channel

    def faulty(data):
        img = decode(data).copy()
        img.view(np.uint8).reshape(-1)[1001] ^= 1
        return img

    monkeypatch.setattr(osf, "_decode_channel", faulty)


def _frame_dropped(monkeypatch):
    from ouster_sdk_tpu_torch.io import osf

    iter_sets = osf.OsfScanSource._iter_sets

    def faulty(self):
        for k, item in enumerate(iter_sets(self)):
            if k != 3:
                yield item

    monkeypatch.setattr(osf.OsfScanSource, "_iter_sets", faulty)


@pytest.mark.parametrize("fault, check", [(_byte_flipped, "field_mismatches"),
                                          (_frame_dropped, "frames_lost")])
def test_faults_are_not_correct(tiny, monkeypatch, fault, check):
    fault(monkeypatch)
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False
    assert line["checks"][check]["value"] > line["checks"][check]["limit"]


def test_a_traced_run_reads_the_osf_spans_and_counters(tiny):
    from ouster_sdk_tpu_torch.utils import profiling

    rc, line = run_cell(tiny, CELL, "--trace", "1")
    assert rc == 0 and line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for name in ("osf_decode_ms_per_frame", "osf_inflate_ms_per_frame",
                 "osf_project_ms_per_frame"):
        assert m[name] > 0
    assert m["osf_decode_ms_per_frame"] > m["osf_inflate_ms_per_frame"]
    # a collated set is decoded whole before the frame counts
    assert m["osf_fields_per_frame"] == pytest.approx(FIELDS)
    # no device trace on the CPU: the kernel's share reads nothing
    assert "osf_project_roofline" not in m
    # the window's counts: 9 channels and 2 range images a scan decoded,
    # projected one set at a time
    snap = profiling.snapshot()
    decoded = sum(s.name == "osf.decode" for s in snap.spans)
    assert sum(s.name == "osf.project" for s in snap.spans) == decoded
    counts = {}
    for c in snap.counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert decoded > 0
    assert counts["osf.fields_decoded"] == FIELDS * decoded
    assert counts["osf.images_projected"] == 2 * decoded


def test_the_roofline_counts_the_bytes_of_a_call(tiny):
    cell = spec.find_cell(CELL, tiny)
    reader = cell.reader("osf_project_roofline")
    h, w = 128, 2048
    # a collated set's scan, 2 returns: each range image in (u32) and its
    # XYZ out (3 x f32), the 18-plane f32 LUT stack and one u32 header row
    want = 2 * (h * w * 4 + 3 * h * w * 4) + 18 * h * w * 4 + w * 4
    assert reader.osf_project_bytes(2, 1, h, w) == want == 27_271_168

    class Run:
        pass

    run = Run()
    run.cell, run.lo, run.hi = cell, 0.0, 1.0
    run.device = [("void planar_project<false, false, true, 4>(...)",
                   0.1, 0.1 + 1e-5), ("Memcpy HtoD", 0.2, 0.3)]

    class Program:
        counts = [("osf.images_projected", 0.05, 2)]

    run._program = Program()
    from portbench.lib.roofline import PEAK_BYTES_PER_S
    from portbench.lib.synth import Sensor
    s = Sensor(cell.config["metadata"])
    share = reader.read(run)
    assert share == pytest.approx(reader.osf_project_bytes(2, 1, s.h, s.w)
                                  / PEAK_BYTES_PER_S / 1e-5 * 100)
    run._program.counts = []
    assert reader.read(run) is None
