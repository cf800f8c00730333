"""The wire cell (`os2-128-2048x10-dual-bp64.wire_bp64`) at 16 x 256 on the
CPU: a traced run reads every metric of the program's spans and counters,
the roofline's bytes, and `correct` false under each fault the cell can
have and under its control."""

import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT, run_cell
from portbench.reference import bp64 as ref

CELL = "os2-128-2048x10-dual-bp64.wire_bp64"
BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_a_traced_run_reads_every_program_metric(tiny):
    from ouster_sdk_tpu_torch.utils import profiling

    profiling.clear()
    rc, line = run_cell(tiny, CELL, "--trace", "1")
    assert rc == 0 and line["correct"] is True, line["checks"]
    names = [m["name"] for m in BENCHMARK["per_layer"]
             if m["source"] in ("program_span", "program_counter")
             and CELL in m["workloads"]]
    assert {"bp64_encode_ms_per_frame", "wire_fuse_ms_per_frame",
            "wire_bytes_per_frame", "bp64_decode_ms_per_frame"} <= set(names)
    for name in names:
        v = line["metrics"].get(name, {}).get("value")
        assert v is not None and math.isfinite(v) and v > 0, name


def test_the_roofline_counts_each_image_and_each_call(monkeypatch, tiny):
    from portbench.lib import program_trace, roofline, spec

    reader = spec.find_cell(CELL, tiny).reader("wire_project_roofline")
    assert reader.wire_project_bytes(16, 1, 128, 2048) == \
        16 * 128 * 2048 * 16 + 18 * 128 * 2048 * 4 + 2048 * 4
    prog = SimpleNamespace(counts=[("bp64.ranges_decoded", 0.5, 16),
                                   ("bp64.ranges_decoded", 1.5, 16)])
    monkeypatch.setattr(program_trace, "of", lambda run: prog)
    cell = spec.find_cell(CELL, tiny)
    run = SimpleNamespace(cell=cell, lo=0.0, hi=2.0, device=[
        ("planar_project<false,false,true,4>", 0.6, 0.6 + 1e-4),
        ("planar_project<false,false,true,4>", 1.6, 1.6 + 1e-4),
        ("gather", 0.7, 0.9)])
    h, w = 16, 256
    want = reader.wire_project_bytes(32, 2, h, w) \
        / roofline.PEAK_BYTES_PER_S / 2e-4 * 100
    assert reader.read(run) == pytest.approx(want)
    prog.counts = []
    assert reader.read(run) is None


def _patch_pack(monkeypatch, fault):
    """Every buffer ChunkFuser.pack returns, altered by `fault(buf,
    layout)` after the pack, before the copy to the card."""
    from ouster_sdk_tpu_torch.io import frames

    pack = frames.ChunkFuser.pack

    def faulty(self, arrays):
        buf, layout = pack(self, arrays)
        fault(buf, layout)
        return buf, layout

    monkeypatch.setattr(frames.ChunkFuser, "pack", faulty)


def _word_flipped(buf, layout):
    buf[layout[0][0]] ^= np.uint32(1 << 3)


def _mask_cleared(buf, layout):
    """The dropout mask of the first frame's first masked block that holds
    a value (all-dropout blocks decode to zeros either way) set to zero."""
    payload, widths, anchors, _ = ref.split(buf, layout)
    wb = widths[0].reshape(-1).astype(np.int64)
    flag = wb >> 7
    size = 2 * flag + 2 * (wb & 0x1F)
    start = np.cumsum(size) - size
    k = int(np.flatnonzero((flag == 1) & (anchors[0].reshape(-1) != 0))[0])
    at = layout[0][0] + int(start[k])
    buf[at:at + 2] = 0


@pytest.mark.parametrize("fault", [_word_flipped, _mask_cleared])
def test_a_shipped_buffer_altered_is_not_correct(tiny, monkeypatch, fault):
    _patch_pack(monkeypatch, fault)
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["range_mismatches"]["value"] > 0


def test_a_chunk_left_out_is_not_correct(tiny, monkeypatch):
    import ouster_sdk_tpu_torch as pt

    fused_pipelined = pt.fused_pipelined

    def faulty(*args, **kwargs):
        it = fused_pipelined(*args, **kwargs)

        def gen():
            try:
                # the first chunk of every pass: lost whenever the
                # window ends
                for k, item in enumerate(it):
                    if k != 0:
                        yield item
            finally:
                it.close()

        return gen()

    monkeypatch.setattr(pt, "fused_pipelined", faulty)
    rc, line = run_cell(tiny, CELL)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["frames_lost"]["value"] > 0


def test_the_control_is_not_correct(tiny):
    rc, line = run_cell(tiny, CELL, "--variant", "control")
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["checks"]["xyz_ulp"]["value"] > 6
    assert line["checks"]["range_mismatches"]["value"] == 0
