"""Shared inputs of the benchmark's CPU tests: a copy of the benchmark
folder whose configurations are cut to 16 x 256 and whose mixes are a few
frames long, so that a whole run takes seconds on the CPU.

    python -m pytest -q portbench/tests           # the CPU tests
    python -m pytest -q -m cuda portbench/tests   # on the card
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

H, W = 16, 256


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


def copy_bench(dst: str) -> str:
    """A copy of the benchmark folder and BENCHMARK.json under dst; returns
    the copy's folder."""
    shutil.copytree(BENCH, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "tests",
                                                  "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return os.path.join(dst, "portbench")


def shrink(root: str) -> None:
    """Cut every configuration of the copy at `root` to H x W and every mix
    to a few frames."""
    bench = json.load(open(os.path.join(os.path.dirname(root),
                                        "BENCHMARK.json")))
    for c in bench["configs"]:
        path = os.path.join(os.path.dirname(root), c["file"])
        cfg = json.load(open(path))
        m = cfg["metadata"]
        f = m["lidar_data_format"]
        f["pixels_per_column"], f["columns_per_frame"] = H, W
        f["column_window"] = [0, W - 1]
        f["pixel_shift_by_row"] = f["pixel_shift_by_row"][:H]
        b = m["beam_intrinsics"]
        step = len(b["beam_altitude_angles"]) // H
        b["beam_altitude_angles"] = b["beam_altitude_angles"][::step]
        b["beam_azimuth_angles"] = b["beam_azimuth_angles"][:H]
        m["config_params"]["lidar_mode"] = f"{W * 2}x10"
        json.dump(cfg, open(path, "w"))
    tdir = os.path.join(root, "traffic")
    for name in os.listdir(tdir):
        t = json.load(open(os.path.join(tdir, name)))
        t["frames"] = 8 if t["unit"] == "frames" else 6
        if "chunk" in t:
            t["chunk"] = 4
        if "drive" in t:
            t["drive"]["ramp_frames"] = 2
            t["warm_frames"] = 2
            t["sample"]["first_at"] = 2
        json.dump(t, open(os.path.join(tdir, name), "w"))


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> str:
    root = copy_bench(str(tmp_path_factory.mktemp("tiny")))
    shrink(root)
    return root


def run_cell(root: str, cell: str, *args, seconds: float = 1.0) -> tuple:
    """(exit code, the result line as a dict or None) of one CPU run of the
    copy at `root`."""
    import io
    import time

    from portbench.lib import harness

    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", "2147483800",
                      "--seconds", str(seconds), "--device", "cpu",
                      "--root", root, *args], time.perf_counter(), out=out)
    text = out.getvalue().strip().splitlines()
    return rc, (json.loads(text[-1]) if text else None)
