"""BENCHMARK.json against the benchmark's contract, and the files each of
its entries is found by."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT, copy_bench
from portbench.lib import spec

def snapshot(root):
    return {os.path.relpath(os.path.join(dp, p), root):
            open(os.path.join(dp, p), "rb").read()
            for dp, _, files in os.walk(root) for p in files
            if "__pycache__" not in dp}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["portbench"]
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCHMARK["run_seconds"], int)
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    # a full check of 24 cells fits its 43 200 s
    rs = BENCHMARK["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCHMARK)) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    configs = {c["name"] for c in BENCHMARK["configs"]}
    used = set()
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == configs
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        # every cell a metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert any(e["name"] == m["moves"]
                       and cell in e.get("workloads", cells)
                       for e in BENCHMARK["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = spec.find_cell(cell)
    drv = c.driver()
    assert hasattr(drv, "Driver")
    assert "setup_s" in [m["name"] for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert c.config["metadata"]["lidar_data_format"]["udp_profile_lidar"]


def test_a_new_config_mix_and_metric_are_found_as_files_alone(tmp_path):
    root = copy_bench(str(tmp_path))
    before = snapshot(root)
    cfg = json.load(open(os.path.join(root, "configs",
                                      "os2-128-2048x10-dual.json")))
    cfg["name"] = "os2-128-512x20-dual"
    json.dump(cfg, open(os.path.join(root, "configs",
                                     "os2-128-512x20-dual.json"), "w"))
    t = json.load(open(os.path.join(root, "traffic", "device_xyz.json")))
    t["chunk"] = 32
    json.dump(t, open(os.path.join(root, "traffic", "device_xyz_b32.json"),
                      "w"))
    with open(os.path.join(root, "metrics", "frames_seen.py"), "w") as f:
        f.write("def read(run):\n    return run.units\n")
    with open(os.path.join(root, "metrics", "frames_per_s.b32.json"),
              "w") as f:
        json.dump({"reader": "units_per_s", "args": {"unit": "frames"}}, f)
    bench_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": "os2-128-512x20-dual", "source": "x",
                             "file": "portbench/configs/"
                                     "os2-128-512x20-dual.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "os2-128-512x20-dual.device_xyz_b32",
                               "config": "os2-128-512x20-dual",
                               "traffic": "device_xyz_b32", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["os2-128-512x20-dual."
                                             "device_xyz_b32"]})
    bench["per_layer"].append({"name": "frames_per_s.b32",
                               "unit": "frames/s", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "frames_per_s",
                               "workloads": ["os2-128-512x20-dual."
                                             "device_xyz_b32"]})
    json.dump(bench, open(bench_path, "w"))
    c = spec.find_cell("os2-128-512x20-dual.device_xyz_b32", root)
    assert c.traffic["chunk"] == 32
    assert c.config["name"] == "os2-128-512x20-dual"
    assert [m["name"] for m in c.per_layer][-2:] == ["frames_seen",
                                                     "frames_per_s.b32"]

    class Run:
        units, unit, window_s = 7, "frames", 2.0
    assert c.reader("frames_seen").read(Run()) == 7
    assert c.reader("frames_per_s.b32").read(Run()) == 3.5
    # nothing that was there changed
    after = snapshot(root)
    assert {k: after[k] for k in before} == before


def test_each_metric_has_one_file():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        own = [os.path.exists(os.path.join(BENCH, "metrics", m["name"] + x))
               for x in (".py", ".json")]
        assert sum(own) == 1, m["name"]


def test_an_unknown_cell_is_refused(capsys):
    from portbench.lib import harness

    assert harness.run(["--workload", "nope", "--seed", "1", "--seconds",
                        "1"], 0.0) == 2
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_folder_is_named():
    for c in BENCHMARK["configs"]:
        assert c["file"].startswith(BENCHMARK["paths"][0] + "/")
    for word in BENCHMARK["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isdir(BENCH) and shutil.which("python3")
