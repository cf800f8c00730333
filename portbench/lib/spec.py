"""BENCHMARK.json and the files it names, found by name:

    configs/<config>.json     a sensor deployment (its metadata)
    traffic/<traffic>.json    a mix: the driver it runs and its parameters
    drivers/<driver>.py       what the window drives, and its check
    metrics/<metric>.py       a metric's own reader, `read(run)`; or
    metrics/<metric>.json     the shared reader readers/<reader>.py that
                              a metric reads with, and its `args`

Adding a cell, a configuration, a mix, a driver or a metric adds files and
entries; nothing here changes."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType, SimpleNamespace
from typing import List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import a file of this folder by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._found." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_name: str
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    def driver(self) -> ModuleType:
        name = self.traffic["driver"]
        return load_module(os.path.join(self.root, "drivers", name + ".py"),
                           "driver." + name)

    def reader(self, metric: str):
        """The reader of `metric`, with `read(run)`: metrics/<metric>.py,
        or the shared reader readers/<reader>.py that
        metrics/<metric>.json names, with the file's `args`."""
        own = os.path.join(self.root, "metrics", metric + ".py")
        if os.path.exists(own):
            return load_module(own, "metric." + metric)
        alias = load_json(os.path.join(self.root, "metrics",
                                       metric + ".json"))
        mod = load_module(os.path.join(self.root, "readers",
                                       alias["reader"] + ".py"),
                          "reader." + alias["reader"])
        return SimpleNamespace(read=functools.partial(
            mod.read, **alias.get("args", {})))


def find_cell(name: str, root: str = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json beside the benchmark's folder
    `root`, with its configuration, mix and the metrics it reports; raises
    KeyError for an unknown cell."""
    bench = load_json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = load_json(os.path.join(os.path.dirname(root),
                                    cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "traffic",
                                     cell["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
        traffic_name=cell["traffic"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root)
