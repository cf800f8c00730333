"""On the card, at each cell's own size: the program's runs are correct and
the cell's control (its lower precision in the program's place) is not,
on three seeds. Skips without a CUDA device; on the card:

    python -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
SEEDS = (2147483901, 2147483902, 2147483903)


def run(cell, seed, *args):
    # 10 s: the SLAM cell samples its first scan at a pass's 13th
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in SEEDS:
        line = run(cell, seed)
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu"
        control = run(cell, seed, "--variant", "control")
        assert control["correct"] is False, control["checks"]
