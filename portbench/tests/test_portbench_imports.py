"""No run loads jax, jaxlib, flax or the JAX package (top-level names
compared whole), the reference and the inputs import nothing of the
program, and a run refuses without what it needs."""

import ast
import os
import subprocess
import sys
import types

import pytest

from conftest import BENCH, ROOT, copy_bench, run_cell
from portbench.lib import harness

CELL = "os2-128-2048x10-dual.device_xyz"


def test_banned_names_are_whole_top_level_names():
    assert harness.banned_modules(["ouster_sdk_tpu_torch",
                                   "ouster_sdk_tpu_torch.ops.fused",
                                   "jaxtyping", "numpy"]) == []
    assert harness.banned_modules(["ouster_sdk_tpu.ops", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "ouster_sdk_tpu"]


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*dirs):
    for d in dirs:
        for dp, _, files in os.walk(os.path.join(BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dp, f)


def test_no_source_of_a_run_imports_jax_or_the_jax_package():
    for path in list(sources("lib", "reference", "drivers", "metrics",
                             "readers")) + \
            [os.path.join(BENCH, "run.py")]:
        assert not imports(path) & set(harness.BANNED), path


def test_the_reference_and_the_inputs_import_nothing_of_the_program():
    for path in sources("reference"):
        assert imports(path) <= {"__future__", "math", "numpy", "torch",
                                 "typing", "portbench"}, path
    for name in ("synth.py", "yard.py", "roofline.py"):
        assert "ouster_sdk_tpu_torch" not in imports(
            os.path.join(BENCH, "lib", name))


def test_a_run_that_loaded_jax_prints_no_result(tiny, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run_cell(tiny, CELL)
    assert rc == 3 and line is None
    assert "jax" in capsys.readouterr().err


def test_a_run_loads_none_of_them(tiny):
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from portbench.lib import harness; "
            "rc = harness.run(['--workload', %r, '--seed', '5', "
            "'--seconds', '0.5', '--device', 'cpu', '--root', %r], "
            "time.perf_counter()); "
            "print(harness.banned_modules()); sys.exit(rc)"
            % (ROOT, CELL, tiny))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_cuda_a_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    copy_bench(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds", "1", "--device",
                          "cpu"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
