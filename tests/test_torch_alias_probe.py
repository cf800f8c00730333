"""The alias probe: the JAX package's own test cases, run against the
PyTorch port. One subprocess imports the port, registers each of its
modules under the JAX package's name (ouster_sdk_tpu.* ->
ouster_sdk_tpu_torch.*, with jax itself blocked), points the port's
default device at the CPU (inside that process only: the port's entry
points run on CUDA unless a caller names a device) and runs the listed
cases with pytest, without tests/conftest.py (it imports jax). Each listed
node id is one case here, which passes only if it passed there.

The list holds the cases of the JAX package's tests for the host layer's
modules (derived views, filters, scan-source semantics, PNG series, point
clouds, bags, utils), the pose optimizer, the CLI's plugin runner, the
viewer (its OpenGL cases run on the host's surfaceless EGL) and the
examples package that neither import jax nor read the reference SDK's
fixture files (cases needing those or the slow marker are left out).
Three viewer cases are left out because they read private names of the
package under test, which a port need not share: test_gl_viewer.py's
test_pointviz_gl_backend_switch (PointViz._gl_renderer) and
test_gl_buffer_cache_reuse (GLRenderer._cloud_cache), and
test_viz_modes.py's test_seekable_invariants (viz.core._Seekable; the
port's copy is held to the JAX package's in tests/test_torch_viz.py)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    "tests/test_bag.py::test_ros1_writer_emits_standard_index",
    "tests/test_cloud_source.py::test_cloud_attributes_map_to_fields",
    "tests/test_cloud_source.py::test_cloud_file_opens_as_scan_source[csv]",
    "tests/test_cloud_source.py::test_cloud_file_opens_as_scan_source[las]",
    "tests/test_cloud_source.py::test_cloud_file_opens_as_scan_source[pcd]",
    "tests/test_cloud_source.py::test_cloud_file_opens_as_scan_source[ply]",
    "tests/test_cloud_source.py::test_small_cloud_grid",
    "tests/test_cli_plugins.py::test_bad_plugin_traceback_flag",
    "tests/test_cli_plugins.py::test_bad_plugin_warns_and_skips",
    "tests/test_cli_plugins.py::test_good_plugin_registers_command",
    "tests/test_cli_plugins.py::test_plugin_subpackage_modules_load",
    "tests/test_cli_plugins.py::test_run_exit_code_client_error",
    "tests/test_cli_plugins.py::test_run_exit_code_source_args",
    "tests/test_cli_plugins.py::test_run_exit_code_usage_error",
    "tests/test_cli_plugins.py::test_run_internal_error_traceback",
    "tests/test_cli_plugins.py::test_source_args_exception_api",
    "tests/test_cli_plugins.py::test_version_lists_plugins",
    "tests/test_cli_viz.py::test_cloud_io_roundtrips",
    "tests/test_cli_viz.py::test_derived_transforms",
    "tests/test_examples_package.py::test_open3d_example_import_gated",
    "tests/test_gl_viewer.py::test_context_clear_and_readback",
    "tests/test_gl_viewer.py::test_gl_lines_drawn",
    "tests/test_gl_viewer.py::test_gl_lines_with_cloud_present",
    "tests/test_gl_viewer.py::test_point_projection_matches_software",
    "tests/test_gl_viewer.py::test_range_lut_path_equals_direct_xyz",
    "tests/test_gl_viewer.py::test_range_zero_discard",
    "tests/test_gl_viewer.py::test_window_gated_headless",
    "tests/test_pose_optimizer.py::test_absolute_pose_anchors_pull_trajectory",
    "tests/test_pose_optimizer.py::test_loss_function_enum_mapping",
    "tests/test_pose_optimizer.py::test_point_constraints",
    "tests/test_pose_optimizer.py::test_pose_to_pose_loop_closure",
    "tests/test_pose_optimizer.py::test_resample_trajectory_knots",
    "tests/test_pose_optimizer.py::test_trajectory_exports",
    "tests/test_pose_optimizer_verification.py::"
    "test_ceres_scipy_loss_curve_identity",
    "tests/test_pose_optimizer_verification.py::"
    "test_fd_jacobian_within_declared_sparsity",
    "tests/test_pose_optimizer_verification.py::"
    "test_loss_mapping_rejects_nothing_silently",
    "tests/test_pose_optimizer_verification.py::"
    "test_residuals_match_reference_functors",
    "tests/test_pose_optimizer_verification.py::"
    "test_solver_reaches_known_analytic_optimum",
    "tests/test_utils.py::test_dewarp_shapes",
    "tests/test_utils.py::test_forward_slicer[-1--7--1]",
    "tests/test_utils.py::test_forward_slicer[-1-0--3]",
    "tests/test_utils.py::test_forward_slicer[-7--2-1]",
    "tests/test_utils.py::test_forward_slicer[0-10-3]",
    "tests/test_utils.py::test_forward_slicer[10-0--2]",
    "tests/test_utils.py::test_forward_slicer[3--1-1]",
    "tests/test_utils.py::test_forward_slicer[3-8--1]",
    "tests/test_utils.py::test_forward_slicer[3-8-2]",
    "tests/test_utils.py::test_forward_slicer[3-None-None]",
    "tests/test_utils.py::test_forward_slicer[8-3--1]",
    "tests/test_utils.py::test_forward_slicer[8-3--3]",
    "tests/test_utils.py::test_forward_slicer[8-3-1]",
    "tests/test_utils.py::test_forward_slicer[9-0--4]",
    "tests/test_utils.py::test_forward_slicer[None-8-None]",
    "tests/test_utils.py::test_forward_slicer[None-None--1]",
    "tests/test_utils.py::test_forward_slicer[None-None-None]",
    "tests/test_utils.py::test_forward_slicer_lazy_and_zero_step",
    "tests/test_utils.py::test_kitti_io",
    "tests/test_utils.py::test_pose_roundtrip_and_transform",
    "tests/test_utils.py::test_trajectory_eval",
    "tests/test_viz_modes.py::test_imu_subplot_renders",
    "tests/test_viz_modes.py::test_po_viz_snapshots",
    "tests/test_viz_modes.py::test_simple_mode_names_single_and_dual",
]

# Runs in the subprocess: argv[1] is the JSON list of node ids; prints one
# JSON object {node id: outcome} as its last line.
HARNESS = r'''
import importlib, json, pkgutil, sys

import torch

torch.set_num_threads(1)
sys.modules["jax"] = None
import ouster_sdk_tpu_torch as port

# every module of the port, under the JAX package's name
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    if ".kernels." in info.name + ".":
        continue
    importlib.import_module(info.name)
for name, mod in list(sys.modules.items()):
    if name == port.__name__ or name.startswith(port.__name__ + "."):
        sys.modules["ouster_sdk_tpu" + name[len(port.__name__):]] = mod

# the default device: the CPU, in this process
from ouster_sdk_tpu_torch.ops import fused
real = fused.default_device
cpu = lambda: torch.device("cpu")
for name, mod in list(sys.modules.items()):
    if name.startswith(port.__name__) and \
            getattr(mod, "default_device", None) is real:
        mod.default_device = cpu

import pytest


class Outcomes:
    def __init__(self):
        self.by_id = {}

    def pytest_runtest_logreport(self, report):
        prev = self.by_id.get(report.nodeid, "passed")
        if report.when == "call" or report.outcome != "passed":
            out = report.outcome
            if prev != "passed":
                out = prev
            self.by_id[report.nodeid] = out


ids = json.loads(sys.argv[1])
rec = Outcomes()
pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest",
             "-p", "no:randomly", "-p", "no:xdist", *ids], plugins=[rec])
print(json.dumps(rec.by_id))
'''


@pytest.fixture(scope="module")
def outcomes():
    env = {k: v for k, v in os.environ.items()
           if k != "OUSTER_SDK_TPU_DEVICE_DECODE"}
    proc = subprocess.run(
        [sys.executable, "-c", HARNESS, json.dumps(CASES)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-4000:]
    try:
        return json.loads(lines[-1]), proc.stdout[-6000:]
    except json.JSONDecodeError:
        raise AssertionError(proc.stdout[-4000:] + proc.stderr[-4000:])


@pytest.mark.parametrize("node", CASES)
def test_jax_case_passes_on_the_port(outcomes, node):
    by_id, log = outcomes
    assert by_id.get(node) == "passed", \
        f"{node}: {by_id.get(node, 'not run')}\n{log}"
