"""The port's command line (ouster_sdk_tpu_torch/cli: core.py, extra.py,
runner.py, util.py) against the JAX package's, on the CPU.

click's CliRunner runs both packages' `cli` on the same inputs: the chip
run's yard (6 frames, 16x256 dual) written as a pcap with its metadata
json beside it, and OSF files made from it. The port's default_device
bindings point at the CPU (monkeypatch), so its engine, OSF projector,
DeviceICP and device normals run their plain versions; the JAX package
runs as its own tests run it. Each package runs in a directory of its own
with the same relative output names, so the printed text compares.

Tolerances: printed text, files and trajectories are equal (byte for
byte), but for the device ICP against the JAX package's "tpu" backend
(within 1e-3 m, as tests/test_torch_slam.py holds the engines), device
normals against numpy ones (tests/test_torch_normals.py's f32 flips: at
most 1 % of the pixels, the rest within 0.1 degree, as chip_smoke.py holds
them) and the rewritten poses of pose_optimize (float32 interpolation:
byte-equal with the JAX package's interpolation patched in, see
tests/test_torch_pose_optimizer.py)."""

import json
import os
import sys
import textwrap
import threading

import click
import numpy as np
import pytest
from click.testing import CliRunner

from _torch_helpers import both, invoke, on_cpu, same_file, \
    yard_pcap  # noqa: F401  (on_cpu: autouse)
import chip_smoke as cs
import ouster_sdk_tpu as jx
import ouster_sdk_tpu.io.save as jsave
import ouster_sdk_tpu_torch as pt
from ouster_sdk_tpu.cli import cli as jcli
from ouster_sdk_tpu_torch.cli import cli as pcli
from ouster_sdk_tpu_torch.ops import fused

FRAMES = 6


@pytest.fixture(scope="module")
def yard(tmp_path_factory):
    """The yard pcap, its metadata json and the ground truth."""
    return yard_pcap(tmp_path_factory.mktemp("yard"), FRAMES)


@pytest.mark.parametrize("args", [
    ["info"], ["metadata"], ["stats"], ["slice", "1:5:2", "stats"],
    ["slice", "0.15s:", "stats"], ["clip", "--min-range", "10", "stats"],
    ["pcap_info"], ["filter", "REFLECTIVITY", "0:100", "stats"],
], ids=lambda a: "-".join(a).replace(":", "_"))
def test_source_commands_print_the_jax_packages_text(yard, tmp_path,
                                                     monkeypatch, args):
    p, j = both(tmp_path, monkeypatch, ["source", yard[0], *args])
    assert p.output == j.output and p.output


@pytest.mark.parametrize("ext", ["osf", "pcap"])
def test_clip_save_writes_the_jax_packages_bytes(yard, tmp_path,
                                                 monkeypatch, ext):
    p, j = both(tmp_path, monkeypatch, [
        "source", yard[0], "clip", "--max-range", "40", "save", f"c.{ext}"])
    assert p.output == j.output == f"wrote {FRAMES} scans to c.{ext} " \
        f"(.{ext})\n"
    same_file(tmp_path, f"c.{ext}")


@pytest.mark.parametrize("ext", ["osf", "pcap"])
def test_reduce_save_writes_reduced_metadata(yard, tmp_path, monkeypatch,
                                             ext):
    """`reduce --beams 8 save` in the port writes what the JAX package's
    ReducedScanSource saves (metadata of 8 beams). The JAX package's own
    command keeps the 16-beam metadata: its pcap writer raises on the
    8-row scans (ROADMAP section 3)."""
    (tmp_path / "port").mkdir()
    r = invoke(pcli, ["source", yard[0], "reduce", "--beams", "8", "save",
                       f"r.{ext}"], tmp_path / "port", monkeypatch)
    assert r.exit_code == 0, (r.output, r.exception)
    src = jx.open_source(yard[0]).reduce([8])
    (tmp_path / "jax").mkdir()
    jsave.save_scans(str(tmp_path / "jax" / f"r.{ext}"), src.sensor_info,
                     src)
    same_file(tmp_path, f"r.{ext}")
    if ext == "pcap":
        r = invoke(jcli, ["source", yard[0], "reduce", "--beams", "8",
                           "save", "--overwrite", "x.pcap"],
                    tmp_path / "jax", monkeypatch)
        assert isinstance(r.exception, ValueError)
    r = invoke(pcli, ["source", yard[0], "reduce", "--beams", "5", "stats"],
                tmp_path / "port", monkeypatch)
    assert r.exit_code != 0 and "must evenly divide" in str(r.exception)


def test_slam_host_is_bit_equal_and_device_within_1e3(yard, tmp_path,
                                                      monkeypatch):
    p, j = both(tmp_path, monkeypatch, [
        "source", yard[0], "slam", "--backend", "host", "-v", "1.0",
        "--trajectory", "t.kitti", "-d", "map.ply", "save", "s.osf"])
    # --trajectory, -d and save are three consumers, each on a thread of
    # its own in both packages: their lines come in no set order
    lines = sorted(p.output.splitlines())
    assert lines == sorted(j.output.splitlines())
    assert [ln.split()[0] for ln in lines] == ["map", "wrote", "wrote"]
    for name in ("t.kitti", "s.osf", "map.ply"):
        same_file(tmp_path, name)
    r = invoke(pcli, ["source", yard[0], "slam", "--backend", "device",
                       "-v", "1.0", "--trajectory", "td.kitti"],
                tmp_path / "port", monkeypatch)
    assert r.exit_code == 0, (r.output, r.exception)
    r = invoke(jcli, ["source", yard[0], "slam", "--backend", "tpu",
                       "-v", "1.0", "--trajectory", "td.kitti"],
                tmp_path / "jax", monkeypatch)
    assert r.exit_code == 0, r.output
    a = np.loadtxt(tmp_path / "port" / "td.kitti")
    b = np.loadtxt(tmp_path / "jax" / "td.kitti")
    assert a.shape == (FRAMES, 12)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    # the device backend tracks the yard like the host one
    np.testing.assert_allclose(
        a, np.loadtxt(tmp_path / "port" / "t.kitti"), rtol=0, atol=0.05)
    # localize against the host map: host bit-equal, device within 1e-3
    for backend, jbackend in (("host", "host"), ("device", "tpu")):
        out = []
        for cli, tag, be in ((pcli, "port", backend),
                             (jcli, "jax", jbackend)):
            r = invoke(cli, ["source", yard[0], "localize", "--map",
                              "map.ply", "--voxel-size", "1.0",
                              "--backend", be, "--trajectory",
                              f"l_{be}.kitti"], tmp_path / tag, monkeypatch)
            assert r.exit_code == 0, (tag, r.output, r.exception)
            out.append(np.loadtxt(tmp_path / tag / f"l_{be}.kitti"))
        if backend == "host":
            same_file(tmp_path, "l_host.kitti")
        np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-3)


@pytest.fixture
def capture():
    """A `_capture` command on the port's source group: it consumes the
    stream into the returned list."""
    got = []

    @click.pass_context
    def cmd(ctx):
        ctx.obj.consumers.append(lambda it: got.extend(it))

    pcli.commands["source"].add_command(click.Command(
        "_capture", callback=cmd), "_capture")
    yield got
    del pcli.commands["source"].commands["_capture"]


def test_normals_device_agrees_with_numpy(yard, tmp_path, monkeypatch,
                                          capture):
    sets = {}
    for backend in ("numpy", "device"):
        capture.clear()
        r = invoke(pcli, ["source", yard[0], "normals", "--backend",
                           backend, "_capture"], tmp_path, monkeypatch)
        assert r.exit_code == 0, (r.output, r.exception)
        sets[backend] = [ls[0] for ls in capture]
    flips = n_px = 0
    for a, b in zip(sets["numpy"], sets["device"]):
        for field in ("NORMALS", "NORMALS2"):
            ang, one = cs._angles(a.field(field).astype(np.float64),
                                  b.field(field).astype(np.float64))
            n_px += ang.size + one
            flips += int((ang > 0.1).sum()) + one
    assert len(sets["device"]) == FRAMES and n_px > 1000
    assert flips <= 0.01 * n_px, (flips, n_px)
    # the numpy backend is the JAX package's bits
    r = invoke(jcli, ["source", yard[0], "normals", "stats"], tmp_path,
                monkeypatch)
    assert r.exit_code == 0


@pytest.mark.parametrize("args", [
    ["source", "{pcap}", "slam", "--backend", "tpu"],
    ["source", "{pcap}", "localize", "--map", "m.ply", "--backend", "tpu"],
    ["source", "{pcap}", "normals", "--backend", "jax"],
], ids=("slam", "localize", "normals"))
def test_tpu_and_jax_backends_are_refused(yard, tmp_path, monkeypatch,
                                          args):
    args = [a.format(pcap=yard[0]) for a in args]
    r = invoke(pcli, args, tmp_path, monkeypatch)
    assert r.exit_code == 2
    assert "Invalid value for '--backend'" in r.output
    assert "'device'" in r.output


@pytest.mark.parametrize("args", [
    ["viz"], ["viz", "--out", "v.png"], ["model_viz", "-o", "m.png"],
    ["pose_optimize", "--viz-snapshot", "po.png", "o.osf"],
], ids=("viz", "viz-out", "model_viz", "pose_optimize-viz-snapshot"))
def test_viewer_commands_exit_non_zero_before_any_work(tmp_path,
                                                       monkeypatch, args):
    """The url does not exist: each viewer command exits non-zero before
    it writes a file, with the JAX package's exit code, output and error
    for the same arguments."""
    p, j = both(tmp_path, monkeypatch, ["source", "missing.osf", *args],
                ok=False)
    assert p.exit_code == j.exit_code == 1, (p.output, p.exception)
    assert p.output == j.output
    assert type(p.exception).__name__ == type(j.exception).__name__
    if not isinstance(p.exception, SystemExit):
        assert str(p.exception) == str(j.exception)
        assert "missing.osf" in str(p.exception)
    for d in tmp_path.iterdir():
        assert not any(d.iterdir()), d


def test_pose_optimize_matches_the_jax_package(yard, tmp_path,
                                               monkeypatch):
    import ouster_sdk_tpu.utils.pose_util as jpu

    import ouster_sdk_tpu_torch.utils.pose_util as tpu

    both(tmp_path, monkeypatch, ["source", yard[0], "slam", "-v", "1.0",
                                 "save", "s.osf"])
    same_file(tmp_path, "s.osf")
    p, j = both(tmp_path, monkeypatch, ["source", yard[0], "pose_optimize",
                                        "o.osf"], ok=False)
    assert p.exit_code == j.exit_code == 1 and p.output == j.output
    assert "requires an OSF source" in p.output
    scans = [ls[0] for ls in pt.open_source(str(tmp_path / "port" / "s.osf"),
                                            device="cpu")]
    ts = [int(s.timestamp[s.w // 2]) for s in scans]
    gt = np.linalg.inv(yard[1][0]) @ yard[1]
    cfg = {"loss_function": "CauchyLoss", "max_num_iterations": 15,
           "key_frame_distance": 0.4,
           "constraints": [{"type": "ABSOLUTE_POSE", "timestamp": ts[-1],
                            "pose": list(gt[-1].ravel()),
                            "rotation_weight": 10.0,
                            "translation_weight": 10.0}]}
    for tag in ("port", "jax"):
        (tmp_path / tag / "c.json").write_text(json.dumps(cfg))
    # the same float32 interpolation in both: byte-equal files
    monkeypatch.setattr(tpu, "pose_interp", lambda t, p0, p1, device=None:
                        jpu.pose_interp(t, p0, p1))
    p, j = both(tmp_path, monkeypatch, ["source", "s.osf", "pose_optimize",
                                        "--config", "c.json", "o.osf"])
    assert p.output == j.output
    assert p.output.endswith(f"wrote {FRAMES} pose-optimized scans to "
                             "o.osf\n")
    same_file(tmp_path, "o.osf")


def test_testing_and_osf_groups_match(yard, tmp_path, monkeypatch):
    p, j = both(tmp_path, monkeypatch, [
        "testing", "synthesize", "syn.pcap", "--mode", "512x10",
        "--profile", "RNG15_RFL8_NIR8", "--frames", "2", "--seed", "3"])
    assert p.output == j.output
    same_file(tmp_path, "syn.pcap")
    same_file(tmp_path, "syn.json")
    for args in (["testing", "digest", "syn.pcap"],
                 ["testing", "digest", "-s", "syn.pcap"],
                 ["testing", "digest", "-c", "syn_digest.json",
                  "syn.pcap"]):
        p, j = both(tmp_path, monkeypatch, args)
        assert p.output == j.output
    same_file(tmp_path, "syn_digest.json")
    both(tmp_path, monkeypatch, ["source", yard[0], "save", "y.osf"])
    same_file(tmp_path, "y.osf")
    for args in (["osf", "info", "y.osf"], ["osf", "dump", "y.osf"],
                 ["osf", "dump", "-s", "y.osf"], ["osf", "metadata",
                                                   "y.osf"],
                 ["osf", "parse", "y.osf"],
                 ["osf", "slice", "y.osf", "z.osf", "--start-index", "1",
                  "--end-index", "4"],
                 ["osf", "set-metadata", "y.osf", "m.osf", "../yard.json"]):
        if args[-1] == "../yard.json":
            args = args[:-1] + [os.path.join(os.path.dirname(yard[0]),
                                             "yard.json")]
        p, j = both(tmp_path, monkeypatch, args)
        assert p.output == j.output, args
    same_file(tmp_path, "z.osf")
    same_file(tmp_path, "m.osf")


def without_torch(packages: dict) -> dict:
    """A `packages` blob of the port without its "torch" entry."""
    assert "torch" in packages
    return {k: v for k, v in packages.items() if k != "torch"}


def test_util_commands(yard, tmp_path, monkeypatch):
    meta = os.path.join(os.path.dirname(yard[0]), "yard.json")
    p, j = both(tmp_path, monkeypatch, ["util", "validate-metadata", meta])
    assert p.output == j.output and "ISSUES" in p.output
    for flags in ([], ["--devices"]):
        p, j = both(tmp_path, monkeypatch, ["util", "system-info", *flags])
        a, b = json.loads(p.output), json.loads(j.output)
        assert sorted(a) == sorted(b)
        assert a["platform"] == b["platform"] and a["cpuinfo"] == b["cpuinfo"]
        assert without_torch(a["packages"]) == b["packages"] == \
            {"ouster-sdk-tpu": pt.__version__}
    p, j = both(tmp_path, monkeypatch, ["util", "benchmark", yard[0],
                                        "--frames", "3", "--report-dir",
                                        "rep", "--trace-dir", "trace"])
    (a,), (b,) = [[json.loads((tmp_path / t / "rep" / f).read_text())
                   for f in os.listdir(tmp_path / t / "rep")]
                  for t in ("port", "jax")]
    assert sorted(a) == sorted(b) == ["pcap", "sys_info", "times"]
    assert a["pcap"] == b["pcap"] and a["pcap"]["n_frames"] == 3
    assert sorted(a["sys_info"]) == sorted(b["sys_info"])
    assert without_torch(a["sys_info"]["packages"]) == \
        b["sys_info"]["packages"] == {"ouster-sdk-tpu": pt.__version__}
    assert f"  ouster-sdk-tpu: {pt.__version__}" in p.output.splitlines()
    keys = sorted(b["times"])
    assert sorted(a["times"]) == sorted(
        "icp_device" if k == "icp_tpu" else k for k in keys)
    assert "device_xyz" in a["times"] and "icp_device" in a["times"]
    assert os.path.isfile(tmp_path / "port" / "trace" / "trace.json")
    assert "torch profiler trace written to trace" in p.output


def test_benchmark_raises_where_a_device_stage_fails(yard, tmp_path,
                                                     monkeypatch):
    """The JAX package prints "skipped" and exits 0; the port raises."""
    def fail(*args, **kwargs):
        raise RuntimeError("the device stage failed")

    from ouster_sdk_tpu_torch.slam import device_icp

    for owner, name in ((fused.ScanPipeline, "project_planar"),
                        (device_icp, "register_points_device")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(owner, name, fail)
            r = invoke(pcli, ["util", "benchmark", yard[0], "--frames",
                               "2"], tmp_path, monkeypatch)
        assert r.exit_code == 1 and "skipped" not in r.output
        assert str(r.exception) == "the device stage failed"


# -- the chained pipeline's threads -------------------------------------------

@pytest.fixture
def failing_commands():
    """`_fail_consumer` (a consumer that raises after one scan set) and
    `_fail_stage` (a stage that raises at the third set)."""
    @click.pass_context
    def consumer_cmd(ctx):
        def consumer(it):
            next(it)
            raise RuntimeError("consumer failed")
        ctx.obj.consumers.append(consumer)

    @click.pass_context
    def stage_cmd(ctx):
        def stage(it):
            for k, ls in enumerate(it):
                if k == 2:
                    raise RuntimeError("stage failed")
                yield ls
        ctx.obj.add_stage(stage)

    src = pcli.commands["source"]
    for name, cb in (("_fail_consumer", consumer_cmd),
                     ("_fail_stage", stage_cmd)):
        src.add_command(click.Command(name, callback=cb), name)
    yield
    for name in ("_fail_consumer", "_fail_stage"):
        del src.commands[name]


@pytest.mark.parametrize("args,msg", [
    (["stats", "_fail_consumer"], "consumer failed"),
    (["_fail_consumer", "stats", "save", "x.osf"], "consumer failed"),
    (["_fail_stage", "stats", "save", "y.osf"], "stage failed"),
    (["_fail_stage", "stats"], "stage failed"),
])
def test_a_failure_in_a_chained_pipeline_neither_hangs_nor_exits_0(
        yard, tmp_path, monkeypatch, failing_commands, args, msg):
    out = []
    t = threading.Thread(target=lambda: out.append(invoke(
        pcli, ["source", yard[0], *args], tmp_path, monkeypatch)))
    t.start()
    t.join(120)
    assert not t.is_alive(), "the pipeline hung"
    (r,) = out
    assert r.exit_code != 0 and str(r.exception) == msg
    # the pipeline's consumer threads have ended
    assert not [th for th in threading.enumerate()
                if th.name.endswith("(drain)")]


def test_async_writer_failure_does_not_deadlock(tmp_path):
    """A failing worker drains the queue; close() raises the stored
    exception instead of hanging (the JAX package's
    tests/test_round2_extras.py case, on a synthesized sensor)."""
    from ouster_sdk_tpu_torch.io.osf import AsyncWriter

    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    w = AsyncWriter(str(tmp_path / "x.osf"))
    sid = w.add_sensor(info)
    w._writer.save = None  # the first save raises in the worker
    scan = pt.LidarScan(info)
    with pytest.raises(RuntimeError):
        for _ in range(64):
            w.save(sid, scan, ts=1)
        w.close()


# -- the plugin runner (tests/test_cli_plugins.py, on the port) --------------

@pytest.fixture
def plugin_dir(tmp_path):
    import ouster_sdk_tpu_torch.cli.plugins as plugins_pkg

    plugins_pkg.__path__.append(str(tmp_path))
    before = set(sys.modules)
    try:
        yield tmp_path
    finally:
        plugins_pkg.__path__.remove(str(tmp_path))
        for name in set(sys.modules) - before:
            if name.startswith(plugins_pkg.__name__ + "."):
                del sys.modules[name]


def _run_code(args, tmp_path, monkeypatch):
    from ouster_sdk_tpu_torch.cli import run

    monkeypatch.setenv("HOME", str(tmp_path))  # the invocation log goes here
    with pytest.raises(SystemExit) as exc:
        run(args=args)
    return exc.value.code


PLUGINS = {
    "client": ("""\
        from ouster_sdk_tpu_torch.cli import cli
        from ouster_sdk_tpu_torch.sensor import ClientError

        @cli.command("raise-client-error")
        def rce():
            raise ClientError("no sensor here")
    """, ["raise-client-error"], 2, "Client error: no sensor here"),
    "source_args": ("""\
        import click
        from ouster_sdk_tpu_torch.cli import cli
        from ouster_sdk_tpu_torch.cli.runner import SourceArgsException

        @cli.command("raise-source-args",
                     context_settings=dict(ignore_unknown_options=True,
                                           allow_extra_args=True))
        @click.pass_context
        def rsa(ctx):
            raise SourceArgsException(ctx)
    """, ["raise-source-args", "bogus", "extra"], 3,
        "unexpected extra arguments (bogus extra)"),
    "internal": ("""\
        from ouster_sdk_tpu_torch.cli import cli

        @cli.command("raise-internal")
        def ri():
            raise ValueError("internal boom")
    """, ["raise-internal"], 0, "ERROR: internal boom"),
    "internal_traceback": (None, ["--traceback", "raise-internal"], 4,
                           "Internal error: internal boom"),
}


@pytest.mark.parametrize("case", sorted(PLUGINS))
def test_runner_exit_codes(tmp_path, monkeypatch, capsys, plugin_dir,
                           case):
    from ouster_sdk_tpu_torch.cli import runner

    source, args, code, text = PLUGINS[case]
    name = case.replace("_traceback", "")
    (plugin_dir / f"p_{name}.py").write_text(
        textwrap.dedent(source or PLUGINS[name][0]))
    monkeypatch.setattr(runner, "TRACEBACK", False)
    try:
        assert _run_code(args, tmp_path, monkeypatch) == code
        out = capsys.readouterr()
        assert text in out.out + out.err
    finally:
        pcli.commands.pop(args[-1] if case != "source_args"
                          else "raise-source-args", None)
        pcli.commands.pop("raise-internal", None)


def test_runner_usage_error_and_bad_plugins(tmp_path, monkeypatch, capsys,
                                            plugin_dir):
    from ouster_sdk_tpu_torch.cli import find_plugins

    assert _run_code(["source"], tmp_path, monkeypatch) == 2
    assert "Usage:" in capsys.readouterr().err
    (plugin_dir / "badplug.py").write_text(
        "raise ImportError('synthetic plugin failure')\n")
    (plugin_dir / "okplug.py").write_text("OK = True\n")
    mods = find_plugins()
    err = capsys.readouterr().err
    assert "Failed to load plugin" in err and "badplug" in err
    assert "--traceback for debug output" in err
    assert "Traceback (most recent call last)" not in err
    assert any(m.name.endswith(".okplug") for m in mods)
    find_plugins(show_traceback=True)
    assert "Traceback (most recent call last)" in capsys.readouterr().err
    # the namespace is the port's: nothing of the JAX package is found
    assert all(m.name.startswith("ouster_sdk_tpu_torch.cli.plugins.")
               for m in mods)
    r = CliRunner().invoke(pcli, ["--version"])
    assert r.exit_code == 0 and "Plugins provided:" in r.output
    assert "okplug" in r.output
