"""The port's example scripts (ouster_sdk_tpu_torch.examples.scripts, one
module a script of the repository's examples/*.py) against the root
scripts, on the CPU.

Each case runs the root script (the JAX package) and the port's script in
this process, as `python examples/<name>.py` and `python -m
ouster_sdk_tpu_torch.examples.scripts.<name>` run them: sys.argv set, the
working directory tmp_path/jax or tmp_path/port, stdout captured, every
default_device binding of the port pointed at the CPU. The inputs are the
chip run's yard (6 frames, 16x256 dual) as a pcap with its metadata json
beside it, the same scans saved to an OSF by the port (for osf_write_read
and filter_and_mask), and a copy of the pcap whose json names free UDP
ports (for sensor_config, whose emulator streams to the ports the json
names).

Tolerance: exact. Printed text is equal and every written file is
byte-equal, with one substitution in each package's text where the text names a
loopback port. pose_optimizer_example runs with the JAX package's float32
SE(3) interpolation patched into the port (utils/pose_util.pose_interp;
torch and XLA round its sin, cos and arccos apart, by 2.98e-8 at most, see
tests/test_torch_pose_optimizer.py). The live scripts run against a fresh
emulator for each package on loopback, and are held on what they print of
each complete scan (frame id and valid pixels, or mean range) against the
scan the emulator served for that frame id. gl_viewer renders on this
host's surfaceless EGL. The root filter_and_mask.py calls MaskedScanSource
without its fields and raises TypeError in the JAX package (held here); the
port's script passes RANGE, and the root script is held to it with the
JAX package's MaskedScanSource given RANGE in the same way.
"""

import contextlib
import copy
import io
import os
import re
import runpy
import shutil
import sys

import pytest

from _torch_helpers import on_cpu, same_files, \
    yard_pcap  # noqa: F401  (on_cpu: autouse)
import chip_smoke as cs
import ouster_sdk_tpu_torch as pt
from _torch_live_helpers import free_udp_ports
from ouster_sdk_tpu_torch.io.save import save_scans
from ouster_sdk_tpu_torch.sensor.emulator import (SensorEmulator,
                                                  looping_packets_factory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6

# port script -> (root script, its input, more arguments)
SCRIPTS = {
    "device_pipeline": ("tpu_pipeline", "pcap", ()),
    "pcap_to_pointcloud": ("pcap_to_pointcloud", "pcap", ()),
    "osf_write_read": ("osf_write_read", "osf", ()),
    "slam_trajectory": ("slam_trajectory", "pcap", ()),
    "pose_optimizer_example": ("pose_optimizer_example", "pcap", (".",)),
    "filter_and_mask": ("filter_and_mask", "osf", ()),
    "zone_monitor_emulation": ("zone_monitor_emulation", "pcap", ()),
    "emulator_live_loop": ("emulator_live_loop", "pcap", ("3",)),
    "live_sensor": ("live_sensor", "host", ("4",)),
    "sensor_config": ("sensor_config", "live", ()),
    "bag_roundtrip": ("bag_roundtrip", "pcap", (".",)),
    "viz_snapshot": ("viz_snapshot", "pcap", ()),
    "gl_viewer": ("gl_viewer", "pcap", ()),
}


@pytest.fixture(scope="module")
def yard(tmp_path_factory):
    """{"pcap", "osf", "live"}: the yard capture with its metadata json,
    the same scans in an OSF, and the capture under a json naming free UDP
    ports."""
    d = tmp_path_factory.mktemp("yard")
    pcap, _ = yard_pcap(d, FRAMES)
    osf = str(d / "yard.osf")
    sets = list(pt.open_source(pcap, device="cpu"))
    info = sets[0][0].sensor_info
    save_scans(osf, [info], sets)
    live = str(d / "live.pcap")
    shutil.copyfile(pcap, live)
    linfo = copy.deepcopy(info)
    linfo.config.udp_port_lidar, linfo.config.udp_port_imu = \
        free_udp_ports(2)
    (d / "live.json").write_text(linfo.to_json_string())
    return {"pcap": pcap, "osf": osf, "live": live, "sets": sets,
            "info": info}


def run_script(tag: str, name: str, argv, cwd, monkeypatch) -> str:
    """One script of the port ("port") or its root script ("jax") as its
    command line runs it, in `cwd`; returns what it printed."""
    root, _, _ = SCRIPTS[name]
    monkeypatch.chdir(cwd)
    buf = io.StringIO()
    with monkeypatch.context() as m, contextlib.redirect_stdout(buf):
        if tag == "port":
            mod = f"ouster_sdk_tpu_torch.examples.scripts.{name}"
            m.setattr(sys, "argv", [mod, *argv])
            runpy.run_module(mod, run_name="__main__")
        else:
            path = os.path.join(ROOT, "examples", f"{root}.py")
            m.setattr(sys, "argv", [path, *argv])
            runpy.run_path(path, run_name="__main__")
    return buf.getvalue()


@contextlib.contextmanager
def live_emulator(yard):
    """The port's emulator looping the yard's scans at 5x real time on
    free UDP ports that its configuration names, started."""
    info = copy.deepcopy(yard["info"])
    info.config.udp_port_lidar, info.config.udp_port_imu = \
        free_udp_ports(2)
    emu = SensorEmulator(info, looping_packets_factory(yard["sets"], info),
                         http_port=0, rate=5.0, loop=True)
    emu.start()
    try:
        yield emu
    finally:
        emu.stop()


def run_both(name, yard, tmp_path, monkeypatch):
    """{tag: printed text} of the script in both packages; the live
    scripts' loopback ports replaced by PORT."""
    _, kind, more = SCRIPTS[name]
    out = {}
    for tag in ("port", "jax"):
        d = tmp_path / tag
        d.mkdir()
        if kind == "host":
            with live_emulator(yard) as emu:
                host = f"127.0.0.1:{emu.http_port}"
                text = run_script(tag, name, [host, *more], d, monkeypatch)
        else:
            text = run_script(tag, name, [yard[kind], *more], d,
                              monkeypatch)
        out[tag] = re.sub(r"(127\.0\.0\.1:|udp :)\d+", r"\1PORT", text)
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_matches_the_root_script(name, yard, tmp_path, monkeypatch):
    if name == "pose_optimizer_example":
        import ouster_sdk_tpu.utils.pose_util as jpu

        import ouster_sdk_tpu_torch.utils.pose_util as tpu

        monkeypatch.setattr(tpu, "pose_interp",
                            lambda t, p0, p1, device=None:
                            jpu.pose_interp(t, p0, p1))
    if name == "filter_and_mask":
        # the root script calls MaskedScanSource without its fields and
        # raises; it is held with the call given RANGE, as the port's is
        from ouster_sdk_tpu.io import derived as jderived

        (tmp_path / "raises").mkdir()
        with pytest.raises(TypeError, match="masks"):
            run_script("jax", name, [yard["osf"]], tmp_path / "raises",
                       monkeypatch)
        masked = jderived.MaskedScanSource
        monkeypatch.setattr(jderived, "MaskedScanSource",
                            lambda parent, masks: masked(parent, ["RANGE"],
                                                         masks))
    out = run_both(name, yard, tmp_path, monkeypatch)
    if name in ("emulator_live_loop", "live_sensor"):
        for tag, text in out.items():
            if name == "emulator_live_loop":
                n = cs.hold_served(text, yard["sets"], cs.LIVE_LOOP_LINE,
                                   cs.valid_px)
                assert n == 3 and "received 3 complete scans" in text, \
                    (tag, text)
            else:
                n = cs.hold_served(text, yard["sets"], cs.LIVE_SENSOR_LINE,
                                   cs.mean_range)
                assert n >= 1 and text.count("\nscan ") == 4, (tag, text)
        # which frames arrive whole, and when, differs from run to run: the
        # rest of the text is held on its first line
        out = {tag: text.split("\n")[0] for tag, text in out.items()}
    assert out["port"] == out["jax"]
    assert out["port"].strip()
    want = {"pcap_to_pointcloud": ["cloud.ply"],
            "osf_write_read": ["recording.osf"],
            "slam_trajectory": ["poses_kitti.txt"],
            "pose_optimizer_example": ["po_orbit.png", "po_top.png",
                                       "refined.osf", "slammed.osf"],
            "bag_roundtrip": ["recording.bag", "recording.db3",
                              "recording.mcap"],
            "viz_snapshot": ["scan.png"], "gl_viewer": ["gl_scan.png"]}
    files = want.get(name, [])
    assert sorted(os.listdir(tmp_path / "jax")) == files
    if files:
        assert same_files(tmp_path) == files
    if name == "device_pipeline":
        assert "max |r| = " in out["port"] and "RANGE2" in out["port"]
