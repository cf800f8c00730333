"""Shared inputs for the tests that hold the PyTorch port
(ouster_sdk_tpu_torch) against the JAX package.

Both packages get the same sensor: one metadata string parsed by each
package's own parser. Frames are synthesized with the JAX package's
writer (__graft_entry__._synth_frame) and restaged word-planar on the host
in numpy, the layout FrameReader.iter_planar_chunks produces; the
synthesized frame itself is packet-layout (FrameReader.iter_chunks).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from __graft_entry__ import _make_info, _synth_frame  # noqa: E402

import ouster_sdk_tpu_torch as pt  # noqa: E402
from ouster_sdk_tpu import UDPProfileLidar  # noqa: E402
from ouster_sdk_tpu.core.metadata import \
    sensor_info_from_metadata as jax_sensor_info  # noqa: E402

# The inputs are small and the suite runs several workers side by side:
# one intra-op thread each keeps them from crowding out the timing-
# sensitive tests of the other files.
torch.set_num_threads(1)

SINGLE = "RNG19_RFL8_SIG16_NIR16"
DUAL = "RNG19_RFL8_SIG16_NIR16_DUAL"
DUAL_SPLIT = "RNG19_RFL8_SIG16_NIR16_RGB16_DUAL"   # pw=5: split range words

#: every profile with a packet layout (not UNKNOWN / OFF)
PROFILES = tuple(p.value for p in UDPProfileLidar
                 if p.name not in ("UNKNOWN", "OFF"))


def infos(profile: str, w: int = 256, h: int = 32):
    """(JAX SensorInfo, port SensorInfo) of one synthetic sensor, both
    parsed from the same metadata string."""
    info = _make_info(w=w, h=h, dual=False)
    info.format.udp_profile_lidar = UDPProfileLidar(profile)
    info.config.udp_port_lidar = 7502
    meta = info.to_json_string()
    return jax_sensor_info(meta), pt.sensor_info_from_metadata(meta)


def synth_frame(jinfo) -> np.ndarray:
    """One frame (n_pkts, pkt_words) u32 from the JAX package's writer."""
    return _synth_frame(jinfo)


def stage_planar(frame: np.ndarray, plan):
    """Restage packet words to planes (pw, h, w) and col_hdrs (schw, w):
    the chw header words plus, for LEGACY, the column-footer status."""
    cols = frame[:, plan.hw:plan.hw + plan.cpp * plan.cw].reshape(
        plan.w, plan.cw)
    pix = cols[:, plan.chw:plan.chw + plan.h * plan.pw]
    planes = np.ascontiguousarray(
        pix.reshape(plan.w, plan.h, plan.pw).transpose(2, 1, 0))
    hdr = cols[:, :plan.chw]
    if plan.schw > plan.chw:
        hdr = np.concatenate([hdr, cols[:, plan.cw - (plan.schw - plan.chw):]],
                             axis=1)
    return planes, np.ascontiguousarray(hdr.T)


def perturb(planes: np.ndarray, hdrs: np.ndarray, plan, seed: int):
    """Clear the status valid bit of some columns and zero the RANGE field
    of some pixels, in copies of (pw, h, w) planes and (schw, w) col_hdrs."""
    planes, hdrs = planes.copy(), hdrs.copy()
    rng = np.random.default_rng(seed)
    cleared = rng.random(plan.w) < 0.1
    hdrs[plan.staged_status_word, cleared] &= np.uint32(
        ~(1 << plan.status_bit) & 0xFFFFFFFF)
    zero = rng.random(planes.shape[1:]) < 0.05
    for f in plan.fields:
        if f.name == "RANGE":   # FIVE_WORD_PIXEL carries raw words only
            field_mask = ((1 << f.size) - 1) << f.bit
            planes[f.word][zero] &= np.uint32(~field_mask & 0xFFFFFFFF)
    return planes, hdrs


def batch(jinfo, plan, seeds=(1, 2)):
    """(B, pw, h, w) planes and (B, schw, w) col_hdrs: one synthesized
    frame, perturbed differently for each seed."""
    planes, hdrs = stage_planar(synth_frame(jinfo), plan)
    pairs = [perturb(planes, hdrs, plan, s) for s in seeds]
    return (np.stack([p for p, _ in pairs]), np.stack([h for _, h in pairs]))


def _columns(frame: np.ndarray, plan) -> np.ndarray:
    """(w, cw) copy of the column blocks of a packet-layout frame."""
    return frame[:, plan.hw:plan.hw + plan.cpp * plan.cw].reshape(
        plan.w, plan.cw)


def _put_columns(frame: np.ndarray, cols: np.ndarray, plan) -> None:
    frame[:, plan.hw:plan.hw + plan.cpp * plan.cw] = cols.reshape(
        plan.n_pkts, plan.cpp * plan.cw)


def perturb_frame(frame: np.ndarray, plan, seed: int) -> np.ndarray:
    """perturb() for a packet-layout frame (n_pkts, pkt_words): a copy with
    the status valid bit of some columns cleared and the RANGE field of
    some pixels zeroed."""
    frame = frame.copy()
    rng = np.random.default_rng(seed)
    cols = _columns(frame, plan)
    cleared = rng.random(plan.w) < 0.1
    cols[cleared, plan.status_word] &= np.uint32(
        ~(1 << plan.status_bit) & 0xFFFFFFFF)
    zero = rng.random((plan.w, plan.h)) < 0.05
    for f in plan.fields:
        if f.name == "RANGE":
            idx = plan.chw + np.arange(plan.h) * plan.pw + f.word
            field_mask = ((1 << f.size) - 1) << f.bit
            sub = cols[:, idx]
            sub[zero] &= np.uint32(~field_mask & 0xFFFFFFFF)
            cols[:, idx] = sub
    _put_columns(frame, cols, plan)
    return frame


def frames_batch(jinfo, plan, seeds=(1, 2)) -> np.ndarray:
    """(B, n_pkts, pkt_words) packet-layout frames: one synthesized frame,
    perturbed differently for each seed."""
    frame = synth_frame(jinfo)
    return np.stack([perturb_frame(frame, plan, s) for s in seeds])


def shuffle_measurement_ids(frame: np.ndarray, plan, seed: int) -> np.ndarray:
    """A copy of a packet-layout frame whose columns carry shuffled
    measurement ids: a permutation, then some ids duplicated (two columns
    claim one destination, others none) and some pushed beyond the frame
    (>= w, dropped)."""
    frame = frame.copy()
    rng = np.random.default_rng(seed)
    cols = _columns(frame, plan)
    mids = rng.permutation(plan.w)
    dup = rng.choice(plan.w, plan.w // 8, replace=False)
    mids[dup] = mids[rng.integers(0, plan.w, dup.size)]
    far = rng.choice(plan.w, plan.w // 16, replace=False)
    mids[far] = plan.w + rng.integers(0, 1000, far.size)
    word = cols[:, plan.mid_word]
    cols[:, plan.mid_word] = (word & np.uint32(0xFFFF0000)) \
        | mids.astype(np.uint32)
    _put_columns(frame, cols, plan)
    return frame


def words(x: np.ndarray) -> torch.Tensor:
    """u32 words -> the int32 CPU tensor the port takes."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def poses(B: int, w: int, seed: int = 7) -> np.ndarray:
    """(B, w, 4, 4) float32 per-column SE(3) poses: exp of random twists
    (rotation ~ N(0, 1) rad per axis, translation ~ N(0, 0.1)), computed
    in float64 numpy in one batch."""
    xi = np.random.default_rng(seed).standard_normal((B, w, 6))
    rot, v = xi[..., :3], 0.1 * xi[..., 3:]
    theta = np.linalg.norm(rot, axis=-1)[..., None, None]
    K = np.zeros((B, w, 3, 3))
    K[..., 0, 1], K[..., 0, 2] = -rot[..., 2], rot[..., 1]
    K[..., 1, 0], K[..., 1, 2] = rot[..., 2], -rot[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -rot[..., 1], rot[..., 0]
    KK = K @ K
    T = np.zeros((B, w, 4, 4))
    T[..., :3, :3] = (np.eye(3) + np.sin(theta) / theta * K
                      + (1 - np.cos(theta)) / theta**2 * KK)
    V = (np.eye(3) + (1 - np.cos(theta)) / theta**2 * K
         + (theta - np.sin(theta)) / theta**3 * KK)
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1
    return T.astype(np.float32)


# -- packet streams, captures and scans for the device engine tests ---------

def engine_infos(profile: str, w: int = 256, h: int = 32, **knobs):
    """(JAX SensorInfo, port SensorInfo) of one synthetic sensor with the
    knobs the engine tests turn (engine_metadata's), both parsed from the
    same metadata string."""
    meta = engine_metadata(profile, w, h, **knobs)
    return jax_sensor_info(meta), pt.sensor_info_from_metadata(meta)


def engine_metadata(profile: str, w: int = 256, h: int = 32, *,
                    column_window=None, init_id: int = 0, sn: int = 0,
                    nmea_imu: bool = False, zone_port: int = 0,
                    extrinsic=None, lidar_port: int = 7502) -> str:
    """The metadata string of one synthetic sensor: an azimuth window, ids
    for the packet id check, an ACCEL32_GYRO32_NMEA IMU stream (port 7503,
    2 packets of 4 measurements a frame), a zone-monitoring stream on
    `zone_port`, an extrinsic, the lidar port."""
    from ouster_sdk_tpu.core.types import UDPProfileIMU

    info = _make_info(w=w, h=h, dual=False)
    info.format.udp_profile_lidar = UDPProfileLidar(profile)
    info.config.udp_port_lidar = lidar_port
    info.init_id, info.sn = init_id, sn
    if column_window is not None:
        info.format.column_window = tuple(column_window)
    meta = json.loads(info.to_json_string())
    if nmea_imu:
        meta["lidar_data_format"]["udp_profile_imu"] = \
            UDPProfileIMU.ACCEL32_GYRO32_NMEA.value
        meta["imu_data_format"] = {"imu_packets_per_frame": 2,
                                   "imu_measurements_per_packet": 4}
        meta["config_params"]["udp_port_imu"] = 7503
    if zone_port:
        meta["config_params"]["udp_port_zm"] = zone_port
        meta["config_params"]["udp_dest_zm"] = "10.0.0.1"
    if extrinsic is not None:
        meta.setdefault("ouster-sdk", {})["extrinsic"] = \
            np.asarray(extrinsic, np.float64).reshape(-1).tolist()
    return json.dumps(meta)


def frame_packets(jinfo, fid: int, seed: int = 0, ts0: int = 10**6,
                  invalid: float = 0.05, **header):
    """One frame's lidar packets as u8 arrays, from the JAX package's
    writer: every channel field of the profile random from the seed
    (about 5% of ranges zero), column timestamps from ts0, `invalid` of
    the columns with their status bit clear; `header` goes to
    set_packet_header (alert_flags, thermal_shutdown, shot_limiting,
    countdown_thermal, countdown_shot)."""
    from ouster_sdk_tpu import PacketWriter

    pw = PacketWriter(jinfo.format)
    cpp, h = pw.columns_per_packet, pw.pixels_per_column
    rng = np.random.default_rng([seed, fid])
    out = []
    for p in range(jinfo.format.columns_per_frame // cpp):
        buf = pw.new_packet()
        pw.set_packet_header(buf, init_id=jinfo.init_id, prod_sn=jinfo.sn,
                             **header)
        pw.set_frame_id(buf, fid)
        m0 = p * cpp
        status = (rng.random(cpp) >= invalid).astype(np.uint32)
        pw.set_col_headers(
            buf, np.arange(cpp, dtype=np.uint64) * 100 + m0 * 100 + ts0,
            np.arange(cpp, dtype=np.uint16) + m0, status)
        for name in pw.fields:
            fi = pw.field_info(name)
            if name.startswith("RAW32"):
                continue
            n_el = fi.num_elements
            bits = fi.bit_size // n_el
            shape = (h, cpp) + ((n_el,) if n_el > 1 else ())
            v = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
            if name.startswith("RANGE"):
                v[rng.random(shape) < 0.05] = 0
            pw.set_field(buf, name, v << np.uint64(fi.upshift))
        out.append(buf)
    return out


def lidar_stream(frames, t0: int = 10**9, dt: int = 10**5):
    """[(kind, payload, host_ts)] of the frames' packets in order, host
    timestamps rising by dt from t0."""
    stream, t = [], t0
    for pkts in frames:
        for p in pkts:
            stream.append(("lidar", p, t))
            t += dt
    return stream


def aux_packet(jinfo, kind: str, fid: int, seed: int = 0,
               m_id0: int = 0) -> np.ndarray:
    """An IMU or zone packet of the profile's size made of seeded random
    bytes with the frame id patched in; an IMU packet also gets its
    measurement ids set from m_id0 on, so that it lands in a packet slot
    of the frame."""
    from ouster_sdk_tpu.ops.packet_format import PacketFormat

    pf = PacketFormat.from_info(jinfo)
    size = pf.imu_packet_size if kind == "imu" else pf.zone_packet_size
    rng = np.random.default_rng([seed, fid, m_id0, kind == "imu"])
    buf = rng.integers(0, 256, size, dtype=np.uint8)
    buf[2:4] = np.frombuffer(np.uint16(fid).tobytes(), np.uint8)
    if kind == "imu":
        g = pf.geom
        for k in range(pf.imu_measurements_per_packet):
            off = g.imu_measurement_offset + k * g.imu_measurement_size + 8
            buf[off:off + 2] = np.frombuffer(
                np.uint16(m_id0 + k).tobytes(), np.uint8)
    return buf


PORTS = {"lidar": 7502, "imu": 7503, "zone": 7504}


def write_pcap(path: str, stream, ports=None) -> str:
    """Write [(kind, payload, host_ts)] to `path` with the port's
    PcapWriter and, beside it, with the JAX package's; the two files must
    be byte-equal. `ports` maps a kind to its destination port (default
    PORTS)."""
    from ouster_sdk_tpu.io.pcap import PcapWriter as JaxPcapWriter

    ports = {**PORTS, **(ports or {})}
    for writer_cls, out in ((pt.PcapWriter, path),
                            (JaxPcapWriter, path + ".jax")):
        with writer_cls(out) as w:
            for kind, payload, ts in stream:
                port = ports[kind] if isinstance(kind, str) else kind
                w.write(np.asarray(payload, np.uint8).tobytes(), "10.0.0.2",
                        "10.0.0.1", port, port, ts)
    with open(path, "rb") as a, open(path + ".jax", "rb") as b:
        assert a.read() == b.read(), "the two PcapWriters disagree"
    os.remove(path + ".jax")
    return path


def batcher_scans(pkg, info, stream, trailing_flush: bool = True,
                  field_types=None):
    """What `pkg`'s ScanBatcher makes of the stream, packet by packet
    (pkg is the port, `pt`, or the JAX package): the scans in release
    order, each with the index of the packet that released it, and with
    the trailing flush the scan sources apply at the end of a capture (the
    open scan is emitted when it has a valid column)."""
    from importlib import import_module

    root = pkg.__name__
    packets = import_module(root + ".core.packets")
    LidarScan = import_module(root + ".core.lidar_scan").LidarScan
    ScanBatcher = import_module(root + ".core.batcher").ScanBatcher
    cls = {"lidar": packets.LidarPacket, "imu": packets.ImuPacket,
           "zone": packets.ZonePacket}
    b = ScanBatcher(info)
    cur = LidarScan(info, field_types=field_types)
    out = []
    for k, (kind, payload, ts) in enumerate(stream):
        pkt = cls[kind](np.asarray(payload, np.uint8).tobytes(), ts)
        if b(pkt, cur):
            out.append((k, cur))
            cur = LidarScan(info, field_types=field_types)
            # the packet that closed the scan was cached: it opens the
            # next scan on the next call
    if trailing_flush and cur.frame_id != -1 and np.any(cur.status & 1):
        out.append((None, cur))
    return out


def has_nan(scan) -> bool:
    """Whether a float field of the scan holds a NaN (float16 RGB, random
    IMU floats): `LidarScan.__eq__` holds no such scan equal, not even to
    itself."""
    return any(scan.field(n).dtype.kind == "f"
               and np.isnan(scan.field(n).astype(np.float64)).any()
               for n in scan.fields)


def assert_scans_equal(a, b, tag: str = "") -> None:
    """Two LidarScans, of either package, carry the same fields (name,
    dtype, shape, bits), header arrays (dtype too) and scalars."""
    assert a.frame_id == b.frame_id, tag
    assert (a.w, a.h) == (b.w, b.h), tag
    assert sorted(a.fields) == sorted(b.fields), \
        f"{tag}: {sorted(a.fields)} != {sorted(b.fields)}"
    for name in b.fields:
        x, y = a.field(name), b.field(name)
        assert x.dtype == y.dtype and x.shape == y.shape, \
            f"{tag}:{name}: {x.dtype}{x.shape} != {y.dtype}{y.shape}"
        if x.dtype.kind == "f" and x.dtype.itemsize == 2:
            x, y = x.view(np.uint16), y.view(np.uint16)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}:{name}")
    for attr in ("timestamp", "measurement_id", "status",
                 "packet_timestamp", "alert_flags", "pose"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.dtype == y.dtype, f"{tag}:{attr} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}:{attr}")
    for attr in ("frame_status", "shutdown_countdown",
                 "shot_limiting_countdown"):
        assert getattr(a, attr) == getattr(b, attr), f"{tag}:{attr}"


# -- the command line and the yard, shared by the CLI, viewer and examples
# tests ---------------------------------------------------------------------

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """Every binding of the port's default device, pointed at the CPU, and
    the source policy variable unset (autouse in a module that imports
    this fixture by name)."""
    from ouster_sdk_tpu_torch.ops import fused

    real = fused.default_device
    for name, mod in list(sys.modules.items()):
        if name.startswith("ouster_sdk_tpu_torch") and \
                getattr(mod, "default_device", None) is real:
            monkeypatch.setattr(mod, "default_device",
                                lambda: torch.device("cpu"))
    monkeypatch.delenv("OUSTER_SDK_TPU_DEVICE_DECODE", raising=False)


def yard_pcap(d, frames: int):
    """chip_smoke's yard (16x256 dual, `frames` frames) written as
    d/yard.pcap with its metadata json beside it; returns (pcap path,
    ground truth)."""
    import chip_smoke as cs
    from ouster_sdk_tpu_torch.core.types import UDPProfileLidar

    info = cs.synth_info(cs.MAIN_PROFILE, w=256, h=16)
    info.config.udp_profile_lidar = UDPProfileLidar(cs.MAIN_PROFILE)
    info.config.udp_port_lidar = 7502
    pcap = os.path.join(str(d), "yard.pcap")
    truth = cs.yard_capture(pt, pcap, info, frames)
    with open(os.path.join(str(d), "yard.json"), "w") as f:
        f.write(info.to_json_string())
    return pcap, truth


def invoke(cli, args, cwd, monkeypatch):
    """click's runner over `cli` in the directory `cwd`."""
    from click.testing import CliRunner

    monkeypatch.chdir(cwd)
    return CliRunner().invoke(cli, args)


def both(tmp_path, monkeypatch, args, ok=True):
    """Run `args` through the port's cli in tmp_path/port and the JAX
    package's in tmp_path/jax; returns (port result, JAX result)."""
    from ouster_sdk_tpu.cli import cli as jcli
    from ouster_sdk_tpu_torch.cli import cli as pcli

    out = []
    for tag, cli in (("port", pcli), ("jax", jcli)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        r = invoke(cli, args, d, monkeypatch)
        if ok:
            assert r.exit_code == 0, (tag, r.output, r.exception)
        out.append(r)
    return out


def same_file(tmp_path, name):
    """tmp_path/port/name and tmp_path/jax/name: non-empty and equal."""
    a = (tmp_path / "port" / name).read_bytes()
    assert a == (tmp_path / "jax" / name).read_bytes(), name
    assert a


def same_files(tmp_path):
    """Every file of tmp_path/port and tmp_path/jax: the same names, each
    non-empty and equal; returns the names."""
    names = sorted(os.listdir(tmp_path / "port"))
    assert names and names == sorted(os.listdir(tmp_path / "jax"))
    for n in names:
        same_file(tmp_path, n)
    return names
