"""The port's live sensor layer (ouster_sdk_tpu_torch.sensor,
io.frames.PlanarStreamAssembler, io.save.scan_to_packets,
PacketFormat.scalar_reader, native.udp_recv_batch) against the JAX
package, over loopback sockets with the sensor emulators (no network, no
hardware).

Tolerance: exact. Scans compare element for element, headers included,
against the port's and the JAX package's ScanBatcher over the packets that
arrived; packets and staged planes byte for byte; XYZ bit for bit against
the JAX package's planar projection in interpret mode. UDP loses packets
even on loopback under load, so a live comparison takes only the frames
whose every packet arrived, every loop has a deadline, and no time or rate
is asserted.
"""

import json
import socket
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ouster_sdk_tpu_torch as pt
from _torch_helpers import assert_scans_equal
from _torch_live_helpers import (batcher_scans, chip_smoke, collect_scans,
                                 frame_packets, free_udp_ports, live_info,
                                 paced)
from ouster_sdk_tpu.core.metadata import \
    sensor_info_from_metadata as jax_sensor_info
from ouster_sdk_tpu_torch.io import device_engine as de
from ouster_sdk_tpu_torch.ops import planar_kernels as pk
from ouster_sdk_tpu_torch.sensor import scan_source as ss
from ouster_sdk_tpu_torch.sensor.emulator import SensorEmulator
from ouster_sdk_tpu_torch.sensor.http import (SensorHttp, SensorHttp_2_4_or_3,
                                              SensorHttpError)
from ouster_sdk_tpu_torch.utils import native

N_PKTS = 32     # a 512x10 frame: 512 columns of 16 a packet


def _jinfo(info):
    return jax_sensor_info(info.to_json_string())


def _emulator(info, frames=None, rate=1.0, **kw):
    """The port's emulator on the info's ports; not started."""
    return SensorEmulator(info, paced(list((frames or {}).values())),
                          http_port=0,
                          lidar_port=info.config.udp_port_lidar,
                          imu_port=info.config.udp_port_imu, rate=rate, **kw)


def _all_arrived(scan) -> bool:
    return int(np.count_nonzero(scan.packet_timestamp)) == N_PKTS


# -- the byte-level pieces ----------------------------------------------------

SCALAR_LAYOUTS = [("RNG19_RFL8_SIG16_NIR16", "STANDARD"),
                  ("RNG19_RFL8_SIG16_NIR16_DUAL", "STANDARD"),
                  ("FUSA_RNG15_RFL8_NIR8_DUAL", "FUSA"),
                  ("RNG15_RFL8_NIR8", "STANDARD")]


@pytest.mark.parametrize("profile,header", SCALAR_LAYOUTS)
def test_scalar_reader_matches_jax_and_the_word_path(profile, header):
    from ouster_sdk_tpu.ops.packet_format import PacketFormat as JaxFormat
    from ouster_sdk_tpu_torch.core.types import HeaderType

    info = live_info(7502, 7503, profile=profile)
    info.format.header_type = HeaderType(header)
    info.init_id, info.sn = 0x123456, 99224400817
    pw = pt.PacketWriter(info.format)
    buf = pw.new_packet()
    pw.set_packet_header(buf, init_id=info.init_id, prod_sn=info.sn)
    fid = 0xABCDEF01 if header == "FUSA" else 0xBEEF
    pw.set_frame_id(buf, fid)
    pf, jpf = pt.PacketFormat.from_info(info), JaxFormat.from_info(
        _jinfo(info))
    raw = buf.tobytes()
    for name, expect in (("init_id", info.init_id), ("prod_sn", info.sn),
                         ("frame_id", fid)):
        fast = pf.scalar_reader(getattr(pf.geom, name))
        jfast = jpf.scalar_reader(getattr(jpf.geom, name))
        for data in (raw, np.frombuffer(raw, np.uint8)):
            assert fast(data) == jfast(data) == getattr(pf, name)(buf) \
                == expect, (profile, name)


def test_udp_recv_batch_drains_loopback_datagrams():
    if native.get_lib() is None:
        pytest.skip("no g++: the receive path reads a datagram a recv")
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.setblocking(False)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        ws = {}
        native.reset_calls()
        assert native.udp_recv_batch(rx, 2048, 8, ws) is None  # nothing yet
        rng = np.random.default_rng(3)
        sent = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(1, 2048, 11)]
        for d in sent:
            tx.sendto(d, rx.getsockname())
        got, deadline = [], time.monotonic() + 5
        while len(got) < len(sent) and time.monotonic() < deadline:
            batch = native.udp_recv_batch(rx, 2048, 8, ws)
            if batch is None:
                time.sleep(0.01)
                continue
            bufs, sizes, ts = batch
            assert bufs.shape[1] == 2048 and ts > 0
            got += [bufs[k, :sizes[k]].tobytes() for k in range(len(sizes))]
        assert got == sent
        assert native.calls["udp_recv_batch"] >= 3    # 8 a call at most
        with pytest.raises(ValueError, match="max_msgs"):
            native.udp_recv_batch(rx, 2048, 0)
    finally:
        rx.close()
        tx.close()


@pytest.mark.parametrize("route", ["recvmmsg", "recv"])
def test_packet_source_receives_by_either_route(route, monkeypatch):
    """Packets reach SensorPacketSource through one recvmmsg a socket, or
    through recv where the native library is not built (no g++)."""
    if route == "recv":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif native.get_lib() is None:
        pytest.skip("no g++")
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    src = pt.sensor.SensorPacketSource(["127.0.0.1"], sensor_info=[info])
    native.reset_calls()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pkts = frame_packets(info, 5)[:6]
        for p in pkts:
            tx.sendto(p, ("127.0.0.1", lp))
        got, deadline = [], time.monotonic() + 5
        while len(got) < len(pkts) and time.monotonic() < deadline:
            idx, pkt = src.get_packet(timeout_sec=0.5)
            if pkt is not None:
                got.append((idx, pkt))
        assert [bytes(p.buf) for _, p in got] == pkts
        assert all(i == 0 and p.host_timestamp > 0 for i, p in got)
        n_calls = native.calls["udp_recv_batch"]
        assert (n_calls > 0) == (route == "recvmmsg")
        if route == "recvmmsg":
            # one host timestamp a drained batch
            assert len({p.host_timestamp for _, p in got}) <= n_calls
    finally:
        src.close()


# -- the HTTP control plane --------------------------------------------------

def test_http_against_the_port_emulator():
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    emu = _emulator(info).start()
    try:
        http = SensorHttp.create(f"127.0.0.1:{emu.http_port}")
        rt = pt.sensor_info_from_metadata(http.metadata())
        assert (rt.sn, rt.format.columns_per_frame) == (
            info.sn, info.format.columns_per_frame)
        assert rt.format.udp_profile_lidar == info.format.udp_profile_lidar
        assert http.active_config_params()["udp_port_lidar"] == lp
        assert "beam_azimuth_angles" in http.beam_intrinsics()
        http.set_config_param("udp_dest", "1.2.3.4")
        assert http.staged_config_params()["udp_dest"] == "1.2.3.4"
        assert http.active_config_params()["udp_dest"] == "127.0.0.1"
        with pytest.raises(SensorHttpError, match="400"):
            http.set_config_param("signal_multiplier", 1.2)
        http.set_user_data("hello")
        assert http.get_user_data() == "hello"
        cfg = pt.sensor.get_config(f"127.0.0.1:{emu.http_port}")
        assert cfg.udp_port_lidar == lp
    finally:
        emu.stop()


@pytest.mark.parametrize("fw", ["3.2.0", "2.4.1", "2.2.0"])
def test_http_dispatch_by_firmware(fw):
    """SensorHttp.create dispatches on the advertised firmware: 3.1+ the
    full surface, 2.4 / 3.0 without user data, below 2.4 refused."""
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    info.image_rev = f"ousteros-image-prod-aries-v{fw}"
    emu = _emulator(info, upgrade_firmware=False).start()
    host = f"127.0.0.1:{emu.http_port}"
    try:
        if fw == "2.2.0":
            with pytest.raises(SensorHttpError, match="2.4 or later"):
                SensorHttp.create(host)
            return
        h = SensorHttp.create(host)
        assert (h.version.major, h.version.minor) == tuple(
            int(x) for x in fw.split(".")[:2])
        if fw == "3.2.0":
            assert type(h) is SensorHttp
            h.set_user_data("x")
            assert h.get_user_data() == "x"
        else:
            assert isinstance(h, SensorHttp_2_4_or_3)
            with pytest.raises(SensorHttpError, match="not supported"):
                h.get_user_data()
    finally:
        emu.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_http_planes_interoperate_across_packages(client):
    """The port's client against the JAX package's emulator and the JAX
    package's client against the port's: metadata, config staging and the
    reinit with its new init_id read the same either way."""
    from ouster_sdk_tpu.sensor.emulator import SensorEmulator as JaxEmulator
    from ouster_sdk_tpu.sensor.http import SensorHttp as JaxHttp

    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    if client == "port":
        emu, http_cls, parse = (JaxEmulator(_jinfo(info), lambda: iter(()),
                                            http_port=0, lidar_port=lp,
                                            imu_port=ip),
                                SensorHttp, pt.sensor_info_from_metadata)
    else:
        emu, http_cls, parse = _emulator(info), JaxHttp, jax_sensor_info
    emu.start()
    try:
        h = http_cls.create(f"127.0.0.1:{emu.http_port}")
        rt = parse(h.metadata())
        assert (rt.sn, rt.format.columns_per_frame, rt.config.udp_port_lidar
                ) == (info.sn, 512, lp)
        h.set_config_param("azimuth_window", [0, 90000])
        h.set_config_param("signal_multiplier", 2)
        h.reinitialize()
        active = h.active_config_params()
        assert active["azimuth_window"] == [0, 90000]
        assert active["signal_multiplier"] == 2
        assert parse(h.metadata()).init_id == info.init_id + 1
    finally:
        emu.stop()


def test_emulator_metadata_equals_the_jax_emulators():
    from ouster_sdk_tpu.sensor.emulator import SensorEmulator as JaxEmulator

    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    info.init_id = 77
    bodies = []
    for emu in (_emulator(info), JaxEmulator(_jinfo(info), lambda: iter(()),
                                             http_port=0, lidar_port=lp,
                                             imu_port=ip)):
        emu.start()
        try:
            h = SensorHttp.create(f"127.0.0.1:{emu.http_port}")
            bodies.append(json.loads(h.metadata()))
        finally:
            emu.stop()
    assert bodies[0] == bodies[1]
    assert bodies[0]["sensor_info"]["initialization_id"] == 77


def test_emulator_restamps_init_id_after_a_reinit():
    """After a reinit every lidar packet carries the new init_id, so a
    client holding the new metadata passes its id check."""
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    info.init_id = 500
    frames = {f: frame_packets(info, f) for f in (1, 2)}
    emu = _emulator(info, frames, rate=4.0, loop=True).start()
    src = None
    try:
        h = SensorHttp.create(f"127.0.0.1:{emu.http_port}")
        h.reinitialize()
        new = pt.sensor_info_from_metadata(h.metadata())
        assert new.init_id == 501
        # the sockets open after the reinit: every packet they get was
        # sent after it
        src = pt.sensor.SensorPacketSource(["127.0.0.1"], sensor_info=[new])
        got, deadline = [], time.monotonic() + 10
        while len(got) < N_PKTS and time.monotonic() < deadline:
            _, pkt = src.get_packet(timeout_sec=0.5)
            if pkt is not None:
                got.append(pkt)
        pf = pt.PacketFormat.from_info(new)
        assert got and src.id_error_count == 0
        assert {pf.init_id(p.buf) for p in got} == {501}
    finally:
        if src is not None:
            src.close()
        emu.stop()


@pytest.mark.parametrize("ports", ["none", "ephemeral", "explicit"])
def test_init_client_port_semantics(ports):
    """None listens on the active config's ports, 0 binds an ephemeral
    port and reconfigures the sensor to send there, an explicit port is
    used as given."""
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    emu = _emulator(info).start()
    host = f"127.0.0.1:{emu.http_port}"
    arg = {"none": (None, None), "ephemeral": (0, 0),
           "explicit": (lp, ip)}[ports]
    client = None
    try:
        client, got = pt.sensor.init_client(host, *arg, timeout_sec=10)
        if ports == "ephemeral":
            assert client.lidar_port not in (0, lp)
            active = SensorHttp.create(host).active_config_params()
            assert active["udp_port_lidar"] == client.lidar_port
            assert got.config.udp_port_lidar == client.lidar_port
        else:
            assert (client.lidar_port, client.imu_port) == (lp, ip)
    finally:
        if client is not None:
            client.close()
        emu.stop()


def test_mdns_responder_answers_a_unicast_query():
    """The emulator's advertiser (mdns=True) answers a PTR question sent
    straight to it, and its answer is the JAX package's, byte for byte."""
    from ouster_sdk_tpu.sensor import mdns as jmdns
    from ouster_sdk_tpu_torch.sensor import mdns

    info = live_info(*free_udp_ports(2))
    emu = _emulator(info, mdns=True, mdns_port=0).start()
    q = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        q.settimeout(5)
        q.bind(("127.0.0.1", 0))
        q.sendto(mdns.build_query(mdns.SENSOR_SERVICES),
                 ("127.0.0.1", emu.mdns_port))
        msg, (src, _) = q.recvfrom(9000)
        found = {}
        mdns._merge_response(msg, src, mdns.SENSOR_SERVICES, found)
        (rec,) = found.values()
        assert rec.port == emu.http_port and rec.addresses == ["127.0.0.1"]
        assert rec.hostname == f"os-{info.sn}"
        assert rec.txt["sn"] == str(info.sn)
        want = jmdns.MDNSResponder(f"os-{info.sn}", port=emu.http_port,
                                   txt={"pn": info.prod_line or "OS-1-128",
                                        "sn": str(info.sn)}, bind_port=0)
        try:
            assert msg == want._answers()
        finally:
            want.stop()
    finally:
        q.close()
        emu.stop()


def test_sensor_namespace_matches_jax():
    """The port's sensor package and top level carry the JAX package's
    live names, with the same values where they are constants."""
    import ouster_sdk_tpu
    import ouster_sdk_tpu.sensor as jsensor
    from ouster_sdk_tpu_torch import sensor

    public = [n for n in vars(jsensor) if not n.startswith("_")
              and not isinstance(getattr(jsensor, n), type(jsensor))]
    assert len(public) > 20
    assert [n for n in public if not hasattr(sensor, n)] == []
    for name in ("LONG_HTTP_REQUEST_TIMEOUT_SECONDS",
                 "SHORT_HTTP_REQUEST_TIMEOUT_SECONDS"):
        assert getattr(pt, name) == getattr(ouster_sdk_tpu, name)
    assert pt.SensorHttp is SensorHttp
    assert str(sensor.MIN_VERSION) == str(jsensor.MIN_VERSION)


def test_deprecated_alias_warns():
    from ouster_sdk_tpu_torch import sensor

    with pytest.warns(DeprecationWarning, match="use MIN_VERSION"):
        assert sensor.min_version == sensor.MIN_VERSION
    with pytest.raises(AttributeError):
        sensor.no_such_name


# -- scans --------------------------------------------------------------------

def test_scan_to_packets_byte_equal():
    """Each package's ScanBatcher scans of the same packets re-packetize
    to the same bytes, which batch back to the same scans."""
    import ouster_sdk_tpu
    from ouster_sdk_tpu.io.save import scan_to_packets as jax_to_packets

    info = live_info(7502, 7503)
    info.init_id = 31
    jinfo = _jinfo(info)
    frames = [p for f in (3, 4, 5) for p in frame_packets(info, f, seed=2)]
    mine = batcher_scans(pt, info, frames)
    theirs = batcher_scans(ouster_sdk_tpu, jinfo, frames)
    assert sorted(mine) == sorted(theirs) == [3, 4]
    for fid in mine:
        a = pt.io.scan_to_packets(mine[fid], info)
        b = jax_to_packets(theirs[fid], jinfo)
        assert len(a) == len(b) == N_PKTS
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
        again = batcher_scans(pt, info, [x.tobytes() for x in a]
                              + frame_packets(info, fid + 2)[:1])
        assert_scans_equal(again[fid], mine[fid], str(fid))


@pytest.mark.parametrize("soft", [False, True])
def test_id_check(soft):
    """A packet whose serial does not match the metadata is dropped and
    counted; soft_id_check counts it and passes it on."""
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    info.sn, info.init_id = 999111, 1234
    src = pt.sensor.SensorPacketSource(["127.0.0.1"], sensor_info=[info],
                                       soft_id_check=soft)
    try:
        pw = pt.PacketWriter(info.format)
        buf = pw.new_packet()
        pw.set_packet_header(buf, init_id=1234, prod_sn=42)
        pw.set_frame_id(buf, 1)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(buf.tobytes(), ("127.0.0.1", lp))
        got, deadline = None, time.monotonic() + 5
        while src.id_error_count == 0 and time.monotonic() < deadline:
            _, got = src.get_packet(timeout_sec=0.5)
        assert src.id_error_count == 1
        if soft and got is None:
            _, got = src.get_packet(timeout_sec=2)
        assert (got is not None) == soft
    finally:
        src.close()


@pytest.mark.parametrize("engine", ["device", "numpy"])
def test_live_scans_equal_both_batchers(engine):
    """SensorScanSource over the port's emulator gives, for every frame
    whose packets all arrived, the port's and the JAX package's
    ScanBatcher scans of the packets received (receive times included),
    and those frames' pixels as the emulator's packets carry them."""
    import ouster_sdk_tpu

    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    frames = {f: frame_packets(info, f, seed=1) for f in range(1, 6)}
    emu = _emulator(info, frames, rate=2.0)
    src = ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                              engine=engine, device="cpu", queue_size=8)
    recorded = chip_smoke.record_lidar(src._packets)
    de.stats["batches"] = 0
    try:
        assert src.engine_used == [engine]
        emu.start()
        got = collect_scans(src, 4)
        emu.join(10)
    finally:
        src.close()
        emu.stop()
    assert all(i == 0 for i, _ in got)
    assert (de.stats["batches"] > 0) == (engine == "device")
    assert all(s.fields_deferred == (engine == "device") for _, s in got)
    mine = chip_smoke.recorded_oracle(pt, info, recorded)
    theirs = chip_smoke.recorded_oracle(ouster_sdk_tpu, _jinfo(info),
                                        recorded)
    sent = batcher_scans(pt, info, [p for v in frames.values() for p in v])
    whole = [s for _, s in got if _all_arrived(s)]
    assert whole, "no frame arrived whole"
    for s in whole:
        assert_scans_equal(s, mine[s.frame_id], f"port {s.frame_id}")
        assert_scans_equal(s, theirs[s.frame_id], f"jax {s.frame_id}")
        for name in s.fields:
            np.testing.assert_array_equal(s.field(name),
                                          sent[s.frame_id].field(name))


@pytest.mark.parametrize("env", ["1", "0"])
def test_engine_auto_follows_the_policy(env, monkeypatch):
    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_DECODE", env)
    info = live_info(*free_udp_ports(2))
    src = ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                              device="cpu")
    try:
        assert src.engine_used == [{"1": "device", "0": "numpy"}[env]]
        assert (src._stagers[0] is not None) == (env == "1")
    finally:
        src.close()
    with pytest.raises(ValueError, match="engine"):
        ss.SensorScanSource(["127.0.0.1"], sensor_info=[info], engine="gpu")


@pytest.mark.parametrize("how", ["sensor_info", "http"])
def test_open_source_on_a_host(how):
    """open_source("<host>:<port>") opens a SensorScanSource, from the
    metadata given or from the sensor's HTTP plane, on the device asked
    for; its scans carry the served sensor's frames."""
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    frames = {f: frame_packets(info, f, seed=4) for f in range(1, 5)}
    emu = _emulator(info, frames, rate=2.0, loop=(how == "http"))
    kw = {"sensor_info": [info]} if how == "sensor_info" else {}
    if how == "http":
        emu.start()
    src = pt.open_source(f"127.0.0.1:{emu.http_port}", lidar_port=lp,
                         imu_port=ip, device="cpu", timeout=10.0, **kw)
    try:
        assert isinstance(src, ss.SensorScanSource) and src.is_live
        assert src.engine_used == ["device"] and src.device.type == "cpu"
        assert src.sensor_info[0].sn == info.sn
        if how == "sensor_info":
            emu.start()
        sent = batcher_scans(pt, info, [p for v in frames.values()
                                        for p in v])
        it = iter(src)
        whole = None
        deadline = time.monotonic() + 20
        while whole is None and time.monotonic() < deadline:
            scan = next(it)[0]
            if scan is not None and _all_arrived(scan) \
                    and scan.frame_id in sent:
                whole = scan
        assert whole is not None, "no frame arrived whole"
        np.testing.assert_array_equal(whole.field("RANGE"),
                                      sent[whole.frame_id].field("RANGE"))
    finally:
        src.close()
        emu.stop()


def test_scan_queue_drops_oldest_and_refuses_size_zero():
    info = live_info(*free_udp_ports(2))
    with pytest.raises(ValueError, match="queue_size"):
        pt.sensor.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                                   queue_size=0, device="cpu")
    with pytest.raises(pt.SourceURLException, match="queue_size"):
        pt.open_source("127.0.0.1", sensor_info=[info], queue_size=0,
                       device="cpu")
    src = ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                              queue_size=2, device="cpu")
    try:
        scans = [pt.LidarScan(info) for _ in range(5)]
        for k, s in enumerate(scans):
            s.frame_id = k
            src._emit(0, s)
        assert src.dropped_scans == 3
        assert [src.get_scan(0.1)[1].frame_id for _ in range(2)] == [3, 4]
        assert src.get_scan(0.1) == (None, None)
    finally:
        src.close()


def test_client_timeout_names_the_sensor():
    info = live_info(*free_udp_ports(2))
    src = ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                              timeout=0.3, device="cpu")
    try:
        with pytest.raises(ss.ClientTimeout,
                           match=f"from sensor {info.sn} .* on port "
                           f"{info.config.udp_port_lidar}"):
            next(iter(src))
    finally:
        src.close()
    packets = pt.sensor.SensorPacketSource(["127.0.0.1"], sensor_info=[info],
                                           timeout=0.3)
    try:
        with pytest.raises(ss.ClientTimeout, match="No packets"):
            next(iter(packets))
    finally:
        packets.close()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_unusable_device_raises_from_the_constructor(device, monkeypatch):
    """No GPU: the default device and an explicit "cuda" raise when the
    source is built (not later on its thread), and its sockets are closed
    again."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                            device=device)
    with pytest.raises(pt.SourceURLException, match="CUDA is not available"):
        pt.open_source("127.0.0.1", sensor_info=[info], device=device)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("", lp))            # the port is free again
    s.close()
    # the numpy route needs no device
    monkeypatch.setenv("OUSTER_SDK_TPU_DEVICE_DECODE", "0")
    ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                        device=device).close()


def test_batcher_thread_failure_is_reraised(monkeypatch):
    """A decode that fails on the batcher thread reaches the consumer as
    that failure from get_scan and from iteration, not as a timeout."""
    def broken(*a, **k):
        raise RuntimeError("decode failed on the device")

    monkeypatch.setattr(de, "decode_frame_planar_batch", broken)
    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip)
    frames = {f: frame_packets(info, f) for f in (1, 2, 3)}
    emu = _emulator(info, frames, rate=4.0)
    src = ss.SensorScanSource(["127.0.0.1"], sensor_info=[info],
                              device="cpu", timeout=30.0)
    try:
        emu.start()
        deadline = time.monotonic() + 20
        with pytest.raises(RuntimeError, match="batcher thread failed") as e:
            while time.monotonic() < deadline:
                src.get_scan(timeout_sec=0.5)
        assert "decode failed on the device" in str(e.value.__cause__)
        with pytest.raises(RuntimeError, match="decode failed"):
            next(iter(src))
        assert not src._thread.is_alive()
    finally:
        src.close()
        emu.stop()


# -- the planar live ingest ---------------------------------------------------

def _assembled(info, packets):
    asm = pt.PlanarStreamAssembler(info)
    out = []
    for p in packets:
        rel = asm.push(pt.LidarPacket(p, 7))
        if rel is not None:
            out.append((rel[0], rel[1].copy(), rel[2].copy(), rel[3]))
    rel = asm.flush()
    out.append((rel[0], rel[1].copy(), rel[2].copy(), rel[3]))
    return out


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("profile", ["RNG19_RFL8_SIG16_NIR16",
                                     "RNG19_RFL8_SIG16_NIR16_DUAL"])
def test_planar_stream_assembler_matches_jax(route, profile, monkeypatch):
    from ouster_sdk_tpu.io.frames import PlanarStreamAssembler as JaxAsm
    from ouster_sdk_tpu.utils import native as jnative

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's assembler needs its native library")
    info = live_info(7502, 7503, profile=profile)
    packets = [p for f in (1, 2, 3) for p in frame_packets(info, f)]
    del packets[40]                      # a lost packet in frame 2
    jasm = JaxAsm(_jinfo(info))
    want = []
    for p in packets:
        rel = jasm.push(p)
        if rel is not None:
            want.append((rel[0], rel[1].copy(), rel[2].copy()))
    rel = jasm.flush()
    want.append((rel[0], rel[1].copy(), rel[2].copy()))
    if route == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    native.reset_calls()
    got = _assembled(info, packets)
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 2, 3]
    assert all(g[3] == 7 for g in got)
    for (_, p, h, _), (_, wp, wh) in zip(got, want):
        assert p.dtype == wp.dtype and p.shape == wp.shape
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(h, wh)
    assert native.calls["group_frames_planar"] == (3 if route == "native"
                                                   else 0)


def test_live_planar_ingest_matches_jax():
    """emulator -> SensorPacketSource -> PlanarStreamAssembler ->
    decode_planar + project_planar on the CPU, against the JAX package's
    decode_frame_planar and its planar projection in interpret mode on the
    same planes; RANGE against PacketFormat's read of the packets."""
    from ouster_sdk_tpu.ops.fused import ScanPipeline as JaxPipeline
    from ouster_sdk_tpu.ops.unpack import decode_frame_planar

    lp, ip = free_udp_ports(2)
    info = live_info(lp, ip, profile="RNG19_RFL8_SIG16_NIR16_DUAL")
    frames = {f: frame_packets(info, f, seed=5) for f in (1, 2, 3)}
    emu = _emulator(info, frames, rate=2.0)
    src = pt.sensor.SensorPacketSource(["127.0.0.1"], sensor_info=[info])
    asm = pt.PlanarStreamAssembler(info)
    released, counts = [], {}
    try:
        emu.start()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and len(released) < 2:
            _, pkt = src.get_packet(timeout_sec=0.5)
            if pkt is None:
                continue
            fid = asm.pf.frame_id(pkt.buf)
            counts[fid] = counts.get(fid, 0) + 1
            rel = asm.push(pkt)
            if rel is not None and counts.get(rel[0]) == N_PKTS:
                released.append((rel[0], rel[1].copy(), rel[2].copy()))
    finally:
        src.close()
        emu.stop()
    assert released, "no frame arrived whole"
    pipe = pt.ScanPipeline(info, device="cpu")
    jinfo = _jinfo(info)
    jpipe = JaxPipeline(jinfo)
    pk.reset_launches()
    for fid, planes, hdrs in released:
        fields = pipe.decode_planar(planes, hdrs)
        want = decode_frame_planar(jnp.asarray(planes), jnp.asarray(hdrs),
                                   jpipe.cfg.plan)
        assert sorted(fields) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(fields[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        got = pipe.project_planar(planes[None], hdrs[None])
        jwant = jpipe.project_planar(jnp.asarray(planes[None]),
                                     jnp.asarray(hdrs[None]),
                                     engine="pallas")
        for g, w in zip(got, jwant):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32))
        pf = pt.PacketFormat.from_info(info)
        bufs = np.stack([np.frombuffer(p, np.uint8) for p in frames[fid]])
        rng = np.concatenate(list(pf.packet_field_all("RANGE", bufs)),
                             axis=1)
        st = np.concatenate([pf.col_status(b) for b in bufs]) & 1
        np.testing.assert_array_equal(fields["RANGE"].numpy(),
                                      np.where(st[None, :] != 0, rng, 0))
    assert sum(pk.launches.values()) == 0    # CPU tensors launch nothing
    assert {fid for fid, *_ in released} <= set(frames)
