"""A rig of sensors in one capture, in numpy alone: each sensor's metadata
made from a configuration's shared `metadata` and its entry under `rig`,
its frames drawn from (seed, sensor, frame index), and one pcap that holds
every sensor's lidar packets in host-time order, each sensor on its own
ports, with each sensor's metadata beside it.

A rig entry gives what differs between the sensors: `prod_sn`,
`initialization_id`, `udp_port_lidar`, `udp_port_imu`, `extrinsic` (4 x 4,
the sensor's frame in the rig's, translation in metres as the SDK's
extrinsics take it) and `time_offset_ns` (when its frames begin after the
first sensor's; whole microseconds, as a pcap keeps host times).
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Iterable, List, Tuple

import numpy as np

from . import synth

UDP_AT = 16 + 14 + 20       # a datagram's UDP header in its first record


def sensor_metadata(config: dict, k: int) -> dict:
    """The metadata of the rig's sensor `k`."""
    meta = copy.deepcopy(config["metadata"])
    entry = config["rig"][k]
    meta["sensor_info"]["prod_sn"] = entry["prod_sn"]
    meta["sensor_info"]["initialization_id"] = entry["initialization_id"]
    meta["config_params"]["udp_port_lidar"] = entry["udp_port_lidar"]
    meta["config_params"]["udp_port_imu"] = entry["udp_port_imu"]
    return meta


def extrinsic(config: dict, k: int) -> np.ndarray:
    return np.asarray(config["rig"][k]["extrinsic"], np.float64)


def sensor_seed(seed: int, k: int) -> int:
    """The seed of sensor k's frames: the first sensor's are the seed's own
    (synth.random_frame), each other's a stream of their own."""
    return seed + k * (1 << 62)


def rig_frame(config: dict, sensor: synth.Sensor, data: dict, seed: int,
              k: int, index: int) -> dict:
    """Frame `index` of sensor k: synth.random_frame from the sensor's
    seed, its column and packet times moved by its offset."""
    offset = int(config["rig"][k]["time_offset_ns"])
    if offset % 1000:
        raise ValueError("time_offset_ns must be whole microseconds")
    frame = synth.random_frame(sensor, data, sensor_seed(seed, k), index)
    frame["col_ts"] = frame["col_ts"] + np.uint64(offset)
    frame["pkt_ts"] = frame["pkt_ts"] + np.uint64(offset)
    return frame


class RigPcapWriter(synth.PcapWriter):
    """synth.PcapWriter with each datagram's own UDP port (source and
    destination): the datagrams are cut into fragments as there, then each
    one's first record gets its port."""

    def write(self, payloads: np.ndarray, host_ts: np.ndarray,
              ports: np.ndarray) -> None:
        out, self._f = self._f, io.BytesIO()
        try:
            super().write(payloads, host_ts)
            recs = np.frombuffer(self._f.getbuffer(), np.uint8) \
                .reshape(len(payloads), -1).copy()
        finally:
            self._f = out
        udp = np.repeat(np.asarray(ports, ">u2")[:, None], 2, axis=1)
        recs[:, UDP_AT:UDP_AT + 4] = udp.view(np.uint8)
        out.write(recs.tobytes())


def write_capture(directory: str, config: dict, data: dict, seed: int,
                  n_frames: int, missing: Iterable[Tuple[int, int]] = ()
                  ) -> Tuple[str, List[str]]:
    """Write `n_frames` frames of every sensor of the rig as rig.pcap, in
    host-time order, with sensor-<k>.json beside it; `missing` holds
    (sensor, frame index) pairs left out. Returns the pcap's path and the
    metadata paths in sensor order. Every file is written under a
    temporary name, synced and renamed (synth.write_capture)."""
    os.makedirs(directory, exist_ok=True)
    n = len(config["rig"])
    metas = [sensor_metadata(config, k) for k in range(n)]
    sensors = [synth.Sensor(m) for m in metas]
    ports = [int(e["udp_port_lidar"]) for e in config["rig"]]
    first = min(int(e["time_offset_ns"]) for e in config["rig"])
    missing = set(missing)
    path = os.path.join(directory, "rig.pcap")
    meta_paths = [os.path.join(directory, f"sensor-{k}.json")
                  for k in range(n)]
    writer = RigPcapWriter(path + ".partial")
    held = []                   # (payloads, host ts, ports) not yet written
    try:
        for index in range(n_frames):
            for k in range(n):
                if (k, index) in missing:
                    continue
                frame = rig_frame(config, sensors[k], data, seed, k, index)
                pay = synth.frame_payloads(sensors[k], frame)
                held.append((pay, frame["pkt_ts"],
                             np.full(len(pay), ports[k], np.int64)))
            # no later frame has a packet before this
            cut = synth.T0_NS + (index + 1) * synth.FRAME_NS + first
            held = _write_before(writer, held, cut)
        _write_before(writer, held, None)
    finally:
        writer.close()
    for meta, mp in zip(metas, meta_paths):
        with open(mp + ".partial", "w") as f:
            json.dump(meta, f, indent=1)
    os.replace(path + ".partial", path)
    for mp in meta_paths:
        os.replace(mp + ".partial", mp)
    return path, meta_paths


def _write_before(writer: RigPcapWriter, held: list, cut):
    """Write the held datagrams stamped before `cut` (all where None) in
    host-time order, ties in sensor order; returns the rest."""
    if not held:
        return held
    pay = np.concatenate([h[0] for h in held])
    ts = np.concatenate([h[1] for h in held])
    ports = np.concatenate([h[2] for h in held])
    order = np.argsort(ts, kind="stable")
    now = order if cut is None else order[ts[order] < np.uint64(cut)]
    if now.size:
        writer.write(pay[now], ts[now], ports[now])
    rest = np.setdiff1d(order, now, assume_unique=True)
    return [(pay[rest], ts[rest], ports[rest])] if rest.size else []
