"""Shared inputs for the tests that hold the PyTorch port
(ouster_sdk_tpu_torch) against the JAX package.

Both packages get the same sensor: one metadata string parsed by each
package's own parser. Frames are synthesized with the JAX package's
writer (__graft_entry__._synth_frame) and restaged word-planar on the host
in numpy, the layout FrameReader.iter_planar_chunks produces; the
synthesized frame itself is packet-layout (FrameReader.iter_chunks).
"""

from __future__ import annotations

import os
import sys

import numpy as np
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
