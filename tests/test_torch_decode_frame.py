"""The port's packet-layout decode (ops/unpack.decode_frame[_batch],
frame_words_from_packets) against the JAX package on the same staged
words, for every profile with a packet layout.

Tolerance: bit-exact, dtypes included (integer decode; float16 fields
compared by their bits). The scatter path (dense=False) moves each valid
column to its measurement id; of several columns with one id the last
wins, as the JAX package's indexed stores do on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_helpers import (DUAL, PROFILES, frames_batch, infos,
                            shuffle_measurement_ids, synth_frame, words)
from ouster_sdk_tpu.ops.unpack import decode_frame as jax_decode_frame
from ouster_sdk_tpu.ops.unpack import \
    decode_frame_batch as jax_decode_frame_batch
from ouster_sdk_tpu.ops.unpack import \
    frame_words_from_packets as jax_frame_words
from ouster_sdk_tpu.ops.unpack import make_decode_plan as jax_plan
from ouster_sdk_tpu_torch.ops.unpack import (decode_frame,
                                             decode_frame_batch,
                                             frame_words_from_packets,
                                             make_decode_plan)
from ouster_sdk_tpu_torch.state import decode_plan_from_jax_fields


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if g.dtype == np.float16:
            g, w = g.view(np.uint16), w.view(np.uint16)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _setup(profile):
    jinfo, pinfo = infos(profile)
    jplan = jax_plan(jinfo)
    plan = make_decode_plan(pinfo)
    assert plan == decode_plan_from_jax_fields(dataclasses.asdict(jplan))
    return jinfo, jplan, plan


@pytest.mark.parametrize("profile", PROFILES)
def test_decode_frame_dense_matches(profile):
    jinfo, jplan, plan = _setup(profile)
    frames = frames_batch(jinfo, jplan)
    want = jax_decode_frame_batch(jnp.asarray(frames), jplan, True, True)
    got = decode_frame_batch(words(frames), plan)
    _assert_same(got, want)
    assert all(v.is_contiguous() for v in got.values())
    _assert_same(decode_frame(words(frames[1]), plan),
                 {k: v[1] for k, v in want.items()})


@pytest.mark.parametrize("profile", PROFILES)
def test_decode_frame_scatter_matches(profile):
    """Shuffled, duplicated and out-of-frame measurement ids, on top of
    columns with their status cleared."""
    jinfo, jplan, plan = _setup(profile)
    frames = np.stack([shuffle_measurement_ids(f, jplan, seed=3 + k)
                       for k, f in enumerate(frames_batch(jinfo, jplan))])
    want = jax_decode_frame_batch(jnp.asarray(frames), jplan, False, True)
    got = decode_frame_batch(words(frames), plan, dense=False)
    _assert_same(got, want)
    status = got["status"].numpy()
    assert 0 < (status == 0).sum() < status.size   # some destinations empty
    _assert_same(decode_frame(words(frames[1]), plan, dense=False),
                 {k: v[1] for k, v in want.items()})


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "scatter"])
def test_decode_frame_keeps_invalid_columns_when_asked(dense):
    jinfo, jplan, plan = _setup(DUAL)
    frame = frames_batch(jinfo, jplan)[0]
    want = jax_decode_frame(jnp.asarray(frame), jplan, dense=dense,
                            zero_invalid=False)
    _assert_same(decode_frame(words(frame), plan, dense=dense,
                              zero_invalid=False), want)


def test_scatter_of_an_in_order_frame_is_the_dense_decode():
    jinfo, jplan, plan = _setup(DUAL)
    frames = words(frames_batch(jinfo, jplan))
    dense = decode_frame_batch(frames, plan)
    scat = decode_frame_batch(frames, plan, dense=False)
    for k, v in dense.items():
        assert torch.equal(v.view(torch.uint8), scat[k].view(torch.uint8)), k


@pytest.mark.parametrize("profile", [DUAL, "LEGACY"])
def test_frame_words_from_packets_matches(profile):
    """Packets out of order, one missing, one duplicated slot (the later
    packet wins), given as buffers and with explicit ids."""
    jinfo, jplan, plan = _setup(profile)
    frame = synth_frame(jinfo)
    order = np.random.default_rng(0).permutation(plan.n_pkts)[:-1]
    packets = [frame[i].view(np.uint8).copy() for i in order]
    late = frame[order[2]].view(np.uint8).copy()
    late[-8:] = 0xAB                      # same slot, other bytes
    packets.append(late)
    want = jax_frame_words(packets, jplan)
    got = frame_words_from_packets(packets, plan)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (got[order[2]].view(np.uint8)[-8:] == 0xAB).all()
    missing = sorted(set(range(plan.n_pkts)) - set(order.tolist()))
    assert (got[missing] == 0).all()
    m_ids = [int(i) * plan.cpp for i in order] + [int(order[2]) * plan.cpp]
    np.testing.assert_array_equal(
        frame_words_from_packets([bytes(p) for p in packets], plan, m_ids),
        jax_frame_words([bytes(p) for p in packets], jplan, m_ids))
