"""The port's image post-processing (ops/image_processing.py: AutoExposure,
BeamUniformityCorrector, numpy on the host) against the JAX package's on
the CPU: the same image stream, made from a seed, through both, with the
outputs and the state after every frame equal. Tolerance: exact (equal
float64 and float32 arrays, equal state)."""

import numpy as np
import pytest

import ouster_sdk_tpu.ops.image_processing as jip
import ouster_sdk_tpu_torch as pt
import ouster_sdk_tpu_torch.ops.image_processing as pip

AE_STATE = ("lo_state", "hi_state", "lo", "hi", "initialized", "counter")


def _frames(shape, n, dtype, seed=0, sparse=False):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        img = rng.gamma(2.0, 300.0 * (1 + k / 4), size=shape).astype(dtype)
        img[rng.random(shape) < (0.995 if sparse and k < 2 else 0.1)] = 0
        out.append(img)
    return out


@pytest.mark.parametrize("case", [
    "gray_f64", "gray_f32", "rgb", "sparse_then_dense", "no_update",
    "percentiles"])
def test_auto_exposure_equal(case):
    kw, shape, dtype, sparse = {}, (32, 256), np.float64, False
    if case == "gray_f32":
        dtype = np.float32
    if case == "rgb":
        shape = (32, 256, 3)
    if case == "sparse_then_dense":
        sparse = True
    if case == "percentiles":
        kw = dict(lo_percentile=0.02, hi_percentile=0.05, update_every=2)
    assert pt.AutoExposure is pip.AutoExposure
    j, p = jip.AutoExposure(**kw), pip.AutoExposure(**kw)
    for k, img in enumerate(_frames(shape, 7, dtype, sparse=sparse)):
        update = not (case == "no_update" and k % 2)
        a = p(img.copy(), update_state=update)
        b = j(img.copy(), update_state=update)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
        for attr in AE_STATE:
            assert getattr(p, attr) == getattr(j, attr), (k, attr)
    assert p.initialized


@pytest.mark.parametrize("case", ["f64", "f32", "height_change",
                                  "no_update", "blank_columns"])
def test_beam_uniformity_equal(case):
    dtype = np.float32 if case == "f32" else np.float64
    frames = _frames((32, 256), 10, dtype, seed=3)
    rows = np.linspace(0, 200, 32)[:, None]
    frames = [f + rows.astype(dtype) for f in frames]
    if case == "height_change":
        frames[5:] = _frames((16, 256), 5, dtype, seed=4)
    if case == "blank_columns":
        for f in frames:
            f[:, 100:180] = 0
        frames[0][:] = 0
    j, p = jip.BeamUniformityCorrector(), pip.BeamUniformityCorrector()
    for k, img in enumerate(frames):
        update = not (case == "no_update" and k in (8, 9))
        a = p(img.copy(), update_state=update)
        b = j(img.copy(), update_state=update)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert np.array_equal(p.dark_count, j.dark_count), k
        assert p.counter == j.counter


def test_full_piv_lu_solve_equal():
    rng = np.random.default_rng(7)
    for m, n in ((32, 2), (5, 3), (4, 4)):
        A = rng.normal(size=(m, n))
        b = rng.normal(size=m)
        assert np.array_equal(pip._full_piv_lu_solve(A, b),
                              jip._full_piv_lu_solve(A, b))
    A = np.zeros((6, 2))
    A[:, 0] = 1.0
    assert np.array_equal(pip._full_piv_lu_solve(A, np.arange(6.0)),
                          jip._full_piv_lu_solve(A, np.arange(6.0)))
