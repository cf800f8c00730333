"""2D image post-processing: auto-exposure and beam uniformity correction.

Rebuild of the reference image pipeline (ref: ouster_client/include/ouster/
image_processing.h:25-132, src/image_processing.cpp). Semantics match the
reference exactly (same damping, stride subsampling, percentile rules), in
numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

AE_DAMPING = 0.90          # ref: image_processing.cpp:30
AE_DEFAULT_UPDATE_EVERY = 3
AE_STRIDE = 4
AE_MIN_NONZERO_POINTS = 100
AE_DEFAULT_PERCENTILE = 0.1

BUC_DAMPING = 0.92
BUC_UPDATE_EVERY = 8


class AutoExposure:
    """Percentile contrast stretch with exponential smoothing
    (ref: image_processing.cpp:56-150)."""

    def __init__(self, lo_percentile: float = AE_DEFAULT_PERCENTILE,
                 hi_percentile: float = AE_DEFAULT_PERCENTILE,
                 update_every: int = AE_DEFAULT_UPDATE_EVERY):
        self.lo_percentile = lo_percentile
        self.hi_percentile = hi_percentile
        self.ae_update_every = max(int(update_every), 1)
        self.lo_state = -1.0
        self.hi_state = -1.0
        self.lo = -1.0
        self.hi = -1.0
        self.initialized = False
        self.counter = 0

    def _sample_percentiles(self, flat: np.ndarray) -> bool:
        sub = flat[::AE_STRIDE]
        nz = sub[sub > 0]
        if nz.size < AE_MIN_NONZERO_POINTS:
            return False
        lo_k = int(nz.size * self.lo_percentile)
        hi_k = int(nz.size * self.hi_percentile)
        part = np.partition(nz, lo_k)
        self.lo = float(part[lo_k])
        part = np.partition(nz, nz.size - hi_k - 1)
        self.hi = float(part[nz.size - hi_k - 1])
        if not self.initialized:
            self.initialized = True
            self.lo_state = self.lo
            self.hi_state = self.hi
        return True

    def __call__(self, image: np.ndarray, update_state: bool = True
                 ) -> np.ndarray:
        """Stretch in place (and return) a float image to [0, 1]."""
        if image.ndim == 3 and image.shape[-1] == 3:
            return self._apply_rgb(image, update_state)

        flat = image.reshape(-1)
        if self.counter == 0 and update_state:
            # too few nonzero samples: leave the frame raw and keep ALL
            # state (incl. the counter) frozen so sampling retries next
            # frame (ref: image_processing.cpp:88-90 unconditional return)
            if not self._sample_percentiles(flat):
                return image
        if not self.initialized:
            return image

        self._smooth_and_scale(image, update_state)
        return image

    update = __call__

    def _smooth_and_scale(self, image: np.ndarray,
                          update_state: bool) -> None:
        if update_state:
            self.lo_state = AE_DAMPING * self.lo_state \
                + (1.0 - AE_DAMPING) * self.lo
            self.hi_state = AE_DAMPING * self.hi_state \
                + (1.0 - AE_DAMPING) * self.hi

        spread = self.hi_state - self.lo_state
        with np.errstate(divide="ignore", invalid="ignore"):
            lo_hi_scale = (1.0 - (self.lo_percentile + self.hi_percentile)) \
                / spread if spread else np.inf
        if not np.isfinite(lo_hi_scale):
            image *= 0.5 / self.hi_state
        elif lo_hi_scale * (0.0 - self.lo_state) + self.lo_percentile <= 0.0:
            image -= self.lo_state
            image *= lo_hi_scale
            image += self.lo_percentile
        else:
            # affine would map 0 to a positive value; scale from hi only
            image *= (1.0 - self.hi_percentile) / self.hi_state

        np.clip(image, 0.0, 1.0, out=image)
        if update_state:
            self.counter = (self.counter + 1) % self.ae_update_every

    def _apply_rgb(self, image: np.ndarray, update_state: bool) -> np.ndarray:
        """Luminance-space RGB exposure (ref: image_processing.cpp:160+)."""
        if self.counter == 0 and update_state:
            lum = (image[..., 0] * 0.299 + image[..., 1] * 0.587
                   + image[..., 2] * 0.114)
            # as in __call__: a failed sample freezes state and skips the
            # frame entirely (ref: image_processing.cpp:88-90)
            if not self._sample_percentiles(lum.reshape(-1)):
                return image
        if not self.initialized:
            return image
        self._smooth_and_scale(image, update_state)
        return image


def _full_piv_lu_solve(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Eigen FullPivLU::solve semantics for an m x n (m >= n) system:
    full-pivot LU, forward-substitute L^-1 P b, back-substitute the rank-r
    pivot block — an exact solve of the pivot rows, not least squares."""
    lu = np.asarray(A, np.float64).copy()
    y = np.asarray(b, np.float64).copy()
    m, n = lu.shape
    col_perm = np.arange(n)
    r = 0
    for k in range(min(m, n)):
        sub = np.abs(lu[k:, k:])
        i, j = np.unravel_index(int(np.argmax(sub)), sub.shape)
        if sub[i, j] == 0.0:
            break
        i += k
        j += k
        lu[[k, i]] = lu[[i, k]]
        y[[k, i]] = y[[i, k]]
        lu[:, [k, j]] = lu[:, [j, k]]
        col_perm[[k, j]] = col_perm[[j, k]]
        r += 1
        lu[k + 1:, k] /= lu[k, k]
        lu[k + 1:, k + 1:] -= np.outer(lu[k + 1:, k], lu[k, k + 1:])
        y[k + 1:] -= lu[k + 1:, k] * y[k]
    xp = np.zeros(n)
    for k in range(r - 1, -1, -1):
        xp[k] = (y[k] - lu[k, k + 1:r] @ xp[k + 1:r]) / lu[k, k]
    out = np.zeros(n)
    out[col_perm[:r]] = xp[:r]
    return out


class BeamUniformityCorrector:
    """Removes per-row bias via median row differences + linear detrend
    (ref: image_processing.cpp BeamUniformityCorrector)."""

    def __init__(self):
        self.dark_count: Optional[np.ndarray] = None
        self.counter = 0

    @staticmethod
    def compute_dark_count(image: np.ndarray) -> np.ndarray:
        h, w = image.shape
        dark = np.zeros(h, dtype=np.float64)
        col_mask = (image != 0).any(axis=0)
        n_cols = int(col_mask.sum())
        if n_cols == 0:
            return dark
        diffs = (image[1:, col_mask].astype(np.float64)
                 - image[:-1, col_mask].astype(np.float64))
        # median per row-difference (nth_element picks n_cols//2)
        med = np.partition(diffs, n_cols // 2, axis=1)[:, n_cols // 2]
        dark[1:] = np.cumsum(med)
        # "linear fit" detrend — the reference solves the overdetermined
        # [1, i] system with Eigen FullPivLU::solve, which is NOT a
        # least-squares fit: it returns the exact solution of the 2 pivot
        # rows. Replicate that semantics (ref: image_processing.cpp
        # compute_dark_count fullPivLu().solve)
        x = np.arange(h, dtype=np.float64)
        A = np.stack([np.ones(h), x], axis=1)
        coef = _full_piv_lu_solve(A, dark)
        dark -= A @ coef
        dark -= dark.min()
        return dark

    def __call__(self, image: np.ndarray, update_state: bool = True
                 ) -> np.ndarray:
        h = image.shape[0]
        if self.dark_count is None or self.dark_count.size != h:
            self.dark_count = self.compute_dark_count(image)
        elif update_state and self.counter == 0:
            new = self.compute_dark_count(image)
            self.dark_count = self.dark_count * BUC_DAMPING \
                + new * (1.0 - BUC_DAMPING)
        self.counter = (self.counter + 1) % BUC_UPDATE_EVERY

        image -= self.dark_count[:, None].astype(image.dtype)
        np.clip(image, 0, None, out=image)
        return image

    update = __call__
