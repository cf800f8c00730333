"""Double-single (two-float) arithmetic on float32 tensors.

The reference computes XYZ in float64 (ref: ouster_client/include/ouster/
cartesian.h:36-69). Each LUT coefficient is carried as an (hi, lo) f32
pair and r * dir + off is evaluated with error-free transforms
(Dekker/Knuth), which need every product and sum rounded on its own:
PyTorch's eager elementwise ops do exactly that, one rounding per op, and
never contract a multiply-add.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_SPLITTER = 4097.0  # 2**12 + 1 for f32 Veltkamp splitting


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker fast-two-sum; requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Veltkamp split of f32 into two 12-bit-mantissa halves."""
    c = _SPLITTER * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    return a_hi, a_lo


def two_prod(a, b):
    """Dekker product: p + e == a * b exactly (no FMA)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def dd_mul_f(x_hi, x_lo, f):
    """(x_hi, x_lo) * f where f is a plain f32."""
    p, e = two_prod(x_hi, f)
    e = e + x_lo * f
    return fast_two_sum(p, e)


def dd_mul(a_hi, a_lo, b_hi, b_lo):
    """Double-single product (the a_lo*b_lo term is below the result's
    precision and dropped, per the standard Dekker recipe)."""
    p, e = two_prod(a_hi, b_hi)
    e = e + (a_hi * b_lo + a_lo * b_hi)
    return fast_two_sum(p, e)


def dd_add(x_hi, x_lo, y_hi, y_lo):
    s, e = two_sum(x_hi, y_hi)
    e = e + x_lo + y_lo
    return fast_two_sum(s, e)


def dd_to_f32(hi, lo):
    """Round a double-single pair to one float32 (tensors or arrays)."""
    return hi + lo


def split_f64_array(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a float64 numpy array into an (hi, lo) float32 pair with
    hi + lo == x to f32-pair precision."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """Correctly rounded float32 a * b + c. The product of two f32 is exact
    in f64; the f64 sum is rounded to odd (moved one ulp toward the
    residual of its two-sum when inexact and even), after which rounding
    to f32 is correct — no double-rounding error."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    inexact_even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
