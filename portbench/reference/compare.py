"""The comparisons that decide `correct`."""

from __future__ import annotations

from typing import Dict

import numpy as np


# coordinates below a millimetre count as a millimetre in ulp_error: the
# float64 reference's own rounding (about 1e-12 m at 500 m) is then under a
# hundredth of the unit, where at a coordinate of a micrometre it would be
# several float32 units of that coordinate
ULP_FLOOR_M = 1e-3


def ulp_error(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest |got - ref| in float32 units in the last place of ref (of a
    millimetre, where |ref| is smaller): a correctly rounded float32
    result reads at most 0.5, plus the reference's own rounding."""
    ref = np.asarray(ref, np.float64)
    ulp = np.spacing(np.maximum(np.abs(ref), ULP_FLOOR_M)
                     .astype(np.float32)).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref) / ulp
    return float(err.max()) if err.size else 0.0


def mismatches(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
               optional=()) -> int:
    """Elements that differ, over every key of `want`; a missing key (not
    in `optional`) or a shape that differs counts every element of it."""
    n = 0
    for key, w in want.items():
        g = got.get(key)
        w = np.asarray(w)
        if g is None and key in optional:
            continue
        if g is None or np.shape(g) != w.shape:
            n += w.size
            continue
        n += int(np.count_nonzero(np.asarray(g).astype(np.int64)
                                  != w.astype(np.int64)))
    return n
