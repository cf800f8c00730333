"""Carry state built elsewhere into the port: a PlanarLut stack, the four
tensors of an XYZLutDevice, the sixteen leaves of a FactorTables and a
DecodePlan given as plain numpy / dict data (e.g. the reference package's
`np.asarray(PlanarLut(...).stack)`, `np.asarray(lut.dir_hi)`,
`np.asarray(tables.P)` and `dataclasses.asdict(plan)`), so two
implementations can be fed the same LUT, tables and plan."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .ops.lutfree_kernels import FactorTables
from .ops.planar_kernels import PlanarLut
from .ops.unpack import DecodePlan, FieldPlan
from .ops.xyzlut import XYZLutDevice


def planar_lut_from_numpy(stack: np.ndarray, device) -> PlanarLut:
    """An (18, h, w) float32 LUT stack -> PlanarLut on `device`."""
    stack = np.asarray(stack)
    if stack.ndim != 3 or stack.shape[0] != 18:
        raise ValueError(f"LUT stack must be (18, h, w), got {stack.shape}")
    return PlanarLut.from_stack(stack, device)


def xyz_lut_device_from_numpy(dir_hi: np.ndarray, dir_lo: np.ndarray,
                              off_hi: np.ndarray, off_lo: np.ndarray,
                              device) -> XYZLutDevice:
    """Four (h, w, 3) float32 arrays, the (hi, lo) splits of direction and
    offset -> XYZLutDevice on `device`."""
    arrays = [np.asarray(a) for a in (dir_hi, dir_lo, off_hi, off_lo)]
    for a in arrays:
        if a.ndim != 3 or a.shape[-1] != 3 or a.shape != arrays[0].shape:
            raise ValueError(f"LUT arrays must all be (h, w, 3), got "
                             f"{[x.shape for x in arrays]}")
    return XYZLutDevice(*(torch.from_numpy(
        np.array(a, dtype=np.float32, order="C")).to(device)
        for a in arrays))


def factor_tables_from_numpy(leaves: Dict[str, np.ndarray], device
                             ) -> FactorTables:
    """The sixteen FactorTables leaves as numpy arrays, keyed by the names
    in FactorTables._LEAVES (P, Q, S, E, F, G as (3, h, 1), ce, se as
    (1, w), each with its `_lo`) -> FactorTables on `device`."""
    return FactorTables.from_leaves(leaves, device)


def decode_plan_from_jax_fields(fields: Dict[str, Any]) -> DecodePlan:
    """DecodePlan from the dict of its fields (dataclasses.asdict form:
    field plans as dicts)."""
    d = dict(fields)
    d["fields"] = tuple(FieldPlan(**dict(f)) for f in d["fields"])
    return DecodePlan(**d)
