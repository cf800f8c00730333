"""Forward-only slice semantics for scan sources.

Provides the reference ForwardSlicer behavior (ref: python/src/ouster/sdk/
util/forward_slicer.py): a python slice (including negative indices and a
negative step) is normalized into a forward window [start, stop) whose step
keeps its sign, and slicing is then performed by walking the source forward
only.  Contract (matching the reference): `slice_iter`/`slice` take an
iterator whose FIRST element sits at index `key.start`; for a negative step
they yield the selected elements in forward order — the caller reverses
(ref: python/tests/test_forward_slicer.py NormalizedSliceable).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List


def _resolve_endpoint(value, length: int, default: int) -> int:
    """Map one slice endpoint onto [0, length] python-style."""
    if value is None:
        return default
    return max(0, length + value) if value < 0 else min(value, length)


class ForwardSlicer:
    @staticmethod
    def normalize(key: slice, length: int) -> slice:
        """Resolve ``key`` against ``length`` into a forward window: the
        result always has start <= stop, while the step keeps its sign."""
        step = key.step if key.step is not None else 1
        if step == 0:
            raise ValueError("slice step cannot be zero")
        if step > 0:
            lo = _resolve_endpoint(key.start, length, 0)
            hi = _resolve_endpoint(key.stop, length, length)
        else:
            # A reversed slice selects (stop, start] — expressed forward,
            # the window is [stop+1, start+1) clipped to the sequence.
            lo = _resolve_endpoint(key.stop, length, -1) + 1
            hi = min(length, _resolve_endpoint(key.start, length, length) + 1)
        return slice(lo, hi, step)

    @staticmethod
    def _stepper(data_iter: Iterator, start: int, stop: int,
                 step: int) -> Iterator:
        """Yield every |step|-th element of the window [start, stop) from an
        iterator already positioned at ``start``.

        For a negative step the picks are anchored to the window END (the
        last selected element is always index stop-1), so that reversing the
        output equals native negative-step slicing.
        """
        span = stop - start
        if span <= 0:
            return iter(())
        if step > 0:
            skew = 0
        else:
            # forward offset of the first end-anchored pick inside the window
            step = -step
            skew = (span - 1) % step
        return itertools.islice(data_iter, skew, span, step)

    @staticmethod
    def slice_iter(data_iter: Iterator, key: slice) -> "Iterator":
        """Lazily slice a forward iterator positioned at key.start using a
        normalized key (start <= stop); negative-step selections come out in
        forward order."""
        start, stop, step = key.start, key.stop, key.step
        return ForwardSlicer._stepper(data_iter, start, stop, step)

    @staticmethod
    def slice(data_iter: Iterator, key: slice) -> List:
        """Eager version of slice_iter."""
        return list(ForwardSlicer.slice_iter(data_iter, key))
