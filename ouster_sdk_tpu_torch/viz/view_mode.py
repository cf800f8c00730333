"""Per-field view modes for the offscreen viz.

Rebuild of the reference view-mode machinery (ref: python/src/ouster/sdk/
viz/view_mode.py — SimpleMode with AutoExposure/BeamUniformityCorrector,
ReflMode with calibrated-reflectivity scaling, RingMode) for the headless
rasterizer: each mode turns a scan field into a [0, 1] key for cloud
coloring and image panels, and reports availability per scan/return.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.constants import ChanField
from ..ops.image_processing import AutoExposure, BeamUniformityCorrector


def _second_chan_field(field: str) -> Optional[str]:
    pairs = {ChanField.RANGE: ChanField.RANGE2,
             ChanField.SIGNAL: ChanField.SIGNAL2,
             ChanField.REFLECTIVITY: ChanField.REFLECTIVITY2,
             ChanField.FLAGS: ChanField.FLAGS2}
    return pairs.get(field)


class FieldViewMode:
    """Base protocol: a mode exposes name/names, enabled(scan, return_num)
    and prepare(scan, return_num) -> [0, 1] key
    (ref: view_mode.py:12-44 FieldViewMode)."""

    name = ""
    names: List[str] = []

    def enabled(self, scan, return_num: int = 0) -> bool:
        raise NotImplementedError

    def prepare(self, scan, return_num: int = 0):
        raise NotImplementedError


class ImageMode(FieldViewMode):
    """Mode usable for 2D image panels (ref: view_mode.py:44)."""


class CloudMode(FieldViewMode):
    """Mode usable for 3D cloud coloring (ref: view_mode.py:56)."""


class ImageCloudMode(ImageMode, CloudMode):
    """Mode usable for both (ref: view_mode.py:68)."""


class SimpleMode(ImageCloudMode):
    """AutoExposure(+ optional BeamUniformityCorrector) over one field
    (ref: view_mode.py SimpleMode)."""

    def __init__(self, field: str, *, prefix: str = "", suffix: str = "",
                 use_ae: bool = True, use_buc: bool = False):
        self._fields = [field]
        second = _second_chan_field(field)
        if second:
            self._fields.append(second)
        self._ae = [AutoExposure() if use_ae else None for _ in range(2)]
        self._buc = [BeamUniformityCorrector() if use_buc else None
                     for _ in range(2)]
        self.name = " ".join(p for p in (prefix, field, suffix) if p)
        # one display name per available return
        # (ref: view_mode.py:168-170 SimpleMode.names)
        self.names = [" ".join(p for p in (prefix, f, suffix) if p)
                      for f in self._fields]

    def enabled(self, scan, return_num: int = 0) -> bool:
        return return_num < len(self._fields) and \
            scan.has_field(self._fields[return_num])

    def prepare(self, scan, return_num: int = 0) -> Optional[np.ndarray]:
        if not self.enabled(scan, return_num):
            return None
        key = scan.field(self._fields[return_num]).astype(np.float64)
        if self._buc[return_num] is not None:
            self._buc[return_num](key)
        if self._ae[return_num] is not None:
            self._ae[return_num](key)
        return np.clip(key, 0.0, 1.0)


class ReflMode(ImageCloudMode):
    """Calibrated-reflectivity mode (ref: view_mode.py:418-455 ReflMode):
    fw >= v2.1.0 emits calibrated 0-255 reflectivity, displayed as a
    fixed /255 normalization; older firmware falls back to AutoExposure.
    When no metadata is available normalization is assumed (reference
    does the same for extra-mode construction)."""

    name = "REFLECTIVITY"

    def __init__(self, info=None):
        self._fields = [ChanField.REFLECTIVITY, ChanField.REFLECTIVITY2]
        self.names = list(self._fields)
        if info is not None:
            from ..core.types import Version
            self._normalized_refl = \
                info.get_version() >= Version.from_string("v2.1.0")
        else:
            self._normalized_refl = True
        self._ae = [AutoExposure() for _ in range(2)]

    def enabled(self, scan, return_num: int = 0) -> bool:
        return return_num < len(self._fields) and \
            scan.has_field(self._fields[return_num])

    def prepare(self, scan, return_num: int = 0) -> Optional[np.ndarray]:
        if not self.enabled(scan, return_num):
            return None
        refl = scan.field(self._fields[return_num]).astype(np.float64)
        if self._normalized_refl:
            return np.clip(refl / 255.0, 0.0, 1.0)
        key = refl.copy()
        self._ae[return_num](key)
        return np.clip(key, 0.0, 1.0)


class RingMode(CloudMode):
    """Color by beam row ring (ref: view_mode.py RingMode)."""

    name = "RING"
    names = ["RING", "RING"]

    def __init__(self, info):
        self._h = info.format.pixels_per_column

    def enabled(self, scan, return_num: int = 0) -> bool:
        return True

    def prepare(self, scan, return_num: int = 0) -> np.ndarray:
        rows = np.arange(scan.h, dtype=np.float64)[:, None]
        return np.broadcast_to((rows % 16) / 15.0,
                               (scan.h, scan.w)).copy()


def default_cloud_modes(info) -> List:
    """Mode cycle order mirrors the reference (REFL, RANGE, SIGNAL,
    NEAR_IR w/ BUC, FLAGS, RING)."""
    return [ReflMode(info),
            SimpleMode(ChanField.RANGE),
            SimpleMode(ChanField.SIGNAL),
            SimpleMode(ChanField.NEAR_IR, use_buc=True),
            SimpleMode(ChanField.FLAGS),
            RingMode(info)]


def default_image_modes(info) -> List:
    return [ReflMode(info),
            SimpleMode(ChanField.RANGE),
            SimpleMode(ChanField.SIGNAL),
            SimpleMode(ChanField.NEAR_IR, use_buc=True)]


# -- reference extra modes (ref: view_mode.py:215+, 353+, 457+;
#    model.py:57 VizExtraMode) -------------------------------------------

class RGBMode(ImageCloudMode):
    """Direct RGB channel display, normalized by dtype range
    (ref: view_mode.py:215-255 RGBMode: u8 / 255, u16 / 65535, floats
    passed through; other dtypes rejected)."""

    def __init__(self, field: str, *, info=None):
        self._info = info
        self._field = field
        self.name = field
        self.names = [field]

    def enabled(self, scan, return_num: int = 0) -> bool:
        if return_num != 0 or not scan.has_field(self._field):
            return False
        data = scan.field(self._field)
        return np.ndim(data) == 3 and data.shape[-1] == 3

    def prepare(self, scan, return_num: int = 0):
        if not self.enabled(scan, return_num):
            return None
        field = scan.field(self._field)
        if field.dtype == np.uint8:
            rgb = field / float(2 ** 8 - 1)
        elif field.dtype == np.uint16:
            rgb = field / float(2 ** 16 - 1)
        elif field.dtype in (np.float32, np.float64):
            rgb = field.astype(np.float64)
        else:
            raise TypeError(f"Unsupported field type {field.dtype}")
        return np.clip(rgb, 0.0, 1.0)


class NormalsMode(ImageCloudMode):
    """Surface-normal display: [-1, 1] components remapped to [0, 1]
    (ref: view_mode.py:353 NormalsMode)."""

    def __init__(self, field: str, *, info=None):
        self._info = info
        self._fields = [field]
        second = _second_chan_field(field)
        if second:
            self._fields.append(second)
        self.name = field
        self.names = list(self._fields)

    def enabled(self, scan, return_num: int = 0) -> bool:
        return return_num < len(self._fields) and \
            scan.has_field(self._fields[return_num])

    def prepare(self, scan, return_num: int = 0):
        if not self.enabled(scan, return_num):
            return None
        n = scan.field(self._fields[return_num]).astype(np.float64)
        return np.clip((n + 1.0) / 2.0, 0.0, 1.0)


def is_norm_reflectivity_mode(mode) -> bool:
    """True for calibrated-reflectivity modes
    (ref: view_mode.py:457-462)."""
    return isinstance(mode, ReflMode) and mode._normalized_refl


from dataclasses import dataclass as _dataclass  # noqa: E402
from typing import Callable  # noqa: E402


@_dataclass
class CloudPaletteItem:
    """Named palette (ref: view_mode.py:470)."""

    name: str
    palette: np.ndarray


@_dataclass
class VizExtraMode:
    """Factory for externally-plugged viz modes
    (ref: model.py:57-71 VizExtraMode)."""

    func: Callable[[], FieldViewMode]

    def create(self, info=None) -> FieldViewMode:
        extra_mode = self.func()
        if info is not None and hasattr(extra_mode, "_info") and \
                getattr(extra_mode, "_info", None) is None:
            extra_mode._info = info
        return extra_mode

