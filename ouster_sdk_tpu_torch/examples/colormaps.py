"""Colormap example (ref: sdk/examples/colormaps.py): colorize a range
image with each available palette and save a strip PNG."""

from __future__ import annotations

import numpy as np

from .. import ChanField, destagger, open_source
from ..viz.core import COLORMAPS, colorize


def colormap_strip(source_file: str, out_path: str = "colormaps.png"
                   ) -> str:
    """Render one destaggered range image under every palette, stacked
    vertically."""
    src = open_source(source_file, sensor_idx=0)
    scan = next(iter(src))
    rng = destagger(src.metadata,
                    scan.field(ChanField.RANGE).astype(np.float64))
    lo, hi = np.percentile(rng[rng > 0], [5, 95]) if (rng > 0).any() \
        else (0, 1)
    key = np.clip((rng - lo) / max(hi - lo, 1), 0, 1).astype(np.float32)
    rows = [colorize(key, name) for name in sorted(COLORMAPS)]
    strip = np.concatenate(rows, axis=0)

    from ..utils import png as png_codec

    with open(out_path, "wb") as f:
        f.write(png_codec.encode(strip, png_codec.COLOR_RGB, 8))
    return out_path


if __name__ == "__main__":
    import sys

    print(colormap_strip(sys.argv[1]))
