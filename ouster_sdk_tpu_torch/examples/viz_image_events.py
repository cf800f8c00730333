"""Viz event-handler example (ref: sdk/examples/viz_image_events.py):
register mouse/key handlers, map viewport clicks onto a 2D image panel
via WindowCtx.normalized_coordinates, and react to them.

Headless: events are injected through the PointViz dispatch_* methods —
the same path an interactive front-end would use.
"""

from __future__ import annotations

import numpy as np

from ..viz import (Image, MouseButton, MouseButtonEvent, PointViz,
                   WindowCtx)


def viz_image_events(out_path: str = "viz_events.png") -> list:
    viz = PointViz("events-example")

    img = Image()
    checker = np.kron([[1, 0] * 8, [0, 1] * 8] * 4,
                      np.ones((16, 16))).astype(np.float32)
    img.set_image(checker)
    img.set_position(-0.5, 0.5, -0.5, 0.5)
    viz.add(img)

    clicks = []

    def on_mouse(ctx: WindowCtx, button, event, mods) -> bool:
        if (button == MouseButton.MOUSE_BUTTON_LEFT
                and event == MouseButtonEvent.MOUSE_BUTTON_PRESSED):
            nx, ny = ctx.normalized_coordinates(ctx.mouse_x, ctx.mouse_y)
            inside = -0.5 <= nx <= 0.5 and -0.5 <= ny <= 0.5
            clicks.append((nx, ny, inside))
            print(f"click at ndc ({nx:+.2f}, {ny:+.2f}) "
                  f"{'inside' if inside else 'outside'} the image")
        return True

    def on_key(ctx: WindowCtx, key: int, mods: int) -> bool:
        if key == ord("c"):
            img.clear_palette()
        return True

    viz.push_mouse_button_handler(on_mouse)
    viz.push_key_handler(on_key)

    # simulate a front-end: move the "mouse" to the center and click
    ctx = viz.window_context()
    ctx.mouse_x = viz.width / 2
    ctx.mouse_y = viz.height / 2
    for h in reversed(viz._mouse_handlers):
        h(ctx, MouseButton.MOUSE_BUTTON_LEFT,
          MouseButtonEvent.MOUSE_BUTTON_PRESSED, 0)
    viz.dispatch_key(ord("c"))
    viz.save_png(out_path)
    return clicks


if __name__ == "__main__":
    print(viz_image_events())
