"""PointViz examples (ref: sdk/examples/viz.py): drawables, camera,
event handlers, snapshot rendering."""

from __future__ import annotations

import numpy as np

from ..viz import (AxisWithLabel, Camera, Cloud, Cuboid, Image, Label,
                   PointViz, add_default_controls)


def make_checker_board(square_size: int, reps) -> np.ndarray:
    """Checkerboard image used by the reference viz example
    (ref: examples/viz.py make_checker_board)."""
    board = np.kron([[1, 0] * reps[1], [0, 1] * reps[1]] * reps[0],
                    np.ones((square_size, square_size)))
    return board[: reps[0] * square_size * 2,
                 : reps[1] * square_size * 2]


def viz_scene(out_path: str = "viz_example.png") -> str:
    """Compose a random cloud, a cuboid, axes, a 2D image panel and a
    label, then snapshot (ref: examples/viz.py main scene)."""
    viz = PointViz("example")
    rng = np.random.RandomState(7)
    pts = rng.randn(20_000, 3).astype(np.float32) * 4
    viz.add(Cloud(pts, np.linalg.norm(pts, axis=1) / 10, palette="viridis"))

    pose = np.eye(4)
    pose[:3, 3] = (4, 4, 0)
    viz.add(Cuboid(pose, (255, 0, 0)))

    img = Image()
    img.set_image(make_checker_board(8, (4, 8)).astype(np.float32))
    img.set_position(-1.0, -0.5, 0.6, 1.0)
    viz.add(img)

    viz.add(Label("example", (0.0, 0.0, 6.0)))
    AxisWithLabel(viz, label="O", length=2.0)

    add_default_controls(viz)
    viz.camera.dolly(-3)
    viz.save_png(out_path)
    return out_path


if __name__ == "__main__":
    print(viz_scene())
