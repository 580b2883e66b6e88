"""A panning camera: `views` views `step` degrees apart about the middle.
Traffic keys: `views`, and `step_deg`, a [lo, hi] range that the pool's
items spread over evenly."""

import math

import numpy as np

from stitchbench.scenes import rot_ypr, spread


def views(traffic: dict) -> int:
    return int(traffic["views"])


def draw(traffic: dict, count: int, rng: np.random.Generator) -> list:
    """Each pool item's (step,) in degrees."""
    return [(s,) for s in spread(traffic["step_deg"], count, rng)]


def cameras(angles, n: int):
    """(world-to-camera rotations (n, 3, 3), the scene's half span in
    degrees)."""
    (step,) = angles
    rots = np.stack([rot_ypr(math.radians(step * (i - (n - 1) / 2)),
                             0.0, 0.0) for i in range(n)])
    return rots, step * (n - 1) / 2
