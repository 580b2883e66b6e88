"""A rotation pair: two views, view 1 turned by -yaw/2, view 2 by +yaw/2
with pitch and roll. Traffic keys: `yaw_deg`, `pitch_deg`, `roll_deg`,
each a [lo, hi] range that the pool's items spread over evenly."""

import math

import numpy as np

from stitchbench.scenes import rot_ypr, spread


def views(traffic: dict) -> int:
    return 2


def draw(traffic: dict, count: int, rng: np.random.Generator) -> list:
    """Each pool item's (yaw, pitch, roll) in degrees."""
    return list(zip(spread(traffic["yaw_deg"], count, rng),
                    spread(traffic["pitch_deg"], count, rng),
                    spread(traffic["roll_deg"], count, rng)))


def cameras(angles, n: int):
    """(world-to-camera rotations (2, 3, 3), the scene's half span in
    degrees: the whole yaw, as the host recipe renders it)."""
    yaw, pitch, roll = angles
    y = math.radians(yaw)
    rots = np.stack([rot_ypr(-y / 2, 0.0, 0.0),
                     rot_ypr(y / 2, math.radians(pitch),
                             math.radians(roll))])
    return rots, yaw
