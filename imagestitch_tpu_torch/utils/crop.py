"""Pano autocrop (`imagestitch_tpu.utils.crop`): the largest axis-aligned
rectangle of valid pixels, by the maximal-rectangle recurrence over rows,
on the host after the pano's readback.

Per row, with height[j] the run of valid rows ending there at column j:
left[j] = max(left_prev[j], 1 + the last invalid column <= j) (a running
max), right[j] = min(right_prev[j], the first invalid column >= j) (a
reversed running min), area[j] = (right[j] - left[j]) · height[j]. Ties
go as in the JAX package: the first best column in a row, then the first
best row.
"""

from __future__ import annotations

import numpy as np


def largest_interior_rect(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool -> int32[4] (y0, x0, h, w), the largest all-valid
    axis-aligned rectangle; (0, 0, 0, 0) for a mask with no valid pixel."""
    mask = np.asarray(mask, bool)
    H, W = mask.shape
    jdx = np.arange(W, dtype=np.int64)
    height = np.zeros(W, np.int64)
    left = np.zeros(W, np.int64)
    right = np.full(W, W, np.int64)
    best = (0, 0, 0, 0, 0)                      # area, row, h, left, right
    for i in range(H):
        row = mask[i]
        height = np.where(row, height + 1, 0)
        cur_left = np.maximum.accumulate(np.where(row, 0, jdx + 1))
        left = np.where(row, np.maximum(left, cur_left), 0)
        cur_right = np.minimum.accumulate(
            np.where(row, W, jdx)[::-1])[::-1]
        right = np.where(row, np.minimum(right, cur_right), W)
        area = (right - left) * height
        j = int(np.argmax(area))
        if area[j] > best[0]:
            best = (int(area[j]), i, int(height[j]), int(left[j]),
                    int(right[j]))
    area, i, h, lft, rgt = best
    if area <= 0:
        return np.zeros(4, np.int32)
    return np.asarray([i + 1 - h, lft, h, rgt - lft], np.int32)


def autocrop(pano: np.ndarray, mask: np.ndarray):
    """Crop `pano` (H, W[, C]) to the largest interior rectangle of `mask`
    (H, W bool). Returns (cropped, (y0, x0, h, w))."""
    y0, x0, h, w = (int(v) for v in largest_interior_rect(mask))
    return np.asarray(pano)[y0:y0 + h, x0:x0 + w], (y0, x0, h, w)
