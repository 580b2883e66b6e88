"""Timelapse compositor (`imagestitch_tpu.timelapse.Timelapser`, OpenCV's
cv2.detail.Timelapser): each warped frame is placed alone on one common
canvas, so that a sequence of frames lands registered on a static frame.

- "as_is": the canvas is the union of the frames' rectangles;
- "crop": their intersection (an error when they do not all intersect);
- `process` writes the frame's whole rectangle at its corner (clipped to
  the canvas) over zeros, as OpenCV's does, which ignores the mask.

Host NumPy, like the JAX package's.
"""

from __future__ import annotations

import numpy as np


class Timelapser:
    """kind: "as_is" (cv2.detail.Timelapser_AS_IS) or "crop"
    (Timelapser_CROP)."""

    def __init__(self, kind: str = "as_is"):
        if kind not in ("as_is", "crop"):
            raise ValueError(f"unknown timelapser kind: {kind!r}")
        self.kind = kind
        self._roi = None            # (x0, y0, x1, y1)

    def initialize(self, corners, sizes):
        """corners: [(x, y)] top-left per frame; sizes: [(w, h)] per frame
        (OpenCV's Size order). Sets the canvas rectangle; returns self."""
        rects = [(int(x), int(y), int(x) + int(w), int(y) + int(h))
                 for (x, y), (w, h) in zip(corners, sizes)]
        x0s, y0s, x1s, y1s = zip(*rects)
        if self.kind == "as_is":
            self._roi = (min(x0s), min(y0s), max(x1s), max(y1s))
        else:
            self._roi = (max(x0s), max(y0s), min(x1s), min(y1s))
            if self._roi[2] <= self._roi[0] or self._roi[3] <= self._roi[1]:
                raise ValueError("crop timelapser: frames do not all "
                                 "intersect")
        return self

    @property
    def dst_roi(self):
        """The canvas rectangle (x0, y0, x1, y1) in pano coordinates."""
        return self._roi

    def process(self, img, corner) -> np.ndarray:
        """One frame alone on the canvas: img (h, w[, C]) with its top-left
        `corner` (x, y) in pano coordinates. Returns the (H, W[, C]) canvas
        in img's dtype, zero outside the frame."""
        if self._roi is None:
            raise RuntimeError("initialize() first")
        x0, y0, x1, y1 = self._roi
        img = np.asarray(img)
        h, w = img.shape[:2]
        dst = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
        cx, cy = int(corner[0]), int(corner[1])
        sx0, sy0 = max(x0 - cx, 0), max(y0 - cy, 0)
        sx1, sy1 = min(x1 - cx, w), min(y1 - cy, h)
        if sx1 > sx0 and sy1 > sy0:
            dst[cy + sy0 - y0:cy + sy1 - y0,
                cx + sx0 - x0:cx + sx1 - x0] = img[sy0:sy1, sx0:sx1]
        return dst
