"""Median wall ms of a serving dispatch's readback of the float32
canvases and bbox crops, from `serve`'s record."""

from stitchbench.metrics._dispatch import median_dispatch


def read(ctx):
    return median_dispatch(ctx, "readback_crop_s")
