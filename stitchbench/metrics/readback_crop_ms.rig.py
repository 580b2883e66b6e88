"""Median over the traced window's composes of `StreamStitcher.stages_ms`
["readback_crop"]: the pano's readback and crop on the host (wall ms)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "readback_crop")
