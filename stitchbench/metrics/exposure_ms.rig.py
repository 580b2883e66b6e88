"""Median over the traced window's composes of `StreamStitcher.stages_ms`
["exposure"]: the exposure compensation of a frame set warped with the
frozen registration (wall ms, synchronized)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "exposure")
