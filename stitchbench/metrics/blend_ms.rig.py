"""Median over the traced window's composes of `StreamStitcher.stages_ms`
["blend"]: the blend of a frame set with the frozen seam masks (wall ms,
synchronized)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "blend")
