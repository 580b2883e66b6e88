"""Median over the traced window's stitches of `Stitcher.stitch`'s
returned `bundle_adjust` stage (wall ms, synchronized)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "bundle_adjust")
