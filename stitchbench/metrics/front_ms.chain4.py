"""Median over the traced window's stitches of `stitch_chain`'s returned
`front` stage (wall ms, synchronized): detect, the consecutive and skip
pairs' matching, the cameras, the bundle adjustment, wave correction, the
spherical warp and GAIN_BLOCKS, all before the host seam."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "front")
