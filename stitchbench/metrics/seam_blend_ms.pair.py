"""Median over the traced window's pairs of `stitch_pair`'s returned
`seam_blend` stage (wall ms, synchronized): the DP seam with its one
backtrack readback (`seam/dp`) and the feather blend."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "seam_blend")
