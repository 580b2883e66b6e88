"""Median over the traced window's stitches of `stitch_chain`'s returned
`seam` stage inside `host_seam_blend` (wall ms): the graph cut on the
host (`seam/graphcut`, `native/`) at the seam scale."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "seam")
