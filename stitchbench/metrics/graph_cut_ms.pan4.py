"""Median over the traced window's stitches of `Stitcher.stitch`'s
returned `seam` stage inside `seam_blend` (wall ms): the colour graph
cut on the host (`seam/graphcut`, `native/`) at the seam scale, as
`graph_cut_ms.chain4` reads it in the chain."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "seam")
