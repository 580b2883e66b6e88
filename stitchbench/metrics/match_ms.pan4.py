"""Median over the traced window's stitches of `Stitcher.stitch`'s
returned `match` stage (wall ms, synchronized): `register_views`'
`match_all`, the 2-NN matching and RANSAC of every pair of the views."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "match")
