"""Median over the traced window's requests of the entry's returned
`bundle_adjust` stage (wall ms, synchronized): the ray bundle adjustment
of `geometry/bundle`, its Levenberg-Marquardt loop with one host sync per
step."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "bundle_adjust")
