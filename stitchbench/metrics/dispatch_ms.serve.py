"""Median wall ms of a serving dispatch (`stitch_pairs_batched` to the
synchronized canvases), from `serve`'s record."""

from stitchbench.metrics._dispatch import median_dispatch


def read(ctx):
    return median_dispatch(ctx, "dispatch_s")
