"""Median over the traced window's requests of the entry's returned
`readback_bytes` counter, in MB (1e6 bytes): every image-sized array a
request reads back to the host (the canvas and its mask, the DP
backtrack's choices, a host seam's inputs)."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "readback_bytes", 1e-6)
