"""Median over the traced window's requests of the entry's returned
`readback_crop` stage (wall ms): `pipeline._to_uint8`, the float32
canvas and its mask read back to the host and cropped there."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "readback_crop")
