"""Median over the traced window's stitches of `stitch_chain`'s returned
`host_seam_blend` stage (wall ms, synchronized): `_host_seam_blend`, the
seam inputs' readback, the graph cut on the host (`seam/graphcut`,
`native/`), the multi-band blend, then the panorama's readback and crop."""

from stitchbench.metrics._stage import median_stage


def read(ctx):
    return median_stage(ctx, "host_seam_blend")
