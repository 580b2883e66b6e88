"""K2 (`ops/cuda_warp` + `csrc/warp.cu`) in situ: the least time the card
could take for the traced window's warps (every view into its stitch's
canvas, `roofline.k2_bound_s`) over the device time of the window's
`warp_kernel` launches, in %. Nothing to read when the window launched
none."""

from stitchbench import roofline, trace

NAMES = ("warp_kernel",)


def read(ctx):
    t = trace.kernel_seconds(ctx.trace, NAMES)
    if t <= 0:
        return None
    n = ctx.views_per_request
    return 100.0 * roofline.k2_bound_s(n * len(ctx.requests), n,
                                       ctx.view_hw, ctx.cfg) / t
