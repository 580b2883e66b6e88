"""K1 (`ops/cuda_detect` + `csrc/detect_maps.cu`) in situ: the least time
the card could take for the traced window's detector maps (every view's
pyramid at the work scale, `roofline.k1_bound_s`) over the device time of
the window's `detect_maps_kernel` launches, in %. Nothing to read when
the window launched none."""

from stitchbench import roofline, trace

NAMES = ("detect_maps_kernel",)


def read(ctx):
    t = trace.kernel_seconds(ctx.trace, NAMES)
    if t <= 0:
        return None
    views = ctx.views_per_request * len(ctx.requests)
    return 100.0 * roofline.k1_bound_s(views, ctx.view_hw, ctx.cfg) / t
