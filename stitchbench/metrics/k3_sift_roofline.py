"""K3 (`ops/cuda_sift` + `csrc/sift_octave.cu`) in situ: the least time
the card could take for the traced window's SIFT octave maps over the
device time of the window's `sift_octave_kernel` launches, in %. Nothing
to read when the window launched none.

The work is counted here from the cell's shapes, whatever computes it
(`roofline.bound_s`: each input read once, each output written once):
every view at the work scale, its `sift_octaves` octaves by OpenCV's
halving (each octave half the last, rounded down), and per octave pixel
at S scales the maps' inputs and outputs, the octave's base read (4
bytes) and 4S + 5 float32 planes written (S + 2 DoG layers, S extremum
scores, S + 1 x- and S + 1 y-gradients, level S, the next octave's
source): 72 bytes at S = 3. Float32 operations: 2 (2k - 1) for each
separable blur of k taps (the first octave's 7-tap sigma0 pre-blur, then
the S + 2 chained increments), the S + 2 DoG differences and the
2 (S + 1) central differences of 2 each; the extremum tests, which most
pixels skip at the contrast test, are not counted. At 1080p, 4 octaves
and S = 3 the bytes bound it: 396.6 MB, 0.118 ms a pair.
"""

from __future__ import annotations

import math

from stitchbench import roofline, trace

NAMES = ("sift_octave_kernel",)
PRE_BLUR_TAPS = 7
MAX_TAPS = 15


def octave_hw(view_hw, octaves: int):
    """Each octave's (h, w): the view, then each octave half the last."""
    h, w = view_hw
    return [(h >> o, w >> o) for o in range(octaves)]


def chain_taps(scales: int, sigma0: float):
    """The taps of the S + 2 chained blurs of an octave: the increment
    sqrt(sig_s^2 - sig_(s-1)^2) from sig_s = sigma0 2^(s/S), 2 round(3
    sigma) + 1 taps, at least 3 and at most 15."""
    out = []
    for s in range(1, scales + 3):
        prev = sigma0 * 2.0 ** ((s - 1) / scales)
        cur = sigma0 * 2.0 ** (s / scales)
        d = math.sqrt(max(cur * cur - prev * prev, 1e-6))
        out.append(min(max(3, 2 * round(3 * d) + 1), MAX_TAPS))
    return out


def bytes_per_px(scales: int) -> int:
    return 4 + 4 * (4 * scales + 5)


def ops_per_px(scales: int, sigma0: float, first_octave: bool) -> int:
    taps = chain_taps(scales, sigma0)
    if first_octave:
        taps = [PRE_BLUR_TAPS] + taps
    return (sum(2 * (2 * k - 1) for k in taps) + (scales + 2)
            + 2 * 2 * (scales + 1))


def k3_bytes_ops(view_hw, det, work_megapix: float = -1.0):
    """(bytes, float32 operations) of one view's octave maps."""
    s = roofline.megapix_scale(work_megapix, view_hw)
    hw = (roofline.scaled(view_hw[0], s), roofline.scaled(view_hw[1], s))
    nbytes = ops = 0
    for o, (h, w) in enumerate(octave_hw(hw, det.sift_octaves)):
        nbytes += bytes_per_px(det.sift_scales) * h * w
        ops += ops_per_px(det.sift_scales, det.sift_sigma, o == 0) * h * w
    return nbytes, ops


def k3_bound_s(views: int, view_hw, cfg) -> float:
    nbytes, ops = k3_bytes_ops(view_hw, cfg.detector, cfg.work_megapix)
    return roofline.bound_s(views * nbytes, views * ops)


def read(ctx):
    t = trace.kernel_seconds(ctx.trace, NAMES)
    if t <= 0:
        return None
    views = ctx.views_per_request * len(ctx.requests)
    return 100.0 * k3_bound_s(views, ctx.view_hw, ctx.cfg) / t
