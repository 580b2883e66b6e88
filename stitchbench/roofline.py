"""The table of peaks and the operations and bytes of the program's kernels,
from the shapes a cell launches them at: the yardstick of the `_roofline`
metrics. The arithmetic is that of the kernel table in PERF.md (copied
from `chip_smoke.py`, where the kernels are timed alone): bound = the
larger of bytes / HBM rate and float32 operations / the float32 rate, each
input read once and each output written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, published peaks (dense): HBM3 and float32 outside the
# tensor cores, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# detector maps (K1), float32 operations per pixel of a pyramid level, at
# most: FAST 118 (16 differences, the arcs' min / max tree, the
# threshold), NMS 11, Harris 49, the 7x7 blur 26; bytes per pixel: the
# level read once (4) and three float32 maps written once (12)
K1_OPS_PER_PX = 118 + 11 + 49 + 26
K1_BYTES_PER_PX = 16
# warp (K2), per canvas pixel and view: the 3x3 projection 15, 2 divides,
# 8 compares, the bilinear blend 3 x 6; per canvas row and column: a
# divide by the scale and a sincos (41); bytes: the view read once as
# float32, per canvas pixel three float32 channels and a mask byte written
K2_OPS_PER_PX = 15 + 2 + 8 + 18
K2_OPS_PER_LINE = 1 + 40
K2_BYTES_PER_PX = 3 * 4 + 1


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def megapix_scale(megapix: float, hw) -> float:
    """OpenCV stitching_detailed's work / compose scale."""
    if megapix <= 0:
        return 1.0
    return min(1.0, math.sqrt(megapix * 1e6 / (hw[0] * hw[1])))


def scaled(d: int, s: float) -> int:
    return max(int(round(d * s)), 1)


def k1_pixels(view_hw, work_megapix: float, nlevels: int,
              scale_factor: float, first_level: int = 0) -> int:
    """Pyramid pixels one view puts through K1: the view at the work
    scale, each level cvRound(size / scale_factor^(level - first))."""
    s = megapix_scale(work_megapix, view_hw)
    h, w = scaled(view_hw[0], s), scaled(view_hw[1], s)
    px = 0
    for lv in range(nlevels):
        f = scale_factor ** (lv - first_level)
        px += int(round(h / f)) * int(round(w / f))
    return px


def k1_bound_s(views: int, view_hw, cfg) -> float:
    d = cfg.detector
    px = views * k1_pixels(view_hw, cfg.work_megapix, d.nlevels,
                           d.scale_factor, d.first_level)
    return bound_s(K1_BYTES_PER_PX * px, K1_OPS_PER_PX * px)


def canvas_hw(view_hw, n_views: int, cfg):
    """The shared canvas a stitch of `n_views` warps each view into (the
    program's static capacity), at the compose scale."""
    s = megapix_scale(cfg.compose_megapix, view_hw)
    h, w = scaled(view_hw[0], s), scaled(view_hw[1], s)
    return (int(round(h * cfg.warp.canvas_scale_h)),
            int(round(w * (1.0 + (cfg.warp.canvas_scale_w - 1.0)
                           * max(n_views - 1, 1)))))


def k2_bound_s(views: int, n_per_stitch: int, view_hw, cfg) -> float:
    """`views` views warped, each into the canvas of a stitch of
    `n_per_stitch` views."""
    s = megapix_scale(cfg.compose_megapix, view_hw)
    src = scaled(view_hw[0], s) * scaled(view_hw[1], s) * 3 * 4
    hc, wc = canvas_hw(view_hw, n_per_stitch, cfg)
    nbytes = views * (src + K2_BYTES_PER_PX * hc * wc)
    ops = views * (K2_OPS_PER_PX * hc * wc + K2_OPS_PER_LINE * (hc + wc))
    return bound_s(nbytes, ops)
