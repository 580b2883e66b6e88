"""FAST-9/16 corner scores, 3x3 non-max suppression and Harris responses
as dense maps over (..., H, W) float32 — the formulation of
`imagestitch_tpu.features.fast`, with its border rules:

- FAST circle differences and Harris gradients wrap around the image;
- NMS treats out-of-image neighbours as -inf;
- the Harris box sums treat them as 0.

Together with `ops.image.gaussian_blur` these are the plain version of the
detector-maps kernel (`ops.cuda_detect`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 points in circular order (dx, dy)
CIRCLE16 = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)

ARC_LEN = 9  # FAST-9: a corner needs >= 9 contiguous brighter/darker pixels
NEG_SCORE = -3.4e38


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 score: the largest threshold at which the pixel is
    still a corner (max over 9-arcs of the arc's min |difference|), 0 where
    it is not one."""
    img = img.to(torch.float32)
    d = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1))
                     for dx, dy in CIRCLE16]) - img[None]    # (16, ..., H, W)
    d_ext = torch.cat([d, d[:ARC_LEN - 1]])                  # (24, ...)
    t = float(threshold)
    score = torch.full_like(img, NEG_SCORE)
    for k in range(16):
        win = d_ext[k:k + ARC_LEN]
        a_min = win.amin(0)
        a_max = win.amax(0)
        sb = torch.where(a_min > t, a_min, torch.full_like(a_min, NEG_SCORE))
        sd = torch.where(a_max < -t, -a_max, torch.full_like(a_max, NEG_SCORE))
        score = torch.maximum(score, torch.maximum(sb, sd))
    return score.clamp(min=0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strictly positive 3x3 local maxima (-inf outside the image)."""
    lead = score.shape[:-2]
    s4 = score.reshape((-1, 1) + score.shape[-2:])
    mx = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(score.shape)
    keep = (score >= mx) & (score > 0)
    return torch.where(keep, score, torch.zeros_like(score)).reshape(
        lead + score.shape[-2:])


def _box_zero(x: torch.Tensor, b: int) -> torch.Tensor:
    """b x b box sum with zeros outside the image: rows, then columns."""
    H, W = x.shape[-2:]
    r = b // 2
    p = F.pad(x, (0, 0, r, r))
    s = p[..., 0:H, :]
    for t in range(1, b):
        s = s + p[..., t:t + H, :]
    p = F.pad(s, (r, r, 0, 0))
    out = p[..., 0:W]
    for t in range(1, b):
        out = out + p[..., t:t + W]
    return out


def harris_map(img: torch.Tensor, block_size: int = 7,
               k: float = 0.04) -> torch.Tensor:
    """Dense Harris response: central-difference gradients, block_size box
    window, scaled by (1/(4·block·255))⁴ like the reference."""
    img = img.to(torch.float32)
    Ix = torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1)
    Iy = torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2)
    a = _box_zero(Ix * Ix, block_size)
    b = _box_zero(Iy * Iy, block_size)
    c = _box_zero(Ix * Iy, block_size)
    s4 = float(np.float32((1.0 / (4 * block_size * 255.0)) ** 4))
    return (a * b - c * c - k * (a + b) * (a + b)) * s4
