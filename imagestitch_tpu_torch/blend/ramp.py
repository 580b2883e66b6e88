"""Seam-anchored linear-ramp blender (`imagestitch_tpu.blend.ramp`, the
reference's own compositor): the full-resolution vertical DP seam through
the overlap, weights falling linearly from 1 at the left overlap edge
through 0.5 at the seam to 0 at the right edge, and a select over the
left-exclusive, overlap and right-exclusive regions.
"""

from __future__ import annotations

import torch

from imagestitch_tpu_torch.seam.dp import dp_seam_pair, ramp_weights


def ramp_blend_pair(img1: torch.Tensor, img2: torch.Tensor,
                    mask1: torch.Tensor, mask2: torch.Tensor,
                    use_grad: bool = False,
                    max_overlap_w: int | None = None):
    """Blend two shared-frame canvases (H, W, C) with masks (H, W) along
    their DP seam (`dp_seam_pair`'s own orient "vertical" and scale 1; the
    cost kind and overlap window from the caller). Returns (pano (H, W,
    C), valid (H, W) bool, seam columns (H,))."""
    both = mask1 & mask2
    _, _, seam = dp_seam_pair(img1, img2, mask1, mask2, use_grad,
                              max_overlap_w=max_overlap_w)
    w1 = ramp_weights(both, seam)
    # the weights are the left image's: flip them when img1 lies right
    xs = torch.arange(mask1.shape[1], dtype=torch.float32,
                      device=mask1.device)[None, :]
    m1f = mask1.to(torch.float32)
    m2f = mask2.to(torch.float32)
    cx1 = (m1f * xs).sum() / m1f.sum().clamp(min=1.0)
    cx2 = (m2f * xs).sum() / m2f.sum().clamp(min=1.0)
    w1 = torch.where(cx1 <= cx2, w1, 1.0 - w1)
    zero = torch.zeros_like(w1)
    w1_full = torch.where(both, w1, zero) + (mask1 & ~mask2).to(torch.float32)
    w2_full = (torch.where(both, 1.0 - w1, zero)
               + (mask2 & ~mask1).to(torch.float32))
    out = img1 * w1_full[..., None] + img2 * w2_full[..., None]
    valid = mask1 | mask2
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out, valid, seam
