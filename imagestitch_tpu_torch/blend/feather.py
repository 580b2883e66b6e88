"""Feather blender (OpenCV FeatherBlender, `imagestitch_tpu.blend.
feather`): weights min(DT_L1(mask)·sharpness, 1) and a normalized
weighted sum over N shared-frame canvases."""

from __future__ import annotations

import math

import torch

from imagestitch_tpu_torch.seam.distance import l1_distance_transform

WEIGHT_EPS = 1e-5  # OpenCV Blender::blend's normalization epsilon


def feather_weights(mask: torch.Tensor, sharpness: float = 5.0
                    ) -> torch.Tensor:
    """For sharpness >= 1 the weights are exactly the mask (the interior L1
    distance is >= 1); below 1 they saturate at distance 1/sharpness."""
    if sharpness >= 1.0:
        return mask.to(torch.float32)
    dmax = int(math.ceil(1.0 / float(sharpness))) + 1
    return (l1_distance_transform(mask, max_dist=dmax)
            * sharpness).clamp(max=1.0)


def feather_blend(images: torch.Tensor, masks: torch.Tensor,
                  sharpness: float = 5.0):
    """(N, H, W, C) x (N, H, W) bool -> ((H, W, C), (H, W) bool)."""
    w = feather_weights(masks, sharpness)
    wsum = w.sum(dim=0)
    out = (images * w[..., None]).sum(dim=0) / (wsum[..., None] + WEIGHT_EPS)
    valid = masks.any(dim=0)
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out, valid
