"""Voronoi seam finder (`imagestitch_tpu.seam.voronoi`, OpenCV's
VoronoiSeamFinder): each overlap pixel goes to the image whose mask
interior is farther away, by the L1 distance to the mask border.
"""

from __future__ import annotations

import torch

from imagestitch_tpu_torch.seam.distance import l1_distance_transform


def voronoi_seam_pair(mask1: torch.Tensor, mask2: torch.Tensor):
    """Resolve the overlap of two (H, W) bool masks of one canvas frame
    (ties go to mask1). Returns (mask1', mask2') with an empty
    intersection."""
    both = mask1 & mask2
    keep1 = l1_distance_transform(mask1) >= l1_distance_transform(mask2)
    return mask1 & (~both | keep1), mask2 & (~both | ~keep1)
