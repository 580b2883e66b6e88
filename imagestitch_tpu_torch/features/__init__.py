from imagestitch_tpu_torch.features.orb import (detect_and_compute, orb_maps,
                                                orb_select)
from imagestitch_tpu_torch.features.sift import detect_and_compute_sift
from imagestitch_tpu_torch.features.fast import (fast_score_map, harris_map,
                                                 nms3x3)
from imagestitch_tpu_torch.features.pattern import (brief_pattern,
                                                    ic_angle_offsets)
from imagestitch_tpu_torch.types import stack

__all__ = [
    "detect",
    "detect_batched",
    "detect_and_compute",
    "detect_and_compute_sift",
    "fast_score_map",
    "harris_map",
    "nms3x3",
    "brief_pattern",
    "ic_angle_offsets",
]


def detect(gray, cfg):
    """Detector dispatch on cfg.kind ("orb" | "sift") -> ImageFeatures."""
    if cfg.kind == "sift":
        return detect_and_compute_sift(
            gray, cfg, num_octaves=cfg.sift_octaves,
            scales_per_octave=cfg.sift_scales, sigma0=cfg.sift_sigma,
            contrast_thresh=cfg.sift_contrast_thresh)
    return detect_and_compute(gray, cfg)


def detect_batched(grays, cfg):
    """(N, H, W) grayscale images -> ImageFeatures with a leading image
    axis. ORB builds the pyramid once on the batch and takes every level's
    detector maps of all N images from one kernel launch, then selects
    keypoints per image; SIFT detects image by image (its octave kernel
    takes one image)."""
    if cfg.kind == "sift":
        return stack([detect(g, cfg) for g in grays])
    levels, maps = orb_maps(grays, cfg)
    hw = tuple(grays.shape[1:])
    return stack([orb_select(levels, maps, i, hw, cfg)
                  for i in range(grays.shape[0])])
