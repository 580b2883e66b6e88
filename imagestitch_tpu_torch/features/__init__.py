from imagestitch_tpu_torch.features.orb import detect_and_compute
from imagestitch_tpu_torch.features.sift import detect_and_compute_sift
from imagestitch_tpu_torch.features.fast import (fast_score_map, harris_map,
                                                 nms3x3)
from imagestitch_tpu_torch.features.pattern import (brief_pattern,
                                                    ic_angle_offsets)

__all__ = [
    "detect",
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
