from imagestitch_tpu_torch.features.orb import detect_and_compute
from imagestitch_tpu_torch.features.fast import (fast_score_map, harris_map,
                                                 nms3x3)
from imagestitch_tpu_torch.features.pattern import (brief_pattern,
                                                    ic_angle_offsets)

__all__ = [
    "detect",
    "detect_and_compute",
    "fast_score_map",
    "harris_map",
    "nms3x3",
    "brief_pattern",
    "ic_angle_offsets",
]


def detect(gray, cfg):
    """Detector dispatch on cfg.kind -> ImageFeatures (ORB; SIFT raises
    until it is ported)."""
    return detect_and_compute(gray, cfg)
