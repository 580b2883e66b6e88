"""imagestitch_tpu_torch.matching: the descriptor distances and the pair
matcher (kNN, ratio test, RANSAC) of `imagestitch_tpu.matching`."""

from imagestitch_tpu_torch.matching.hamming import (hamming_distance_matrix,
                                                    l2_distance_matrix)
from imagestitch_tpu_torch.matching.matcher import (match_all, match_pair,
                                                    match_pair_descriptors)

__all__ = [
    "hamming_distance_matrix",
    "l2_distance_matrix",
    "match_pair",
    "match_pair_descriptors",
    "match_all",
]
