"""imagestitch_tpu_torch.seam: the seam finders of `imagestitch_tpu.seam`
that run on the device (the graph cut is not ported yet)."""

from imagestitch_tpu_torch.seam.distance import l1_distance_transform
from imagestitch_tpu_torch.seam.dp import (dp_seam_pair, dp_seam_path,
                                           overlap_extents, ramp_weights,
                                           seam_costs)
from imagestitch_tpu_torch.seam.voronoi import voronoi_seam_pair

__all__ = [
    "l1_distance_transform",
    "voronoi_seam_pair",
    "dp_seam_pair",
    "dp_seam_path",
    "seam_costs",
    "ramp_weights",
    "overlap_extents",
]
