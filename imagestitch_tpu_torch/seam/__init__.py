"""imagestitch_tpu_torch.seam: the seam finders of `imagestitch_tpu.seam`:
on the device the DP scan, Voronoi and the distance transform; on the
host the graph cut and the full DpSeamFinder."""

from imagestitch_tpu_torch.seam.distance import l1_distance_transform
from imagestitch_tpu_torch.seam.dp import (dp_seam_pair, dp_seam_path,
                                           overlap_extents, ramp_weights,
                                           seam_costs)
from imagestitch_tpu_torch.seam.dp_full import (DpSeamFinder,
                                                dp_seam_find_full)
from imagestitch_tpu_torch.seam.graphcut import graphcut_seam_pair
from imagestitch_tpu_torch.seam.voronoi import voronoi_seam_pair

__all__ = [
    "l1_distance_transform",
    "voronoi_seam_pair",
    "dp_seam_pair",
    "dp_seam_path",
    "seam_costs",
    "ramp_weights",
    "overlap_extents",
    "graphcut_seam_pair",
    "DpSeamFinder",
    "dp_seam_find_full",
]
