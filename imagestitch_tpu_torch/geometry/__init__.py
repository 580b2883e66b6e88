"""imagestitch_tpu_torch.geometry: the homography solvers, RANSAC, focal
estimation, the rotation chain, the bundle adjusters and wave correction
of `imagestitch_tpu.geometry`, and SCANS mode's affine estimation."""

from imagestitch_tpu_torch.geometry.affine import find_affine
from imagestitch_tpu_torch.geometry.autocalib import (estimate_focal,
                                                      focals_from_homography)
from imagestitch_tpu_torch.geometry.bundle import (bundle_adjust,
                                                   bundle_adjust_affine,
                                                   bundle_adjust_ray,
                                                   bundle_adjust_reproj,
                                                   wave_correct)
from imagestitch_tpu_torch.geometry.homography import (apply_homography,
                                                       dlt_homography,
                                                       lm_refine_homography,
                                                       reproj_error_sq,
                                                       solve_h4p)
from imagestitch_tpu_torch.geometry.ransac import (RansacResult,
                                                   find_homography)
from imagestitch_tpu_torch.geometry.rotation import (estimate_cameras,
                                                     estimate_cameras_host,
                                                     max_spanning_tree)

__all__ = [
    "dlt_homography",
    "solve_h4p",
    "reproj_error_sq",
    "lm_refine_homography",
    "apply_homography",
    "find_homography",
    "RansacResult",
    "focals_from_homography",
    "estimate_focal",
    "max_spanning_tree",
    "estimate_cameras",
    "estimate_cameras_host",
    "bundle_adjust",
    "bundle_adjust_affine",
    "bundle_adjust_ray",
    "bundle_adjust_reproj",
    "find_affine",
    "wave_correct",
]
