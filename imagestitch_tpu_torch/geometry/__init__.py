"""imagestitch_tpu_torch.geometry (see the modules); the bundle adjusters,
wave correction and SCANS mode's affine estimation of
`imagestitch_tpu.geometry` are exported here."""

from imagestitch_tpu_torch.geometry.affine import find_affine
from imagestitch_tpu_torch.geometry.bundle import (bundle_adjust,
                                                   bundle_adjust_affine,
                                                   bundle_adjust_ray,
                                                   bundle_adjust_reproj,
                                                   wave_correct)

__all__ = [
    "bundle_adjust",
    "bundle_adjust_affine",
    "bundle_adjust_ray",
    "bundle_adjust_reproj",
    "find_affine",
    "wave_correct",
]
