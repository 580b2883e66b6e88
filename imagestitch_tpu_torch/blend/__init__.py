"""imagestitch_tpu_torch.blend: the blenders of `imagestitch_tpu.blend`."""

from imagestitch_tpu_torch.blend.feather import feather_blend, feather_weights
from imagestitch_tpu_torch.blend.frame import shift_to_frame, union_corner_size
from imagestitch_tpu_torch.blend.multiband import multiband_blend
from imagestitch_tpu_torch.blend.ramp import ramp_blend_pair

__all__ = [
    "shift_to_frame",
    "union_corner_size",
    "feather_blend",
    "feather_weights",
    "multiband_blend",
    "ramp_blend_pair",
]
