"""imagestitch_tpu_torch.warp: the projectors and the rotation warper of
`imagestitch_tpu.warp`."""

from imagestitch_tpu_torch.warp.projectors import PROJECTORS
from imagestitch_tpu_torch.warp.warper import (WarpResult, warp_image,
                                               warp_point)

__all__ = ["PROJECTORS", "WarpResult", "warp_image", "warp_point"]
