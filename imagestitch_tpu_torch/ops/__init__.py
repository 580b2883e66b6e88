"""imagestitch_tpu_torch.ops: the image substrate and the pyramid of
`imagestitch_tpu.ops`; the CUDA kernels' wrappers are the `cuda_*`
modules (sources in `csrc/`)."""

from imagestitch_tpu_torch.ops.image import (box_filter, dilate, erode,
                                             gaussian_blur, gaussian_kernel1d,
                                             remap_bilinear, remap_nearest,
                                             resize, rgb_to_gray, sobel)
from imagestitch_tpu_torch.ops.pyramid import build_pyramid, level_scale

__all__ = [
    "rgb_to_gray",
    "gaussian_kernel1d",
    "gaussian_blur",
    "sobel",
    "resize",
    "remap_bilinear",
    "remap_nearest",
    "dilate",
    "erode",
    "box_filter",
    "build_pyramid",
    "level_scale",
]
