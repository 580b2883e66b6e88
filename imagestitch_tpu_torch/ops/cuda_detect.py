"""Detector maps of a pyramid level: FAST-9 score with 3x3 NMS, Harris
response and the 7x7 σ=2 blur, for a batch of (B, H, W) float32 images.

On a CUDA tensor `detect_maps` launches the hand-written kernel of
`csrc/detect_maps.cu` (it replaces the TPU kernel
`imagestitch_tpu/ops/pallas_detect.py:detect_maps`) or raises; on a CPU
tensor it runs `detect_maps_plain`, the same function in plain tensor code
(features/fast.py + ops/image.py). `launch_count` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from imagestitch_tpu_torch.features.fast import (fast_score_map, harris_map,
                                                 nms3x3)
from imagestitch_tpu_torch.ops.image import (gaussian_kernel1d,
                                             sep_filter_planes)

BLUR_KSIZE = 7
BLUR_SIGMA = 2.0

launch_count = 0


def detect_maps_plain(img: torch.Tensor, threshold: float,
                      block_size: int = 7, k_harris: float = 0.04):
    """(B, H, W) -> (nms_score, harris, blurred), each (B, H, W) float32."""
    img = img.to(torch.float32)
    k = gaussian_kernel1d(BLUR_KSIZE, BLUR_SIGMA, device=img.device)
    return (nms3x3(fast_score_map(img, threshold)),
            harris_map(img, block_size, k_harris),
            sep_filter_planes(img, k, k))


def _fn():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    fn = load_library().imagestitch_detect_maps
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _taps() -> "ctypes.Array":
    """The plain version's float32 blur taps."""
    t = gaussian_kernel1d(BLUR_KSIZE, BLUR_SIGMA)
    return (ctypes.c_float * BLUR_KSIZE)(*t.numpy().tolist())


def detect_maps_cuda(img: torch.Tensor, threshold: float,
                     block_size: int = 7, k_harris: float = 0.04):
    """Launch the CUDA kernel on a (B, H, W) float32 contiguous CUDA
    tensor; returns (nms_score, harris, blurred)."""
    global launch_count
    if not img.is_cuda:
        raise ValueError("detect_maps_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.ndim != 3:
        raise ValueError(f"expected (B, H, W) float32, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("detect_maps_cuda needs a contiguous tensor")
    B, H, W = img.shape
    if H < 4 or W < 4:
        raise ValueError(f"level {H}x{W} is smaller than the 7-tap blur")
    if block_size % 2 == 0 or not 1 <= block_size <= 7:
        raise ValueError(f"harris block_size {block_size} is not odd <= 7")
    nms, harris, blur = (torch.empty_like(img) for _ in range(3))
    s4 = float(np.float32((1.0 / (4 * block_size * 255.0)) ** 4))
    fn = _fn()
    taps = _taps()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(img.data_ptr(), nms.data_ptr(), harris.data_ptr(),
                    blur.data_ptr(), B, H, W, float(threshold), block_size,
                    float(k_harris), s4, taps, stream)
    from imagestitch_tpu_torch.ops.cuda_build import check
    check(status, "detect_maps kernel launch")
    launch_count += 1
    return nms, harris, blur


def detect_maps(img: torch.Tensor, threshold: float, block_size: int = 7,
                k_harris: float = 0.04):
    """(B, H, W) float32 -> (nms_score, harris, blurred): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if img.is_cuda:
        return detect_maps_cuda(img, threshold, block_size, k_harris)
    if img.device.type != "cpu":
        raise ValueError(f"detect_maps: unsupported device {img.device}")
    return detect_maps_plain(img, threshold, block_size, k_harris)
