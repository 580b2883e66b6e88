"""Detector maps of pyramid levels: FAST-9 score with 3x3 NMS, Harris
response and the Gaussian blur (7x7 σ=2 by default; the kernel takes an
odd size up to 7), for batches of (B, H, W) float32 images.

On CUDA tensors `detect_maps_levels` launches the hand-written kernel of
`csrc/detect_maps.cu` once for up to 8 levels (it replaces the TPU kernel
`imagestitch_tpu/ops/pallas_detect.py:detect_maps`) or raises; on CPU
tensors it runs `detect_maps_plain`, the same function in plain tensor
code (features/fast.py + ops/image.py), level by level. `detect_maps` is
its one-level case. `launch_count` counts kernel launches.
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
MAX_LEVELS = 8

launch_count = 0


def detect_maps_plain(img: torch.Tensor, threshold: float,
                      block_size: int = 7, k_harris: float = 0.04,
                      ksize: int = BLUR_KSIZE, sigma: float = BLUR_SIGMA):
    """(B, H, W) -> (nms_score, harris, blurred), each (B, H, W) float32;
    the blur is ksize x ksize with σ = sigma."""
    img = img.to(torch.float32)
    k = gaussian_kernel1d(ksize, sigma, device=img.device)
    return (nms3x3(fast_score_map(img, threshold)),
            harris_map(img, block_size, k_harris),
            sep_filter_planes(img, k, k))


@functools.lru_cache(maxsize=None)
def _fn():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    fn = load_library().imagestitch_detect_maps_levels
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                   + [ctypes.POINTER(ctypes.c_int)] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _taps(ksize: int, sigma: float) -> "ctypes.Array":
    """The plain version's float32 blur taps, centred in the kernel's
    BLUR_KSIZE with zeros around them (a zero tap times a finite pixel
    adds exactly nothing, so the sums stay the plain version's)."""
    if ksize % 2 == 0 or not 1 <= ksize <= BLUR_KSIZE:
        raise ValueError(f"blur ksize {ksize} is not odd <= {BLUR_KSIZE}")
    pad = [0.0] * ((BLUR_KSIZE - ksize) // 2)
    t = gaussian_kernel1d(ksize, sigma).numpy().tolist()
    return (ctypes.c_float * BLUR_KSIZE)(*(pad + t + pad))


def _check_levels(levels) -> int:
    """Raise on what the kernel does not take; returns the batch size."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    dev = levels[0].device
    B = levels[0].shape[0] if levels[0].ndim == 3 else -1
    for img in levels:
        if not img.is_cuda or img.device != dev:
            raise ValueError(f"detect_maps_cuda needs CUDA tensors on one "
                             f"device, got {img.device} and {dev}")
        if img.dtype != torch.float32 or img.ndim != 3 or img.shape[0] != B:
            raise ValueError(f"expected (B, H, W) float32 with one B, got "
                             f"{img.dtype} {tuple(img.shape)}")
        if not img.is_contiguous():
            raise ValueError("detect_maps_cuda needs contiguous tensors")
        _, H, W = img.shape
        if H < 4 or W < 4:
            raise ValueError(f"level {H}x{W} is smaller than the 7-tap blur")
        if img.numel() >= 2 ** 31:
            raise ValueError(f"level {tuple(img.shape)} has 2^31 pixels or "
                             "more")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} is not in 1..65535")
    return B


def detect_maps_levels_cuda(levels, threshold: float, block_size: int = 7,
                            k_harris: float = 0.04, ksize: int = BLUR_KSIZE,
                            sigma: float = BLUR_SIGMA):
    """One kernel launch over a list of (B, H_l, W_l) float32 contiguous
    CUDA tensors; returns [(nms_score, harris, blurred)] per level, views
    into one allocation that holds each level's three maps as a block."""
    levels = list(levels)
    B = _check_levels(levels)
    if block_size % 2 == 0 or not 1 <= block_size <= 7:
        raise ValueError(f"harris block_size {block_size} is not odd <= 7")
    taps = _taps(ksize, float(sigma))
    sizes = [3 * img.numel() for img in levels]
    flat = torch.empty(sum(sizes), dtype=torch.float32,
                       device=levels[0].device)
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    hs = (ctypes.c_int * n)(*[img.shape[1] for img in levels])
    ws = (ctypes.c_int * n)(*[img.shape[2] for img in levels])
    s4 = float(np.float32((1.0 / (4 * block_size * 255.0)) ** 4))
    with torch.cuda.device(levels[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _fn()(ptrs, hs, ws, n, B, flat.data_ptr(),
                       float(threshold), block_size, float(k_harris), s4,
                       taps, stream)
    from imagestitch_tpu_torch.ops.cuda_build import (check,
                                                       count_launch)
    check(status, "detect_maps kernel launch")
    count_launch(globals())
    out, off = [], 0
    for img, size in zip(levels, sizes):
        out.append(flat[off:off + size].view((3,) + img.shape).unbind(0))
        off += size
    return out


def detect_maps_cuda(img: torch.Tensor, threshold: float,
                     block_size: int = 7, k_harris: float = 0.04,
                     ksize: int = BLUR_KSIZE, sigma: float = BLUR_SIGMA):
    """Launch the CUDA kernel on one (B, H, W) float32 contiguous CUDA
    tensor; returns (nms_score, harris, blurred)."""
    return detect_maps_levels_cuda([img], threshold, block_size, k_harris,
                                   ksize, sigma)[0]


def detect_maps_levels(levels, threshold: float, block_size: int = 7,
                       k_harris: float = 0.04, ksize: int = BLUR_KSIZE,
                       sigma: float = BLUR_SIGMA):
    """[(B, H_l, W_l) float32] -> [(nms_score, harris, blurred)] per level:
    one launch of the CUDA kernel for CUDA tensors, the plain version level
    by level for CPU tensors."""
    levels = list(levels)
    if levels and all(img.device.type == "cpu" for img in levels):
        return [detect_maps_plain(img, threshold, block_size, k_harris,
                                  ksize, sigma) for img in levels]
    if levels and all(img.is_cuda for img in levels):
        return detect_maps_levels_cuda(levels, threshold, block_size,
                                       k_harris, ksize, sigma)
    raise ValueError("detect_maps_levels: unsupported devices "
                     f"{sorted({str(img.device) for img in levels})}")


def detect_maps(img: torch.Tensor, threshold: float, block_size: int = 7,
                k_harris: float = 0.04, ksize: int = BLUR_KSIZE,
                sigma: float = BLUR_SIGMA):
    """(B, H, W) float32 -> (nms_score, harris, blurred): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. The blur is
    ksize x ksize with σ = sigma (the kernel's ksize: odd, at most 7)."""
    return detect_maps_levels([img], threshold, block_size, k_harris, ksize,
                              sigma)[0]
