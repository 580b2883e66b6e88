"""Image substrate: gray conversion, separable Gaussian blur, rectangular
dilation and the bilinear remap (the OpenCV cvtColor / GaussianBlur /
dilate / remap the reference leans on), as plain tensor code on (H, W) or
(H, W, C) float32, the layouts of `imagestitch_tpu.ops.image`.

Every product and sum rounds on its own, in the order the JAX package
writes it (no fused multiply-adds): on the CPU the tests compare these
functions with it bit for bit where the detector thresholds on their
values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_GRAY_W = (0.299, 0.587, 0.114)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of (..., H, W, 3) RGB (cv::cvtColor coefficients)."""
    img = img.to(torch.float32)
    w = torch.tensor(_GRAY_W, dtype=torch.float32, device=img.device)
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def gaussian_kernel1d(ksize: int, sigma: float,
                      device=None) -> torch.Tensor:
    """1-D Gaussian taps with cv::getGaussianKernel semantics (float32)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2.0
    x = torch.arange(ksize, dtype=torch.float32, device=device) - r
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def sep_filter_planes(x: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor
                      ) -> torch.Tensor:
    """Separable filter of (P, H, W) float32 planes with BORDER_REFLECT_101
    padding: a vertical pass of shifted multiply-adds, then a horizontal
    one."""
    H, W = x.shape[-2:]
    rx = (kx.shape[0] - 1) // 2
    ry = (ky.shape[0] - 1) // 2
    p = F.pad(x[None], (rx, rx, ry, ry), mode="reflect")[0]
    acc = ky[0] * p[:, 0:H]
    for t in range(1, ky.shape[0]):
        acc = acc + ky[t] * p[:, t:t + H]
    out = kx[0] * acc[:, :, 0:W]
    for t in range(1, kx.shape[0]):
        out = out + kx[t] * acc[:, :, t:t + W]
    return out


def _sep_filter2d(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor
                  ) -> torch.Tensor:
    """Separable 2-D filter over (H, W) or (H, W, C) float32, reflect-101."""
    if img.ndim == 2:
        return sep_filter_planes(img[None], kx, ky)[0]
    return sep_filter_planes(img.permute(2, 0, 1), kx, ky).permute(1, 2, 0)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """GaussianBlur of (H, W) or (H, W, C), reflect-101 border (7x7 sigma=2
    before descriptor sampling in the reference)."""
    k = gaussian_kernel1d(ksize, sigma, device=img.device)
    return _sep_filter2d(img.to(torch.float32), k, k)


def _morph_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Separable rectangular max filter over the last two dims with the
    asymmetric even-kernel padding (k//2 before, (k-1)//2 after) and -inf
    outside the image."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    y = F.pad(y, (0, 0, kh // 2, (kh - 1) // 2), value=float("-inf"))
    y = F.max_pool2d(y, (kh, 1), stride=1)
    y = F.pad(y, (kw // 2, (kw - 1) // 2, 0, 0), value=float("-inf"))
    y = F.max_pool2d(y, (1, kw), stride=1)
    return y.reshape(lead + y.shape[-2:])


def dilate(img: torch.Tensor, ksize: tuple[int, int] = (3, 3)
           ) -> torch.Tensor:
    """cv::dilate with a rect kernel over (..., H, W) float32."""
    return _morph_max(img.to(torch.float32), ksize[0], ksize[1])


def remap_bilinear(img: torch.Tensor, xmap: torch.Tensor,
                   ymap: torch.Tensor, border_value: float = 0.0):
    """Bilinear remap with clamped taps: img (H, W) or (H, W, C) float32,
    maps (H', W') source coordinates. Samples outside [0, W-1] x [0, H-1]
    get `border_value` and valid=False. Returns (out, valid)."""
    img = img.to(torch.float32)
    H, W = img.shape[:2]
    x0 = torch.floor(xmap)
    y0 = torch.floor(ymap)
    fx = xmap - x0
    fy = ymap - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape((H * W,) + img.shape[2:])

    def tap(yi, xi):
        yi = yi.clamp(0, H - 1)
        xi = xi.clamp(0, W - 1)
        return flat[yi * W + xi]

    Ia = tap(y0i, x0i)
    Ib = tap(y0i, x0i + 1)
    Ic = tap(y0i + 1, x0i)
    Id = tap(y0i + 1, x0i + 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = Ia + (Ib - Ia) * fx
    bot = Ic + (Id - Ic) * fx
    out = top + (bot - top) * fy
    valid = (xmap >= 0) & (xmap <= W - 1) & (ymap >= 0) & (ymap <= H - 1)
    vmask = valid[..., None] if img.ndim == 3 else valid
    out = torch.where(vmask, out, torch.full_like(out, border_value))
    return out, valid
