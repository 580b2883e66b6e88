"""Multi-band (Laplacian pyramid) blender (`imagestitch_tpu.blend.
multiband`, OpenCV's MultiBandBlender): each Laplacian band of the
canvases is blended with the Gaussian pyramid of the weights, and the
bands are collapsed coarse to fine.

The canvases are zero-padded to a multiple of 2^bands. A pyramid level is
a 5-tap σ=1 Gaussian blur (reflect-101) and `jax.image.resize`'s linear
resize (antialiased when it halves), `ops.image.resize_planes`. The
images' channels and the weights go down the pyramid together, as one
stack of (H, W) planes; each plane rounds as the JAX package's arrays do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagestitch_tpu_torch.ops.image import (gaussian_kernel1d,
                                             resize_planes,
                                             sep_filter_planes)

WEIGHT_EPS = 1e-5


def _down(x: torch.Tensor) -> torch.Tensor:
    """One pyramid step of (P, h, w) planes: blur, then halve."""
    h, w = x.shape[-2:]
    k = gaussian_kernel1d(5, 1.0, device=x.device)
    return resize_planes(sep_filter_planes(x, k, k), (h // 2, w // 2))


def _sum(xs):
    """x0 + x1 + ..., left to right."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def multiband_blend(images: torch.Tensor, masks: torch.Tensor,
                    num_bands: int = 5):
    """Blend N shared-frame canvases with Laplacian pyramids.

    images: (N, H, W, C) float32; masks: (N, H, W) bool, the
    seam-resolved and dilated masks. Returns ((H, W, C), (H, W) bool),
    zero outside the union of the masks."""
    N, H, W, C = images.shape
    mult = 1 << num_bands
    Hp = -(-H // mult) * mult
    Wp = -(-W // mult) * mult
    planes = torch.cat([
        images.to(torch.float32).permute(0, 3, 1, 2).reshape(N * C, H, W),
        masks.to(torch.float32)])
    gauss = [F.pad(planes, (0, Wp - W, 0, Hp - H))]
    for _ in range(num_bands):
        gauss.append(_down(gauss[-1]))

    blended = []
    for lv in range(num_bands + 1):
        g = gauss[lv]
        hw = tuple(g.shape[-2:])
        imgs = g[:N * C]
        if lv < num_bands:
            imgs = imgs - resize_planes(gauss[lv + 1][:N * C], hw)
        laps = imgs.reshape(N, C, *hw)
        ws = g[N * C:]
        wsum = _sum(list(ws)) + WEIGHT_EPS
        acc = _sum([laps[i] * ws[i][None] for i in range(N)])
        blended.append(acc / wsum[None])

    out = blended[-1]
    for lv in range(num_bands - 1, -1, -1):
        out = resize_planes(out, tuple(blended[lv].shape[-2:])) + blended[lv]
    out = out[:, :H, :W].permute(1, 2, 0)
    valid = masks.any(dim=0)
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out, valid
