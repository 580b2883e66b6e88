"""Rotation warper: projected-ROI bounds and the backward-map + bilinear
gather into a static canvas (`imagestitch_tpu.warp.warper`).

`warp_batched_plain` is the plain version of the warp kernel
(`ops.cuda_warp.warp_batched`): the JAX package's XLA path, image by image,
with the kernel's signature. `warp_image` warps one image with any
projector, bilinearly or by nearest neighbour, optionally through a source
mask: through the kernel (`ops.cuda_warp.warp`) for a CUDA image in the
cases it carries, else the plain path. `warp_point` forward-maps points.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imagestitch_tpu_torch.ops.cuda_warp import KIND_IDS, warp
from imagestitch_tpu_torch.ops.image import remap_bilinear, remap_nearest
from imagestitch_tpu_torch.types import _Replace
from imagestitch_tpu_torch.warp.projectors import PROJECTORS


@dataclass(frozen=True)
class WarpResult(_Replace):
    image: torch.Tensor   # (Hc, Wc, C) float32
    mask: torch.Tensor    # (Hc, Wc) bool
    corner: torch.Tensor  # (2,) int32 — (x, y) of the canvas origin
    size: torch.Tensor    # (2,) int32 — (w, h) ROI extent, <= the canvas


def _linspace0(stop: float, num: int, device) -> torch.Tensor:
    """float32 linspace(0, stop, num) evaluated as stop·(i/(num-1)) with the
    exact endpoint — the JAX package's rounding."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    stop_t = torch.tensor([stop], dtype=torch.float32, device=device)
    return torch.cat([stop_t * step, stop_t])


def _roi_bounds(proj, src_h: int, src_w: int, samples: int = 64):
    """(u_min, v_min, u_max, v_max) from a decimated source grid."""
    dev = proj.k_rinv.device
    xs = _linspace0(src_w - 1.0, min(samples, src_w), dev)
    ys = _linspace0(src_h - 1.0, min(samples, src_h), dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    u, v = proj.forward(gx, gy)
    return u.min(), v.min(), u.max(), v.max()


def roi_bounds(K: torch.Tensor, R: torch.Tensor, scale,
               src_hw: tuple[int, int], kind: str = "cylindrical"):
    """Projected-ROI bounds (u0, v0, u1, v1) of a source image."""
    return _roi_bounds(PROJECTORS[kind](K, R, scale), src_hw[0], src_hw[1])


def image_scale(scale, i: int):
    """Image i's surface scale, where `scale` is one value for every image
    or one per image."""
    if isinstance(scale, torch.Tensor):
        return scale.reshape(-1)[i] if scale.numel() > 1 else scale
    return np.asarray(scale).reshape(-1)[i] if np.ndim(scale) > 0 else scale


def warp_batched_plain(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                       corners: torch.Tensor, roi_uvs: torch.Tensor,
                       canvas_hw: tuple[int, int], kind: str = "cylindrical",
                       src_sizes=None, masks: torch.Tensor | None = None,
                       interp: str = "linear"):
    """Warp (N, H, W, C) images into N (Hc, Wc) canvases: per canvas pixel
    (u, v) = pixel + corner, the backward map at the image's surface scale
    (`scale`: one for every image, or (N,) one each), the ROI-rectangle
    test (±1 px), the in-image test on each image's true size and a
    clamped bilinear sample (`interp="nearest"`: the nearest tap). With
    `masks` (N, H, W), a pixel is valid only where the nearest source
    mask pixel is set. Returns (out (N, Hc, Wc, C), valid (N, Hc, Wc)
    bool)."""
    N, H, W = imgs.shape[:3]
    Hc, Wc = canvas_hw
    dev = imgs.device
    remap = remap_bilinear if interp == "linear" else remap_nearest
    outs, valids = [], []
    for i in range(N):
        h, w = ((H, W) if src_sizes is None
                else (int(src_sizes[i][0]), int(src_sizes[i][1])))
        proj = PROJECTORS[kind].from_backward(k_rinvs[i],
                                              image_scale(scale, i))
        corner = corners[i].to(torch.float32)
        dx = torch.arange(Wc, dtype=torch.float32, device=dev)[None, :] \
            + corner[0]
        dy = torch.arange(Hc, dtype=torch.float32, device=dev)[:, None] \
            + corner[1]
        dxg = dx.expand(Hc, Wc)
        dyg = dy.expand(Hc, Wc)
        xm, ym, ray_ok = proj.backward(dxg, dyg)
        u0, v0, u1, v1 = roi_uvs[i].to(torch.float32)
        in_roi = ((dxg >= u0 - 1.0) & (dxg <= u1 + 1.0)
                  & (dyg >= v0 - 1.0) & (dyg <= v1 + 1.0))
        out, samp_ok = remap(imgs[i, :h, :w].to(torch.float32), xm, ym)
        valid = ray_ok & samp_ok & in_roi
        if masks is not None:
            m_out, _ = remap_nearest(masks[i, :h, :w].to(torch.float32),
                                     xm, ym)
            valid = valid & (m_out > 0.5)
        vmask = valid[..., None] if out.ndim == 3 else valid
        outs.append(torch.where(vmask, out, torch.zeros_like(out)))
        valids.append(valid)
    return torch.stack(outs), torch.stack(valids)


def warp_image(img: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
               scale, canvas_hw: tuple[int, int], kind: str = "cylindrical",
               mask: torch.Tensor | None = None, interp: str = "linear",
               corner: torch.Tensor | None = None,
               use_kernel: bool | None = None) -> WarpResult:
    """Warp one source image (H, W[, C]) onto the projection surface:
    bilinear (`interp="linear"`) or nearest sampling, and with `mask`
    (H, W) only where the nearest source mask pixel is set. `corner`
    (x, y) places the canvas origin (default: the floor of the image's own
    ROI corner).

    `use_kernel` (the JAX package's `use_pallas`): None takes the warp
    kernel (one launch of `ops.cuda_warp.warp`) for a CUDA image in the
    cases it carries (a cylindrical, spherical or plane surface, linear
    sampling, no mask), else the plain path; False the plain path on any
    device; True the kernel in those cases (the plain path in the others,
    as `use_pallas=True` does), and raises for an image that is not on a
    CUDA device (the kernel has no CPU mode). Both routes give the same
    bits."""
    Hc, Wc = canvas_hw
    H, W = img.shape[:2]
    proj = PROJECTORS[kind](K, R, scale)
    u0, v0, u1, v1 = _roi_bounds(proj, H, W)
    if corner is None:
        corner = torch.stack([torch.floor(u0), torch.floor(v0)])
    corner = corner.to(torch.int32)
    size_w = (torch.ceil(u1) - torch.floor(u0) + 1).to(torch.int32)
    size_h = (torch.ceil(v1) - torch.floor(v0) + 1).to(torch.int32)
    size = torch.stack([size_w.clamp(max=Wc), size_h.clamp(max=Hc)])
    roi_uv = torch.stack([u0, v0, u1, v1])
    if use_kernel and not img.is_cuda:
        raise ValueError(f"warp_image(use_kernel=True) needs a CUDA tensor, "
                         f"got one on {img.device}: the warp kernel has no "
                         "CPU mode")
    if use_kernel is None:
        use_kernel = img.is_cuda
    kernel_case = kind in KIND_IDS and interp == "linear" and mask is None
    x = img.to(torch.float32)
    if use_kernel and kernel_case:
        out, valid = warp(x.contiguous(), proj.k_rinv, scale, corner,
                          roi_uv, canvas_hw, kind)
        return WarpResult(image=out, mask=valid, corner=corner, size=size)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    out, valid = warp_batched_plain(
        x[None], proj.k_rinv[None], scale, corner[None], roi_uv[None],
        canvas_hw, kind, masks=None if mask is None else mask[None],
        interp=interp)
    out = out[0, ..., 0] if squeeze else out[0]
    return WarpResult(image=out, mask=valid[0], corner=corner, size=size)


def warp_point(xy: torch.Tensor, K: torch.Tensor, R: torch.Tensor, scale,
               kind: str = "cylindrical") -> torch.Tensor:
    """Forward-map points (..., 2) onto the projection surface (OpenCV
    RotationWarper::warpPoint)."""
    u, v = PROJECTORS[kind](K, R, scale).forward(xy[..., 0], xy[..., 1])
    return torch.stack([u, v], dim=-1)
