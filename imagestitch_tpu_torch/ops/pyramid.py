"""Image pyramid for the ORB detector: each level is the source resampled
by 1/scale_factor**l with INTER_LINEAR (half-pixel centres), separably —
rows, then columns (`imagestitch_tpu.ops.pyramid`).

The JAX package writes each pass as a product with a 2-tap hat matrix;
here each pass gathers its two taps directly. The roundings are the ones
its compiled CPU path makes for most level shapes: the row pass fuses the
second tap into the rounded first product, the column pass rounds both
products before the sum (for a few shapes its column product fuses too,
and those levels then differ in the last bit; ROADMAP Queue C).
"""

from __future__ import annotations

import torch


def level_scale(level: int, scale_factor: float, first_level: int = 0
                ) -> float:
    """Scale of `level` relative to the source image (getScale)."""
    return float(scale_factor) ** (level - first_level)


def level_shape(hw: tuple[int, int], level: int, scale_factor: float,
                first_level: int = 0) -> tuple[int, int]:
    """Rounded level size, cvRound(size / getScale(level))."""
    s = level_scale(level, scale_factor, first_level)
    return (int(round(hw[0] / s)), int(round(hw[1] / s)))


def _linear_resize_taps(n_out: int, n_in: int, device=None):
    """The two nonzero entries per row of the (n_out, n_in) INTER_LINEAR
    matrix max(0, 1 - |src_i - y|), src_i = (i + 0.5)·(n_in/n_out) - 0.5:
    (lower index, upper index, lower weight, upper weight); a row with one
    tap gets a zero upper weight."""
    i = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    src = (i * (n_in / n_out) - 0.5).clamp(0.0, n_in - 1.0)
    y0 = torch.floor(src)
    y1 = (y0 + 1.0).clamp(max=n_in - 1.0)
    w0 = torch.clamp(1.0 - (src - y0).abs(), min=0.0)
    w1 = torch.where(y1 > y0, torch.clamp(1.0 - (src - y1).abs(), min=0.0),
                     torch.zeros_like(src))
    return y0.long(), y1.long(), w0, w1


def resize_linear_mxu(img: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    """Separable INTER_LINEAR resize of (..., H, W) float32."""
    h, w = out_hw
    H, W = img.shape[-2:]
    img = img.to(torch.float32)
    r0, r1, a0, a1 = _linear_resize_taps(h, H, img.device)
    rows = torch.addcmul(img[..., r0, :] * a0[:, None], img[..., r1, :],
                         a1[:, None])
    c0, c1, b0, b1 = _linear_resize_taps(w, W, img.device)
    return rows[..., c0] * b0 + rows[..., c1] * b1


def build_pyramid(gray: torch.Tensor, nlevels: int, scale_factor: float,
                  first_level: int = 0) -> tuple[torch.Tensor, ...]:
    """nlevels float32 levels of (..., H, W), each resampled from the
    source."""
    H, W = gray.shape[-2:]
    levels = []
    for lv in range(nlevels):
        h, w = level_shape((H, W), lv, scale_factor, first_level)
        if (h, w) == (H, W):
            levels.append(gray.to(torch.float32))
        else:
            levels.append(resize_linear_mxu(gray, (h, w)))
    return tuple(levels)
