"""Canvas-frame alignment (`imagestitch_tpu.blend.frame`): moving a
canvas whose origin sits at one pano corner into the frame of another is
an integer translation, done as a nearest remap.
"""

from __future__ import annotations

import torch

from imagestitch_tpu_torch.ops.image import remap_nearest


def shift_to_frame(src: torch.Tensor, src_corner: torch.Tensor,
                   dst_corner: torch.Tensor, dst_hw: tuple[int, int],
                   fill: float = 0.0) -> torch.Tensor:
    """Resample `src` (H, W[, C]), whose canvas origin sits at pano
    coordinates `src_corner` (x, y), into a `dst_hw` canvas with origin
    `dst_corner`; pixels that `src` does not cover get `fill`."""
    Hd, Wd = dst_hw
    off = (torch.as_tensor(src_corner, device=src.device)
           - torch.as_tensor(dst_corner, device=src.device)
           ).to(torch.float32)
    xs = torch.arange(Wd, dtype=torch.float32, device=src.device)[None, :] \
        - off[0]
    ys = torch.arange(Hd, dtype=torch.float32, device=src.device)[:, None] \
        - off[1]
    out, _ = remap_nearest(src, xs.expand(Hd, Wd), ys.expand(Hd, Wd),
                           border_value=fill)
    return out


def union_corner_size(corners: torch.Tensor, sizes: torch.Tensor):
    """Bounding box of per-image ROIs: corners (N, 2) (x, y), sizes (N, 2)
    (w, h) -> (corner (2,), size (2,))."""
    lo = corners.amin(dim=0)
    hi = (corners + sizes).amax(dim=0)
    return lo, hi - lo
