"""Dynamic-programming seam finder (`imagestitch_tpu.seam.dp`): per-pixel
colour (or colour over gradient) costs over the overlap and a minimal-cost
top-to-bottom path with moves in {-1, 0, +1}, found row by row; the masks
split along it. Also the seam-anchored ramp weights of `blend.ramp`.

The path is found one of two ways, chosen by the cost's device
(`takes_kernel`): on a CUDA device the forward recurrence, the argmin and
the backtrack are one launch of the kernel of `csrc/dp_seam.cu`
(`ops/cuda_dp`), and nothing is read back; CPU tensors take the plain
loop, one row per step and a backtrack that reads the int8 choices back
to the host once. Both pad the transition rows to a multiple of 8 with
free rows (`_transitions`), as the JAX package's chunked scan does, so
each starts its backtrack from the JAX package's padded bottom.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagestitch_tpu_torch.ops import cuda_dp
from imagestitch_tpu_torch.ops.image import rgb_to_gray, sobel
from imagestitch_tpu_torch.utils import log

BIG = 1e9
_CHUNK = 8


def seam_costs(img1: torch.Tensor, img2: torch.Tensor, both: torch.Tensor,
               use_grad: bool = False) -> torch.Tensor:
    """Squared L2 colour difference over the overlap, BIG outside; with
    `use_grad` (COLOR_GRAD) divided by |grad1| + |grad2| + 1, the
    gradients' L1 norms from Sobel on the grays."""
    d = img1.to(torch.float32) - img2.to(torch.float32)
    e = (d * d).sum(dim=-1) if d.ndim == 3 else d * d
    if use_grad:
        def gmag(im):
            g = rgb_to_gray(im) if im.ndim == 3 else im
            return sobel(g, 1, 0).abs() + sobel(g, 0, 1).abs()
        e = e / (gmag(img1) + gmag(img2) + 1.0)
    return torch.where(both, e, torch.full_like(e, BIG))


def _shift_big(x: torch.Tensor, s: int) -> torch.Tensor:
    """x shifted by s (±1) along the row, BIG shifted in."""
    big = x.new_full((1,), BIG)
    return torch.cat([big, x[:-1]]) if s > 0 else torch.cat([x[1:], big])


def takes_kernel(device: torch.device) -> bool:
    """Whether a DP seam over costs on `device` runs as one launch of the
    DP kernel (`ops/cuda_dp`): on a CUDA device, at every width."""
    return device.type == "cuda"


def _transitions(height: int) -> int:
    """The rows of choices for `height` cost rows: height - 1 padded up to
    a multiple of `_CHUNK` with free rows, so the kernel and the plain
    loop start their backtrack from the JAX package's padded bottom."""
    return height - 1 + (-(height - 1)) % _CHUNK


def dp_seam_path(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost top-to-bottom path through (H, W) costs; rows with no
    overlap (all BIG) are free. Returns the seam column per row, (H,)
    int64 on the cost's device. A stage `seam_dp` of the active timer; a
    seam the kernel solved (in float32) adds 1 to its counter `dp_fused`."""
    with log.stage("seam_dp"):
        if takes_kernel(cost.device):
            cols = cuda_dp.seam_path(cost.to(torch.float32),
                                     _transitions(cost.shape[0]))
            log.count("dp_fused")
            return cols
        return _dp_seam_path_plain(cost)


def _dp_seam_path_plain(cost: torch.Tensor) -> torch.Tensor:
    """`dp_seam_path` as the plain loop (CPU tensors). The choices read
    back for the backtrack add their bytes to the active timer's
    `readback_bytes`."""
    H, W = cost.shape
    row_has = (cost < BIG).any(dim=1)
    e = torch.where(row_has[:, None], cost, torch.zeros_like(cost))
    n_pad = _transitions(H) - (H - 1)
    rest = torch.cat([e[1:], e.new_zeros((n_pad, W))])
    m = e[0]
    choices = []
    for r in range(rest.shape[0]):
        left = _shift_big(m, 1)
        right = _shift_big(m, -1)
        # first minimum among (left, straight, right)
        take_l = (left <= m) & (left <= right)
        take_s = ~take_l & (m <= right)
        choice = torch.where(take_l, 0, torch.where(take_s, 1, 2))
        best = torch.minimum(torch.minimum(left, m), right)
        m = torch.clamp(rest[r] + best, max=BIG)
        choices.append(choice.to(torch.int8))
    if H == 1:
        return torch.argmin(e[0]).reshape(1)
    last = int(torch.argmin(m))
    ch = torch.stack(choices).cpu().numpy()
    log.count("readback_bytes", ch.nbytes)
    cols = np.empty(ch.shape[0] + 1, np.int64)
    col = last
    for r in range(ch.shape[0] - 1, -1, -1):
        cols[r + 1] = col
        o = ch[r, col]
        nxt = col - 1 if o == 0 else (col + 1 if o == 2 else col)
        if 0 <= nxt < W:      # a move off the grid keeps the position
            col = nxt
    cols[0] = col
    return torch.as_tensor(cols[:H], device=cost.device)


def _decimate_cost(cwin: torch.Tensor, scale: int) -> torch.Tensor:
    """Mean-pool a cost window by `scale` (borders padded with BIG)."""
    H, W = cwin.shape
    Hp = -(-H // scale) * scale
    Wp = -(-W // scale) * scale
    if Hp != H or Wp != W:
        cwin = F.pad(cwin, (0, Wp - W, 0, Hp - H), value=BIG)
    cells = cwin.reshape(Hp // scale, scale, Wp // scale, scale)
    # each cell summed row by row, left to right (the JAX package's
    # reduction order: the DP compares these sums, so ties must agree)
    acc = cells[:, 0, :, 0]
    for r in range(scale):
        for c in range(scale):
            if r or c:
                acc = acc + cells[:, r, :, c]
    return acc / float(scale * scale)


def _dp_split_vertical(cost, mask1, mask2, both, max_overlap_w, scale=1):
    """Vertical-seam mask split on a precomputed cost map; with scale > 1
    the DP runs on a mean-pooled map and the seam is upscaled (left cell
    edge). Returns (mask1', mask2', seam_cols (H,))."""
    H, W = mask1.shape
    dev = cost.device
    if max_overlap_w is not None and max_overlap_w < W:
        Wd = max_overlap_w
        first = int(torch.argmax(both.any(dim=0).to(torch.uint8)))
        x0 = min(max(first - 8, 0), W - Wd)
        cwin = cost[:, x0:x0 + Wd]
    else:
        x0 = 0
        cwin = cost
    if scale > 1:
        seam_lo = dp_seam_path(_decimate_cost(cwin, scale))
        seam = torch.repeat_interleave(seam_lo * scale, scale)[:H] + x0
    else:
        seam = dp_seam_path(cwin) + x0
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    m1f = mask1.to(torch.float32)
    m2f = mask2.to(torch.float32)
    cx1 = (m1f * xs[None, :]).sum() / m1f.sum().clamp(min=1.0)
    cx2 = (m2f * xs[None, :]).sum() / m2f.sum().clamp(min=1.0)
    one_is_left = cx1 <= cx2
    left_of = torch.arange(W, device=dev)[None, :] <= seam[:, None]
    keep1 = torch.where(one_is_left, left_of, ~left_of)
    m1 = mask1 & (~both | keep1)
    m2 = mask2 & (~both | ~keep1)
    return m1, m2, seam


def _centroid(m: torch.Tensor):
    mf = m.to(torch.float32)
    tot = mf.sum().clamp(min=1.0)
    cx = (mf.sum(dim=0) * torch.arange(m.shape[1], dtype=torch.float32,
                                       device=m.device)).sum() / tot
    cy = (mf.sum(dim=1) * torch.arange(m.shape[0], dtype=torch.float32,
                                       device=m.device)).sum() / tot
    return cx, cy


def dp_seam_pair(img1, img2, mask1, mask2, use_grad: bool = False,
                 max_overlap_w: int | None = None,
                 max_overlap_h: int | None = None, orient: str = "vertical",
                 scale: int = 1):
    """Optimal seam between two shared-frame images and the mask split
    along it. `orient` "auto" picks a vertical seam for a horizontally
    displaced pair (by mask centroids) and a horizontal one otherwise.
    Returns (mask1', mask2', seam) — seam is None for "auto"."""
    both = mask1 & mask2
    cost = seam_costs(img1, img2, both, use_grad)

    def vertical():
        return _dp_split_vertical(cost, mask1, mask2, both, max_overlap_w,
                                  scale)

    def horizontal():
        m1t, m2t, seam = _dp_split_vertical(cost.T, mask1.T, mask2.T, both.T,
                                            max_overlap_h, scale)
        return m1t.T, m2t.T, seam

    if orient == "vertical":
        return vertical()
    if orient == "horizontal":
        return horizontal()
    cx1, cy1 = _centroid(mask1)
    cx2, cy2 = _centroid(mask2)
    if bool((cx1 - cx2).abs() >= (cy1 - cy2).abs()):
        m1, m2, _ = vertical()
    else:
        m1, m2, _ = horizontal()
    return m1, m2, None


def overlap_extents(both: torch.Tensor):
    """Per-row overlap [left, right] column extents of (H, W) bool, with
    (0, W-1) for rows that have no overlap. Returns (left, right, has)."""
    W = both.shape[1]
    col = torch.arange(W, device=both.device)[None, :]
    left = torch.where(both, col, W).amin(dim=1)
    right = torch.where(both, col, -1).amax(dim=1)
    has = both.any(dim=1)
    return (torch.where(has, left, 0), torch.where(has, right, W - 1), has)


def ramp_weights(both: torch.Tensor, seam: torch.Tensor) -> torch.Tensor:
    """Seam-anchored piecewise-linear weights of the LEFT image over the
    overlap: 1 at the row's left overlap edge, 0.5 at the seam, 0 at its
    right edge. Returns (H, W) float32 (meaningful only where `both`)."""
    W = both.shape[1]
    left, right, _ = overlap_extents(both)
    x = torch.arange(W, dtype=torch.float32, device=both.device)[None, :]
    l = left.to(torch.float32)[:, None]
    r = right.to(torch.float32)[:, None]
    s = seam.to(torch.float32)[:, None]
    wl = 1.0 - 0.5 * (x - l) / (s - l).clamp(min=1.0)
    wr = 0.5 * (r - x) / (r - s).clamp(min=1.0)
    return torch.where(x <= s, wl, wr).clamp(0.0, 1.0)
