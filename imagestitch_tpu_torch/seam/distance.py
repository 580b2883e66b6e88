"""Exact L1 distance transform by separable min-plus doubling
(`imagestitch_tpu.seam.distance`): along each axis
D <- min(D, shift(D, ±2^t) + 2^t) for t = 0, 1, ..., rows then columns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INF = 1e9


def _shift_pad(x: torch.Tensor, k: int, dim: int, fill: float
               ) -> torch.Tensor:
    """x shifted by +k along `dim`, vacated slots filled."""
    n = x.shape[dim]
    if abs(k) >= n:
        return torch.full_like(x, fill)
    xs = x.narrow(dim, 0, n - k) if k > 0 else x.narrow(dim, -k, n + k)
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim)
    pad += [k, 0] if k > 0 else [0, -k]
    return F.pad(xs, pad, value=fill)


def _minplus_1d(d0: torch.Tensor, dim: int, max_dist: int | None = None
                ) -> torch.Tensor:
    """min_j (d0[j] + |i - j|) along `dim`; with max_dist, exact up to it
    and an upper bound beyond."""
    n = d0.shape[dim]
    fwd = d0
    bwd = d0
    k = 1
    limit = n if max_dist is None else min(n, max_dist + 1)
    while k < limit:
        fwd = torch.minimum(fwd, _shift_pad(fwd, k, dim, INF) + k)
        bwd = torch.minimum(bwd, _shift_pad(bwd, -k, dim, INF) + k)
        k *= 2
    return torch.minimum(fwd, bwd)


def l1_distance_transform(mask: torch.Tensor, max_dist: int | None = None
                          ) -> torch.Tensor:
    """Per-pixel L1 distance of (..., H, W) bool masks to the nearest pixel
    outside the mask (cv::distanceTransform DIST_L1 semantics)."""
    d0 = torch.where(mask, torch.full(mask.shape, INF, device=mask.device),
                     torch.zeros(mask.shape, device=mask.device))
    d = _minplus_1d(d0, dim=-1, max_dist=max_dist)
    d = _minplus_1d(d, dim=-2, max_dist=max_dist)
    return d.clamp(max=INF)
