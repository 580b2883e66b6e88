"""Focal auto-calibration from pairwise homographies
(`imagestitch_tpu.geometry.autocalib`): closed-form focal candidates per
homography, the geometric mean per pair (each pair counted through H and
H⁻¹), the median over pairs, and the image-size fallback."""

from __future__ import annotations

import torch


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)


def _pick(v1, v2, d1, d2):
    lo = torch.minimum(v1, v2)
    hi = torch.maximum(v1, v2)
    both = (lo > 0) & (hi > 0)
    sel = torch.where(d1.abs() > d2.abs(), hi, lo)
    f = torch.where(both, torch.sqrt(sel.clamp(min=0.0)),
                    torch.sqrt(hi.clamp(min=0.0)))
    return f, hi > 0


def focals_from_homography(H: torch.Tensor):
    """Focal candidates (f0 source, f1 destination) from (..., 3, 3)
    homographies. Returns (f0, f1, f0_ok, f1_ok)."""
    h = H.reshape(H.shape[:-2] + (9,))
    h = [h[..., i] for i in range(9)]
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / _safe(d1)
    v2 = (h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / _safe(d2)
    f1, f1_ok = _pick(v1, v2, d1, d2)
    d1b = h[0] * h[3] + h[1] * h[4]
    d2b = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
    w1 = -h[2] * h[5] / _safe(d1b)
    w2 = (h[5] * h[5] - h[2] * h[2]) / _safe(d2b)
    f0, f0_ok = _pick(w1, w2, d1b, d2b)
    return f0, f1, f0_ok, f1_ok


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries, the mean of the two middle values for an
    even count (invalid entries sort to +inf)."""
    n = mask.to(torch.int64).sum()
    xs, _ = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    lo = xs[((n - 1) // 2).clamp(min=0)]
    hi = xs[(n // 2).clamp(min=0)]
    return 0.5 * (lo + hi)


def estimate_focal(Hs: torch.Tensor, pair_valid: torch.Tensor,
                   img_sizes: torch.Tensor, num_images: int) -> torch.Tensor:
    """Scalar shared focal: the masked median of sqrt(f0·f1) over H and H⁻¹
    of every valid pair when at least num_images-1 estimates exist, else
    the mean of (width + height)."""
    eye = torch.eye(3, dtype=Hs.dtype, device=Hs.device)
    Hsafe = torch.where(pair_valid[:, None, None], Hs, eye)
    Hall = torch.cat([Hsafe, torch.linalg.inv(Hsafe)])
    valid_all = torch.cat([pair_valid, pair_valid])
    f0, f1, ok0, ok1 = focals_from_homography(Hall)
    ok = ok0 & ok1 & valid_all
    fpair = torch.sqrt((f0 * f1).clamp(min=0.0))
    n_est = ok.to(torch.int32).sum()
    med = _masked_median(fpair, ok)
    sizes = img_sizes.to(torch.float32)
    naive = (sizes[:, 0] + sizes[:, 1]).mean()
    use_med = (n_est >= num_images - 1) & torch.isfinite(med) & (med > 0)
    return torch.where(use_med, med, naive).to(torch.float32)
