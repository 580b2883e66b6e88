"""Gain exposure compensation (OpenCV ExposureCompensator::GAIN, as
`imagestitch_tpu.exposure.gain.gain_compensate` reproduces it): one gain
per image minimizing Σ_ij N_ij [α (g_i Ī_ij − g_j Ī_ji)² + β (1 − g_i)²],
with OpenCV's exact accumulation — the per-pixel intensity is the L2 norm
of the colour vector, the β prior includes the self pair (N_ii = mask
area), α terms carry factor 2 for i ≠ j, and pair counts are max(1, N).
Canvases share one frame (the pipeline's layout).
"""

from __future__ import annotations

import torch


def gain_compensate(images: torch.Tensor, masks: torch.Tensor,
                    alpha: float = 0.01, beta: float = 100.0):
    """images (N, H, W, C) float32, masks (N, H, W) bool in one shared
    frame. Returns (gains (N,), images * gains)."""
    N = images.shape[0]
    dev = images.device
    if N == 1:
        return torch.ones(1, dtype=torch.float32, device=dev), images
    m = masks.to(torch.float32)
    grays = (torch.sqrt((images * images).sum(dim=-1))
             if images.ndim == 4 else images.abs())
    n_p = torch.zeros((N, N), dtype=torch.float32, device=dev)
    s_p = torch.zeros((N, N), dtype=torch.float32, device=dev)
    for i in range(N):
        for j in range(i + 1, N):
            both = m[i] * m[j]
            n_p[i, j] = n_p[j, i] = both.sum()
            s_p[i, j] = (grays[i] * both).sum()
            s_p[j, i] = (grays[j] * both).sum()
    Ibar = s_p / n_p.clamp(min=1.0)
    areas = m.sum(dim=(1, 2))
    off = 1.0 - torch.eye(N, dtype=torch.float32, device=dev)
    n_acc = n_p.clamp(min=1.0) * off
    b = beta * (n_acc.sum(dim=1) + areas)
    diag = (beta * (n_acc.sum(dim=1) + areas)
            + 2.0 * alpha * (Ibar * Ibar * n_acc).sum(dim=1))
    A = torch.diag(diag) - 2.0 * alpha * Ibar * Ibar.T * n_acc
    gains = torch.linalg.solve(A, b)
    gains = torch.where(torch.isfinite(gains).all(), gains,
                        torch.ones_like(gains))
    scale = (gains[:, None, None, None] if images.ndim == 4
             else gains[:, None, None])
    return gains, images * scale
