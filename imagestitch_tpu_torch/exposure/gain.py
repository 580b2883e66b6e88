"""Gain exposure compensation (`imagestitch_tpu.exposure.gain`): OpenCV's
GAIN, CHANNELS, GAIN_BLOCKS and CHANNELS_BLOCKS compensators.

The Brown-Lowe gain model: gains minimizing
Σ_ij N_ij [α (g_i Ī_ij − g_j Ī_ji)² + β (1 − g_i)²], with OpenCV's exact
accumulation — the per-pixel intensity is the L2 norm of the colour
vector (the channel value itself for the per-channel kinds), the β prior
includes the self pair (N_ii = mask area), α terms carry factor 2 for
i ≠ j, and pair counts are max(1, N).

The *_BLOCKS kinds solve one such system per `block`-pixel cell (in the
shared frame a cell overlaps only the same cell of the other canvases, so
the (N·B)² system splits into B batched N x N solves), smooth the gain
maps with a 3x3 binomial kernel and upsample them bilinearly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagestitch_tpu_torch.blend.frame import shift_to_frame
from imagestitch_tpu_torch.ops.pyramid import resize_linear_mxu


def _intensity(images: torch.Tensor) -> torch.Tensor:
    """OpenCV's intensity: the L2 norm of the colour vector, or |v| for
    single-channel canvases."""
    return (torch.sqrt((images * images).sum(dim=-1))
            if images.ndim == 4 else images.abs())


def _total(x: torch.Tensor) -> torch.Tensor:
    """(H, W[, K]) -> ([K]) sum over the whole canvas: one cell."""
    return x.sum(dim=(0, 1))


def _pair_stats(vals: torch.Tensor, m: torch.Tensor, corners=None,
                reduce=_total):
    """Overlap counts and Σ value over each overlap for every pair of
    (N, H, W, K) values under (N, H, W) float masks, each summed into
    cells by `reduce` ((H, W[, K]) -> (*cells[, K])). With `corners`
    (N, 2), canvas j is moved into canvas i's frame for each pair;
    without, the canvases share one frame. Returns n_p (N, N, *cells) and
    s_p (N, N, *cells, K)."""
    N = m.shape[0]
    n_p = s_p = None
    for i in range(N):
        for j in range(i + 1, N):
            if corners is None:
                mj, vj = m[j], vals[j]
            else:
                hw = tuple(m[i].shape)
                mj = shift_to_frame(m[j], corners[j], corners[i], hw)
                vj = shift_to_frame(vals[j], corners[j], corners[i], hw)
            both = m[i] * mj
            nb = reduce(both)
            if n_p is None:
                n_p = torch.zeros((N, N) + nb.shape, dtype=torch.float32,
                                  device=m.device)
                s_p = torch.zeros((N, N) + nb.shape + vals.shape[3:],
                                  dtype=torch.float32, device=m.device)
            n_p[i, j] = n_p[j, i] = nb
            s_p[i, j] = reduce(vals[i] * both[..., None])
            s_p[j, i] = reduce(vj * both[..., None])
    return n_p, s_p


def _gain_system(Ibar: torch.Tensor, n_p: torch.Tensor, areas, alpha, beta):
    """The normal equations of the gain model over the last two axes:
    Ibar (..., N, N) mean intensities, n_p (..., N, N) overlap counts,
    areas (..., N). Returns (A (..., N, N), b (..., N))."""
    N = n_p.shape[-1]
    off = 1.0 - torch.eye(N, dtype=torch.float32, device=n_p.device)
    n_acc = n_p.clamp(min=1.0) * off
    b = beta * (n_acc.sum(dim=-1) + areas)
    diag = b + 2.0 * alpha * (Ibar * Ibar * n_acc).sum(dim=-1)
    A = (torch.diag_embed(diag)
         - 2.0 * alpha * Ibar * Ibar.transpose(-1, -2) * n_acc)
    return A, b


def gain_compensate(images: torch.Tensor, masks: torch.Tensor,
                    corners: torch.Tensor | None = None, alpha: float = 0.01,
                    beta: float = 100.0, shared_frame: bool = False):
    """One gain per canvas. images (N, H, W[, C]) float32, masks (N, H, W)
    bool; corners (N, 2) (x, y) pano origins of the canvases, None when
    every canvas shares one origin (then canvas j is not moved into canvas
    i's frame for each pair); `shared_frame=True` says the same of given
    corners, which are then not read. Returns (gains (N,), images *
    gains); gains are all 1 when the solve is not finite."""
    N = images.shape[0]
    dev = images.device
    if N == 1:
        return torch.ones(1, dtype=torch.float32, device=dev), images
    m = masks.to(torch.float32)
    n_p, s_p = _pair_stats(_intensity(images)[..., None], m,
                           None if shared_frame else corners)
    Ibar = s_p[..., 0] / n_p.clamp(min=1.0)
    A, b = _gain_system(Ibar, n_p, m.sum(dim=(1, 2)), alpha, beta)
    gains = torch.linalg.solve(A, b)
    gains = torch.where(torch.isfinite(gains).all(), gains,
                        torch.ones_like(gains))
    scale = (gains[:, None, None, None] if images.ndim == 4
             else gains[:, None, None])
    return gains, images * scale


def channels_compensate(images: torch.Tensor, masks: torch.Tensor,
                        corners: torch.Tensor | None = None,
                        alpha: float = 0.01, beta: float = 100.0,
                        shared_frame: bool = False):
    """Per-channel gains (OpenCV CHANNELS): the gain system solved on each
    colour channel, whose intensity is |channel value|; one mask-stats
    pass, C batched N x N solves; corners and `shared_frame` as in
    `gain_compensate`. Returns (gains (N, C), images * gains)."""
    N, C = images.shape[0], images.shape[-1]
    dev = images.device
    if N == 1:
        return torch.ones((1, C), dtype=torch.float32, device=dev), images
    m = masks.to(torch.float32)
    n_p, s_p = _pair_stats(images.abs(), m, None if shared_frame else corners)
    Ic = (s_p / n_p.clamp(min=1.0)[..., None]).permute(2, 0, 1)  # (C, N, N)
    A, b = _gain_system(Ic, n_p[None], m.sum(dim=(1, 2))[None], alpha, beta)
    gains = torch.linalg.solve(A, b.expand(C, N)).T                # (N, C)
    gains = torch.where(torch.isfinite(gains).all(), gains,
                        torch.ones_like(gains))
    return gains, images * gains[:, None, None, :]


def _blocksum(x: torch.Tensor, block: int) -> torch.Tensor:
    """(H, W[, K]) -> (By, Bx[, K]) sums over block x block cells, the
    image zero-padded to whole cells."""
    H, W = x.shape[:2]
    By, Bx = -(-H // block), -(-W // block)
    if x.ndim == 2:
        xp = F.pad(x, (0, Bx * block - W, 0, By * block - H))
    else:
        xp = F.pad(x, (0, 0, 0, Bx * block - W, 0, By * block - H))
    return xp.reshape((By, block, Bx, block) + x.shape[2:]).sum(dim=(1, 3))


def _blocks_gain_maps(intens: torch.Tensor, m: torch.Tensor, block: int,
                      alpha: float, beta: float, smooth_iters: int
                      ) -> torch.Tensor:
    """The core of the *_BLOCKS compensators. intens (N, H, W, K)
    non-negative intensities (K = 1: the L2 norm; K = C: each channel);
    m (N, H, W) float masks. Each cell's K gain systems are solved in one
    batched solve with a 1e-6·I ridge; cells with no mask pixel get gain 1
    (cells with mask but no overlap get 1 from the prior alone). The gain
    maps are smoothed (3x3 binomial, edge padding) and bilinearly
    upsampled. Returns (N, H, W, K) gain maps."""
    N, H, W, K = intens.shape
    dev = intens.device
    By, Bx = -(-H // block), -(-W // block)
    B = By * Bx
    n_p, s_p = _pair_stats(intens, m, reduce=lambda x: _blocksum(x, block))
    n_p = n_p.reshape(N, N, B).permute(2, 0, 1)                    # (B, N, N)
    s_p = s_p.reshape(N, N, B, K).permute(3, 2, 0, 1)           # (K, B, N, N)
    Ibar = s_p / n_p.clamp(min=1.0)[None]
    areas = torch.stack([_blocksum(m[i], block).reshape(B)
                         for i in range(N)], dim=1)                # (B, N)
    A, b = _gain_system(Ibar, n_p[None], areas[None], alpha, beta)
    ridge = 1e-6 * torch.eye(N, dtype=torch.float32, device=dev)
    gains = torch.linalg.solve(A + ridge, b.expand(K, B, N))       # (K, B, N)
    gains = torch.where(torch.isfinite(gains) & (areas[None] > 0), gains,
                        torch.ones_like(gains))
    gmap = gains.reshape(K, By, Bx, N).permute(3, 0, 1, 2)  # (N, K, By, Bx)

    k = (0.25, 0.5, 0.25)
    for _ in range(smooth_iters):
        gp = F.pad(gmap, (1, 1, 1, 1), mode="replicate")
        acc = None
        for a in range(3):
            for c in range(3):
                t = (k[a] * k[c]) * gp[..., a:a + By, c:c + Bx]
                acc = t if acc is None else acc + t
        gmap = acc

    up = resize_linear_mxu(gmap, (By * block, Bx * block))  # (N, K, Hp, Wp)
    return up[..., :H, :W].permute(0, 2, 3, 1)


def gain_compensate_blocks(images: torch.Tensor, masks: torch.Tensor,
                           block: int = 32, alpha: float = 0.01,
                           beta: float = 100.0, smooth_iters: int = 1):
    """Per-block gains (OpenCV GAIN_BLOCKS) on (N, H, W[, C]) shared-frame
    canvases. Returns (gain maps (N, H, W), compensated images)."""
    N, H, W = images.shape[:3]
    if N == 1:
        return torch.ones((1, H, W), dtype=torch.float32,
                          device=images.device), images
    up = _blocks_gain_maps(_intensity(images)[..., None],
                           masks.to(torch.float32), block, alpha, beta,
                           smooth_iters)[..., 0]
    return up, images * (up[..., None] if images.ndim == 4 else up)


def channels_compensate_blocks(images: torch.Tensor, masks: torch.Tensor,
                               block: int = 32, alpha: float = 0.01,
                               beta: float = 100.0, smooth_iters: int = 1):
    """Per-channel per-block gains (OpenCV CHANNELS_BLOCKS) on (N, H, W, C)
    canvases. Returns (gain maps (N, H, W, C), compensated images)."""
    if images.shape[0] == 1:
        return torch.ones_like(images), images
    maps = _blocks_gain_maps(images.abs(), masks.to(torch.float32), block,
                             alpha, beta, smooth_iters)
    return maps, images * maps
