"""Batched-hypothesis RANSAC homography (`imagestitch_tpu.geometry.ransac`):
a fixed batch of minimal samples solved and scored at once, degenerate
samples masked, the winner refit with the normalized DLT on its inliers and
polished with LM.

The (B, 4) uniform draw that picks the samples can be injected (`u`), so
that tests feed the JAX package's `jax.random` numbers; otherwise it comes
from `generator` on the points' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imagestitch_tpu_torch.config import RansacConfig
from imagestitch_tpu_torch.geometry.homography import (
    dlt_homography, lm_refine_homography, reproj_error_sq, solve_h4p)
from imagestitch_tpu_torch.parallel.mesh import chunk_ranges, model_devices
from imagestitch_tpu_torch.types import _Replace

_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


@dataclass(frozen=True)
class RansacResult(_Replace):
    H: torch.Tensor            # (3, 3) float32
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor           # () bool


def _triple_areas(p: torch.Tensor) -> torch.Tensor:
    """Signed twice-areas of the 4 triples of (B, 4, 2) subsets, (B, 4)."""
    idx = torch.tensor(_TRIPLES, device=p.device)
    a, b, c = p[:, idx[:, 0]], p[:, idx[:, 1]], p[:, idx[:, 2]]
    return ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _check_subset(src4, dst4, idx4) -> torch.Tensor:
    """Degenerate-sample rejection over (B, 4, ...) samples: distinct
    indices, no near-collinear triple, consistent triple orientation."""
    distinct = (idx4[:, :, None] == idx4[:, None, :]).sum(dim=(1, 2)) == 4
    a_src = _triple_areas(src4)
    a_dst = _triple_areas(dst4)
    span_s = src4.abs().amax(dim=(1, 2)).clamp(min=1.0)[:, None]
    span_d = dst4.abs().amax(dim=(1, 2)).clamp(min=1.0)[:, None]
    noncol = ((a_src.abs() > 1e-5 * span_s * span_s).all(dim=1)
              & (a_dst.abs() > 1e-5 * span_d * span_d).all(dim=1))
    prod = torch.sign(a_src) * torch.sign(a_dst)
    orient = (prod > 0).all(dim=1) | (prod < 0).all(dim=1)
    return distinct & noncol & orient


def _score_chunk(Hs, hyp_ok, src, dst, mask, thresh2: float, error_sq):
    """Inlier masks (B, N) and counts (B,) of (B, 3, 3) hypotheses; -1
    where a hypothesis is not ok."""
    inl = (error_sq(Hs, src, dst) <= thresh2) & mask[None, :]
    counts = inl.to(torch.int32).sum(dim=1)
    return inl, torch.where(hyp_ok, counts, torch.full_like(counts, -1))


def score_hypotheses(Hs: torch.Tensor, hyp_ok: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor,
                     mask: torch.Tensor, thresh2: float, error_sq):
    """The winner of (B, 3, 3) hypotheses over (N, 2) points whose squared
    transfer errors are `error_sq(Hs, src, dst)` (B, N): (index, inlier
    count, inlier mask (N,)), the first maximum of the counts as
    `jnp.argmax` picks it.

    With an active mesh whose "model" axis has k > 1 devices
    (`parallel.mesh.use_mesh`), the hypotheses are scored in k contiguous
    chunks, one on each model device, and each chunk's first maximum
    (its count, index and inlier row) is gathered to the points' device:
    the first chunk holding the largest count holds the same index that
    one argmax over all counts gives."""
    devs = model_devices()
    if len(devs) <= 1:
        inl, counts = _score_chunk(Hs, hyp_ok, src, dst, mask, thresh2,
                                   error_sq)
        best = torch.argmax(counts)                     # first maximum
        return best, counts[best], inl[best]
    home = src.device
    tops, idxs, rows = [], [], []
    for dev, (a, b) in zip(devs, chunk_ranges(Hs.shape[0], len(devs))):
        if a == b:
            continue
        inl, counts = _score_chunk(Hs[a:b].to(dev), hyp_ok[a:b].to(dev),
                                   src.to(dev), dst.to(dev), mask.to(dev),
                                   thresh2, error_sq)
        j = torch.argmax(counts)
        tops.append(counts[j].to(home))
        idxs.append((j + a).to(home))
        rows.append(inl[j].to(home))
    c = torch.argmax(torch.stack(tops))                 # first chunk
    return torch.stack(idxs)[c], torch.stack(tops)[c], torch.stack(rows)[c]


def find_homography(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                    cfg: RansacConfig = RansacConfig(),
                    u: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> RansacResult:
    """RANSAC + DLT refit + LM polish over (N, 2) padded point sets with an
    (N,) validity mask. `u`: optional (num_hypotheses, 4) uniform draw."""
    dev = src.device
    B = cfg.num_hypotheses
    m = mask.to(torch.float32)
    nvalid = m.sum().to(torch.int64)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    if u is None:
        u = torch.rand((B, 4), generator=generator, device=dev)
    if not torch.is_tensor(u):
        u = torch.from_numpy(np.array(u, np.float32))
    u = u.to(device=dev, dtype=torch.float32)
    raw = torch.floor(u * nvalid.clamp(min=1).to(torch.float32))
    raw = torch.minimum(raw.to(torch.int64).clamp(min=0),
                        (nvalid - 1).clamp(min=0))
    idx = order[raw]                                   # (B, 4)
    src4 = src[idx]
    dst4 = dst[idx]

    good = _check_subset(src4, dst4, idx)
    Hs, ok_solve = solve_h4p(src4, dst4)
    hyp_ok = good & ok_solve & (nvalid >= 4)

    thresh2 = float(cfg.reproj_threshold ** 2)
    best, best_count, inliers0 = score_hypotheses(
        Hs, hyp_ok, src, dst, mask, thresh2,
        lambda H, s, d: reproj_error_sq(H, s[None], d[None]))
    H_best = Hs[best]

    H_fit, fit_ok = dlt_homography(src, dst, inliers0)
    H_fit = torch.where(fit_ok, H_fit, H_best)
    H_ref = lm_refine_homography(H_fit, src, dst, inliers0, cfg.lm_iters)
    inliers = (reproj_error_sq(H_ref, src, dst) <= thresh2) & mask
    num = inliers.to(torch.int32).sum()

    ok = (best_count >= 4) & (num >= 4) & torch.isfinite(H_ref).all()
    H_out = torch.where(ok, H_ref, torch.eye(3, dtype=torch.float32,
                                             device=dev))
    return RansacResult(H=H_out, inliers=inliers, num_inliers=num, ok=ok)
