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

_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


@dataclass(frozen=True)
class RansacResult:
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
    errs = reproj_error_sq(Hs, src[None], dst[None])    # (B, N)
    inl = (errs <= thresh2) & mask[None, :]
    counts = inl.to(torch.int32).sum(dim=1)
    counts = torch.where(hyp_ok, counts, torch.full_like(counts, -1))

    best = torch.argmax(counts)                         # first maximum
    H_best = Hs[best]
    best_count = counts[best]
    inliers0 = inl[best]

    H_fit, fit_ok = dlt_homography(src, dst, inliers0)
    H_fit = torch.where(fit_ok, H_fit, H_best)
    H_ref = lm_refine_homography(H_fit, src, dst, inliers0, cfg.lm_iters)
    inliers = (reproj_error_sq(H_ref, src, dst) <= thresh2) & mask
    num = inliers.to(torch.int32).sum()

    ok = (best_count >= 4) & (num >= 4) & torch.isfinite(H_ref).all()
    H_out = torch.where(ok, H_ref, torch.eye(3, dtype=torch.float32,
                                             device=dev))
    return RansacResult(H=H_out, inliers=inliers, num_inliers=num, ok=ok)
