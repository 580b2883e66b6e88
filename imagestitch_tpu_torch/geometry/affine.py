"""Batched-hypothesis RANSAC affine estimation, the SCANS motion model
(`imagestitch_tpu.geometry.affine`; OpenCV's estimateAffinePartial2D /
estimateAffine2D as AffineBestOf2NearestMatcher uses them): a fixed batch
of minimal samples (2 points for the 4-DoF similarity, 3 for the 6-DoF
affine) solved and scored at once, the winner refit by masked least
squares, which is the exact minimizer of this linear model.

Transforms are (3, 3) float32 with last row (0, 0, 1), so they travel as
`MatchesInfo.H` and as warp cameras unchanged. The (B, P) uniform draw
that picks the samples can be injected (`u`), so that tests feed the JAX
package's `jax.random` numbers; otherwise it comes from `generator` on
the points' device.
"""

from __future__ import annotations

import numpy as np
import torch

from imagestitch_tpu_torch.config import RansacConfig
from imagestitch_tpu_torch.geometry.ransac import (RansacResult,
                                                   score_hypotheses)


def _promote(P: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) affine -> (..., 3, 3) with last row (0, 0, 1)."""
    last = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                        device=P.device).expand(P.shape[:-2] + (1, 3))
    return torch.cat([P.to(torch.float32), last], dim=-2)


def solve_affine_partial_2p(src2: torch.Tensor, dst2: torch.Tensor):
    """Similarity dst = [a, -b; b, a]·src + t from (..., 2, 2) point pairs
    ((a + ib) is the complex ratio of the point differences). Returns
    ((..., 3, 3), ok)."""
    ds = src2[..., 1, :] - src2[..., 0, :]
    dd = dst2[..., 1, :] - dst2[..., 0, :]
    n2 = ds[..., 0] * ds[..., 0] + ds[..., 1] * ds[..., 1]
    ok = n2 > 1e-8
    n2s = n2.clamp(min=1e-8)
    a = (dd[..., 0] * ds[..., 0] + dd[..., 1] * ds[..., 1]) / n2s
    b = (dd[..., 1] * ds[..., 0] - dd[..., 0] * ds[..., 1]) / n2s
    x0, y0 = src2[..., 0, 0], src2[..., 0, 1]
    tx = dst2[..., 0, 0] - (a * x0 - b * y0)
    ty = dst2[..., 0, 1] - (b * x0 + a * y0)
    P = torch.stack([torch.stack([a, -b, tx], -1),
                     torch.stack([b, a, ty], -1)], -2)
    return _promote(P), ok


def solve_affine_3p(src3: torch.Tensor, dst3: torch.Tensor):
    """Full 6-DoF affine from (..., 3, 2) point triples: two 3x3 solves
    against [x, y, 1]. Returns ((..., 3, 3), ok)."""
    S = torch.cat([src3, torch.ones_like(src3[..., :1])], dim=-1)
    det = torch.linalg.det(S)
    span = src3.abs().amax(dim=(-2, -1)).clamp(min=1.0)
    ok = det.abs() > 1e-5 * span * span
    eye = torch.eye(3, dtype=torch.float32, device=S.device)
    Ssafe = torch.where(ok[..., None, None], S, eye)
    rows = torch.linalg.solve(Ssafe, dst3)              # (..., 3, 2)
    return _promote(rows.transpose(-1, -2)), ok


def affine_error_sq(A: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """Squared transfer error ||A·[src, 1] − dst||² of (N, 2) points under
    one (3, 3) or a batch (..., 3, 3) of transforms: (N,) or (..., N)."""
    x = (A[..., 0, 0, None] * src[:, 0] + A[..., 0, 1, None] * src[:, 1]
         + A[..., 0, 2, None])
    y = (A[..., 1, 0, None] * src[:, 0] + A[..., 1, 1, None] * src[:, 1]
         + A[..., 1, 2, None])
    dx = x - dst[:, 0]
    dy = y - dst[:, 1]
    return dx * dx + dy * dy


def ls_affine(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              partial: bool):
    """Masked least-squares affine fit with (N,) float weights w. partial:
    the 4-DoF similarity [a, -b, tx; b, a, ty] from its 4x4 normal
    equations (rows [x, -y, 1, 0] and [y, x, 0, 1] per point); else the
    6-DoF normal equations XᵀWX (3x3) solved for both output rows.
    Returns ((3, 3), ok)."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    dev = src.device
    if partial:
        sw = w.sum()
        sxx = (w * (x * x + y * y)).sum()
        sx = (w * x).sum()
        sy = (w * y).sum()
        z = torch.zeros((), dtype=torch.float32, device=dev)
        A4 = torch.stack([torch.stack([sxx, z, sx, sy]),
                          torch.stack([z, sxx, -sy, sx]),
                          torch.stack([sx, -sy, sw, z]),
                          torch.stack([sy, sx, z, sw])])
        b4 = torch.stack([(w * (x * u + y * v)).sum(),
                          (w * (x * v - y * u)).sum(),
                          (w * u).sum(), (w * v).sum()])
        ok = sw >= 2
        sol = torch.linalg.solve(
            A4 + 1e-8 * torch.eye(4, dtype=torch.float32, device=dev), b4)
        a, b, tx, ty = sol[0], sol[1], sol[2], sol[3]
        P = torch.stack([torch.stack([a, -b, tx]), torch.stack([b, a, ty])])
    else:
        X = torch.stack([x, y, torch.ones_like(x)], dim=1)     # (N, 3)
        Xw = X * w[:, None]
        G = X.T @ Xw
        ok = w.sum() >= 3
        Gs = G + 1e-8 * torch.eye(3, dtype=torch.float32, device=dev)
        P = torch.linalg.solve(Gs, Xw.T @ dst).T               # (2, 3)
    A = _promote(P)
    return A, ok & torch.isfinite(A).all()


def find_affine(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                cfg: RansacConfig = RansacConfig(), partial: bool = True,
                u: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> RansacResult:
    """RANSAC affine (partial: 2-point similarity samples; full: 3-point)
    + least-squares refit on the winner's inliers, over (N, 2) padded point
    sets with an (N,) validity mask. `u`: optional (num_hypotheses, P)
    uniform draw, P = 2 (partial) or 3."""
    dev = src.device
    B = cfg.num_hypotheses
    P = 2 if partial else 3
    nvalid = mask.to(torch.int64).sum()
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    if u is None:
        u = torch.rand((B, P), generator=generator, device=dev)
    if not torch.is_tensor(u):
        u = torch.from_numpy(np.array(u, np.float32))
    u = u.to(device=dev, dtype=torch.float32)
    if tuple(u.shape) != (B, P):
        raise ValueError(f"affine draws: ({B}, {P}) expected, got "
                         f"{tuple(u.shape)}")
    raw = torch.floor(u * nvalid.clamp(min=1).to(torch.float32))
    raw = torch.minimum(raw.to(torch.int64).clamp(min=0),
                        (nvalid - 1).clamp(min=0))
    idx = order[raw]                                    # (B, P)
    distinct = (idx[:, :, None] == idx[:, None, :]).sum(dim=(1, 2)) == P

    solve = solve_affine_partial_2p if partial else solve_affine_3p
    As, ok_solve = solve(src[idx], dst[idx])
    hyp_ok = distinct & ok_solve & (nvalid >= P)

    thresh2 = float(cfg.reproj_threshold ** 2)
    best, best_count, inliers0 = score_hypotheses(
        As, hyp_ok, src, dst, mask, thresh2, affine_error_sq)

    A_fit, fit_ok = ls_affine(src, dst, inliers0.to(torch.float32),
                              partial)
    A_ref = torch.where(fit_ok, A_fit, As[best])
    inliers = (affine_error_sq(A_ref, src, dst) <= thresh2) & mask
    num = inliers.to(torch.int32).sum()
    ok = (best_count >= P) & (num >= P) & torch.isfinite(A_ref).all()
    A_out = torch.where(ok, A_ref, torch.eye(3, dtype=torch.float32,
                                             device=dev))
    return RansacResult(H=A_out, inliers=inliers, num_inliers=num, ok=ok)
