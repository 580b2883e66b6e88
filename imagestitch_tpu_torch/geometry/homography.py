"""Homography numerics (`imagestitch_tpu.geometry.homography`): the
normalized DLT (9x9 eigh), the closed-form 4-point solve, the
reprojection error and the 8-parameter Levenberg–Marquardt refinement.

Every function is mask-aware over fixed-capacity padded point sets, and
`solve_h4p` takes a leading batch of minimal samples (the RANSAC engine
solves all hypotheses in one call).
"""

from __future__ import annotations

import torch


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=ref.device)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map (..., N, 2) points through (..., 3, 3) homographies; the divide
    is guarded with a signed epsilon so padded points stay finite."""
    ones = torch.ones_like(pts[..., :1])
    p = torch.cat([pts, ones], dim=-1)
    q = p @ H.transpose(-1, -2)
    w = q[..., 2:3]
    eps = torch.where(w < 0, torch.full_like(w, -1e-12),
                      torch.full_like(w, 1e-12))
    w = torch.where(w.abs() < 1e-12, eps, w)
    return q[..., :2] / w


def reproj_error_sq(H: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """Squared reprojection error per point, |H·src/w − dst|²."""
    d = apply_homography(H, src) - dst
    return (d * d).sum(dim=-1)


def _normalization(pts: torch.Tensor, mask: torch.Tensor):
    """L1 point normalization: centroid and inverse mean absolute
    deviation per axis over the masked points."""
    m = mask.to(torch.float32)
    n = m.sum().clamp(min=1.0)
    c = (pts * m[:, None]).sum(dim=0) / n
    d = (pts - c).abs() * m[:, None]
    mad = d.sum(dim=0) / n
    return c, 1.0 / mad.clamp(min=1e-12)


def dlt_homography(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor):
    """Normalized DLT over a masked point set -> (H scaled to H[2,2] = 1,
    ok). The eigenvector of the smallest eigenvalue of LᵀL; its sign is
    arbitrary, so compare results after the h33 = 1 scaling."""
    m = mask.to(torch.float32)
    src = torch.where(mask[:, None], src, torch.zeros_like(src))
    dst = torch.where(mask[:, None], dst, torch.zeros_like(dst))
    cM, sM = _normalization(src, mask)
    cm, sm = _normalization(dst, mask)
    X = (src[:, 0] - cM[0]) * sM[0]
    Y = (src[:, 1] - cM[1]) * sM[1]
    x = (dst[:, 0] - cm[0]) * sm[0]
    y = (dst[:, 1] - cm[1]) * sm[1]
    zeros = torch.zeros_like(X)
    ones = torch.ones_like(X)
    Lx = torch.stack([X, Y, ones, zeros, zeros, zeros, -x * X, -x * Y, -x], 1)
    Ly = torch.stack([zeros, zeros, zeros, X, Y, ones, -y * X, -y * Y, -y], 1)
    L = torch.cat([Lx * m[:, None], Ly * m[:, None]], dim=0)
    _, V = torch.linalg.eigh(L.T @ L)        # ascending eigenvalues
    H0 = V[:, 0].reshape(3, 3)

    one = torch.ones((), dtype=torch.float32, device=src.device)
    zero = torch.zeros_like(one)
    Tsrc = torch.stack([
        torch.stack([sM[0], zero, -cM[0] * sM[0]]),
        torch.stack([zero, sM[1], -cM[1] * sM[1]]),
        torch.stack([zero, zero, one])])
    invTdst = torch.stack([
        torch.stack([1.0 / sm[0], zero, cm[0]]),
        torch.stack([zero, 1.0 / sm[1], cm[1]]),
        torch.stack([zero, zero, one])])
    H = invTdst @ H0 @ Tsrc
    scale = H[2, 2]
    ok = (scale.abs() > 1e-10) & torch.isfinite(H).all() & (m.sum() >= 4)
    H = H / torch.where(ok, scale, one)
    H = torch.where(ok, H, _eye3(H))
    return H.to(torch.float32), ok


def _adjugate3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of (..., 3, 3) matrices (adj(M)·M = det(M)·I)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [e * i - f * h, c * h - b * i, b * f - c * e],
        [f * g - d * i, a * i - c * g, c * d - a * f],
        [d * h - e * g, b * g - a * h, a * e - b * d],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _hom(q: torch.Tensor) -> torch.Tensor:
    """(..., 2) points -> (..., 3) homogeneous."""
    return torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)


def _basis_to_quad(q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) quads -> (..., 3, 3) M mapping the projective basis to
    them: columns are the first three points scaled so they sum to the
    fourth."""
    P = _hom(q[..., :3, :]).transpose(-1, -2)          # columns = points
    lam = (_adjugate3(P) @ _hom(q[..., 3, :])[..., None])[..., 0]
    return P * lam[..., None, :]


def _norm_T(q: torch.Tensor):
    """Per-quad centering and isotropic mean-absolute-deviation scaling."""
    c = q.mean(dim=-2, keepdim=True)
    s = 1.0 / (q - c).abs().mean(dim=(-2, -1)).clamp(min=1e-12)
    T = torch.zeros(q.shape[:-2] + (3, 3), dtype=torch.float32,
                    device=q.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -c[..., 0, 0] * s
    T[..., 1, 2] = -c[..., 0, 1] * s
    T[..., 2, 2] = 1.0
    return (q - c) * s[..., None, None], T


def solve_h4p(src4: torch.Tensor, dst4: torch.Tensor):
    """Exact homographies from (..., 4, 2) correspondences by the
    projective-basis construction H = M_dst · adj(M_src), on normalized
    quads. Returns (H (..., 3, 3), ok (...))."""
    src_n, Tsrc = _norm_T(src4)
    dst_n, Tdst = _norm_T(dst4)
    Hn = _basis_to_quad(dst_n) @ _adjugate3(_basis_to_quad(src_n))
    H = _adjugate3(Tdst) @ Hn @ Tsrc
    scale = H[..., 2, 2]
    ok = torch.isfinite(H).all(dim=-1).all(dim=-1) & (scale.abs() > 1e-20)
    H = H / torch.where(ok, scale, torch.ones_like(scale))[..., None, None]
    H = torch.where(ok[..., None, None], H, _eye3(H).expand_as(H))
    return H.to(torch.float32), ok


def _lm_jacobian_residual(h8, src, dst, mask):
    """Residuals (2N,) and analytic Jacobian (2N, 8) of the 8-parameter
    homography (h22 = 1); masked rows are zero."""
    src = torch.where(mask[:, None], src, torch.zeros_like(src))
    dst = torch.where(mask[:, None], dst, torch.zeros_like(dst))
    Mx, My = src[:, 0], src[:, 1]
    h = h8
    w = h[6] * Mx + h[7] * My + 1.0
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    ww = 1.0 / w
    xi = (h[0] * Mx + h[1] * My + h[2]) * ww
    yi = (h[3] * Mx + h[4] * My + h[5]) * ww
    m = mask.to(torch.float32)
    rx = (xi - dst[:, 0]) * m
    ry = (yi - dst[:, 1]) * m
    zeros = torch.zeros_like(Mx)
    Jx = torch.stack([Mx * ww, My * ww, ww, zeros, zeros, zeros,
                      -Mx * ww * xi, -My * ww * xi], 1) * m[:, None]
    Jy = torch.stack([zeros, zeros, zeros, Mx * ww, My * ww, ww,
                      -Mx * ww * yi, -My * ww * yi], 1) * m[:, None]
    return torch.cat([rx, ry]), torch.cat([Jx, Jy], dim=0)


def lm_refine_homography(H: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, mask: torch.Tensor,
                         iters: int = 10) -> torch.Tensor:
    """Fixed-iteration Levenberg–Marquardt over masked correspondences:
    damped normal equations (A + λ·diag A)·dx = Jᵀr, λ halved on an
    accepted step and quadrupled on a rejected one. A step the solve
    cannot give (a singular system, or one that is not finite) is no step,
    as in the JAX package, where the solve returns it as inf or NaN;
    `torch.linalg.solve_ex` reports it without raising."""
    s = torch.where(H[2, 2].abs() > 1e-12, H[2, 2],
                    torch.ones_like(H[2, 2]))
    h8 = (H / s).reshape(-1)[:8]

    def err_of(hh):
        r, _ = _lm_jacobian_residual(hh, src, dst, mask)
        return (r * r).sum()

    lam = torch.tensor(1e-3, dtype=torch.float32, device=H.device)
    err = err_of(h8)
    for _ in range(iters):
        r, J = _lm_jacobian_residual(h8, src, dst, mask)
        A = J.T @ J
        g = J.T @ r
        D = torch.diag(torch.diagonal(A).clamp(min=1e-12))
        dx, info = torch.linalg.solve_ex(A + lam * D, g)
        dx = torch.where((info == 0) & torch.isfinite(dx).all(), dx,
                         torch.zeros_like(dx))
        h_try = h8 - dx
        err_try = err_of(h_try)
        accept = err_try < err
        h8 = torch.where(accept, h_try, h8)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-12, 1e12)
        err = torch.where(accept, err_try, err)
    return torch.cat([h8, torch.ones_like(h8[:1])]).reshape(3, 3)
