"""Ray-error bundle adjustment (`imagestitch_tpu.geometry.bundle`, the
reference driver's BundleAdjusterRay): per-camera (focal, Rodrigues
rotation) refined by Levenberg–Marquardt over the ray differences of all
inlier correspondences, with the same damping schedule and stopping rule
as the JAX package; the Jacobian comes from forward-mode autodiff.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from imagestitch_tpu_torch.types import CameraParams


def _cross_mat(k: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(k[..., 0])
    return torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], dim=-1),
        torch.stack([k[..., 2], z, -k[..., 0]], dim=-1),
        torch.stack([-k[..., 1], k[..., 0], z], dim=-1)], dim=-2)


def rodrigues_to_R(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices from (..., 3) Rodrigues vectors, small-angle safe."""
    theta2 = (r * r).sum(dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-24)
    K = _cross_mat(r) / theta
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    Rsmall = eye + _cross_mat(r)
    return torch.where(theta2 < 1e-12, Rsmall, R).to(torch.float32)


def R_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rodrigues vectors from (..., 3, 3) rotation matrices."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = 2.0 * torch.sin(theta)
    small = s.abs() < 1e-8
    scale = torch.where(small, torch.full_like(s, 0.5),
                        theta / torch.where(small, torch.ones_like(s), s))
    return (v * scale[..., None]).to(torch.float32)


def _rays(params: torch.Tensor, pts: torch.Tensor, ppx, ppy) -> torch.Tensor:
    """Unit rays of (P, T, 2) pixel points under per-pair camera params
    (P, 4) = (focal, r3). Returns (P, T, 3)."""
    f = params[:, 0, None]
    R = rodrigues_to_R(params[:, 1:4])
    x = (pts[..., 0] - ppx[:, None]) / f
    y = (pts[..., 1] - ppy[:, None]) / f
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rays = d @ R.transpose(-1, -2)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def _lm_minimize(residuals, x0: torch.Tensor, iters: int) -> torch.Tensor:
    """Levenberg–Marquardt on a dense residual vector: damped normal
    equations, λ·0.5 on an accepted step and λ·4 on a rejected one; stops
    when an accepted step improves the error by < 1e-6 relative or λ
    exceeds 1e8."""

    def err_of(x):
        r = residuals(x)
        return (r * r).sum()

    jac = jacfwd(residuals)
    x = x0
    lam = torch.tensor(1e-3, dtype=torch.float32, device=x0.device)
    err = err_of(x0)
    for _ in range(iters):
        r = residuals(x)
        J = jac(x)
        A = J.T @ J
        g = J.T @ r
        D = torch.diag(torch.diagonal(A).clamp(min=1e-8))
        dx = torch.linalg.solve(A + lam * D, g)
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        x_try = x - dx
        e_try = err_of(x_try)
        accept = e_try < err
        done = (accept & (err - e_try < 1e-6 * (err + 1e-20))) | (lam > 1e8)
        x = torch.where(accept, x_try, x)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e10)
        err = torch.where(accept, e_try, err)
        if bool(done):
            break
    return x


def bundle_adjust_ray(cameras: CameraParams, src_pts: torch.Tensor,
                      dst_pts: torch.Tensor, pt_valid: torch.Tensor,
                      pair_from: torch.Tensor, pair_to: torch.Tensor,
                      pair_valid: torch.Tensor, iters: int = 25
                      ) -> CameraParams:
    """Refine focals + rotations by minimizing sqrt(f_i·f_j)·(ray_i − ray_j)
    over (P, T, 2) correspondences; camera 0 is re-anchored afterwards (the
    residuals are invariant under a global rotation)."""
    N = cameras.focal.shape[0]
    x0 = torch.cat([cameras.focal[:, None], R_to_rodrigues(cameras.R)],
                   dim=1).reshape(-1)
    ppx, ppy = cameras.ppx, cameras.ppy
    pair_from = pair_from.long()
    pair_to = pair_to.long()
    m = (pt_valid & pair_valid[:, None]).to(torch.float32)

    def residuals(x):
        p = x.reshape(N, 4)
        scale = torch.sqrt((p[pair_from, 0] * p[pair_to, 0]).abs())
        rays_i = _rays(p[pair_from], src_pts, ppx[pair_from],
                       ppy[pair_from])
        rays_j = _rays(p[pair_to], dst_pts, ppx[pair_to], ppy[pair_to])
        r = (rays_i - rays_j) * scale[:, None, None] * m[..., None]
        return r.reshape(-1)

    pf = _lm_minimize(residuals, x0, iters).reshape(N, 4)
    Rf = rodrigues_to_R(pf[:, 1:4])
    G = cameras.R[0] @ Rf[0].T
    return cameras.replace(focal=pf[:, 0].abs(), R=G @ Rf)


def bundle_adjust(cameras: CameraParams, src_pts, dst_pts, pt_valid,
                  pair_from, pair_to, pair_valid, iters: int = 25,
                  kind: str = "ray") -> CameraParams:
    """Bundle-adjuster dispatch (the ray adjuster; "reproj" is not ported
    yet)."""
    if kind != "ray":
        raise NotImplementedError(
            f"bundle adjuster {kind!r} is not ported yet "
            "(ROADMAP Queue A, item 13)")
    return bundle_adjust_ray(cameras, src_pts, dst_pts, pt_valid,
                             pair_from, pair_to, pair_valid, iters)
