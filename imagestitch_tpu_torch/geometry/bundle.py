"""Bundle adjustment and wave correction (`imagestitch_tpu.geometry.
bundle`): the ray-error adjuster (the reference program's
BundleAdjusterRay: per-camera focal and Rodrigues rotation) and the
reprojection adjuster (OpenCV's BundleAdjusterReproj: focal, ppx, ppy,
aspect and rotation), both refined by Levenberg–Marquardt over all inlier
correspondences with the same damping schedule and stopping rule as the
JAX package; OpenCV's waveCorrect; and SCANS mode's joint affine
adjustment (`bundle_adjust_affine`, one least-squares solve on the host in
NumPy, as in the JAX package).

The LM loop runs one of two ways, chosen by what the inputs are
(`takes_kernel`): on a CUDA device, with at most `cuda_lm.MAX_PARAMS`
parameters (32 ray or 18 reprojection cameras), the whole loop is one
launch of the kernel of `csrc/lm_bundle.cu` (the Jacobian from
forward-mode dual numbers inside it) and one readback; CPU tensors and
larger problems take the plain loop `_lm_minimize` (the Jacobian from
forward-mode autodiff, `torch.func.jacfwd`).
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.func import jacfwd

from imagestitch_tpu_torch.ops import cuda_lm
from imagestitch_tpu_torch.types import CameraParams
from imagestitch_tpu_torch.utils import log


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


def rotation_defect(R: torch.Tensor) -> float:
    """The largest ‖RᵀR − I‖_F over (..., 3, 3) matrices, in float64 on
    the host: 0 for rotations up to float32 rounding (about 1e-7), and
    what a rotation chained through homographies is off by."""
    Rh = R.detach().to("cpu", torch.float64).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=torch.float64)
    return float(torch.linalg.matrix_norm(Rh.transpose(-1, -2) @ Rh - eye)
                 .max())


def nearest_rotation(R: torch.Tensor) -> torch.Tensor:
    """The rotation nearest to each (..., 3, 3) matrix, as OpenCV's
    BundleAdjusterBase::setUpInitialCameraParams takes it: the polar
    factor U·Vᵀ of the SVD, negated where its determinant is -1 (a
    homography's sign). Worked out in float64 on the host; float32 on R's
    device."""
    Rh = R.detach().to("cpu", torch.float64)
    U, _, Vh = torch.linalg.svd(Rh)
    P = U @ Vh
    P = torch.where((torch.linalg.det(P) < 0)[..., None, None], -P, P)
    return P.to(device=R.device, dtype=torch.float32)


# a start rotation within this of orthonormal (‖RᵀR − I‖_F) anchors as it
# is: the pair and chain fronts start camera 0 at the identity
ANCHOR_DEFECT = 1e-6


def _anchor(R0: torch.Tensor) -> torch.Tensor:
    """The rotation that camera 0 keeps through an adjustment: its start
    `R0` where that is a rotation, else `nearest_rotation(R0)`. The
    N-view fronts chain view 0's start through homographies
    (`estimate_cameras_host`), which shears it; re-anchoring every
    adjusted camera on a sheared R0 would shear them all."""
    if rotation_defect(R0) < ANCHOR_DEFECT:
        return R0
    return nearest_rotation(R0)


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


# torch's forward-mode autodiff numbers its dual levels in process-wide
# state: two threads inside jacfwd at once (the shards of a mesh on
# distinct devices) delete each other's levels, so one Jacobian is taken
# at a time
_JACOBIAN_LOCK = threading.Lock()


def takes_kernel(device: torch.device, n_params: int) -> bool:
    """Whether an adjustment of `n_params` parameters on `device` runs
    as one launch of the LM kernel (`ops/cuda_lm`): on a CUDA device, when
    the kernel's shared-memory system holds the parameters."""
    return device.type == "cuda" and cuda_lm.fits(n_params)


def _lm_minimize(residuals, x0: torch.Tensor, iters: int) -> torch.Tensor:
    """Levenberg–Marquardt on a dense residual vector, the plain loop
    (CPU tensors, or more parameters than the kernel holds): damped normal
    equations with the Jacobian from forward-mode autodiff (`jacfwd`),
    λ·0.5 on an accepted step and λ·4 on a rejected one; stops when an
    accepted step improves the error by < 1e-6 relative or λ exceeds 1e8.
    Each iteration (the Jacobian, the solve and the host's read of the
    stopping test) is a stage `lm_step` of the active timer and adds 1 to
    its counter `lm_iters`."""

    def err_of(x):
        r = residuals(x)
        return (r * r).sum()

    jac = jacfwd(residuals)
    x = x0
    lam = torch.tensor(1e-3, dtype=torch.float32, device=x0.device)
    err = err_of(x0)
    for _ in range(iters):
        log.count("lm_iters")
        with log.stage("lm_step"):
            r = residuals(x)
            with _JACOBIAN_LOCK:
                J = jac(x)
            A = J.T @ J
            g = J.T @ r
            D = torch.diag(torch.diagonal(A).clamp(min=1e-8))
            dx = torch.linalg.solve(A + lam * D, g)
            dx = torch.where(torch.isfinite(dx).all(), dx,
                             torch.zeros_like(dx))
            x_try = x - dx
            e_try = err_of(x_try)
            accept = e_try < err
            done = ((accept & (err - e_try < 1e-6 * (err + 1e-20)))
                    | (lam > 1e8))
            x = torch.where(accept, x_try, x)
            lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10,
                                                                  1e10)
            err = torch.where(accept, e_try, err)
            stop = bool(done)
        if stop:
            break
    return x


def _lm_kernel(kind: str, x0: torch.Tensor, src_pts, dst_pts, pt_valid,
               pair_valid, pair_from, pair_to, iters: int, ppx=None,
               ppy=None) -> torch.Tensor:
    """The LM loop as one launch of the kernel (`cuda_lm.lm_minimize`) and
    its one readback, a stage `lm_step` of the active timer; adds the
    iterations the kernel ran to the counter `lm_iters` and 1 to
    `lm_fused`."""
    log.count("lm_fused")
    with log.stage("lm_step"):
        x, n_iters, _ = cuda_lm.lm_minimize(
            kind, x0, src_pts, dst_pts, pt_valid, pair_valid, pair_from,
            pair_to, ppx, ppy, iters)
    log.count("lm_iters", n_iters)
    return x


def _ray_residuals(src_pts, dst_pts, pt_valid, pair_from, pair_to,
                   pair_valid, ppx, ppy):
    """The ray adjuster's residual function of x ((N·4,): focal, r3 per
    camera): sqrt(f_i·f_j)·(ray_i − ray_j) per correspondence, masked."""
    m = (pt_valid & pair_valid[:, None]).to(torch.float32)

    def residuals(x):
        p = x.reshape(-1, 4)
        scale = torch.sqrt((p[pair_from, 0] * p[pair_to, 0]).abs())
        rays_i = _rays(p[pair_from], src_pts, ppx[pair_from],
                       ppy[pair_from])
        rays_j = _rays(p[pair_to], dst_pts, ppx[pair_to], ppy[pair_to])
        r = (rays_i - rays_j) * scale[:, None, None] * m[..., None]
        return r.reshape(-1)

    return residuals


def _reproj_residuals(src_pts, dst_pts, pt_valid, pair_from, pair_to,
                      pair_valid):
    """The reprojection adjuster's residual function of x ((N·7,): focal,
    ppx, ppy, aspect, r3 per camera): the transfer's pixel error per
    correspondence, masked."""
    m = (pt_valid & pair_valid[:, None]).to(torch.float32)

    def residuals(x):
        p = x.reshape(-1, 7)
        pi, pj = p[pair_from], p[pair_to]
        fi, pxi, pyi, ai = (pi[:, k, None] for k in range(4))
        fj, pxj, pyj, aj = (pj[:, k, None] for k in range(4))
        Ri = rodrigues_to_R(pi[:, 4:7])
        Rj = rodrigues_to_R(pj[:, 4:7])
        xx = (src_pts[..., 0] - pxi) / fi
        yy = (src_pts[..., 1] - pyi) / (fi * ai)
        d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
        w = (d @ Ri.transpose(-1, -2)) @ Rj
        z = torch.where(w[..., 2].abs() < 1e-8,
                        torch.full_like(w[..., 2], 1e-8), w[..., 2])
        u = fj * w[..., 0] / z + pxj
        v = fj * aj * w[..., 1] / z + pyj
        r = (torch.stack([u, v], dim=-1) - dst_pts) * m[..., None]
        return r.reshape(-1)

    return residuals


def bundle_adjust_ray(cameras: CameraParams, src_pts: torch.Tensor,
                      dst_pts: torch.Tensor, pt_valid: torch.Tensor,
                      pair_from: torch.Tensor, pair_to: torch.Tensor,
                      pair_valid: torch.Tensor, iters: int = 25
                      ) -> CameraParams:
    """Refine focals + rotations by minimizing sqrt(f_i·f_j)·(ray_i − ray_j)
    over (P, T, 2) correspondences; camera 0 is re-anchored afterwards on
    its start rotation (`_anchor`: the residuals are invariant under a
    global rotation)."""
    N = cameras.focal.shape[0]
    x0 = torch.cat([cameras.focal[:, None], R_to_rodrigues(cameras.R)],
                   dim=1).reshape(-1)
    ppx, ppy = cameras.ppx, cameras.ppy
    pair_from = pair_from.long()
    pair_to = pair_to.long()
    if takes_kernel(x0.device, x0.numel()):
        pf = _lm_kernel("ray", x0, src_pts, dst_pts, pt_valid, pair_valid,
                        pair_from, pair_to, iters, ppx, ppy)
    else:
        pf = _lm_minimize(_ray_residuals(src_pts, dst_pts, pt_valid,
                                         pair_from, pair_to, pair_valid,
                                         ppx, ppy), x0, iters)
    pf = pf.reshape(N, 4)
    Rf = rodrigues_to_R(pf[:, 1:4])
    G = _anchor(cameras.R[0]) @ Rf[0].T
    return cameras.replace(focal=pf[:, 0].abs(), R=G @ Rf)


def bundle_adjust_reproj(cameras: CameraParams, src_pts: torch.Tensor,
                         dst_pts: torch.Tensor, pt_valid: torch.Tensor,
                         pair_from: torch.Tensor, pair_to: torch.Tensor,
                         pair_valid: torch.Tensor, iters: int = 25
                         ) -> CameraParams:
    """Refine (focal, ppx, ppy, aspect, Rodrigues rotation) per camera by
    minimizing the pixel error of the rotation-only transfer
    proj(K_j·R_jᵀ·R_i·K_i⁻¹·[p, 1]) − q over (P, T, 2) correspondences;
    camera 0 is re-anchored afterwards on its start rotation (`_anchor`)."""
    N = cameras.focal.shape[0]
    x0 = torch.cat([cameras.focal[:, None], cameras.ppx[:, None],
                    cameras.ppy[:, None], cameras.aspect[:, None],
                    R_to_rodrigues(cameras.R)], dim=1).reshape(-1)
    pair_from = pair_from.long()
    pair_to = pair_to.long()
    if takes_kernel(x0.device, x0.numel()):
        pf = _lm_kernel("reproj", x0, src_pts, dst_pts, pt_valid,
                        pair_valid, pair_from, pair_to, iters)
    else:
        pf = _lm_minimize(_reproj_residuals(src_pts, dst_pts, pt_valid,
                                            pair_from, pair_to, pair_valid),
                          x0, iters)
    pf = pf.reshape(N, 7)
    Rf = rodrigues_to_R(pf[:, 4:7])
    G = _anchor(cameras.R[0]) @ Rf[0].T
    return cameras.replace(focal=pf[:, 0].abs(), ppx=pf[:, 1],
                           ppy=pf[:, 2], aspect=pf[:, 3].abs(), R=G @ Rf)


def bundle_adjust(cameras: CameraParams, src_pts, dst_pts, pt_valid,
                  pair_from, pair_to, pair_valid, iters: int = 25,
                  kind: str = "ray") -> CameraParams:
    """Bundle-adjuster dispatch: kind "ray" (BundleAdjusterRay) or
    "reproj" (BundleAdjusterReproj)."""
    fn = {"ray": bundle_adjust_ray, "reproj": bundle_adjust_reproj}[kind]
    return fn(cameras, src_pts, dst_pts, pt_valid, pair_from, pair_to,
              pair_valid, iters)


def bundle_adjust_affine(Gs, src_pts, dst_pts, pt_valid,
                         pair_from, pair_to, pair_valid,
                         anchor: int = 0, partial: bool = True):
    """Joint affine bundle adjustment (OpenCV BundleAdjusterAffinePartial /
    BundleAdjusterAffine, the SCANS-mode refiners), host NumPy.

    The residual of a correspondence (x in image u, y in image v) under
    global transforms is G_u·[x,1] − G_v·[y,1], linear in every
    transform's entries, so the joint optimum is one least-squares solve
    of the normal equations (4 unknowns per camera for the similarity
    model, 6 for the full affine), with the anchor camera's transform
    pinned as the gauge and a 1e-6 prior toward the chained transforms
    (which keeps unconstrained cameras in place).

    Gs: (N, 3, 3) chained initial transforms; src_pts/dst_pts: (P, T, 2);
    pt_valid: (P, T) bool; pair_from/to: (P,); pair_valid: (P,) bool, all
    host arrays. Returns the refined (N, 3, 3) float32."""
    Gs = np.asarray(Gs, np.float64)
    N = Gs.shape[0]
    k = 4 if partial else 6

    def params_of(G):
        if partial:
            return np.array([G[0, 0], G[1, 0], G[0, 2], G[1, 2]])
        return np.array([G[0, 0], G[0, 1], G[0, 2],
                         G[1, 0], G[1, 1], G[1, 2]])

    def G_of(p):
        if partial:
            a, b, tx, ty = p
            return np.array([[a, -b, tx], [b, a, ty], [0, 0, 1.0]])
        return np.array([[p[0], p[1], p[2]], [p[3], p[4], p[5]],
                         [0, 0, 1.0]])

    def rows(pts):
        """Coefficient rows (T, 2, k): the residual's two rows as
        functions of a camera's params, at its own points."""
        x, y = pts[:, 0], pts[:, 1]
        one = np.ones_like(x)
        zero = np.zeros_like(x)
        if partial:
            r1 = np.stack([x, -y, one, zero], 1)
            r2 = np.stack([y, x, zero, one], 1)
        else:
            r1 = np.stack([x, y, one, zero, zero, zero], 1)
            r2 = np.stack([zero, zero, zero, x, y, one], 1)
        return np.stack([r1, r2], 1)

    M = np.zeros((k * N, k * N))
    for p in range(src_pts.shape[0]):
        if not bool(pair_valid[p]):
            continue
        w = np.asarray(pt_valid[p], np.float64)
        if w.sum() < 2:
            continue
        u, v = int(pair_from[p]), int(pair_to[p])
        Cu = rows(np.asarray(src_pts[p], np.float64))
        Cv = rows(np.asarray(dst_pts[p], np.float64))
        Cu_w = Cu * w[:, None, None]
        uu = np.einsum("trk,trl->kl", Cu_w, Cu)
        uv = np.einsum("trk,trl->kl", Cu_w, Cv)
        vv = np.einsum("trk,trl->kl", Cv * w[:, None, None], Cv)
        su, sv = slice(k * u, k * u + k), slice(k * v, k * v + k)
        M[su, su] += uu
        M[sv, sv] += vv
        M[su, sv] -= uv
        M[sv, su] -= uv.T

    p0 = np.concatenate([params_of(Gs[i]) for i in range(N)])
    lam = 1e-6 * max(np.trace(M) / max(k * N, 1), 1.0)
    M += lam * np.eye(k * N)
    b = lam * p0.copy()

    # gauge: the anchor's (known) params move to the right-hand side
    free = np.ones(k * N, bool)
    free[k * anchor:k * anchor + k] = False
    pa = params_of(Gs[anchor])
    b_free = b[free] - M[np.ix_(free, ~free)] @ pa
    sol = np.linalg.solve(M[np.ix_(free, free)], b_free)

    p_all = np.empty(k * N)
    p_all[~free] = pa
    p_all[free] = sol
    out = np.stack([G_of(p_all[k * i:k * i + k]) for i in range(N)])
    return out.astype(np.float32)


def wave_correct(R: torch.Tensor, kind: str = "horiz") -> torch.Tensor:
    """Straighten the panorama's horizon (OpenCV detail::waveCorrect):
    rotate all (N, 3, 3) cameras by one global rotation whose up axis is
    the smallest-eigenvalue direction of the cameras' x-axis moment
    ("horiz") or the largest ("vert").

    The 3x3 eigen-decomposition and the global rotation are computed on
    the host in float32 (a device solver would cost more in launches and
    a readback than the arithmetic); only the product with R runs on R's
    device. The result does not depend on the eigenvectors' signs."""
    Rh = R.detach().to("cpu", torch.float32)
    x_axes = Rh[:, :, 0]
    _, V = torch.linalg.eigh(x_axes.T @ x_axes)
    rg1 = V[:, 0] if kind == "horiz" else V[:, 2]
    img_k = Rh[:, :, 2].sum(dim=0)
    rg0 = torch.linalg.cross(rg1, img_k)
    rg0 = rg0 / torch.linalg.norm(rg0).clamp(min=1e-12)
    rg2 = torch.linalg.cross(rg0, rg1)
    conf = ((x_axes @ rg0).sum() if kind == "horiz"
            else -(x_axes @ rg1).sum())
    sign = -1.0 if float(conf) < 0 else 1.0
    G = torch.stack([rg0 * sign, rg1 * sign, rg2])
    return (G.to(R.device) @ R.to(torch.float32)).to(torch.float32)
