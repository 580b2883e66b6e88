"""Test support for the port's kernels: what the tests and
`chip_smoke.py` use to hold a kernel's output against its plain version.
Nothing on the stitching path imports it."""

from __future__ import annotations

import math

import numpy as np
import torch

from imagestitch_tpu_torch.types import CameraParams
from imagestitch_tpu_torch.warp.projectors import PROJECTORS
from imagestitch_tpu_torch.warp.warper import image_scale


def _unit_rays(kind: str, u: torch.Tensor, v: torch.Tensor):
    """float64 rays of surface coordinates already divided by the scale."""
    proj = PROJECTORS[kind].__new__(PROJECTORS[kind])
    proj.scale = torch.ones((), dtype=torch.float64, device=u.device)
    return proj._ray_from_surface(u, v)


def near_validity_boundary(k_rinvs: torch.Tensor, scale, corners,
                           canvas_hw: tuple[int, int], kind: str, sizes,
                           tol: float = 1e-3,
                           interp: str = "linear") -> torch.Tensor:
    """(N, Hc, Wc) bool: canvas pixels whose float64 source coordinate lies
    within `tol` px of the in-image boundary of its (h, w) in `sizes`, or
    whose ray is near z = 0; `scale` is one surface scale for every image
    or (N,) one each. float32 rounding may put these on either side
    of the validity test, so two warps' masks may differ there. With
    `interp="nearest"` the pixels within `tol` of a half-integer source
    coordinate are the ones marked: there the rounding chooses the tap,
    and so the in-image test, the sampled value and the source-mask
    lookup."""
    Hc, Wc = canvas_hw
    dev = k_rinvs.device
    out = []
    for i in range(k_rinvs.shape[0]):
        s = float(image_scale(scale, i))
        M = k_rinvs[i].double()
        cx, cy = (float(c) for c in corners[i])
        u = (torch.arange(Wc, dtype=torch.float64, device=dev)
             + cx)[None, :].expand(Hc, Wc) / s
        v = (torch.arange(Hc, dtype=torch.float64, device=dev)
             + cy)[:, None].expand(Hc, Wc) / s
        if kind == "cylindrical":
            X, Y, Z = torch.sin(u), v, torch.cos(u)
        elif kind == "spherical":
            sv = torch.sin(math.pi - v)
            X, Y, Z = sv * torch.sin(u), torch.cos(math.pi - v), \
                sv * torch.cos(u)
        elif kind == "plane":
            X, Y, Z = u, v, torch.ones_like(u)
        else:
            X, Y, Z = _unit_rays(kind, u, v)
        px = M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z
        py = M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z
        pz = M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z
        xs, ys = px / pz, py / pz
        h, w = (int(x) for x in sizes[i])
        if interp == "nearest":
            d = torch.stack([(xs - torch.floor(xs) - 0.5).abs(),
                             (ys - torch.floor(ys) - 0.5).abs()]).amin(0)
        else:
            d = torch.stack([xs.abs(), (xs - (w - 1)).abs(), ys.abs(),
                             (ys - (h - 1)).abs()]).amin(0)
        out.append((d < tol) | (pz.abs() < 1e-6))
    return torch.stack(out)


def _rotation(axis_angle) -> np.ndarray:
    """float64 rotation matrix of an axis-angle vector (Rodrigues)."""
    r = np.asarray(axis_angle, np.float64)
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * K @ K


def bundle_problem(n_cams: int, pairs, T: int = 512, seed: int = 0,
                   masked: float = 0.0, invalid_pairs=(),
                   focal: float = 1728.0, size=(1080, 1920),
                   yaw_step_deg: float = 15.0, noise_px: float = 0.5):
    """A bundle adjustment's inputs, made with numpy from `seed`: `n_cams`
    cameras of one (h, w) `size` panning by `yaw_step_deg` (with a little
    pitch and roll), true focal `focal`; for each (i, j) of `pairs`, T
    correspondences of scene directions both views see, the second
    view's points with `noise_px` of Gaussian noise; the initial cameras
    off the truth by up to 3% in focal and about 0.5 deg in rotation.
    `masked`: the share of points marked invalid; `invalid_pairs`: the
    indices of pairs marked invalid. Returns the arguments of
    `geometry.bundle.bundle_adjust` before `iters`: (CameraParams, src
    (P, T, 2), dst, pt_valid (P, T), pair_from (P,), pair_to, pair_valid
    (P,)), CPU tensors."""
    rng = np.random.default_rng(seed)
    h, w = size
    Kt = np.array([[focal, 0.0, w / 2], [0.0, focal, h / 2], [0, 0, 1.0]])
    Rt = [_rotation([0.0, math.radians(yaw_step_deg * i), 0.0])
          @ _rotation(rng.normal(0.0, 0.01, 3)) for i in range(n_cams)]
    P = len(pairs)
    src = np.zeros((P, T, 2))
    dst = np.zeros((P, T, 2))
    for p, (i, j) in enumerate(pairs):
        got = 0
        while got < T:
            px = rng.uniform([0, 0], [w - 1, h - 1], (4 * T, 2))
            d = np.linalg.solve(Kt, np.c_[px, np.ones(len(px))].T)
            q = Kt @ Rt[j].T @ Rt[i] @ d
            ok = q[2] > 0
            q = (q[:2] / np.where(ok, q[2], 1.0)).T
            ok &= (q[:, 0] >= 0) & (q[:, 0] <= w - 1) & (q[:, 1] >= 0) \
                & (q[:, 1] <= h - 1)
            take = min(T - got, int(ok.sum()))
            src[p, got:got + take] = px[ok][:take]
            dst[p, got:got + take] = q[ok][:take]
            got += take
    dst += rng.normal(0.0, noise_px, dst.shape)
    pt_valid = rng.uniform(size=(P, T)) >= masked
    pair_valid = np.ones(P, bool)
    pair_valid[list(invalid_pairs)] = False
    f0 = focal * (1 + rng.uniform(-0.03, 0.03, n_cams))
    R0 = np.stack([R @ _rotation(rng.normal(0.0, math.radians(0.3), 3))
                   for R in Rt])
    cams = CameraParams(
        focal=torch.tensor(f0, dtype=torch.float32),
        aspect=torch.ones(n_cams), ppx=torch.full((n_cams,), w / 2),
        ppy=torch.full((n_cams,), h / 2),
        R=torch.tensor(R0, dtype=torch.float32), t=torch.zeros(n_cams, 3))
    idx = torch.tensor(pairs, dtype=torch.int64).reshape(P, 2)
    return (cams, torch.tensor(src, dtype=torch.float32),
            torch.tensor(dst, dtype=torch.float32),
            torch.from_numpy(pt_valid), idx[:, 0].clone(),
            idx[:, 1].clone(), torch.from_numpy(pair_valid))
