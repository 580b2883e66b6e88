"""Test support for the port's kernels: what the tests and
`chip_smoke.py` use to hold a kernel's output against its plain version.
Nothing on the stitching path imports it."""

from __future__ import annotations

import math

import torch

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
