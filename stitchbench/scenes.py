"""Seeded synthetic scenes and the views a rotating camera takes of them,
made on the device in plain torch.

The recipe is that of `imagestitch_tpu_torch.utils.io` (`_render_scene`,
`rotation_views_of_scene`, `synthetic_pan_sequence`), rewritten so that a
pool of 1080p views renders on the card in well under a second instead of
seconds per pair on the host. It need not equal the host generator bit for
bit; what the benchmark needs is the truth that comes with every view:
the focal and each camera's rotation. A traffic mix's cameras come from
`poses/<name>.py`; this module renders whatever rotations they give.

Conventions: a scene is the image plane of a camera at rest, focal f,
principal point at its centre. A view with world-to-camera rotation R sees
at pixel p the scene point Ks · Rᵀ · K⁻¹ · p (a camera ray c = R·w for the
world ray w), sampled bilinearly with the indices clamped to the scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rot_ypr(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Rz(roll) @ Rx(pitch) @ Ry(yaw), angles in radians (float64)."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cx, sx = math.cos(pitch), math.sin(pitch)
    cz, sz = math.cos(roll), math.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ rx @ ry


def intrinsics(f: float, h: int, w: int) -> np.ndarray:
    return np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0],
                     [0, 0, 1.0]])


def render_scene(h: int, w: int, rng: np.random.Generator,
                 device: torch.device) -> torch.Tensor:
    """(h, w, 3) float32 corner-rich texture on `device`: smooth colour
    waves, 160 translucent rectangles, 300 3x3 blobs (later ones on top).
    The shapes' places and colours come from `rng`."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    img = torch.stack(torch.broadcast_tensors(
        90 + 50 * torch.sin(xx / 97.0) * torch.cos(yy / 71.0),
        100 + 40 * torch.cos(xx / 53.0 + 1.0),
        110 + 45 * torch.sin(yy / 83.0 + 2.0)), dim=-1).contiguous()
    rh = rng.integers(8, h // 6, size=160)
    rw = rng.integers(8, w // 6, size=160)
    ry = rng.integers(0, h - rh)
    rx = rng.integers(0, w - rw)
    colors = torch.as_tensor(rng.uniform(0, 255, size=(160, 3)),
                             dtype=torch.float32, device=device)
    for i in range(160):
        y, x, a, b = int(ry[i]), int(rx[i]), int(rh[i]), int(rw[i])
        blk = img[y:y + a, x:x + b]
        blk.mul_(0.25).add_(0.75 * colors[i])
    # blobs: the last blob over a pixel wins, found with an order-free max
    by = torch.as_tensor(rng.integers(2, h - 2, size=300), device=device)
    bx = torch.as_tensor(rng.integers(2, w - 2, size=300), device=device)
    bcol = torch.as_tensor(rng.uniform(0, 255, size=(300, 3)),
                           dtype=torch.float32, device=device)
    owner = torch.full((h * w,), -1, dtype=torch.int64, device=device)
    ids = torch.arange(300, device=device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            owner.scatter_reduce_(0, (by + dy) * w + bx + dx, ids, "amax")
    flat = img.view(h * w, 3)
    hit = owner >= 0
    flat[hit] = bcol[owner[hit]]
    return img.clamp_(0, 255)


def sample_views(scene: torch.Tensor, rotations: np.ndarray, f: float,
                 h: int, w: int) -> torch.Tensor:
    """(n, h, w, 3) uint8 views of `scene` by cameras with world-to-camera
    `rotations` (n, 3, 3), focal f, bilinear with clamped indices."""
    sh, sw = scene.shape[:2]
    dev = scene.device
    kinv = np.linalg.inv(intrinsics(f, h, w))
    ks = intrinsics(f, sh, sw)
    ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    views = []
    for r in rotations:
        m = (ks @ r.T @ kinv).tolist()
        px = m[0][0] * xs + m[0][1] * ys + m[0][2]
        py = m[1][0] * xs + m[1][1] * ys + m[1][2]
        pz = m[2][0] * xs + m[2][1] * ys + m[2][2]
        views.append(bilinear(scene, (px / pz), (py / pz)))
    return torch.stack(views).clamp_(0, 255).to(torch.uint8)


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (H, W, C) sampled at float (x, y) of any shape; the four
    neighbours' indices clamped to the image (the host recipe's
    `_bilinear_sample`). Returns float32 (..., C)."""
    hh, ww = img.shape[:2]
    # the indices as integers (a low-precision float holds no index)
    x0 = torch.floor(x).long().clamp(0, ww - 2)
    y0 = torch.floor(y).long().clamp(0, hh - 2)
    fx = (x - x0.to(x.dtype)).clamp(0, 1).to(torch.float32)[..., None]
    fy = (y - y0.to(y.dtype)).clamp(0, 1).to(torch.float32)[..., None]
    p00 = img[y0, x0]
    p01 = img[y0, x0 + 1]
    p10 = img[y0 + 1, x0]
    p11 = img[y0 + 1, x0 + 1]
    return ((p00 * (1 - fx) + p01 * fx) * (1 - fy)
            + (p10 * (1 - fx) + p11 * fx) * fy)


def scene_size(h: int, w: int, f: float, half_span_deg: float):
    """The scene that the host recipe renders for views whose centres lie
    up to `half_span_deg` off the middle: a third taller than a view and
    2·f·tan(half span) + a quarter of a view wider."""
    extra = int(math.ceil(2.0 * f * math.tan(math.radians(half_span_deg))
                          + 0.25 * w))
    return h + h // 3, w + extra


def render_views(rotations: np.ndarray, half_span_deg: float, h: int,
                 w: int, f: float, rng: np.random.Generator,
                 device: torch.device) -> torch.Tensor:
    """One pool item's views (n, h, w, 3) uint8 on `device`: a scene as
    large as `scene_size` makes it for `half_span_deg`, seen by cameras
    with world-to-camera `rotations` (n, 3, 3)."""
    sh, sw = scene_size(h, w, f, half_span_deg)
    scene = render_scene(sh, sw, rng, device)
    return sample_views(scene, rotations, f, h, w)


def spread(lo_hi, count: int, rng: np.random.Generator) -> list[float]:
    """`count` values evenly spaced over [lo, hi], in an order drawn from
    `rng`: every seed gets the same set of sizes, in another order."""
    lo, hi = lo_hi
    vals = np.linspace(lo, hi, count)
    return [float(v) for v in vals[rng.permutation(count)]]
