"""The plain reference that decides `correct`: what a panorama of the
generator's views must look like, worked out from the generator's truth
alone (focal, each camera's rotation), and the comparison of a stitched
panorama with it.

Plain torch, float64 geometry; it imports nothing of the program and reads
no camera, scale or canvas of the program. What it judges are the
program's outputs: the cropped uint8 panorama and the focal it reports.

The panorama frame. A stitcher's panorama is fixed up to a global rotation
of the world (a gauge). The program anchors it on view 0 (the pair
path and every stitcher without wave correction) or levels it
(`wave_correct`); in the generator's scenes view 0 and the levelled frame
differ from the world frame by a turn about the vertical axis at most,
which on a cylinder or sphere moves the panorama sideways and which the
bounding-box crop takes out. So the reference renders in the frame of
view 0 or, with wave correction, in the world frame; the comparison
then allows a small affine map between the two panoramas, which takes
up the estimated focal's scale and sub-pixel offsets, and nothing more.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stitchbench import find
from stitchbench.scenes import bilinear


def surface_to_ray(kind: str, u: torch.Tensor, v: torch.Tensor, s: float):
    """Panorama surface coordinates at scale s -> rays (..., 3) in the
    panorama frame, by `surfaces/<kind>.py`."""
    return find.part("surfaces", kind).to_ray(u, v, s)


def ray_to_surface(kind: str, r: torch.Tensor, s: float):
    return find.part("surfaces", kind).from_ray(r, s)


def _frame(rotations: torch.Tensor, wave_correct: bool) -> torch.Tensor:
    """World-to-panorama rotation G: view 0's, or the world itself."""
    if wave_correct:
        return torch.eye(3, dtype=rotations.dtype, device=rotations.device)
    return rotations[0]


def render(views: torch.Tensor, rotations, f: float, kind: str,
           wave_correct: bool = False, dtype=torch.float64):
    """The panorama of `views` ((n, h, w, 3) uint8) taken by cameras with
    world-to-camera `rotations` (n, 3, 3) and focal f, on the `kind`
    surface at scale f: each view's pixel valid where the backward map
    lands in [0, w-1] x [0, h-1], the views averaged with weights that
    grow with the distance to their borders, cropped to the bounding box
    of the valid pixels. Returns (pano (H, W, 3) float32, valid (H, W)
    bool). `dtype`: the geometry's precision."""
    dev = views.device
    n, h, w = views.shape[:3]
    rots = torch.as_tensor(rotations, dtype=dtype, device=dev)
    g = _frame(rots, wave_correct)
    cam_of_pano = rots @ g.T                   # pano-frame ray -> camera ray
    fx = torch.tensor([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0],
                       [0, 0, 1.0]], dtype=torch.float64, device=dev)
    # the inverse worked out wide, then held at the geometry's precision
    # (torch inverts no low-precision matrix)
    kinv = torch.linalg.inv(fx).to(dtype)
    fx = fx.to(dtype)
    # the surface box: every border pixel of every view, forward
    border = torch.cat([
        torch.stack([torch.arange(w, device=dev, dtype=dtype),
                     torch.full((w,), float(y), device=dev,
                                dtype=dtype)], -1)
        for y in (0, h - 1)] + [
        torch.stack([torch.full((h,), float(x), device=dev,
                                dtype=dtype),
                     torch.arange(h, device=dev, dtype=dtype)], -1)
        for x in (0, w - 1)])
        # (P, 2)
    pts = torch.cat([border, torch.ones_like(border[:, :1])], 1)
    us, vs = [], []
    for i in range(n):
        rays = pts @ kinv.T @ cam_of_pano[i]   # camera ray -> pano ray
        u, v = ray_to_surface(kind, rays, f)
        us.append(u)
        vs.append(v)
    u_all, v_all = torch.cat(us), torch.cat(vs)
    u0 = math.floor(float(u_all.min())) - 1
    v0 = math.floor(float(v_all.min())) - 1
    wc = math.ceil(float(u_all.max())) + 2 - u0
    hc = math.ceil(float(v_all.max())) + 2 - v0
    uu = (torch.arange(wc, dtype=dtype, device=dev) + u0)[None, :]
    vv = (torch.arange(hc, dtype=dtype, device=dev) + v0)[:, None]
    uu, vv = torch.broadcast_tensors(uu, vv)
    pano_rays = surface_to_ray(kind, uu, vv, f)
    acc = torch.zeros((hc, wc, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((hc, wc), dtype=torch.float32, device=dev)
    for i in range(n):
        c = pano_rays @ cam_of_pano[i].T
        p = c @ fx.T
        z = p[..., 2]
        x = p[..., 0] / z
        y = p[..., 1] / z
        ok = (z > 0) & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        wt = torch.minimum(torch.minimum(x, w - 1 - x),
                           torch.minimum(y, h - 1 - y)) + 1.0
        wt = torch.where(ok, wt, torch.zeros_like(wt)).to(torch.float32)
        val = bilinear(views[i].to(torch.float32), x.where(ok, 0.0),
                       y.where(ok, 0.0))
        acc += val * wt[..., None]
        wsum += wt
    valid = wsum > 0
    pano = acc / wsum.clamp(min=1e-12)[..., None]
    ys, xs = torch.nonzero(valid, as_tuple=True)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    return pano[y0:y1, x0:x1], valid[y0:y1, x0:x1]


def _gray_pooled(rgb: torch.Tensor, valid: torch.Tensor, factor: int):
    """Channel mean, area-averaged over factor x factor blocks; a block is
    valid where all its pixels are."""
    g = rgb.to(torch.float32).mean(-1)[None, None]
    v = valid.to(torch.float32)[None, None]
    hh = (g.shape[-2] // factor) * factor
    ww = (g.shape[-1] // factor) * factor
    g = F.avg_pool2d(g[..., :hh, :ww], factor)[0, 0]
    v = F.avg_pool2d(v[..., :hh, :ww], factor)[0, 0] > 0.999
    return g, v


def _sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear sample of a (H, W) map at pixel coordinates (zeros
    outside)."""
    hh, ww = img.shape
    grid = torch.stack([2 * x / max(ww - 1, 1) - 1,
                        2 * y / max(hh - 1, 1) - 1], -1)
    out = F.grid_sample(img[None, None], grid.reshape(1, -1, 1, 2).to(
        img.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=True)
    return out.reshape(x.shape)


# the comparison's scale: gray at a quarter of the size, 16-pixel tiles
# (64 px at full size), offsets searched within 6 pixels (24), a margin of
# 8 (32) along the reference's border
FACTOR, TILE, SEARCH, ERODE = 4, 16, 6, 8


def compare(pano: torch.Tensor, ref: torch.Tensor,
            ref_valid: torch.Tensor) -> dict:
    """Hold a program's cropped uint8 panorama (H, W, 3) against the
    reference's (`render`), both on one device.

    Both go to gray at 1/FACTOR of their size. From the reference's
    textured tiles (TILE x TILE, fully valid) the program's panorama is
    searched within ±SEARCH pixels of where a scaling by the widths'
    ratio puts them; an affine map is fitted to the tiles' best offsets
    (sub-pixel), and the program's panorama is resampled through it.
    Returns, in full-size pixels and gray levels:
    `tile_mad`, the largest mean absolute difference over the tiles of
    the reference's valid area less an ERODE-pixel margin (a pixel the
    program leaves empty there counts 255); `mad`, the mean over that
    area; `align_resid_px`, the median distance of a tile's offset from
    the affine map; `tiles`, the tiles compared."""
    factor, t, search, erode = FACTOR, TILE, SEARCH, ERODE
    dev = ref.device
    pano = pano.to(dev)
    gr, vr = _gray_pooled(ref, ref_valid, factor)
    gp, vp = _gray_pooled(pano, (pano > 0).any(-1), factor)
    hr, wr = gr.shape
    hp, wp = gp.shape
    s = pano.shape[1] / ref.shape[1]
    ty = torch.arange(hr // t, device=dev) * t
    tx = torch.arange(wr // t, device=dev) * t
    tys, txs = torch.meshgrid(ty, tx, indexing="ij")
    tys, txs = tys.reshape(-1), txs.reshape(-1)
    oy = torch.arange(t, device=dev)
    ry = (tys[:, None, None] + oy[None, :, None]).expand(-1, t, t)
    rx = (txs[:, None, None] + oy[None, None, :]).expand(-1, t, t)
    full = vr[ry, rx].all(-1).all(-1)
    g_t = gr[ry, rx]
    textured = full & (g_t.flatten(1).std(-1) > 4.0)
    cxr, cyr = (wr - 1) / 2, (hr - 1) / 2
    cxp, cyp = (wp - 1) / 2, (hp - 1) / 2
    keep = torch.nonzero(textured).reshape(-1)
    bad = {"tile_mad": float("inf"), "mad": float("inf"),
           "align_resid_px": float("inf"), "tiles": 0}
    if keep.numel() < 6:
        return bad
    kx = rx[keep].to(torch.float32)
    ky = ry[keep].to(torch.float32)
    px0 = s * (kx - cxr) + cxp
    py0 = s * (ky - cyr) + cyp
    d = torch.arange(-search, search + 1, device=dev, dtype=torch.float32)
    nd = d.numel()
    costs = torch.empty((keep.numel(), nd, nd), device=dev)
    vpf = vp.to(torch.float32)
    for a in range(nd):
        for b in range(nd):
            xs = px0 + d[b]
            ys = py0 + d[a]
            sp = _sample(gp, xs, ys)
            ok = _sample(vpf, xs, ys) > 0.999
            err = ((sp - g_t[keep]) ** 2).mean((-1, -2))
            costs[:, a, b] = torch.where(ok.all(-1).all(-1), err,
                                         torch.full_like(err, float("inf")))
    flat = costs.reshape(costs.shape[0], -1)
    best = flat.argmin(-1)
    finite = torch.isfinite(flat.gather(1, best[:, None]))[:, 0]
    ia, ib = best // nd, best % nd

    def refine(c_lo, c_mid, c_hi):
        den = c_lo - 2 * c_mid + c_hi
        off = 0.5 * (c_lo - c_hi) / torch.where(den > 0, den,
                                                 torch.ones_like(den))
        return torch.where((den > 0) & torch.isfinite(den),
                           off.clamp(-0.5, 0.5), torch.zeros_like(den))

    k = torch.arange(costs.shape[0], device=dev)
    ia_lo, ia_hi = (ia - 1).clamp(0, nd - 1), (ia + 1).clamp(0, nd - 1)
    ib_lo, ib_hi = (ib - 1).clamp(0, nd - 1), (ib + 1).clamp(0, nd - 1)
    sy = d[ia] + refine(costs[k, ia_lo, ib], costs[k, ia, ib],
                        costs[k, ia_hi, ib])
    sx = d[ib] + refine(costs[k, ia, ib_lo], costs[k, ia, ib],
                        costs[k, ia, ib_hi])
    cy = ky[:, 0, 0] + (t - 1) / 2
    cx = kx[:, 0, 0] + (t - 1) / 2
    tgt_x = s * (cx - cxr) + cxp + sx
    tgt_y = s * (cy - cyr) + cyp + sy
    use = finite
    if int(use.sum()) < 6:
        return bad
    src = torch.stack([cx, cy, torch.ones_like(cx)], -1)[use].double()
    dst = torch.stack([tgt_x, tgt_y], -1)[use].double()
    # least squares, then twice again without the tiles that sit far
    # off the fit (a flat or repeating tile can match elsewhere)
    inl = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    for _ in range(3):
        amat = torch.linalg.lstsq(src[inl], dst[inl]).solution   # (3, 2)
        resid = torch.linalg.norm(src @ amat - dst, dim=-1)
        cut = max(3.0 * float(resid[inl].median()), 0.25)
        if int((resid < cut).sum()) < 6:
            break
        inl = resid < cut
    # the program's panorama through the fitted map, on the reference grid
    yy, xx = torch.meshgrid(torch.arange(hr, device=dev, dtype=torch.float64),
                            torch.arange(wr, device=dev, dtype=torch.float64),
                            indexing="ij")
    grid = torch.stack([xx, yy, torch.ones_like(xx)], -1) @ amat
    gx = grid[..., 0].to(torch.float32)
    gy = grid[..., 1].to(torch.float32)
    gal = _sample(gp, gx, gy)
    val = _sample(vpf, gx, gy) > 0.999
    # outside the crop counts as invalid, so the margin runs along the
    # crop's edges too
    outside = F.pad(1.0 - vr.to(torch.float32)[None, None],
                    (erode,) * 4, value=1.0)
    region = F.max_pool2d(outside, 2 * erode + 1, 1)[0, 0] < 0.5
    diff = torch.where(val, (gal - gr).abs(), torch.full_like(gr, 255.0))
    diff = torch.where(region, diff, torch.zeros_like(diff))
    th, tw = hr // t, wr // t
    dsum = diff[:th * t, :tw * t].reshape(th, t, tw, t).sum((1, 3))
    cnt = region[:th * t, :tw * t].reshape(th, t, tw, t).sum((1, 3))
    counted = cnt >= (t * t) // 2
    if not bool(counted.any()):
        return bad
    tile_mad = (dsum / cnt.clamp(min=1))[counted]
    return {"tile_mad": float(tile_mad.max()),
            "mad": float(diff[region].mean()),
            "align_resid_px": float(resid.median()) * factor,
            "tiles": int(counted.sum())}


def judge(pano, focal, truth: dict, ref, ref_valid, compare_pano: bool):
    """The numbers of one request: `focal_rel_err` (the reported focal
    against the truth), `extent_rel_err` (the crop's height and width
    against the reference's, the larger relative gap) and, with
    `compare_pano`, `compare`'s numbers."""
    hp, wp = pano.shape[:2]
    hr, wr = ref.shape[:2]
    out = {"extent_rel_err": max(abs(hp - hr) / hr, abs(wp - wr) / wr),
           "focal_rel_err": (math.inf if focal is None else
                             abs(float(focal) - truth["f"]) / truth["f"])}
    if compare_pano:
        out.update(compare(torch.as_tensor(pano), ref, ref_valid))
    return out
