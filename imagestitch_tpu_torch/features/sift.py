"""SIFT keypoints + 128-D gradient-histogram descriptors with static
capacities (`imagestitch_tpu.features.sift`): per octave the maps (DoG
layers, extremum scores, gradients, the next octave's source) come from
one call of the octave-maps kernel (`ops.cuda_sift`; its plain version on
the CPU), then one candidate per (8, 16) block and layer, Lowe's 3x3x3
subpixel refinement with the interpolated-contrast test, up to two
orientations per keypoint from a 36-bin histogram, and the 4x4x8
descriptor over a rotated, scale-sized 17x17 sample grid.

Spans on the active timer (`utils/log`; nothing without one): each
octave opens `sift_maps` (the octave-maps launch, the next octave's
resize, the block top-k), `sift_refine` (the subpixel refinement and the
contrast test), `sift_orient` (the orientation histograms and peaks) and
`sift_describe` (the descriptor call and the per-peak assembly).

Every top-k breaks ties by ascending index, the order `lax.top_k` gives;
`torch.round` rounds half to even like `jnp.round`. The histogram and
descriptor contractions are batched products like the JAX package's
einsums.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from imagestitch_tpu_torch.config import DetectorConfig
from imagestitch_tpu_torch.features.orb import _pad_or_trim, top_k_stable
from imagestitch_tpu_torch.ops.cuda_sift import octave_shapes, sift_octave_maps
from imagestitch_tpu_torch.ops.image import resize
from imagestitch_tpu_torch.types import ImageFeatures
from imagestitch_tpu_torch.utils import log

BLOCK_H, BLOCK_W = 8, 16


def topk_block_candidates(score: torch.Tensor, quota: int):
    """Top-`quota` candidates of an (S, H, W) score volume, at most one
    per (8, 16) spatial block and layer (its first maximum). Returns
    (scores, flat indices into the volume); slots with score 0 are
    invalid."""
    S, H, W = score.shape
    Hp = -(-H // BLOCK_H) * BLOCK_H
    Wp = -(-W // BLOCK_W) * BLOCK_W
    sp = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    sb = (sp.reshape(S, Hp // BLOCK_H, BLOCK_H, Wp // BLOCK_W, BLOCK_W)
          .permute(0, 1, 3, 2, 4).reshape(S, -1, BLOCK_H * BLOCK_W))
    bmax = sb.amax(dim=-1)                                   # (S, nB)
    barg = torch.argmax(sb, dim=-1)                          # first maximum
    nbx = Wp // BLOCK_W
    bi = torch.arange(bmax.shape[1], device=score.device)[None, :]
    wy = (bi // nbx) * BLOCK_H + barg // BLOCK_W
    wx = (bi % nbx) * BLOCK_W + barg % BLOCK_W
    widx = (torch.arange(S, device=score.device)[:, None] * (H * W)
            + wy * W + wx)
    # pad-region winners score 0 (invalid); keep their index in range
    widx = widx.clamp(max=S * H * W - 1)
    kq = min(quota, bmax.numel())
    top_s, top_b = top_k_stable(bmax.reshape(-1), kq)
    top_i = widx.reshape(-1)[top_b]
    if kq < quota:
        top_s = torch.cat([top_s, top_s.new_zeros(quota - kq)])
        top_i = torch.cat([top_i, top_i.new_zeros(quota - kq)])
    return top_s, top_i


def _gather_dog(flat, L, H, W, li, yi, xi):
    li = li.clamp(0, L - 1)
    yi = yi.clamp(0, H - 1)
    xi = xi.clamp(0, W - 1)
    return flat[(li * H + yi) * W + xi]


def refine_subpixel(dog: torch.Tensor, li, yk, xk, contrast_thresh: float,
                    n_steps: int = 3):
    """Lowe's quadratic extremum interpolation per keypoint: offset
    -H^-1 grad D from central differences of the 27-neighbourhood, a
    fixed number of re-centring steps where an offset exceeds half a
    pixel. Returns (li', yf, xf, scale offset, |D(offset)| >=
    contrast_thresh)."""
    L, H, W = dog.shape
    flat = dog.reshape(-1)
    g = functools.partial(_gather_dog, flat, L, H, W)

    def deriv(l_, y_, x_):
        c = g(l_, y_, x_)
        dx = 0.5 * (g(l_, y_, x_ + 1) - g(l_, y_, x_ - 1))
        dy = 0.5 * (g(l_, y_ + 1, x_) - g(l_, y_ - 1, x_))
        dl = 0.5 * (g(l_ + 1, y_, x_) - g(l_ - 1, y_, x_))
        dxx = g(l_, y_, x_ + 1) + g(l_, y_, x_ - 1) - 2 * c
        dyy = g(l_, y_ + 1, x_) + g(l_, y_ - 1, x_) - 2 * c
        dll = g(l_ + 1, y_, x_) + g(l_ - 1, y_, x_) - 2 * c
        dxy = 0.25 * (g(l_, y_ + 1, x_ + 1) - g(l_, y_ + 1, x_ - 1)
                      - g(l_, y_ - 1, x_ + 1) + g(l_, y_ - 1, x_ - 1))
        dxl = 0.25 * (g(l_ + 1, y_, x_ + 1) - g(l_ + 1, y_, x_ - 1)
                      - g(l_ - 1, y_, x_ + 1) + g(l_ - 1, y_, x_ - 1))
        dyl = 0.25 * (g(l_ + 1, y_ + 1, x_) - g(l_ + 1, y_ - 1, x_)
                      - g(l_ - 1, y_ + 1, x_) + g(l_ - 1, y_ - 1, x_))
        return c, (dx, dy, dl), dxx, dyy, dll, dxy, dxl, dyl

    def solve_offset(args):
        _, (gx, gy, gl), dxx, dyy, dll, dxy, dxl, dyl = args
        # H offset = -grad through the adjugate (closed-form 3x3 solve)
        a, b, cc = dxx, dxy, dxl
        d_, e, f = dxy, dyy, dyl
        gg, h_, i_ = dxl, dyl, dll
        det = (a * (e * i_ - f * h_) - b * (d_ * i_ - f * gg)
               + cc * (d_ * h_ - e * gg))
        det_safe = torch.where(det.abs() < 1e-10,
                               torch.full_like(det, 1e-10), det)
        adj00 = e * i_ - f * h_
        adj01 = cc * h_ - b * i_
        adj02 = b * f - cc * e
        adj10 = f * gg - d_ * i_
        adj11 = a * i_ - cc * gg
        adj12 = cc * d_ - a * f
        adj20 = d_ * h_ - e * gg
        adj21 = b * gg - a * h_
        adj22 = a * e - b * d_
        ox = -(adj00 * gx + adj01 * gy + adj02 * gl) / det_safe
        oy = -(adj10 * gx + adj11 * gy + adj12 * gl) / det_safe
        ol = -(adj20 * gx + adj21 * gy + adj22 * gl) / det_safe
        return ox, oy, ol

    def step(i, o, lo, hi):
        move = torch.round(o.clamp(-1, 1)).to(torch.int64) \
            * (o.abs() > 0.5).to(torch.int64)
        return (i + move).clamp(lo, hi)

    li_c, yi_c, xi_c = li, yk, xk
    for _ in range(n_steps):
        ox, oy, ol = solve_offset(deriv(li_c, yi_c, xi_c))
        xi_c = step(xi_c, ox, 1, W - 2)
        yi_c = step(yi_c, oy, 1, H - 2)
        li_c = step(li_c, ol, 1, L - 2)
    args = deriv(li_c, yi_c, xi_c)
    ox, oy, ol = solve_offset(args)
    c, (gx, gy, gl) = args[0], args[1]
    ox = ox.clamp(-0.5, 0.5)
    oy = oy.clamp(-0.5, 0.5)
    ol = ol.clamp(-0.5, 0.5)
    # interpolated contrast D + grad D . offset / 2 (Lowe eq. 3)
    d_hat = c + 0.5 * (gx * ox + gy * oy + gl * ol)
    ok = d_hat.abs() >= contrast_thresh
    return (li_c, yi_c.to(torch.float32) + oy, xi_c.to(torch.float32) + ox,
            ol, ok)


@functools.lru_cache(maxsize=None)
def _window_offsets(rad: int):
    """(dv, du) of the (2 rad + 1)^2 window, row-major."""
    vs, us = np.mgrid[-rad:rad + 1, -rad:rad + 1]
    return vs.reshape(-1).astype(np.int64), us.reshape(-1).astype(np.int64)


def orientations(gx_stack, gy_stack, si, yk, xk, sigma_rel, rad: int = 12,
                 n_peaks: int = 2):
    """Up to `n_peaks` orientations per keypoint (Lowe §5): a 36-bin
    histogram of the gradients in a (2 rad + 1)^2 window of the
    keypoint's own level (edge-clamped), Gaussian-weighted with sigma
    1.5 sigma_rel inside radius 3 sigma, smoothed 6 times, peaks >= 0.8
    max with parabolic interpolation. Returns (thetas (n_peaks, K),
    ok (n_peaks, K))."""
    _, H, W = gx_stack.shape
    dev = gx_stack.device
    dv_np, du_np = _window_offsets(rad)
    dv = torch.as_tensor(dv_np, device=dev)
    du = torch.as_tensor(du_np, device=dev)
    yi = (yk[:, None] + dv[None, :]).clamp(0, H - 1)
    xi = (xk[:, None] + du[None, :]).clamp(0, W - 1)
    flat = (si[:, None] * H + yi) * W + xi
    gx = gx_stack.reshape(-1)[flat]                          # (K, P)
    gy = gy_stack.reshape(-1)[flat]
    m = torch.sqrt(gx * gx + gy * gy)
    a = torch.atan2(gy, gx)
    r2 = (du.to(torch.float32) ** 2 + dv.to(torch.float32) ** 2)[None, :]
    sig = (1.5 * sigma_rel)[:, None]
    w = torch.exp(-r2 / (2.0 * sig * sig))
    w = torch.where(r2 <= (3.0 * sig) ** 2, w, torch.zeros_like(w))
    bins = torch.remainder(
        torch.floor((a + math.pi) / (2 * math.pi) * 36).to(torch.int64), 36)
    onehot = torch.nn.functional.one_hot(bins, 36).to(torch.float32)
    hist = torch.einsum("kp,kpb->kb", m * w, onehot)
    for _ in range(6):                       # OpenCV smooths 6 times
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0

    prev = torch.roll(hist, 1, 1)
    nxt = torch.roll(hist, -1, 1)
    is_peak = (hist > prev) & (hist > nxt)
    peak_val = torch.where(is_peak, hist,
                           torch.full_like(hist, float("-inf")))
    top_v, top_b = top_k_stable(peak_val, n_peaks)          # (K, n_peaks)
    hmax = top_v[:, :1]
    ok = (top_v >= 0.8 * hmax) & torch.isfinite(top_v)

    hp = torch.gather(prev, 1, top_b)
    hc = torch.gather(hist, 1, top_b)
    hn = torch.gather(nxt, 1, top_b)
    denom = hp - 2.0 * hc + hn
    frac = torch.where(denom.abs() > 1e-8, 0.5 * (hp - hn) / denom,
                       torch.zeros_like(denom))
    bin_f = top_b.to(torch.float32) + frac.clamp(-0.5, 0.5) + 0.5
    theta = bin_f / 36.0 * 2 * math.pi - math.pi
    return theta.T, ok.T


@functools.lru_cache(maxsize=None)
def _cell_weights(cell: int, width: int):
    """The descriptor grid's spatial soft assignment, (P, width^2) float32:
    each sample's bilinear weights over the 4x4 cells (depends only on the
    unrotated grid)."""
    half = cell * width // 2
    vs_np, us_np = _window_offsets(half)
    uf = torch.as_tensor(us_np, dtype=torch.float32)
    vf = torch.as_tensor(vs_np, dtype=torch.float32)
    gx = (uf + half) / cell - 0.5
    gy = (vf + half) / cell - 0.5
    gx0 = torch.floor(gx)
    gy0 = torch.floor(gy)
    fx = gx - gx0
    fy = gy - gy0
    ncell = width * width
    wcell = torch.zeros((uf.shape[0], ncell), dtype=torch.float32)
    for dy_ in (0, 1):
        wy = 1.0 - fy if dy_ == 0 else fy
        cy = (gy0 + dy_).clamp(0, width - 1).to(torch.int64)
        for dx_ in (0, 1):
            wx = 1.0 - fx if dx_ == 0 else fx
            cx = (gx0 + dx_).clamp(0, width - 1).to(torch.int64)
            oh = torch.nn.functional.one_hot(cy * width + cx, ncell)
            wcell = wcell + (wy * wx)[:, None] * oh.to(torch.float32)
    return wcell


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((x * x).sum(dim=1, keepdim=True))
    return x / n.clamp(min=1e-8)


def descriptors(gx_stack, gy_stack, si, yk, xk, theta, sigma_rel,
                cell: int = 4, nbins: int = 8, width: int = 4):
    """SIFT 4x4x8 descriptor per keypoint, (K, 128) float32: the 17x17
    grid rotated by theta and scaled by 3 sigma_rel / 4 (one cell spans
    3 sigma_rel pixels), gradients of the keypoint's own level,
    trilinear soft assignment as one (16, P) x (P, 8) product per
    keypoint, then normalise, clip at 0.2, normalise."""
    _, H, W = gx_stack.shape
    dev = gx_stack.device
    half = cell * width // 2
    vs_np, us_np = _window_offsets(half)
    uf = torch.as_tensor(us_np, dtype=torch.float32, device=dev)[None, :]
    vf = torch.as_tensor(vs_np, dtype=torch.float32, device=dev)[None, :]
    ca = torch.cos(theta)[:, None]
    sa = torch.sin(theta)[:, None]
    k_scale = (3.0 * sigma_rel / cell)[:, None]          # px per grid step
    ru = torch.round((uf * ca - vf * sa) * k_scale).to(torch.int64)
    rv = torch.round((uf * sa + vf * ca) * k_scale).to(torch.int64)

    yi = (yk[:, None] + rv).clamp(0, H - 1)
    xi = (xk[:, None] + ru).clamp(0, W - 1)
    flat = (si[:, None] * H + yi) * W + xi
    gx = gx_stack.reshape(-1)[flat]                        # (K, P)
    gy = gy_stack.reshape(-1)[flat]
    m = torch.sqrt(gx * gx + gy * gy)
    a = torch.atan2(gy, gx) - theta[:, None]

    ab = (a + math.pi) / (2 * math.pi) * nbins
    ab0 = torch.floor(ab)
    fa = ab - ab0
    gauss = torch.exp(-(uf ** 2 + vf ** 2)
                      / (2.0 * (0.5 * cell * width) ** 2))
    base_w = m * gauss                                     # (K, P)

    wcell = _cell_weights(cell, width).to(dev)[None]       # (1, P, 16)
    K, P = base_w.shape
    wbin = torch.zeros((K, P, nbins), dtype=torch.float32, device=dev)
    for da_ in (0, 1):
        wa = 1.0 - fa if da_ == 0 else fa
        cb = torch.remainder(ab0.to(torch.int64) + da_, nbins)
        wbin = wbin + wa[..., None] * torch.nn.functional.one_hot(
            cb, nbins).to(torch.float32)
    desc = torch.einsum("kpc,kpb->kcb", wcell * base_w[..., None], wbin)
    desc = _l2_normalize(desc.reshape(K, -1))
    return _l2_normalize(desc.clamp(max=0.2))


def detect_and_compute_sift(gray: torch.Tensor,
                            cfg: DetectorConfig = DetectorConfig(),
                            num_octaves: int = 4, scales_per_octave: int = 3,
                            sigma0: float = 1.6,
                            contrast_thresh: float = 0.04) -> ImageFeatures:
    """SIFT over one (H, W) grayscale image -> padded ImageFeatures with
    (K, 128) float32 descriptors. Each DoG extremum gives up to two
    keypoints (its second orientation peak).

    `contrast_thresh` has OpenCV's contrastThreshold meaning on 0..1
    intensities; on this pipeline's 0..255 DoG it becomes thresh*255/S
    (the subpixel test; the extremum pre-test takes half of it)."""
    H, W = gray.shape
    dev = gray.device
    gray = gray.to(torch.float32)
    S = scales_per_octave
    contrast_thresh = contrast_thresh * 255.0 / S
    shapes = octave_shapes(H, W, num_octaves)
    quota = max(cfg.max_keypoints // (2 * len(shapes)), 16)
    xs, ys, resp, angs, sizes, levels, valids, descs = \
        [], [], [], [], [], [], [], []

    base = gray
    for o, (Hh, Wh) in enumerate(shapes):
        with log.stage("sift_maps"):
            dog, score, gx_stack, gy_stack, gS = sift_octave_maps(
                base, o == 0, S, sigma0, contrast_thresh)
            if o + 1 < len(shapes):
                base = resize(gS, shapes[o + 1], "linear")
            top_s, top_i = topk_block_candidates(score, quota)
            v = top_s > 0
            li = top_i // (Hh * Wh) + 1      # interior layer -> DoG layer
            rem = top_i % (Hh * Wh)
            yk = rem // Wh
            xk = rem % Wh

        with log.stage("sift_refine"):
            li_r, yf, xf, ol, c_ok = refine_subpixel(
                dog, li, yk, xk, contrast_thresh)
            v = v & c_ok
            yk_i = torch.round(yf).to(torch.int64).clamp(0, Hh - 1)
            xk_i = torch.round(xf).to(torch.int64).clamp(0, Wh - 1)

            si = (li_r - 1).clamp(0, S)                   # gradient level
            lf = li_r.to(torch.float32) + ol              # interpolated scale
            sigma_rel = sigma0 * (2.0 ** (lf.clamp(0.0, S + 1.0) / S))

        with log.stage("sift_orient"):
            thetas, peak_ok = orientations(gx_stack, gy_stack, si, yk_i,
                                           xk_i, sigma_rel)
        s = float(2 ** o)
        with log.stage("sift_describe"):
            # one descriptor call for every peak: row p*quota+k is peak p
            # of keypoint k
            npk = thetas.shape[0]
            d_all = descriptors(gx_stack, gy_stack, si.repeat(npk),
                                yk_i.repeat(npk), xk_i.repeat(npk),
                                thetas.reshape(-1), sigma_rel.repeat(npk))
            for p in range(npk):
                vp = v & peak_ok[p]
                xs.append(xf * s)
                ys.append(yf * s)
                resp.append(torch.where(vp, top_s, torch.zeros_like(top_s)))
                angs.append(thetas[p])
                sizes.append(sigma_rel * s * 2.0)
                levels.append(torch.full((quota,), o, dtype=torch.int32,
                                         device=dev))
                valids.append(vp)
                descs.append(d_all[p * quota:(p + 1) * quota])

    feats = ImageFeatures(
        xy=torch.stack([torch.cat(xs), torch.cat(ys)], dim=1),
        response=torch.cat(resp),
        angle=torch.cat(angs),
        size=torch.cat(sizes),
        level=torch.cat(levels),
        valid=torch.cat(valids),
        descriptors=torch.cat(descs, dim=0),
        img_size=torch.tensor([H, W], dtype=torch.int32, device=dev),
    )
    return _pad_or_trim(feats, cfg.max_keypoints)
