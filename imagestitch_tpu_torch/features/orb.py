"""ORB keypoints + rBRIEF descriptors with static capacities
(`imagestitch_tpu.features.orb`): per pyramid level the detector maps
(FAST-9 score + 3x3 NMS, Harris, 7x7 σ=2 blur) come from one launch of the
detector-maps kernel (`ops.cuda_detect`; its plain version on the CPU),
then a border mask, (8, 16) block-max candidates, per-grid-cell top-k with
2x over-retention, the Harris re-score, intensity-centroid angles and the
rotated BRIEF (256 bits; with wta_k 3 or 4, 128 one-hot symbols).

Every top-k breaks ties by ascending index (a stable descending sort), the
order the JAX package's `lax.top_k` gives; invalid slots carry
valid=False.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagestitch_tpu_torch.config import DetectorConfig
from imagestitch_tpu_torch.features.pattern import (
    brief_pattern, brief_pattern_opencv, orb_tuple_pattern)
from imagestitch_tpu_torch.ops.cuda_detect import (MAX_LEVELS,
                                                   detect_maps_levels)
from imagestitch_tpu_torch.ops.pyramid import build_pyramid, level_scale
from imagestitch_tpu_torch.types import ImageFeatures


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim, equal
    values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _features_per_level(cfg: DetectorConfig) -> list[int]:
    """Per-level keypoint quotas, n_l ∝ (1/scale_factor)^l, remainder to
    the top level."""
    factor = 1.0 / cfg.scale_factor
    n = cfg.nfeatures
    ndesired = n * (1 - factor) / (1 - factor ** cfg.nlevels)
    quotas = []
    total = 0
    for lv in range(cfg.nlevels - 1):
        q = int(round(ndesired * factor ** lv))
        quotas.append(q)
        total += q
    quotas.append(max(n - total, 0))
    return quotas


_SCAN_TILE = 16


def _cumsum_tiled(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dim, summed in the order the
    JAX package's compiled CPU cumsum uses: sequentially inside tiles of
    16, tile totals scanned the same way (recursively), then added. The
    angle below takes differences of these sums, so the order shows in
    its last bits and, through rounding, in the descriptor bits."""
    n = x.shape[-1]
    if n <= _SCAN_TILE:
        out = [x[..., 0]]
        for j in range(1, n):
            out.append(out[-1] + x[..., j])
        return torch.stack(out, dim=-1)
    T = -(-n // _SCAN_TILE)
    xp = F.pad(x, (0, T * _SCAN_TILE - n)).reshape(
        x.shape[:-1] + (T, _SCAN_TILE))
    inner = _cumsum_tiled(xp)
    incl = _cumsum_tiled(inner[..., -1])
    prefix = F.pad(incl[..., :-1], (1, 0))
    out = inner + prefix[..., None]
    return out.reshape(x.shape[:-1] + (T * _SCAN_TILE,))[..., :n]


def _ic_angles(img: torch.Tensor, xk: torch.Tensor, yk: torch.Tensor,
               half_patch: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint from row prefix sums
    (P = x-cumsum(I), Q = x-cumsum(x·I)): each disc row's sum and first
    moment are prefix differences."""
    H, W = img.shape
    dev = img.device
    img = img.to(torch.float32)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    Pf = F.pad(_cumsum_tiled(img), (1, 0)).reshape(-1)
    Qf = F.pad(_cumsum_tiled(img * xs[None, :]), (1, 0)).reshape(-1)
    Wp1 = W + 1
    h = half_patch
    vs = np.arange(-h, h + 1, dtype=np.int64)
    umax = np.round(np.sqrt(np.maximum(
        h * h - vs.astype(np.float64) ** 2, 0.0))).astype(np.int64)
    vs_t = torch.as_tensor(vs, device=dev)[None, :]
    rs_t = torch.as_tensor(umax, device=dev)[None, :]
    xk = xk.to(torch.int64)
    yk = yk.to(torch.int64)
    yv = (yk[:, None] + vs_t).clamp(0, H - 1)
    lo = (xk[:, None] - rs_t).clamp(0, W)
    hi = (xk[:, None] + rs_t + 1).clamp(0, W)
    base = yv * Wp1
    s = Pf[base + hi] - Pf[base + lo]
    q = Qf[base + hi] - Qf[base + lo]
    t10 = q - xk.to(torch.float32)[:, None] * s
    t01 = vs_t.to(torch.float32) * s
    # row sums in sequence, the order of the JAX package's compiled
    # reduction (the moments are differences of large prefix sums)
    m10, m01 = t10[:, 0], t01[:, 0]
    for j in range(1, t10.shape[1]):
        m10 = m10 + t10[:, j]
        m01 = m01 + t01[:, j]
    return torch.atan2(m01, m10)


def _rotated_gather(blurred: torch.Tensor, xk: torch.Tensor,
                    yk: torch.Tensor, angles: torch.Tensor,
                    pat: torch.Tensor) -> torch.Tensor:
    """Pattern samples rotated by each keypoint's angle, (K, P)."""
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    px = pat[None, :, 0]
    py = pat[None, :, 1]
    rx = torch.round(px * ca - py * sa).to(torch.int64)
    ry = torch.round(px * sa + py * ca).to(torch.int64)
    H, W = blurred.shape
    xi = (xk.to(torch.int64)[:, None] + rx).clamp(0, W - 1)
    yi = (yk.to(torch.int64)[:, None] + ry).clamp(0, H - 1)
    return blurred.reshape(-1)[yi * W + xi]


def _orb_descriptors(blurred, xk, yk, angles, cfg: DetectorConfig):
    """Rotated BRIEF: wta_k 2 gives (K, 256) {0,1} uint8 bits (point pair
    comparisons); wta_k 3 and 4 give 128 symbols, each the index of the
    brightest of its tuple's points (the reference's tie rules), stored
    one-hot as (K, 128·wta_k) {0,1} uint8 bits: their Hamming distance is
    twice OpenCV's NORM_HAMMING2 symbol distance."""
    dev = blurred.device
    if cfg.wta_k == 2:
        pat_np = (brief_pattern_opencv() if cfg.pattern == "opencv"
                  else brief_pattern(256, cfg.patch_size))
        pat = torch.as_tensor(pat_np, dtype=torch.float32, device=dev)
        vals = _rotated_gather(blurred, xk, yk, angles, pat)  # (K, 512)
        return (vals[:, 0::2] < vals[:, 1::2]).to(torch.uint8)
    ntuples = 128
    pat = torch.as_tensor(orb_tuple_pattern(cfg.wta_k, ntuples,
                                            cfg.patch_size),
                          dtype=torch.float32, device=dev)
    vals = _rotated_gather(blurred, xk, yk, angles, pat)
    vals = vals.reshape(vals.shape[0], ntuples, cfg.wta_k)
    if cfg.wta_k == 3:
        t0, t1, t2 = vals.unbind(-1)
        code = torch.where(t2 > t1,
                           torch.where(t2 > t0, 2, 0),
                           (t1 > t0).to(torch.int64))
    else:
        t0, t1, t2, t3 = vals.unbind(-1)
        u = (t1 > t0).to(torch.int64)
        v = 2 + (t3 > t2).to(torch.int64)
        code = torch.where(torch.maximum(t0, t1) > torch.maximum(t2, t3),
                           u, v)
    onehot = code[..., None] == torch.arange(cfg.wta_k, device=dev)
    return onehot.reshape(vals.shape[0], ntuples * cfg.wta_k).to(torch.uint8)


def orb_maps(grays: torch.Tensor, cfg: DetectorConfig = DetectorConfig()):
    """The maps stage over a (B, H, W) batch of grayscale images: the
    pyramid, then the detector maps of every level of every image from one
    kernel launch (up to MAX_LEVELS levels a launch). Returns (levels,
    maps): levels[l] (B, H_l, W_l) float32; maps[l] (nms_score, harris,
    blurred), each (B, H_l, W_l)."""
    pyr = build_pyramid(grays, cfg.nlevels, cfg.scale_factor,
                        cfg.first_level)
    pyr = [lv.contiguous() for lv in pyr]
    maps = [m for i in range(0, len(pyr), MAX_LEVELS)
            for m in detect_maps_levels(pyr[i:i + MAX_LEVELS],
                                        float(cfg.fast_threshold),
                                        cfg.harris_block_size)]
    return pyr, maps


def orb_select(levels, maps, view: int, hw: tuple[int, int],
               cfg: DetectorConfig = DetectorConfig()) -> ImageFeatures:
    """The selection stage for image `view` of the batch that `orb_maps`
    returned, whose source is `hw` (H, W): border mask, block-max
    candidates, per-cell top-k, Harris re-score, angles and descriptors
    -> padded ImageFeatures (keypoint xy in source-image coordinates)."""
    H, W = hw
    dev = levels[0].device
    ncells = cfg.grid_rows * cfg.grid_cols
    quotas = _features_per_level(cfg)

    xs, ys, resp, angs, sizes, lvls, valids, descs = \
        [], [], [], [], [], [], [], []
    for lv, (lv_imgs, lv_maps) in enumerate(zip(levels, maps)):
        img_l = lv_imgs[view]
        Hl, Wl = img_l.shape
        score, harris, blurred = (m[view] for m in lv_maps)

        # border mask (runByImageBorder with edge_threshold)
        b = cfg.edge_threshold
        score = score.clone()
        score[:b] = 0.0
        score[Hl - b:] = 0.0
        score[:, :b] = 0.0
        score[:, Wl - b:] = 0.0

        k_cell = max(int(np.ceil(quotas[lv] / ncells)), 1)
        k_cand = max(int(np.ceil(k_cell * cfg.per_level_overretain)), k_cell)

        # one candidate per (8, 16) block: post-NMS corners are sparse
        BH, BW = 8, 16
        Hp = -(-Hl // BH) * BH
        Wp = -(-Wl // BW) * BW
        sp = F.pad(score, (0, Wp - Wl, 0, Hp - Hl))
        sb = (sp.reshape(Hp // BH, BH, Wp // BW, BW)
              .permute(0, 2, 1, 3).reshape(-1, BH * BW))
        bmax = sb.amax(dim=-1)
        barg = torch.argmax(sb, dim=-1)     # the first maximum
        nbx = Wp // BW
        bi = torch.arange(bmax.shape[0], device=dev)
        win_y = (bi // nbx) * BH + barg // BW
        win_x = (bi % nbx) * BW + barg % BW
        if bmax.shape[0] < k_cand:
            padn = k_cand - bmax.shape[0]
            bmax = torch.cat([bmax, bmax.new_zeros(padn)])
            win_y = torch.cat([win_y, win_y.new_zeros(padn)])
            win_x = torch.cat([win_x, win_x.new_zeros(padn)])

        hflat = harris.reshape(-1)
        cell_xk, cell_yk, cell_h, cell_v = [], [], [], []
        for cy in range(cfg.grid_rows):
            for cx in range(cfg.grid_cols):
                y0c, y1c = Hl * cy // cfg.grid_rows, \
                    Hl * (cy + 1) // cfg.grid_rows
                x0c, x1c = Wl * cx // cfg.grid_cols, \
                    Wl * (cx + 1) // cfg.grid_cols
                cell = ((win_y >= y0c) & (win_y < y1c)
                        & (win_x >= x0c) & (win_x < x1c))
                s_cell = torch.where(cell, bmax, torch.zeros_like(bmax))
                cand_s, cand_b = top_k_stable(s_cell, k_cand)
                cand_i = win_y[cand_b] * Wl + win_x[cand_b]
                cand_valid = cand_s > 0
                hvals = torch.where(cand_valid, hflat[cand_i],
                                    torch.full_like(cand_s, float("-inf")))
                top_h, top_j = top_k_stable(hvals, k_cell)
                ci = cand_i[top_j]
                v = cand_valid[top_j]
                cell_xk.append(ci % Wl)
                cell_yk.append(ci // Wl)
                cell_h.append(torch.where(v, top_h, torch.zeros_like(top_h)))
                cell_v.append(v)
        xk = torch.cat(cell_xk)
        yk = torch.cat(cell_yk)
        v = torch.cat(cell_v)
        ang = _ic_angles(img_l, xk, yk, cfg.patch_size // 2)
        d = _orb_descriptors(blurred, xk, yk, ang, cfg)
        n_l = ncells * k_cell
        s = level_scale(lv, cfg.scale_factor, cfg.first_level)
        xs.append(xk.to(torch.float32) * s)
        ys.append(yk.to(torch.float32) * s)
        resp.append(torch.cat(cell_h).to(torch.float32))
        angs.append(ang)
        sizes.append(torch.full((n_l,), cfg.patch_size * s,
                                dtype=torch.float32, device=dev))
        lvls.append(torch.full((n_l,), lv, dtype=torch.int32, device=dev))
        valids.append(v)
        descs.append(d)

    feats = ImageFeatures(
        xy=torch.stack([torch.cat(xs), torch.cat(ys)], dim=1),
        response=torch.cat(resp),
        angle=torch.cat(angs),
        size=torch.cat(sizes),
        level=torch.cat(lvls),
        valid=torch.cat(valids),
        descriptors=torch.cat(descs, dim=0),
        img_size=torch.tensor([H, W], dtype=torch.int32, device=dev),
    )
    return _pad_or_trim(feats, cfg.max_keypoints)


def detect_and_compute(gray: torch.Tensor,
                       cfg: DetectorConfig = DetectorConfig()
                       ) -> ImageFeatures:
    """Full ORB over one (H, W) grayscale image -> padded ImageFeatures
    (keypoint xy in source-image coordinates)."""
    levels, maps = orb_maps(gray[None], cfg)
    return orb_select(levels, maps, 0, tuple(gray.shape), cfg)


def _pad_or_trim(f: ImageFeatures, capacity: int) -> ImageFeatures:
    """Fix the keypoint capacity: trim by response (stable top-k) or
    zero-pad with valid=False."""
    K = f.xy.shape[0]
    if K == capacity:
        return f
    if K > capacity:
        key = torch.where(f.valid, f.response,
                          torch.full_like(f.response, float("-inf")))
        _, idx = top_k_stable(key, capacity)
        return ImageFeatures(
            xy=f.xy[idx], response=f.response[idx], angle=f.angle[idx],
            size=f.size[idx], level=f.level[idx], valid=f.valid[idx],
            descriptors=f.descriptors[idx], img_size=f.img_size)
    pad = capacity - K

    def z(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])], dim=0)

    return ImageFeatures(
        xy=z(f.xy), response=z(f.response), angle=z(f.angle),
        size=z(f.size), level=z(f.level), valid=z(f.valid),
        descriptors=z(f.descriptors), img_size=f.img_size)
