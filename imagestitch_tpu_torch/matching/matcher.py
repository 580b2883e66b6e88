"""Pairwise matching + per-pair motion (`imagestitch_tpu.matching.
matcher`): exact Hamming (ORB) or squared-L2 (SIFT) 2-NN in both
directions with Lowe's ratio test, mutual-duplicate suppression,
compaction to `max_matches` by ascending distance, then by
`MatcherConfig.motion`
- "homography": center-normalized RANSAC, Brown–Lowe confidence (zeroed
  above 3) and the second RANSAC pass on the inliers;
- "affine_partial" / "affine" (SCANS mode, OpenCV's
  AffineBestOf2NearestMatcher): RANSAC similarity or affine on the raw
  keypoint coordinates, one pass with its least-squares refit, and the
  confidence kept above 3.
`match_all` runs it over the pairs of a batch of images."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imagestitch_tpu_torch.config import MatcherConfig, RansacConfig
from imagestitch_tpu_torch.features.orb import top_k_stable
from imagestitch_tpu_torch.geometry.affine import find_affine
from imagestitch_tpu_torch.geometry.ransac import find_homography
from imagestitch_tpu_torch.matching.hamming import (hamming_distance_matrix,
                                                    l2_distance_matrix)
from imagestitch_tpu_torch.types import (ImageFeatures, MatchesInfo,
                                        index, stack)

BIG = float(np.float32(3.0e38))
REFIT_HYPOTHESES = 256


def _two_nn(D: torch.Tensor, ratio_keep: torch.Tensor):
    """Row-wise 2-NN with the ratio test over (N, M) distances (BIG at
    invalid entries). Returns (best_j, best_d, keep)."""
    if D.shape[1] < 2:
        D = torch.cat([D, D.new_full((D.shape[0], 2 - D.shape[1]), BIG)], 1)
    d0 = D.amin(dim=1)
    best_j = torch.argmin(D, dim=1)                     # first minimum
    cols = torch.arange(D.shape[1], device=D.device)[None, :]
    d1 = torch.where(cols == best_j[:, None], torch.full_like(D, BIG),
                     D).amin(dim=1)
    keep = (d0 < ratio_keep * d1) & (d0 < BIG)
    return best_j, d0, keep


def match_pair_descriptors(f1: ImageFeatures, f2: ImageFeatures,
                           cfg: MatcherConfig = MatcherConfig()):
    """Bidirectional ratio-tested matches. Returns (pairs (M, 2) int32,
    dist (M,) float32, valid (M,) bool), padded to cfg.max_matches, valid
    first by ascending distance (ties by ascending candidate index)."""
    dev = f1.xy.device
    N = f1.capacity
    M = f2.capacity
    # binary (ORB rBRIEF) descriptors -> Hamming; float (SIFT) -> L2
    if f1.descriptors.dtype.is_floating_point:
        D = l2_distance_matrix(f1.descriptors, f2.descriptors)
    else:
        D = hamming_distance_matrix(f1.descriptors, f2.descriptors)
    D = torch.where(f1.valid[:, None] & f2.valid[None, :], D,
                    torch.full_like(D, BIG))
    ratio_keep = torch.tensor(1.0 - cfg.match_conf, dtype=torch.float32,
                              device=dev)
    fj, fd, fk = _two_nn(D, ratio_keep)
    bj, bd, bk = _two_nn(D.T, ratio_keep)
    # a backward match (bj[j], j) duplicates a kept forward match (i, j)
    dup = fk[bj] & (fj[bj] == torch.arange(M, device=dev))
    bk = bk & ~dup

    pairs = torch.cat([
        torch.stack([torch.arange(N, device=dev), fj], dim=1),
        torch.stack([bj, torch.arange(M, device=dev)], dim=1),
    ]).to(torch.int32)
    dist = torch.cat([fd, bd])
    valid = torch.cat([fk, bk])
    if pairs.shape[0] < cfg.max_matches:
        deficit = cfg.max_matches - pairs.shape[0]
        pairs = torch.cat([pairs, pairs.new_zeros((deficit, 2))])
        dist = torch.cat([dist, dist.new_full((deficit,), BIG)])
        valid = torch.cat([valid, valid.new_zeros(deficit)])
    keymat = torch.where(valid, -dist, torch.full_like(dist, -BIG))
    _, order = top_k_stable(keymat, cfg.max_matches)
    return pairs[order], dist[order], valid[order]


def match_pair(f1: ImageFeatures, f2: ImageFeatures, src_idx: int = 0,
               dst_idx: int = 1, cfg: MatcherConfig = MatcherConfig(),
               rcfg: RansacConfig = RansacConfig(), draws=None,
               generator: torch.Generator | None = None) -> MatchesInfo:
    """Descriptors -> RANSAC motion -> confidence for one pair. H maps
    f1's points into f2's: center-normalized for the homography, raw
    pixel coordinates for the affine motions.

    `draws`: optional (u_first, u_refit) uniform draws of the RANSAC
    passes: (num_hypotheses, 4) and (256, 4) for the homography; for the
    affine motions u_first is (num_hypotheses, 2) (partial) or (.., 3)
    and u_refit is not used (one pass). Without them the draws come from
    `generator`."""
    dev = f1.xy.device
    pairs, dist, valid = match_pair_descriptors(f1, f2, cfg)
    homography = cfg.motion == "homography"
    src = f1.xy[pairs[:, 0].long()]
    dst = f2.xy[pairs[:, 1].long()]
    if homography:
        src = src - 0.5 * torch.flip(f1.img_size.to(torch.float32), [0])
        dst = dst - 0.5 * torch.flip(f2.img_size.to(torch.float32), [0])

    u_first, u_refit = draws if draws is not None else (None, None)
    num_matches = valid.to(torch.int32).sum()
    enough = num_matches >= cfg.num_matches_thresh1
    if homography:
        res = find_homography(src, dst, valid, rcfg, u=u_first,
                              generator=generator)
    else:
        res = find_affine(src, dst, valid, rcfg,
                          partial=cfg.motion == "affine_partial",
                          u=u_first, generator=generator)
    h_ok = res.ok & enough

    conf = res.num_inliers.to(torch.float32) / (
        8.0 + 0.3 * num_matches.to(torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if homography:
        # "too close to be believable": OpenCV's affine matcher keeps it
        conf = torch.where(conf > 3.0, zero, conf)
    conf = torch.where(h_ok, conf, zero)

    H = res.H
    if homography:
        # second pass on the first pass's inliers: replaces H, keeps the
        # first pass's inlier mask, count and confidence
        rcfg_refit = dataclasses.replace(
            rcfg, num_hypotheses=min(REFIT_HYPOTHESES, rcfg.num_hypotheses))
        refit = find_homography(src, dst, res.inliers & valid, rcfg_refit,
                                u=u_refit, generator=generator)
        do_refit = (res.num_inliers >= cfg.num_matches_thresh2) & refit.ok
        H = torch.where(do_refit, refit.H, res.H)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return MatchesInfo(
        src_idx=torch.tensor(src_idx, dtype=torch.int32, device=dev),
        dst_idx=torch.tensor(dst_idx, dtype=torch.int32, device=dev),
        pairs=pairs, distance=dist, valid=valid,
        inliers=res.inliers & valid,
        num_inliers=torch.where(h_ok, res.num_inliers,
                                torch.zeros_like(res.num_inliers)),
        H=torch.where(h_ok, H, eye),
        h_valid=h_ok, confidence=conf)


def draw_pair(cfg: MatcherConfig, rcfg: RansacConfig,
              generator: torch.Generator | None, device):
    """One pair's RANSAC draws taken from `generator` on `device` as
    `match_pair` takes them when none are injected: (u_first, u_refit) of
    shapes (num_hypotheses, 4) and (min(256, num_hypotheses), 4) for the
    homography; for the affine motions (num_hypotheses, 2 or 3) and
    None. Drawing every pair's first, in pair order, lets a split over
    devices give each pair the draws the unsplit run gives it."""
    B = rcfg.num_hypotheses
    if cfg.motion == "homography":
        u_first = torch.rand((B, 4), generator=generator, device=device)
        return u_first, torch.rand((min(REFIT_HYPOTHESES, B), 4),
                                   generator=generator, device=device)
    p = 2 if cfg.motion == "affine_partial" else 3
    return torch.rand((B, p), generator=generator, device=device), None


def pair_list(n: int, range_width: int = -1) -> list[tuple[int, int]]:
    """The (i, j) pairs, i < j, that `match_all` matches: all of them, or
    those with j - i <= range_width when range_width > 0."""
    w = range_width if range_width > 0 else n
    return [(i, j) for i in range(n) for j in range(i + 1, min(i + w + 1, n))]


def match_pairs(feats: ImageFeatures, pairs,
                cfg: MatcherConfig = MatcherConfig(),
                rcfg: RansacConfig = RansacConfig(), draws=None,
                generator: torch.Generator | None = None
                ) -> list[MatchesInfo]:
    """`match_pair` over the (i, j) `pairs` of a batched ImageFeatures
    (leading axis = image). `draws`: optional mapping (i, j) -> (u_first,
    u_refit), the pair's RANSAC draws; without it every pair draws from
    `generator`."""
    views = [index(feats, i) for i in range(feats.xy.shape[0])]
    return [match_pair(views[i], views[j], i, j, cfg, rcfg,
                       draws=None if draws is None else draws[(i, j)],
                       generator=generator) for i, j in pairs]


def match_all(feats: ImageFeatures, cfg: MatcherConfig = MatcherConfig(),
              rcfg: RansacConfig = RansacConfig(), draws=None,
              generator: torch.Generator | None = None) -> MatchesInfo:
    """`match_pairs` over `pair_list(N, cfg.range_width)`, stacked in that
    order."""
    return stack(match_pairs(feats,
                             pair_list(feats.xy.shape[0], cfg.range_width),
                             cfg, rcfg, draws, generator))
