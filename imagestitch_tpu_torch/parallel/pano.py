"""One chain panorama over a device mesh (`imagestitch_tpu.parallel.pano`).

`stitch_chain_pano` is the fixed-N chain with a seam schedule of its own:
the N-1 consecutive pair seams are computed independently from the
ORIGINAL masks and merged, with the leftover pixels handed to the first
image that covers them, so the split still partitions the coverage.
`pipeline.stitch_chain_impl` resolves them sequentially instead (pair
(i, i+1) sees masks already split by pair (i-1, i)). Where non-adjacent
views do not overlap (every consecutive-overlap panorama) the two
schedules give the same masks; under a triple overlap they may differ in
the doubly contested sliver.

`stitch_chain_pano_sharded` computes the same panorama over a mesh:
- the views split over axis "data" for detect (K1 once per data device,
  on its views) and for the warp (K2 once per data device, its views into
  the shared canvas frame);
- the pair matching and the N-1 pair seams split over "data";
- RANSAC scores its hypotheses over "model" when the mesh has that axis;
- the cameras, the bundle adjustment, the exposure compensation and the
  blend run on the mesh's first device after one gather.
The JAX package also lays the canvas stages out in canvas rows. The
feather blend's distance transform and the multi-band pyramid are not
pointwise in rows, PyTorch has no partitioner to exchange the halos, and
so the port does not split the canvas (ROADMAP Queue C).

`stitch_pair_hostseam_sharded` is the host-seam pair (graph cut, full
DP) under a mesh: its front on the mesh's first device (RANSAC over
"model"), then `pipeline._host_seam_blend` as `stitch_pair` runs it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from imagestitch_tpu_torch.config import PipelineConfig
from imagestitch_tpu_torch.features import detect_batched
from imagestitch_tpu_torch.matching.matcher import draw_pair, match_pairs
from imagestitch_tpu_torch.parallel.mesh import (Mesh, data_sharding,
                                                 run_on_devices, use_mesh)
from imagestitch_tpu_torch.pipeline import (
    OneDevice, _blend_resolved, _generator, _host_seam_blend,
    _needs_host_seam, resolve_device, set_full_precision,
    stitch_chain_front_impl, stitch_pair_front_impl, warp_views)
from imagestitch_tpu_torch.seam.dp import dp_seam_pair
from imagestitch_tpu_torch.seam.voronoi import voronoi_seam_pair
from imagestitch_tpu_torch.types import to_device


def _pair_seams(warped, masks, cfg: PipelineConfig, max_w: int | None):
    """The seams of the consecutive pairs (u, u+1) of (n, Hc, Wc, C)
    canvases, each from the original masks. Returns (keep_l, keep_r):
    per pair the masks its left and its right image keep."""
    keep_l, keep_r = [], []
    for u in range(warped.shape[0] - 1):
        if cfg.seam.kind == "voronoi":
            a2, b2 = voronoi_seam_pair(masks[u], masks[u + 1])
        else:
            # vertical pin: as in the JAX package, whose vmapped
            # orient="auto" dispatch would compute both orientations
            a2, b2, _ = dp_seam_pair(
                warped[u], warped[u + 1], masks[u], masks[u + 1],
                cfg.seam.kind.endswith("colorgrad"), max_overlap_w=max_w,
                orient="vertical", scale=cfg.seam.dp_scale)
        keep_l.append(a2)
        keep_r.append(b2)
    return keep_l, keep_r


def _merge_pair_seams(masks, keep_l, keep_r) -> torch.Tensor:
    """Each image keeps its left side of pair (i, i+1) and its right side
    of pair (i-1, i); a pixel that every image ceded (in both overlaps of
    a middle image) goes to the first image that covers it. Returns the
    (N, Hc, Wc) bool coverage partition."""
    n = masks.shape[0]
    owned = []
    for i in range(n):
        m = masks[i]
        if i < n - 1:
            m = m & keep_l[i]
        if i > 0:
            m = m & keep_r[i - 1]
        owned.append(m)
    un = masks.any(dim=0) & ~torch.stack(owned).any(dim=0)
    for i in range(n):
        take = un & masks[i]
        owned[i] = owned[i] | take
        un = un & ~take
    return torch.stack(owned)


def _independent_pair_seams(warped, masks, cfg: PipelineConfig,
                            max_w: int | None, steps=None):
    """All N-1 consecutive-pair seams from the original masks, merged into
    a coverage partition (N, Hc, Wc) bool; with `steps` (a `MeshSteps`)
    the pairs split over its mesh."""
    keeps = (_pair_seams(warped, masks, cfg, max_w) if steps is None
             else steps.pair_seams(warped, masks, cfg, max_w))
    return _merge_pair_seams(masks, *keeps)


def _cat(parts, home: torch.device):
    """Batched ImageFeatures concatenated on their leading axis, on
    `home`."""
    return type(parts[0])(**{
        f.name: torch.cat([getattr(p, f.name).to(home) for p in parts])
        for f in dataclasses.fields(parts[0])})


class MeshSteps:
    """The chain front's detect, match and warp (`pipeline.OneDevice`) and
    the pair seams split over a mesh's "data" axis, each shard on its
    device, the results gathered to the mesh's first device in order.
    Matching takes every pair's RANSAC draws first, in pair order, from
    the chain's generator, so that a split changes no draw."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.home = mesh.first()
        self.sharding = data_sharding(mesh, 1)

    def _run(self, n: int, fn):
        """fn(d, dev, a, b) for each non-empty data shard [a, b) of n."""
        return run_on_devices([
            (dev, functools.partial(fn, d, dev, a, b))
            for d, (dev, (a, b)) in enumerate(zip(self.sharding.devices,
                                                  self.sharding.ranges(n)))
            if a < b])

    def detect(self, grays, dcfg):
        return _cat(self._run(grays.shape[0], lambda d, dev, a, b:
                              detect_batched(grays[a:b].to(dev), dcfg)),
                    self.home)

    def match(self, feats, pairs, cfg, rcfg, draws=None, generator=None):
        if draws is None:
            draws = {p: draw_pair(cfg, rcfg, generator, self.home)
                     for p in pairs}

        def shard(d, dev, a, b):
            with use_mesh(self.mesh.row("data", d)):
                return match_pairs(to_device(feats, dev), pairs[a:b], cfg,
                                   rcfg, draws)

        return [to_device(m, self.home)
                for part in self._run(len(pairs), shard) for m in part]

    def warp(self, imgs, k_rinvs, scale, corners, roi_uvs, canvas_hw, kind,
             src_sizes=None):
        per_view = torch.is_tensor(scale) and scale.numel() > 1

        def shard(d, dev, a, b):
            s = scale[a:b] if per_view else scale
            return warp_views(
                imgs[a:b].to(dev), k_rinvs[a:b].to(dev),
                s.to(dev) if torch.is_tensor(s) else s,
                corners[a:b].to(dev), roi_uvs[a:b].to(dev), canvas_hw, kind,
                src_sizes=None if src_sizes is None else src_sizes[a:b])

        parts = self._run(imgs.shape[0], shard)
        return (torch.cat([p[0].to(self.home) for p in parts]),
                torch.cat([p[1].to(self.home) for p in parts]))

    def pair_seams(self, warped, masks, cfg, max_w):
        """`_pair_seams` with the pairs split: a shard of pairs [a, b)
        takes views a..b."""
        def shard(d, dev, a, b):
            kl, kr = _pair_seams(warped[a:b + 1].to(dev),
                                 masks[a:b + 1].to(dev), cfg, max_w)
            return ([k.to(self.home) for k in kl],
                    [k.to(self.home) for k in kr])

        parts = self._run(masks.shape[0] - 1, shard)
        return ([k for kl, _ in parts for k in kl],
                [k for _, kr in parts for k in kr])


def _refuse(cfg: PipelineConfig) -> None:
    if _needs_host_seam(cfg):
        raise ValueError(
            f"seam kind '{cfg.seam.kind}' resolves on the host and cannot "
            "run inside the sharded pano program; use an on-device kind")
    if cfg.blend.kind == "ramp":
        raise ValueError("blend='ramp' is pair-only; the sharded pano path "
                         "needs feather/multiband/none")


def _chain_pano(imgs: torch.Tensor, cfg: PipelineConfig, draws, generator,
                mesh: Mesh | None):
    _refuse(cfg)
    W = imgs.shape[2]
    steps = None if mesh is None else MeshSteps(mesh)
    warped, masks, corner, metrics = stitch_chain_front_impl(
        imgs, cfg, draws, generator, steps or OneDevice)
    if cfg.seam.kind == "none":
        seam_masks = masks
    else:
        fac = 1.1 if cfg.warp.kind in ("cylindrical", "spherical") else 1.3
        max_w = -(-int(round(fac * W)) // 128) * 128
        seam_masks = _independent_pair_seams(warped, masks, cfg, max_w,
                                             steps)
    pano, valid = _blend_resolved(warped, seam_masks, masks, cfg,
                                  dilate_seam=cfg.seam.kind != "none")
    return pano, valid, corner, metrics


def stitch_chain_pano_impl(imgs: torch.Tensor,
                           cfg: PipelineConfig = PipelineConfig(),
                           draws=None,
                           generator: torch.Generator | None = None):
    """(N, H, W, 3) chain on one device -> (pano canvas, valid, corner,
    metrics): `pipeline.stitch_chain_front_impl` (K1 once, K2 once), then
    the independent pair seams and the blend. A host seam or the ramp
    blend raises ValueError. `draws`: optional mapping (i, j) ->
    (u_first, u_refit) per pair."""
    return _chain_pano(imgs, cfg, draws, generator, None)


def _views(images, dev: torch.device) -> torch.Tensor:
    set_full_precision()
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(np.stack([np.asarray(im) for im in images]))
    return images.to(device=dev, dtype=torch.float32)


def stitch_chain_pano(imgs, config: PipelineConfig | None = None,
                      seed: int = 0, device=None, draws=None):
    """N same-size (H, W, 3) views with consecutive overlap -> uncropped
    (pano (Hc, Wc, 3), valid, corner, metrics) tensors on the device.
    Runs on `device` (default: the CUDA card; with no card it raises);
    RANSAC draws come from a torch.Generator seeded with `seed` there,
    unless `draws` maps each pair (i, j) to its draws."""
    cfg = config or PipelineConfig()
    _refuse(cfg)
    dev = resolve_device(device)
    return stitch_chain_pano_impl(_views(imgs, dev), cfg, draws,
                                  _generator(dev, seed))


def stitch_chain_pano_sharded(imgs, mesh: Mesh,
                              config: PipelineConfig | None = None,
                              seed: int = 0, draws=None):
    """`stitch_chain_pano` split over `mesh` (module docstring); the same
    result, on the mesh's first device, whose generator gives the draws
    (unless `draws` injects them)."""
    cfg = config or PipelineConfig()
    _refuse(cfg)
    home = mesh.first()
    return _chain_pano(_views(imgs, home), cfg, draws,
                       _generator(home, seed), mesh)


def stitch_pair_hostseam_sharded(img1, img2, mesh: Mesh,
                                 config: PipelineConfig | None = None,
                                 seed: int = 0, draws=None):
    """A host-seam pair (graph cut, or a DP seam with full_components)
    under `mesh`: the front on the mesh's first device with RANSAC over
    its "model" axis, then the host seam and the blend
    (`pipeline._host_seam_blend`), as `stitch_pair` splits it. Returns
    uncropped (pano, valid, corner, metrics) tensors; an on-device seam
    kind raises ValueError. `draws`: optional (u_first, u_refit)."""
    cfg = config or PipelineConfig()
    if not _needs_host_seam(cfg):
        raise ValueError(
            f"seam kind '{cfg.seam.kind}' is on-device; use stitch_pair / "
            "stitch_chain_pano_sharded instead")
    home = mesh.first()
    set_full_precision()
    a = torch.as_tensor(np.asarray(img1), device=home).to(torch.float32)
    b = torch.as_tensor(np.asarray(img2), device=home).to(torch.float32)
    with use_mesh(mesh):
        warped, masks, corner, metrics = stitch_pair_front_impl(
            a, b, cfg, draws, _generator(home, seed))
        pano, valid, _ = _host_seam_blend(warped, masks, cfg)
    return pano, valid, corner, metrics
