"""The stitch entry points of `imagestitch_tpu.pipeline`: gray (resized to
the work scale with `work_megapix`) -> ORB on a 5-level pyramid (one
detector-maps launch for all levels of all images) or SIFT on 4 octaves
(octave-maps kernel per octave and image) -> Hamming or L2 2-NN ->
RANSAC homography -> focal + chained rotations -> ray or reprojection
bundle adjustment -> optional wave correction -> intrinsics scaled back
to full resolution -> warp of all images into one shared canvas (the
cylindrical, spherical and plane kinds in one warp-kernel launch, the
other projectors by the plain warp) -> gain compensation (gain,
channels, per block) -> DP, Voronoi or no seams -> 20x20 seam dilate +
feather or multi-band blend, or the seam-anchored ramp of a pair -> bbox
or interior crop.

The host seams (`SeamConfig` kinds "graphcut" / "graphcut_colorgrad" and
`full_components=True`) split the stitch around a host solve, as the JAX
package does: the front runs on the device, the seam inputs are read back
(decimated on the device with `seam_megapix`; for a graph-cut pair only
the overlap's uint8 crop), the seams resolve in NumPy and the native
solvers, and the blend runs on the device again. SCANS mode
(`mode="scans"`) registers with affine motions on raw coordinates and
warps with affine cameras through the plane projector.

Entry points, each running on the CUDA card unless the caller names
another device (with device=None and no card they raise):
- `stitch_pair(img1, img2, config=None, seed=0, device=None)`: two images;
- `stitch_chain(images, config=None, seed=0, device=None)`: N same-size
  views matched i -> i+1 (with `chain_splice`, also i -> i+2);
- `Stitcher(config).stitch(images)` and `stitch(images)`: N views of any
  sizes and pair topology (all pairs, a spanning tree of the confident
  ones, the largest component composed).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from imagestitch_tpu_torch.blend.feather import feather_blend
from imagestitch_tpu_torch.blend.multiband import multiband_blend
from imagestitch_tpu_torch.blend.ramp import ramp_blend_pair
from imagestitch_tpu_torch.config import PipelineConfig
from imagestitch_tpu_torch.exposure.gain import (
    channels_compensate, channels_compensate_blocks, gain_compensate,
    gain_compensate_blocks)
from imagestitch_tpu_torch.features import detect as detect_features
from imagestitch_tpu_torch.features import detect_batched
from imagestitch_tpu_torch.geometry.autocalib import _masked_median
from imagestitch_tpu_torch.geometry.bundle import (bundle_adjust,
                                                   bundle_adjust_affine,
                                                   rotation_defect,
                                                   wave_correct)
from imagestitch_tpu_torch.geometry.rotation import (
    affine_cameras, estimate_affine_host, estimate_cameras,
    estimate_cameras_host, estimate_cameras_spliced)
from imagestitch_tpu_torch.matching.matcher import (match_all, match_pair,
                                                    match_pairs, pair_list)
from imagestitch_tpu_torch.ops import cuda_crop
from imagestitch_tpu_torch.ops.cuda_warp import KIND_IDS, warp_batched
from imagestitch_tpu_torch.ops.image import dilate, rgb_to_gray
from imagestitch_tpu_torch.ops.pyramid import resize_linear_mxu
from imagestitch_tpu_torch.seam.dp import dp_seam_pair
from imagestitch_tpu_torch.seam.dp_full import dp_seam_find_full
from imagestitch_tpu_torch.seam.graphcut import graphcut_seam_pair
from imagestitch_tpu_torch.seam.voronoi import voronoi_seam_pair
from imagestitch_tpu_torch.types import CameraParams, stack
from imagestitch_tpu_torch.utils.crop import autocrop
from imagestitch_tpu_torch.utils import log
from imagestitch_tpu_torch.utils.log import StageTimer
from imagestitch_tpu_torch.warp.projectors import _camera_mats
from imagestitch_tpu_torch.warp.warper import roi_bounds, warp_batched_plain


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default; with
    device=None and no card, raise rather than run elsewhere."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_full_precision() -> None:
    """Every float32 matrix product (pyramid resize, Hamming, DLT, LM normal
    equations) runs in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _normalize_scans(cfg: PipelineConfig) -> PipelineConfig:
    """SCANS mode implies the affine matcher motion (the similarity unless
    the configuration names one) and the plane warp, which affine cameras
    turn into the affine warp (cv2.Stitcher SCANS). A no-op in panorama
    mode."""
    if cfg.mode != "scans":
        return cfg
    m = cfg.matcher
    if m.motion == "homography":
        m = dataclasses.replace(m, motion="affine_partial")
    return cfg.replace(matcher=m,
                       warp=dataclasses.replace(cfg.warp, kind="plane"))


def _upscale_affine(Gs: torch.Tensor, s: float) -> torch.Tensor:
    """Work-scale global affines at full resolution: S·G·S⁻¹ with
    S = diag(s, s, 1)."""
    S = torch.tensor([[s, 0, 0], [0, s, 0], [0, 0, 1]], dtype=torch.float32,
                     device=Gs.device)
    Sinv = torch.tensor([[1 / s, 0, 0], [0, 1 / s, 0], [0, 0, 1]],
                        dtype=torch.float32, device=Gs.device)
    return torch.einsum("ab,nbc,cd->nad", S, Gs, Sinv)


def _scans_cameras(ms, feats, pairs, keep: np.ndarray, n: int,
                   cfg: PipelineConfig, ws: float, device):
    """SCANS-mode cameras of the N-view stitchers: affine transforms
    chained along the spanning tree (`estimate_affine_host`), the joint
    affine bundle adjustment over the matched `pairs` anchored at the
    tree's center (host NumPy), and the work-scale conjugation. Returns
    (cams, tree_edges, reachable)."""
    pair_ok = _np(ms.h_valid) & keep
    cams, tree_edges, reachable = estimate_affine_host(
        _np(ms.H), _np(ms.src_idx), _np(ms.dst_idx), _np(ms.num_inliers),
        pair_ok, n, return_tree=True, device=device)
    if cfg.camera.ba_refine:
        src_pts, dst_pts = _pair_points(feats, ms, pairs)
        Gr = bundle_adjust_affine(
            _np(cams.R), _np(src_pts), _np(dst_pts),
            _np(ms.inliers & ms.valid), _np(ms.src_idx), _np(ms.dst_idx),
            pair_ok, anchor=tree_edges[0][0] if tree_edges else 0,
            partial=cfg.matcher.motion == "affine_partial")
        cams = cams.replace(R=torch.as_tensor(Gr, device=device))
    if ws < 1.0:
        cams = cams.replace(R=_upscale_affine(cams.R, 1.0 / ws))
    return cams, tree_edges, reachable


def _chain_affines(mis, good, mis2, good2, eye):
    """SCANS-mode chain: G_{i+1} = G_i·H_i⁻¹ (the canvas is image 0's
    frame); with the skip pairs (`mis2`), a broken link i -> i+1 is
    bridged by G_{i+1} = G_{i-1}·H2_{i-1}⁻¹. Returns (Gs (N, 3, 3),
    reachable (N,))."""
    Gs = [eye]
    reach = [torch.ones((), dtype=torch.bool, device=eye.device)]
    for i in range(mis.H.shape[0]):
        step1 = torch.where(mis.h_valid[i], torch.linalg.inv(mis.H[i]), eye)
        cand1 = Gs[i] @ step1
        ok1 = good[i] & reach[i]
        if mis2 is not None and i >= 1:
            step2 = torch.where(mis2.h_valid[i - 1],
                                torch.linalg.inv(mis2.H[i - 1]), eye)
            cand2 = Gs[i - 1] @ step2
            ok2 = good2[i - 1] & reach[i - 1]
            Gs.append(torch.where(ok1, cand1,
                                  torch.where(ok2, cand2, cand1)))
            reach.append(ok1 | ok2)
        else:
            Gs.append(cand1)
            reach.append(ok1)
    return torch.stack(Gs), torch.stack(reach)


def _megapix_scale(megapix: float, hw: tuple[int, int]) -> float:
    """The scale that brings an (H, W) image down to `megapix` (OpenCV
    stitching_detailed's work and compose scales: min(1, sqrt(megapix·1e6
    / area)); <= 0 disables)."""
    if megapix <= 0:
        return 1.0
    H, W = hw
    return min(1.0, float(np.sqrt(megapix * 1e6 / (H * W))))


def _scaled_dim(d: int, s: float) -> int:
    return max(int(round(d * s)), 1)


def _work_grays(grays: torch.Tensor, hw: tuple[int, int], ws: float
                ) -> torch.Tensor:
    """(..., H, W) grays resized to the work scale (unchanged at 1)."""
    if ws >= 1.0:
        return grays
    return resize_linear_mxu(grays, (_scaled_dim(hw[0], ws),
                                     _scaled_dim(hw[1], ws)))


def _upscale_cameras(cams: CameraParams, s: float) -> CameraParams:
    """Scale intrinsics by s (rotations are scale-free)."""
    return cams.replace(focal=cams.focal * s, ppx=cams.ppx * s,
                        ppy=cams.ppy * s)


def _finish_cameras(cams: CameraParams, cfg: PipelineConfig,
                    ws: float) -> CameraParams:
    """After the bundle adjustment: wave correction, then the work-scale
    intrinsics scaled back to full resolution."""
    if cfg.camera.wave_correct:
        cams = cams.replace(R=wave_correct(cams.R, cfg.camera.wave_kind))
    if ws < 1.0:
        cams = _upscale_cameras(cams, 1.0 / ws)
    return cams


def _pano_canvas_shape(hw: tuple[int, int], n_images: int,
                       cfg: PipelineConfig) -> tuple[int, int]:
    """Static pano canvas capacity."""
    H, W = hw
    w = int(round(W * (1.0 + (cfg.warp.canvas_scale_w - 1.0)
                       * max(n_images - 1, 1))))
    h = int(round(H * cfg.warp.canvas_scale_h))
    return h, w


def _warp_all_shared(images: torch.Tensor, cams: CameraParams, scale,
                     canvas_hw: tuple[int, int], cfg: PipelineConfig,
                     src_sizes: np.ndarray | None = None, warp=None):
    """Warp N images into one shared pano frame whose corner is the union
    of the per-image ROI corners, in one launch of the warp kernel
    (`warp`: a function of `warp_views`' arguments, by default
    `warp_views` itself).
    `src_sizes` (host (N, 2) [h, w]) gives true sizes of images
    edge-padded to a common shape. Returns (warped (N, Hc, Wc, C), masks,
    corner (2,) int32, overflow, roi_uvs (N, 4))."""
    n = images.shape[0]
    k_rinvs, corner, roi_uvs, overflow = warp_inputs(
        cams, scale, images.shape[1:3], n, canvas_hw, cfg, src_sizes)
    warped, masks = (warp or warp_views)(
        images.contiguous(), k_rinvs, scale, corner.expand(n, 2), roi_uvs,
        canvas_hw, cfg.warp.kind, src_sizes=src_sizes)
    return warped, masks, corner, overflow, roi_uvs


def warp_views(imgs, k_rinvs, scale, corners, roi_uvs, canvas_hw, kind,
               src_sizes=None):
    """The warp by projector kind, as the JAX package chooses it: the
    warp kernel's kinds (cylindrical, spherical, plane) in one
    `warp_batched` launch, the other projectors by the plain warp, image
    by image, on the images' device."""
    fn = warp_batched if kind in KIND_IDS else warp_batched_plain
    return fn(imgs, k_rinvs, scale, corners, roi_uvs, canvas_hw, kind,
              src_sizes=src_sizes)


def warp_inputs(cams: CameraParams, scale, hw: tuple[int, int], n: int,
                canvas_hw: tuple[int, int], cfg: PipelineConfig,
                src_sizes: np.ndarray | None = None):
    """The warp kernel's inputs for N cameras: (k_rinvs (N, 3, 3), shared
    corner (2,) int32, roi_uvs (N, 4), overflow)."""
    Hc, Wc = canvas_hw
    Ks = cams.K()
    hws = ([tuple(hw)] * n if src_sizes is None
           else [(int(s[0]), int(s[1])) for s in src_sizes])
    roi_uvs = torch.stack([
        torch.stack(roi_bounds(Ks[i], cams.R[i], scale, hws[i],
                               cfg.warp.kind)) for i in range(n)])
    u0, v0 = roi_uvs[:, 0].min(), roi_uvs[:, 1].min()
    u1, v1 = roi_uvs[:, 2].max(), roi_uvs[:, 3].max()
    corner = torch.stack([torch.floor(u0), torch.floor(v0)]).to(torch.int32)
    overflow = ((torch.ceil(u1) - torch.floor(u0) + 1 > Wc)
                | (torch.ceil(v1) - torch.floor(v0) + 1 > Hc))
    k_rinvs = torch.stack([_camera_mats(Ks[i], cams.R[i])[1]
                           for i in range(n)])
    return k_rinvs, corner, roi_uvs, overflow


def _apply_exposure(warped, masks, cfg: PipelineConfig):
    """Exposure compensation of shared-frame canvases by cfg.exposure.kind."""
    kind = cfg.exposure.kind
    if kind == "gain":
        _, warped = gain_compensate(warped, masks)
    elif kind == "gain_blocks":
        _, warped = gain_compensate_blocks(warped, masks,
                                           cfg.exposure.block_size)
    elif kind == "channels":
        _, warped = channels_compensate(warped, masks)
    elif kind == "channels_blocks":
        _, warped = channels_compensate_blocks(warped, masks,
                                               cfg.exposure.block_size)
    return warped


def _warp_expose(imgs, cams: CameraParams, hw: tuple[int, int],
                 cfg: PipelineConfig, reachable=None, src_sizes=None,
                 warp=None):
    """`_warp_all_shared` at the median focal (stage `warp`; the coverage
    ANDed with `reachable` (N,) bool where given), then `_apply_exposure`
    (stage `exposure`). Returns (warped, masks, corner, overflow,
    roi_uvs)."""
    scale = warp_scale(cams)
    canvas_hw = _pano_canvas_shape(hw, imgs.shape[0], cfg)
    with log.stage("warp"):
        warped, masks, corner, overflow, roi_uvs = _warp_all_shared(
            imgs, cams, scale, canvas_hw, cfg, src_sizes=src_sizes,
            warp=warp)
        if reachable is not None:
            masks = masks & reachable[:, None, None]
    with log.stage("exposure"):
        warped = _apply_exposure(warped, masks, cfg)
    return warped, masks, corner, overflow, roi_uvs


def _blend_resolved(images, seam_masks, masks, cfg: PipelineConfig,
                    dilate_seam: bool = True):
    """Blend shared-frame canvases with resolved seam masks: a k x k rect
    dilation ANDed with the coverage, then the blender."""
    sm = seam_masks
    if cfg.blend.kind == "none":
        out = (images * sm[..., None]).sum(dim=0)
        return out, sm.any(dim=0)
    k = cfg.seam.dilate_kernel
    if k > 1 and dilate_seam:
        sm = (dilate(sm.to(torch.float32), (k, k)) > 0.5) & masks
    if cfg.blend.kind == "multiband":
        return multiband_blend(images, sm, cfg.blend.num_bands)
    return feather_blend(images, sm, cfg.blend.feather_sharpness)


def _seam_and_blend(images, masks, cfg: PipelineConfig,
                    src_w: int | None = None, src_h: int | None = None,
                    edges=None):
    """Pairwise seam resolution + blend on (N, H, W, C) shared-frame
    canvases. `edges` orders the pairwise resolution (the Stitcher's
    spanning tree); None means the chain (i, i+1). The DP runs on a window
    bounded by the overlap a two-view pair can have (1.1x the source size
    for the contracting cylindrical/spherical warps, 1.3x otherwise,
    128-aligned). The ramp blend of a pair finds its own full-resolution
    vertical DP seam (colour or colour-gradient cost)."""
    n = images.shape[0]
    fac = 1.1 if cfg.warp.kind in ("cylindrical", "spherical") else 1.3
    max_w = (-(-int(round(fac * src_w)) // 128) * 128
             if src_w is not None else None)
    max_h = (-(-int(round(fac * src_h)) // 128) * 128
             if src_h is not None else None)
    if cfg.blend.kind == "ramp":
        if n != 2:
            raise ValueError("blend='ramp' supports exactly 2 images")
        if cfg.seam.kind not in ("dp_color", "dp_colorgrad", "none"):
            raise ValueError(
                f"blend='ramp' needs a DP seam (column-anchored weights); "
                f"got seam='{cfg.seam.kind}'")
        out, valid, _ = ramp_blend_pair(
            images[0], images[1], masks[0], masks[1],
            use_grad=cfg.seam.kind == "dp_colorgrad", max_overlap_w=max_w)
        return out, valid
    _refuse_host_seam(cfg)
    return _blend_resolved(images,
                           _seam_masks(images, masks, cfg, edges, max_w,
                                       max_h),
                           masks, cfg, dilate_seam=cfg.seam.kind != "none")


def _seam_masks(images, masks, cfg: PipelineConfig, edges=None,
                max_w: int | None = None, max_h: int | None = None):
    """(N, H, W) seam masks of shared-frame canvases: `_seam_pair` along
    `edges` (the chain (i, i+1) when None); the coverage for kind "none"."""
    n = images.shape[0]
    seam_masks = [masks[i] for i in range(n)]
    if cfg.seam.kind != "none":
        if edges is None:
            edges = [(i, i + 1) for i in range(n - 1)]
        for u, v in edges:
            seam_masks[u], seam_masks[v] = _seam_pair(
                images[u], images[v], seam_masks[u], seam_masks[v], cfg,
                max_w, max_h)
    return torch.stack(seam_masks)


def _seam_pair(img_a, img_b, mask_a, mask_b, cfg: PipelineConfig,
               max_w: int | None = None, max_h: int | None = None):
    """One pair's seam by cfg.seam.kind (voronoi or a DP cost). Returns
    the two split masks."""
    if cfg.seam.kind == "voronoi":
        return voronoi_seam_pair(mask_a, mask_b)
    a2, b2, _ = dp_seam_pair(
        img_a, img_b, mask_a, mask_b, cfg.seam.kind == "dp_colorgrad",
        max_overlap_w=max_w, max_overlap_h=max_h, orient=cfg.seam.orient,
        scale=cfg.seam.dp_scale)
    return a2, b2


def _needs_host_seam(cfg: PipelineConfig) -> bool:
    """The seam kinds that resolve on the host: the graph cut (native BK
    maxflow or the banded dual solver) and the full DpSeamFinder
    component machinery (`seam.dp_full`)."""
    return (cfg.seam.kind.startswith("graphcut")
            or (cfg.seam.kind.startswith("dp_")
                and cfg.seam.full_components))


def _refuse_host_seam(cfg: PipelineConfig) -> None:
    """Raise the JAX package's ValueError when a host seam is asked of an
    entry point that has no host split (`stitch_pairs_batched`, the
    `_impl` functions)."""
    if not _needs_host_seam(cfg):
        return
    raise ValueError(
        f"seam kind '{cfg.seam.kind}'"
        f"{' (full_components)' if cfg.seam.full_components else ''} "
        "resolves on the host and cannot run inside a jitted stitch "
        "program; use stitch_pair/stitch_chain/Stitcher (which split "
        "around the host seam) or an on-device seam kind "
        "(dp_color/dp_colorgrad/voronoi/none)")


def _seam_grid(hw: tuple[int, int], megapix: float):
    """The nearest-index grids of a `seam_megapix` solve on an (Hc, Wc)
    canvas: (yi, xi) decimate it to (hs, ws), (yb, xb) bring the masks
    back; None when the canvas is already small enough."""
    Hc, Wc = hw
    if not (megapix > 0 and Hc * Wc > megapix * 1e6):
        return None
    s = float(np.sqrt(megapix * 1e6 / (Hc * Wc)))
    hs = max(int(round(Hc * s)), 16)
    ws = max(int(round(Wc * s)), 16)
    yi = np.minimum((np.arange(hs) / s).astype(np.int64), Hc - 1)
    xi = np.minimum((np.arange(ws) / s).astype(np.int64), Wc - 1)
    yb = np.minimum((np.arange(Hc) * s).astype(np.int64), hs - 1)
    xb = np.minimum((np.arange(Wc) * s).astype(np.int64), ws - 1)
    return yi, xi, yb, xb


def _full_res(cfg: PipelineConfig) -> PipelineConfig:
    return cfg.replace(seam=dataclasses.replace(cfg.seam, seam_megapix=-1.0))


def _host_seam_masks(warped, masks, cfg: PipelineConfig, edges=None,
                     pair_marginals=None, crop_origin=(0, 0)) -> np.ndarray:
    """Resolve host seams on NumPy (N, H, W, C) canvases and (N, H, W)
    masks: the graph cut pair by pair along `edges` (the Stitcher's
    spanning tree; the chain i -> i+1 when None), or the full reference
    DpSeamFinder over all pairs. With cfg.seam.seam_megapix > 0 the seams
    resolve on a nearest-index decimation and come back by nearest
    upscale, bounded by the coverage, with covered pixels that no mask
    kept handed to the first image that covers them (a seam split
    partitions the coverage). `pair_marginals` and `crop_origin`: a
    graph-cut pair's full-canvas column and row marginals and the crop's
    origin when the canvases are its overlap crop; they are passed in
    (masks[0], masks[1]) order, whatever the edge. Returns (N, H, W)
    bool."""
    n = len(masks)
    grid = _seam_grid(masks[0].shape[:2], cfg.seam.seam_megapix)
    if grid is not None:
        yi, xi, yb, xb = grid
        m_all = np.asarray(masks)
        lo = _host_seam_masks(np.asarray(warped)[:, yi][:, :, xi],
                              m_all[:, yi][:, :, xi], _full_res(cfg),
                              edges=edges)
        res = lo[:, yb][:, :, xb] & m_all
        un = m_all.any(0) & ~res.any(0)
        for i in range(n):
            take = un & m_all[i]
            res[i] |= take
            un &= ~take
        return res
    if cfg.seam.kind.startswith("graphcut"):
        if edges is None:
            edges = [(i, i + 1) for i in range(n - 1)]
        m_list = [np.asarray(masks[i]) for i in range(n)]
        for u, v in edges:
            m_list[u], m_list[v] = graphcut_seam_pair(
                warped[u], warped[v], m_list[u], m_list[v],
                use_grad=cfg.seam.kind.endswith("colorgrad"),
                orient_marginals=pair_marginals if n == 2 else None,
                crop_origin=crop_origin)
        return np.stack(m_list)
    return np.stack(dp_seam_find_full(
        list(warped), [(0, 0)] * n, list(masks),
        use_grad=cfg.seam.kind == "dp_colorgrad"))


def _decimate_for_seam(warped: torch.Tensor, masks: torch.Tensor, yi, xi):
    """Nearest-index decimation of the canvases on their device, so that
    only the small seam inputs are read back."""
    yi = torch.as_tensor(yi, device=warped.device)
    xi = torch.as_tensor(xi, device=warped.device)
    return warped[:, yi][:, :, xi], masks[:, yi][:, :, xi]


def _blend_lowres_seams(warped, seam_lo, masks, yb, xb,
                        cfg: PipelineConfig):
    """Upscale decimated host seam masks (nearest) on the device, bound
    them by the coverage, hand the unowned covered pixels to the first
    image that covers them, then blend."""
    yb = torch.as_tensor(yb, device=masks.device)
    xb = torch.as_tensor(xb, device=masks.device)
    res = seam_lo[:, yb][:, :, xb] & masks
    un = masks.any(dim=0) & ~res.any(dim=0)
    owned = []
    for i in range(masks.shape[0]):
        take = un & masks[i]
        owned.append(res[i] | take)
        un = un & ~take
    return _blend_resolved(warped, torch.stack(owned), masks, cfg)


def _first_last(a: torch.Tensor):
    """Index of the first and one past the last True of a 1-D bool
    tensor (0 and len when none is set, as argmax gives)."""
    a8 = a.to(torch.uint8)
    n = a.shape[0]
    return torch.argmax(a8), n - torch.argmax(a8.flip(0))


def _overlap_bbox_device(m1: torch.Tensor, m2: torch.Tensor):
    """The pair overlap's bbox and the full-canvas orientation marginals,
    on the device. Returns (bbox (5,) int64 [y0, x0, y1, x1, nonempty],
    colm (4, W) and rowm (4, H) float32: per column and per row the pixel
    counts of (exclusive-1, exclusive-2, mask1, mask2))."""
    both = m1 & m2
    y0, y1 = _first_last(both.any(dim=1))
    x0, x1 = _first_last(both.any(dim=0))
    bbox = torch.stack([y0, x0, y1, x1, both.any().to(torch.int64)])
    sets = torch.stack([m1 & ~m2, m2 & ~m1, m1, m2]).to(torch.float32)
    return bbox, sets.sum(dim=1), sets.sum(dim=2)


def _crop_quantize_impl(warped, masks, y0: int, x0: int, hh: int, ww: int):
    """The seam inputs' crop, quantized to uint8 on the device (round half
    to even, clip): the reference's seam finders consume uint8-warped
    images, and the readback shrinks 4x."""
    w = warped[:, y0:y0 + hh, x0:x0 + ww]
    m = masks[:, y0:y0 + hh, x0:x0 + ww]
    return _quantize_u8(w), m


def _quantize_u8(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w), 0, 255).to(torch.uint8)


def _splice_seam_crop(masks, sm_crop, y0: int, x0: int):
    """Full-canvas seam masks from a crop's solve: outside the crop the
    split changes nothing (seams live in the pair's overlap)."""
    out = masks.clone()
    out[:, y0:y0 + sm_crop.shape[1], x0:x0 + sm_crop.shape[2]] = sm_crop
    return out


CROP_MARGIN = 64
CROP_ALIGN = 128


def _read_back(*tensors) -> list[np.ndarray]:
    """The tensors as host arrays, whole; their bytes add to the active
    timer's `readback_bytes`. The host seams' inputs, and `_to_uint8`'s
    float32 canvas and mask off the crop kernel's path (a CPU canvas, the
    "interior" crop, a stage dump)."""
    out = [t.cpu().numpy() for t in tensors]
    log.count("readback_bytes", sum(a.nbytes for a in out))
    return out


def _pair_seam_crop(masks: torch.Tensor):
    """A full-resolution graph-cut pair's seam crop: the overlap's bbox
    grown by a 64-px margin, its extent aligned to 128 (toward the origin
    when clipped), with the full-canvas marginals. Returns ((y0, x0, hh,
    ww) or None where the pair has no overlap or the crop is the whole
    canvas, (colm, rowm) host arrays)."""
    Hc, Wc = masks.shape[1:3]
    bb, colm, rowm = _overlap_bbox_device(masks[0], masks[1])
    bb = bb.cpu().numpy()
    marginals = (tuple(colm.cpu().numpy()), tuple(rowm.cpu().numpy()))
    if not bb[4]:
        return None, marginals
    y0 = max(int(bb[0]) - CROP_MARGIN, 0)
    x0 = max(int(bb[1]) - CROP_MARGIN, 0)
    y1 = min(int(bb[2]) + CROP_MARGIN, Hc)
    x1 = min(int(bb[3]) + CROP_MARGIN, Wc)
    y0 = max(y1 - -(-(y1 - y0) // CROP_ALIGN) * CROP_ALIGN, 0)
    x0 = max(x1 - -(-(x1 - x0) // CROP_ALIGN) * CROP_ALIGN, 0)
    if (y1 - y0) * (x1 - x0) >= Hc * Wc:
        return None, marginals
    return (y0, x0, y1 - y0, x1 - x0), marginals


def _host_seam_blend(warped: torch.Tensor, masks: torch.Tensor,
                     cfg: PipelineConfig, edges=None):
    """The host-seam split: resolve the host seams of device canvases and
    blend on the device. Returns (pano, valid, seam masks).

    - `seam_megapix` > 0: the canvases are decimated on the device, read
      back, solved at that scale, and the low-resolution masks go back up
      (`_blend_lowres_seams`); the seam masks returned are those.
    - A full-resolution graph-cut pair reads back only its overlap's
      crop (`_pair_seam_crop`) as uint8, with the full-canvas marginals,
      and splices the solved crop into the masks.
    - Otherwise the whole canvases come back: uint8-quantized for the
      graph cut, float32 for the full DP.
    Stages of the active timer: `seam_readback` (the seam inputs to the
    host; their canvases' and masks' bytes add to `readback_bytes`),
    `seam` (the host solve), `blend`."""
    grid = _seam_grid(masks.shape[1:3], cfg.seam.seam_megapix)
    if grid is not None:
        yi, xi, yb, xb = grid
        with log.stage("seam_readback"):
            w_lo, m_lo = _read_back(*_decimate_for_seam(warped, masks, yi,
                                                        xi))
        with log.stage("seam"):
            seam_lo = _host_seam_masks(w_lo, m_lo, _full_res(cfg),
                                       edges=edges)
        with log.stage("blend"):
            pano, valid = _blend_lowres_seams(
                warped, torch.as_tensor(seam_lo, device=masks.device),
                masks, yb, xb, cfg)
        return pano, valid, seam_lo
    graphcut = cfg.seam.kind.startswith("graphcut")
    if masks.shape[0] == 2 and graphcut:
        with log.stage("seam_readback"):
            crop, marginals = _pair_seam_crop(masks)
            if crop is not None:
                w_u8, m_crop = _read_back(*_crop_quantize_impl(
                    warped, masks, *crop))
        if crop is not None:
            with log.stage("seam"):
                sm_crop = _host_seam_masks(
                    w_u8.astype(np.float32), m_crop, cfg, edges=edges,
                    pair_marginals=marginals, crop_origin=crop[:2])
            with log.stage("blend"):
                seam_masks = _splice_seam_crop(
                    masks, torch.as_tensor(sm_crop, device=masks.device),
                    *crop[:2])
                pano, valid = _blend_resolved(warped, seam_masks, masks,
                                              cfg)
            return pano, valid, seam_masks
    with log.stage("seam_readback"):
        w_host, m_host = _read_back(
            _quantize_u8(warped) if graphcut else warped, masks)
        if graphcut:
            w_host = w_host.astype(np.float32)
    with log.stage("seam"):
        seam_masks = _host_seam_masks(w_host, m_host, cfg, edges=edges)
    with log.stage("blend"):
        pano, valid = _blend_resolved(
            warped, torch.as_tensor(seam_masks, device=masks.device),
            masks, cfg)
    return pano, valid, seam_masks


def register_pair(img1: torch.Tensor, img2: torch.Tensor,
                  cfg: PipelineConfig = PipelineConfig(), draws=None,
                  generator: torch.Generator | None = None):
    """Stages 1-5 on two (H, W, 3) float32 images: features (on grays at
    the work scale of the larger extent), matches + homography, cameras,
    bundle adjustment, wave correction, full-resolution intrinsics (in
    SCANS mode, with `cfg` normalized by `_normalize_scans`: the affine
    motion and the pair's affine cameras). Stages of the active timer:
    `detect`, `match`, and `pair_cameras`' own. Returns (f1, f2, mi,
    cams)."""
    hw1, hw2 = tuple(img1.shape[:2]), tuple(img2.shape[:2])
    ws = _megapix_scale(cfg.work_megapix,
                        (max(hw1[0], hw2[0]), max(hw1[1], hw2[1])))
    with log.stage("detect"):
        f1 = detect_features(_work_grays(rgb_to_gray(img1), hw1, ws),
                             cfg.detector)
        f2 = detect_features(_work_grays(rgb_to_gray(img2), hw2, ws),
                             cfg.detector)
    with log.stage("match"):
        mi = match_pair(f1, f2, 0, 1, cfg.matcher, cfg.ransac, draws=draws,
                        generator=generator)
    cams = pair_cameras(f1, f2, mi, (hw1, hw2), cfg, ws)
    return f1, f2, mi, cams


def pair_cameras(f1, f2, mi, hws, cfg: PipelineConfig,
                 ws: float = 1.0) -> CameraParams:
    """Stages 4-5 of a pair: the two cameras from its homography at the
    work scale `ws`, the bundle adjustment over its inliers, the wave
    correction and the intrinsics scaled to full resolution. `hws`: the
    two images' full-resolution (h, w).

    In SCANS mode the canvas is image 0's frame: G_0 = I and G_1 = H⁻¹
    (H maps image-0 pixels to image-1 pixels), scaled from the work scale;
    a pair's least-squares affine is already the joint affine optimum, so
    there is no bundle adjustment. Stages of the active timer: `cameras`
    and `bundle_adjust` (with its `lm_step`s)."""
    dev = mi.H.device
    if cfg.mode == "scans":
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        Gs = torch.stack([eye, torch.where(mi.h_valid,
                                           torch.linalg.inv(mi.H), eye)])
        if ws < 1.0:
            Gs = _upscale_affine(Gs, 1.0 / ws)
        return affine_cameras(Gs)
    sizes = torch.tensor([[_scaled_dim(h, ws), _scaled_dim(w, ws)]
                          for h, w in hws], dtype=torch.int32, device=dev)
    with log.stage("cameras"):
        cams = estimate_cameras(mi.H[None], mi.h_valid[None], sizes)
    if cfg.camera.ba_refine:
        with log.stage("bundle_adjust"):
            pairs = mi.pairs.long()
            cams = bundle_adjust(
                cams, f1.xy[pairs[:, 0]][None], f2.xy[pairs[:, 1]][None],
                (mi.inliers & mi.valid)[None],
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.ones(1, dtype=torch.int64, device=dev),
                (mi.confidence > cfg.camera.ba_conf_thresh)[None],
                cfg.camera.ba_iters, cfg.camera.ba_kind)
    return _finish_cameras(cams, cfg, ws)


def pair_metrics(f1, f2, mi, cams: CameraParams, overflow, roi_uvs) -> dict:
    """The metrics of one stitched pair, as tensors."""
    return {
        "kpts1": f1.num_valid(), "kpts2": f2.num_valid(),
        "num_matches": mi.num_matches(), "num_inliers": mi.num_inliers,
        "confidence": mi.confidence, "focal": cams.focal[0],
        "h_valid": mi.h_valid, "canvas_overflow": overflow,
        "roi_uv": roi_uvs,
    }


def warp_scale(cams: CameraParams) -> torch.Tensor:
    """The warp's surface scale: the median focal (the midpoint of the two
    middle values for an even count)."""
    return _masked_median(cams.focal,
                          torch.ones_like(cams.focal, dtype=torch.bool))


def stitch_pair_front_impl(img1: torch.Tensor, img2: torch.Tensor,
                           cfg: PipelineConfig = PipelineConfig(),
                           draws=None,
                           generator: torch.Generator | None = None):
    """Stages 1-7 (detect -> gain-compensated shared-frame warps) on two
    (H, W, 3) images on one device, possibly of different sizes. `draws`:
    optional (u_first, u_refit) RANSAC draws (`match_pair`). SCANS mode
    is normalized here (`_normalize_scans`). Stages of the active timer:
    `register_pair`'s, `warp`, `exposure`. Returns (warped (2, Hc, Wc,
    3), masks (2, Hc, Wc), corner, metrics)."""
    cfg = _normalize_scans(cfg)
    H1, W1 = img1.shape[:2]
    H2, W2 = img2.shape[:2]
    H, W = max(H1, H2), max(W1, W2)
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    f1, f2, mi, cams = register_pair(img1, img2, cfg, draws, generator)
    if (H1, W1) == (H2, W2):
        imgs = torch.stack([img1, img2])
        src_sizes = None
    else:
        def pad(im, h, w):
            x = im.permute(2, 0, 1)[None]
            return F.pad(x, (0, W - w, 0, H - h),
                         mode="replicate")[0].permute(1, 2, 0)
        imgs = torch.stack([pad(img1, H1, W1), pad(img2, H2, W2)])
        src_sizes = np.asarray([[H1, W1], [H2, W2]], np.int32)
    warped, masks, corner, overflow, roi_uvs = _warp_expose(
        imgs, cams, (H, W), cfg, src_sizes=src_sizes)
    return warped, masks, corner, pair_metrics(f1, f2, mi, cams, overflow,
                                               roi_uvs)


def stitch_pair_impl(img1: torch.Tensor, img2: torch.Tensor,
                     cfg: PipelineConfig = PipelineConfig(), draws=None,
                     generator: torch.Generator | None = None):
    """Two (H, W, 3) images on one device -> (pano canvas, valid, corner,
    metrics). The seam and blend take `cfg` as given (the front
    normalizes SCANS mode for itself, as in the JAX package); a host seam
    raises ValueError here (`stitch_pair` splits around it). Stages of
    the active timer: the front's, `seam_blend`."""
    return _front_seam_blend(stitch_pair_front_impl, (img1, img2), cfg,
                             draws, generator)


def _front_seam_blend(front, views, cfg: PipelineConfig, draws, generator):
    """`front(*views, ...)`, then `_seam_and_blend` in the stage
    `seam_blend`, its window sized by the largest of `views` (a pair's two
    images or a chain's stack). Returns (pano, valid, corner, metrics)."""
    H = max(v.shape[-3] for v in views)
    W = max(v.shape[-2] for v in views)
    warped, masks, corner, metrics = front(*views, cfg, draws, generator)
    with log.stage("seam_blend"):
        pano, valid = _seam_and_blend(warped, masks, cfg, src_w=W, src_h=H)
    return pano, valid, corner, metrics


def _crop_valid(pano: np.ndarray, valid: np.ndarray, mode: str = "bbox"):
    """Crop to the bounding box of the valid pixels, or with mode
    "interior" to their largest all-valid rectangle."""
    if mode == "interior":
        cropped, (y0, x0, h, w) = autocrop(pano, valid)
        if h == 0:
            return pano[:1, :1], valid[:1, :1]
        return cropped, valid[y0:y0 + h, x0:x0 + w]
    ys, xs = np.nonzero(valid)
    if len(ys) == 0:
        return pano[:1, :1], valid[:1, :1]
    return (pano[ys.min():ys.max() + 1, xs.min():xs.max() + 1],
            valid[ys.min():ys.max() + 1, xs.min():xs.max() + 1])


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _crop_takes_kernel(device: torch.device) -> bool:
    """Whether `_to_uint8`'s bbox crop of a canvas on `device` runs as the
    crop kernel (`ops/cuda_crop`): on a CUDA device."""
    return device.type == "cuda"


def _to_uint8(pano: torch.Tensor, valid: torch.Tensor, crop: str = "bbox",
              dump=None) -> np.ndarray:
    """The one place a device canvas becomes a host panorama, in the stage
    `readback_crop`. A CUDA canvas with the bbox crop and no `dump` goes
    through the crop kernel (`cuda_crop.crop_u8`): only the bbox (16 B)
    and the cropped uint8 panorama are read back, counted in
    `readback_bytes`, and the counter `crop_fused` adds 1. Otherwise the
    float32 canvas and its mask are read back (`_read_back`), cropped
    (`_crop_valid`, "bbox" or "interior") and clipped to uint8 on the
    host; `dump` (a `_StageDumper`) gets the cropped float32 canvas and
    mask as pano.npz. Both give the same bytes."""
    with log.stage("readback_crop"):
        if _crop_takes_kernel(pano.device) and crop == "bbox" and \
                dump is None:
            out = cuda_crop.crop_u8(pano, valid)
            log.count("readback_bytes", cuda_crop.BBOX_BYTES + out.nbytes)
            log.count("crop_fused")
            return out
        p, v = _crop_valid(*_read_back(pano, valid), crop)
        out = np.clip(p, 0, 255).astype(np.uint8)
    if dump is not None:
        dump("pano", pano=p, valid=v)
    return out


def _stitch_entry(front, total: str, arrays, config: PipelineConfig | None,
                  seed: int, device, draws):
    """`stitch_pair`'s and `stitch_chain`'s shell: `arrays` uploaded, one
    tensor each, through `_front_seam_blend` in the stage `total`, or for
    a host seam `front` (stage "front") and `_host_seam_blend`, then
    `_to_uint8`, under an active `StageTimer`. The metrics: the front's
    (0-d ones as Python scalars), the stages' wall ms, the counters."""
    cfg = config or PipelineConfig()
    dev = resolve_device(device)
    set_full_precision()
    timer = StageTimer(dev)
    gen = _generator(dev, seed)
    views = [torch.as_tensor(np.asarray(a), device=dev) for a in arrays]
    with timer.active():
        if _needs_host_seam(cfg):
            with log.stage("front"):
                warped, masks, _, metrics = front(*views, cfg, draws, gen)
            with log.stage("host_seam_blend"):
                pano, valid, _ = _host_seam_blend(warped, masks, cfg)
                out = _to_uint8(pano, valid, cfg.crop)
        else:
            with log.stage(total):
                pano, valid, _, metrics = _front_seam_blend(
                    front, views, cfg, draws, gen)
                out = _to_uint8(pano, valid, cfg.crop)
    m = {k: v.detach().cpu().numpy().tolist() for k, v in metrics.items()}
    m.update(timer.summary())
    m.update(timer.counts())
    return out, m


def stitch_pair(img1, img2, config: PipelineConfig | None = None,
                seed: int = 0, device=None, draws=None):
    """Two (H, W, 3) uint8 RGB arrays -> (pano uint8, metrics).

    Runs on `device` (default: the CUDA card; with no card it raises).
    RANSAC draws come from a torch.Generator seeded with `seed` on that
    device, unless `draws` injects them (see stitch_pair_front_impl). A
    host seam splits the stitch into the front and `_host_seam_blend`
    (metrics "front" and "host_seam_blend"; otherwise
    "stitch_pair_total"). The metrics also hold the wall ms of the stages
    inside (detect, match, cameras, bundle_adjust, lm_step, warp,
    exposure; seam_blend with the DP seam's seam_dp inside, or
    seam_readback, seam and blend; readback_crop) and the counters
    `lm_iters` and `readback_bytes`, and on the card `lm_fused`,
    `dp_fused` and `crop_fused` (the adjustments, DP seams and bbox
    readbacks run as one kernel launch each)."""
    return _stitch_entry(stitch_pair_front_impl, "stitch_pair_total",
                         (img1, img2), config, seed, device, draws)


def _pair_points(feats, mis, pairs):
    """The matched keypoints (P, M, 2) of stacked pairs `mis` in their
    source and destination views, whose (i, j) indices are `pairs`."""
    src = torch.stack([feats.xy[i][mis.pairs[p, :, 0].long()]
                       for p, (i, _) in enumerate(pairs)])
    dst = torch.stack([feats.xy[j][mis.pairs[p, :, 1].long()]
                       for p, (_, j) in enumerate(pairs)])
    return src, dst


def _adjust(cams: CameraParams, feats, mis, pairs, pair_valid,
            cfg: PipelineConfig) -> CameraParams:
    """Ray bundle adjustment over the inlier correspondences of stacked
    pairs `mis`, whose (i, j) image indices are `pairs`."""
    src, dst = _pair_points(feats, mis, pairs)
    return bundle_adjust(cams, src, dst, mis.inliers & mis.valid,
                         mis.src_idx.long(), mis.dst_idx.long(), pair_valid,
                         cfg.camera.ba_iters, cfg.camera.ba_kind)


class OneDevice:
    """The per-view and per-pair steps of the chain front on the images'
    own device: `detect_batched` on all views, `match_pairs` on all
    pairs and `warp_views` of all views in one launch. `parallel.pano`
    splits the same three steps over a mesh."""

    detect = staticmethod(detect_batched)
    match = staticmethod(match_pairs)
    warp = staticmethod(warp_views)


def register_chain(imgs: torch.Tensor,
                   cfg: PipelineConfig = PipelineConfig(), draws=None,
                   generator: torch.Generator | None = None,
                   steps=OneDevice):
    """Stages 1-5 of the fixed-N chain on (N, H, W, 3) float32 images on
    one device: one batched detect (at the work scale), the consecutive
    pairs i -> i+1 (and, with cfg.chain_splice and N >= 3, the skip pairs
    i -> i+2), chained cameras, bundle adjustment over those pairs, wave
    correction and full-resolution intrinsics.

    A pair is good when its H is valid and its confidence exceeds
    cfg.matcher.conf_thresh. Without the splice an image is reachable
    when every link before it is good; with it, one broken link is bridged
    by the skip pair around it. `draws`: optional mapping (i, j) ->
    (u_first, u_refit) RANSAC draws per pair; without it every pair draws
    from `generator`. In SCANS mode (`cfg` normalized) the cameras are
    global affines chained along the pairs (`_chain_affines`, with the
    skip pairs bridging one broken link), with no bundle adjustment.
    `steps` detects and matches (`OneDevice`, or a split over a mesh).
    Stages of the active timer: `detect`, `match` (the consecutive and
    the skip pairs), `cameras`, `bundle_adjust` (with its `lm_step`s).
    Returns (feats, mis (the consecutive pairs), cams, reachable (N,)
    bool)."""
    N, H, W = imgs.shape[:3]
    dev = imgs.device
    ws = _megapix_scale(cfg.work_megapix, (H, W))
    with log.stage("detect"):
        feats = steps.detect(_work_grays(rgb_to_gray(imgs), (H, W), ws),
                             cfg.detector)

    def match(pairs):
        with log.stage("match"):
            return steps.match(feats, pairs, cfg.matcher, cfg.ransac, draws,
                               generator)

    def good_of(mis):
        return mis.h_valid & (mis.confidence > cfg.matcher.conf_thresh)

    pairs = [(i, i + 1) for i in range(N - 1)]
    mis_list = match(pairs)
    mis = stack(mis_list)
    good = good_of(mis)
    sizes = torch.tensor([[_scaled_dim(H, ws), _scaled_dim(W, ws)]] * N,
                         dtype=torch.int32, device=dev)
    mis2 = good2 = None
    if cfg.chain_splice and N >= 3:
        pairs2 = [(j, j + 2) for j in range(N - 2)]
        mis2_list = match(pairs2)
        mis2 = stack(mis2_list)
        good2 = good_of(mis2)
    if cfg.mode == "scans":
        Gs, reachable = _chain_affines(
            mis, good, mis2, good2,
            torch.eye(3, dtype=torch.float32, device=dev))
        if ws < 1.0:
            Gs = _upscale_affine(Gs, 1.0 / ws)
        return feats, mis, affine_cameras(Gs), reachable
    with log.stage("cameras"):
        if mis2 is not None:
            cams, reachable = estimate_cameras_spliced(
                mis.H, mis.h_valid, good, mis2.H, mis2.h_valid, good2,
                sizes)
            # the skip pairs constrain the bundle adjustment too
            pairs_ba = pairs + pairs2
            mis_ba = stack(mis_list + mis2_list)
        else:
            reachable = torch.cat([
                torch.ones(1, dtype=torch.bool, device=dev),
                torch.cumprod(good.to(torch.int32), 0).to(torch.bool)])
            cams = estimate_cameras(mis.H, mis.h_valid, sizes)
            pairs_ba, mis_ba = pairs, mis
    if cfg.camera.ba_refine:
        with log.stage("bundle_adjust"):
            cams = _adjust(cams, feats, mis_ba, pairs_ba,
                           (mis_ba.confidence > cfg.camera.ba_conf_thresh)
                           & mis_ba.h_valid, cfg)
    return feats, mis, _finish_cameras(cams, cfg, ws), reachable


def stitch_chain_front_impl(imgs: torch.Tensor,
                            cfg: PipelineConfig = PipelineConfig(),
                            draws=None,
                            generator: torch.Generator | None = None,
                            steps=OneDevice):
    """Stages 1-7 of the fixed-N chain on (N, H, W, 3) images on one
    device: `register_chain`, then one warp launch for all N views (the
    unreachable ones masked out) and gain compensation; SCANS mode is
    normalized here. `steps`: detect, match and warp (`OneDevice`, or a
    split over a mesh). Stages of the active timer: `register_chain`'s,
    `warp`, `exposure`. Returns (warped (N, Hc, Wc, 3), masks (N, Hc,
    Wc), corner, metrics)."""
    cfg = _normalize_scans(cfg)
    H, W = imgs.shape[1:3]
    imgs = imgs.to(torch.float32)
    _, mis, cams, reachable = register_chain(imgs, cfg, draws, generator,
                                             steps)
    warped, masks, corner, overflow, roi_uvs = _warp_expose(
        imgs, cams, (H, W), cfg, reachable, warp=steps.warp)
    metrics = {
        "num_inliers": mis.num_inliers, "confidence": mis.confidence,
        "h_valid": mis.h_valid, "focal": cams.focal[0],
        "canvas_overflow": overflow, "roi_uv": roi_uvs,
        "reachable": reachable,
    }
    return warped, masks, corner, metrics


def stitch_chain_impl(imgs: torch.Tensor,
                      cfg: PipelineConfig = PipelineConfig(), draws=None,
                      generator: torch.Generator | None = None):
    """(N, H, W, 3) chain on one device -> (pano canvas, valid, corner,
    metrics): the front, then the seams along the chain and the blend
    (`cfg` as given; a host seam raises ValueError here), the active
    timer's stage `seam_blend`."""
    return _front_seam_blend(stitch_chain_front_impl, (imgs,), cfg, draws,
                             generator)


# the JAX package's jitted programs by their names: the port runs eagerly,
# so each is the function itself
stitch_pair_core = stitch_pair_impl
stitch_chain_core = stitch_chain_impl
stitch_chain_front = stitch_chain_front_impl
stitch_pair_front = stitch_pair_front_impl
blend_resolved = _blend_resolved


def stitch_chain(images, config: PipelineConfig | None = None,
                 seed: int = 0, device=None, draws=None):
    """N same-size (H, W, 3) uint8 RGB views with consecutive overlap ->
    (pano uint8, metrics), through `stitch_chain_impl`, or for a host seam
    through the front and `_host_seam_blend` (metrics "front" and
    "host_seam_blend").

    Runs on `device` (default: the CUDA card; with no card it raises).
    RANSAC draws come from a torch.Generator seeded with `seed` on that
    device, unless `draws` injects them per pair (i, j). The metrics also
    hold the stages inside and the counters, as `stitch_pair`'s do."""
    return _stitch_entry(stitch_chain_front_impl, "stitch_chain_total",
                         (np.stack([np.asarray(im) for im in images]),),
                         config, seed, device, draws)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class _StageDumper:
    """Optional per-stage .npz dumps, under the JAX package's names, for
    parity debugging."""

    def __init__(self, directory: str | None):
        self.dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def __call__(self, name: str, **arrays):
        if self.dir:
            np.savez_compressed(os.path.join(self.dir, f"{name}.npz"),
                                **{k: _np(v) for k, v in arrays.items()})


def register_views(imgs: torch.Tensor, cfg: PipelineConfig, draws=None,
                   generator: torch.Generator | None = None,
                   src_sizes: np.ndarray | None = None, dump=None):
    """Stages 1-5 of the N-view stitchers (`Stitcher`,
    `StreamStitcher`) on (N, H, W, 3) float32 images on one device, each
    step a stage of the active timer: one batched detect on grays at the work
    scale (with `src_sizes`, the host (N, 2) true sizes of edge-padded
    views, keypoints whose patch would reach past a view's true border
    are dropped, the border growing by scale_factor per pyramid level);
    `match_all`; rotations chained along the maximum spanning tree of the
    confident pairs (host); the bundle adjustment over the matched pairs;
    then the wave correction and the intrinsics scaled to full
    resolution. `draws`: optional mapping (i, j) -> (u_first, u_refit)
    RANSAC draws per pair. In SCANS mode (`cfg` normalized) the cameras
    are `_scans_cameras` (affines along the tree, the affine adjustment),
    with no ray adjustment or wave correction. Counters of the active
    timer: `pairs_matched` (the pairs `match_all` ran), `pairs_kept`
    (those with a homography over cfg.matcher.conf_thresh, which enter
    the tree and the adjustment). `dump` (a `_StageDumper`) writes
    features.npz, matches.npz and cameras.npz. Returns (cams, tree_edges,
    reachable (N,) bool, pair confidences, start_defect), the middle two
    host arrays; start_defect is the largest ‖RᵀR − I‖_F of the start
    rotations handed to the ray adjustment (the chained homographies shear
    them; `geometry.bundle._anchor` keeps the shear out of the result),
    None where no ray adjustment runs."""
    cfg_d = cfg.detector
    dev = imgs.device
    n, H, W = imgs.shape[:3]
    dump = dump or _StageDumper(None)
    ws = _megapix_scale(cfg.work_megapix, (H, W))
    if src_sizes is not None:
        work_sizes = np.maximum(np.round(np.asarray(src_sizes) * ws),
                                1).astype(np.int32)
    else:
        work_sizes = np.asarray(
            [[_scaled_dim(H, ws), _scaled_dim(W, ws)]] * n, np.int32)
    with log.stage("detect"):
        feats = detect_batched(_work_grays(rgb_to_gray(imgs), (H, W), ws),
                               cfg_d)
        if src_sizes is not None:
            b = cfg_d.edge_threshold * torch.pow(
                torch.tensor(cfg_d.scale_factor, dtype=torch.float32,
                             device=dev), feats.level.to(torch.float32))
            sw = torch.as_tensor(work_sizes, dtype=torch.float32,
                                 device=dev)
            x, y = feats.xy[..., 0], feats.xy[..., 1]
            inb = ((x >= b) & (x <= sw[:, None, 1] - 1.0 - b)
                   & (y >= b) & (y <= sw[:, None, 0] - 1.0 - b))
            feats = feats.replace(valid=feats.valid & inb)
    dump("features", xy=feats.xy, valid=feats.valid,
         response=feats.response, level=feats.level)

    with log.stage("match"):
        pairs = pair_list(n, cfg.matcher.range_width)
        ms = match_all(feats, cfg.matcher, cfg.ransac, draws, generator)
    log.count("pairs_matched", len(pairs))
    dump("matches", H=ms.H, num_inliers=ms.num_inliers,
         confidence=ms.confidence, h_valid=ms.h_valid,
         src_idx=ms.src_idx, dst_idx=ms.dst_idx)

    with log.stage("cameras"):
        conf = _np(ms.confidence)
        keep = conf > cfg.matcher.conf_thresh
        good = _np(ms.h_valid) & keep
        log.count("pairs_kept", int(good.sum()))
        start_defect = None
        if cfg.mode == "scans":
            cams, tree_edges, reachable = _scans_cameras(
                ms, feats, pairs, keep, n, cfg, ws, dev)
        else:
            cams, tree_edges, reachable = estimate_cameras_host(
                _np(ms.H), _np(ms.src_idx), _np(ms.dst_idx),
                _np(ms.num_inliers), good, work_sizes,
                return_tree=True, device=dev)
            if cfg.camera.ba_refine:
                start_defect = rotation_defect(cams.R)

    if cfg.mode != "scans":
        if cfg.camera.ba_refine:
            with log.stage("bundle_adjust"):
                cams = _adjust(cams, feats, ms, pairs,
                               torch.as_tensor(keep, device=dev)
                               & ms.h_valid, cfg)
        cams = _finish_cameras(cams, cfg, ws)
    dump("cameras", focal=cams.focal, R=cams.R, ppx=cams.ppx, ppy=cams.ppy)
    return cams, tree_edges, np.asarray(reachable), conf, start_defect


class Stitcher:
    """N-image panorama stitcher with per-stage timers: registration at
    the work scale (`register_views`: all-pairs matching or within
    cfg.matcher.range_width, confidence filtering, rotations chained along
    the maximum spanning tree of the confident pairs on the host, bundle
    adjustment, wave correction), the views resized to the compose scale
    (`compose_megapix`), one warp into a shared canvas, exposure
    compensation, seams along the tree's edges (a host seam through
    `_host_seam_blend`), the blend and the crop. Images outside the
    tree's largest component are not composed. SCANS mode is normalized
    once, here.

    Runs on `device` (default: the CUDA card; with no card it raises)."""

    def __init__(self, config: PipelineConfig | None = None, device=None):
        self.cfg = _normalize_scans(config or PipelineConfig())
        self.device = resolve_device(device)

    def stitch(self, images, seed: int = 0, dump_stages: str | None = None,
               draws=None):
        """images: (H, W, 3) uint8 RGB views, whose sizes may differ: the
        smaller ones are edge-replicate-padded to the common extent, their
        keypoints past their true border (scaled per pyramid level) are
        dropped, and the warp reads each within its true size.
        `draws`: optional mapping (i, j) -> (u_first, u_refit) RANSAC draws
        per matched pair. `dump_stages`: a directory to write
        features.npz, matches.npz, cameras.npz, warped.npz, pano.npz and,
        for a host seam, seams.npz. Returns (pano uint8, metrics); the
        metrics hold the stages' wall ms, the counters `lm_iters`,
        `readback_bytes`, `pairs_matched` and `pairs_kept`, and
        `start_defect` (`register_views`)."""
        cfg = self.cfg
        dev = self.device
        n = len(images)
        if n == 1:
            return np.asarray(images[0]), {"n_images": 1}
        if n == 2:
            return stitch_pair(images[0], images[1], cfg, seed, dev,
                               None if draws is None else draws[(0, 1)])
        set_full_precision()
        timer = StageTimer(dev)
        with timer.active():
            dump = _StageDumper(dump_stages)
            gen = _generator(dev, seed)

            shapes = [tuple(np.asarray(im).shape[:2]) for im in images]
            H = max(h for h, _ in shapes)
            W = max(w for _, w in shapes)
            full_sizes = (np.asarray(shapes, np.int32)
                          if len(set(shapes)) > 1 else None)
            images = [np.pad(np.asarray(im),
                             ((0, H - h), (0, W - w), (0, 0)), mode="edge")
                      for im, (h, w) in zip(images, shapes)]
            imgs = torch.as_tensor(np.stack(images), device=dev).to(
                torch.float32)

            cams, tree_edges, reachable, conf, start_defect = \
                register_views(imgs, cfg, draws, gen, full_sizes, dump)

            # composite at compose_megapix: the views resized per channel,
            # the cameras scaled to match; the pano comes out at that scale
            cs = _megapix_scale(cfg.compose_megapix, (H, W))
            if cs < 1.0:
                H, W = _scaled_dim(H, cs), _scaled_dim(W, cs)
                imgs = resize_linear_mxu(imgs.permute(0, 3, 1, 2),
                                         (H, W)).permute(0, 2, 3, 1)
                if cfg.mode == "scans":
                    cams = cams.replace(R=_upscale_affine(cams.R, cs))
                else:
                    cams = _upscale_cameras(cams, cs)
                if full_sizes is not None:
                    full_sizes = np.maximum(np.round(full_sizes * cs),
                                            1).astype(np.int32)

            warped, masks, corner, overflow, _ = _warp_expose(
                imgs, cams, (H, W), cfg,
                torch.as_tensor(reachable, device=dev), full_sizes)
            dump("warped", warped=warped, masks=masks, corner=corner)

            with timer.stage("seam_blend"):
                if _needs_host_seam(cfg):
                    pano, valid, seam_masks = _host_seam_blend(
                        warped, masks, cfg, edges=tree_edges)
                    dump("seams", seam_masks=seam_masks)
                else:
                    pano, valid = _seam_and_blend(
                        warped, masks, cfg, src_w=W, src_h=H,
                        edges=tree_edges)
                out = _to_uint8(pano, valid, cfg.crop,
                                dump if dump_stages else None)
        metrics = {
            "n_images": n,
            "focal": float(cams.focal[0]),
            "pair_confidences": conf.tolist(),
            "canvas_overflow": bool(overflow),
            "reachable": reachable.tolist(),
        }
        metrics.update(timer.summary())
        metrics.update(timer.counts())
        if start_defect is not None:
            metrics["start_defect"] = start_defect
        return out, metrics


def stitch(images, config: PipelineConfig | None = None, seed: int = 0,
           device=None, draws=None):
    """N-image entry point: `stitch(images) -> (pano uint8, metrics)`, a
    `Stitcher` run once."""
    return Stitcher(config, device).stitch(images, seed, draws=draws)
