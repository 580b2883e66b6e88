"""Video stitcher for a fixed rig: calibrate once, compose every frame
(`imagestitch_tpu.stream.StreamStitcher`).

- `calibrate(images)` runs the N-view registration of the `Stitcher`
  (`pipeline.register_views`: one batched detect at the work scale, all
  pairs matched, rotations along the spanning tree, bundle adjustment,
  wave correction; in SCANS mode the affine cameras along the tree and
  the affine adjustment) on one frame set, warps it (one warp launch for
  the warp kernel's projectors), drops the views outside the tree's
  largest component from the masks, applies exposure compensation,
  resolves DP or Voronoi seams along i -> i+1 (not along the tree, as the
  JAX package's stream does), or the host seams on the whole float32
  canvases read back (`pipeline._host_seam_masks`, chain order, no
  edges), and freezes the seam masks, the cameras and the warp's inputs.
- `compose(images)` warps a new frame set with the frozen registration
  (one warp launch, no detection), applies exposure compensation and
  blends with the frozen seam masks, then crops on the host.

Runs on `device` (default: the CUDA card; with no card it raises).
"""

from __future__ import annotations

import numpy as np
import torch

from imagestitch_tpu_torch.config import PipelineConfig
from imagestitch_tpu_torch.pipeline import (
    _apply_exposure, _blend_resolved, _generator, _host_seam_masks,
    _needs_host_seam, _normalize_scans, _pano_canvas_shape, _read_back,
    _seam_masks, _to_uint8, register_views, resolve_device,
    set_full_precision, warp_inputs, warp_scale, warp_views)
from imagestitch_tpu_torch.utils.log import StageTimer


class StreamStitcher:
    """Fixed-rig video stitcher: `calibrate` once, `compose` per frame set.
    `stages_ms` holds the wall ms per stage of the last call."""

    def __init__(self, config: PipelineConfig | None = None, device=None):
        self.cfg = _normalize_scans(config or PipelineConfig())
        self.device = resolve_device(device)
        self._frozen = None
        self.stages_ms: dict[str, float] = {}

    def _upload(self, images) -> torch.Tensor:
        return torch.as_tensor(np.stack([np.asarray(im) for im in images]),
                               device=self.device).to(torch.float32)

    def _warp(self, imgs: torch.Tensor):
        f = self._frozen
        return warp_views(imgs.contiguous(), f["k_rinvs"], f["scale"],
                          f["corners"], f["roi_uvs"], f["canvas_hw"],
                          self.cfg.warp.kind)

    def calibrate(self, images, seed: int = 0, draws=None):
        """Register one frame set of N same-size (H, W, 3) uint8 views and
        freeze the registration. `draws`: optional mapping (i, j) ->
        (u_first, u_refit) RANSAC draws per matched pair. Returns the
        calibration pano (uint8) and metrics, which hold the counters
        (`lm_iters`, `readback_bytes`, `pairs_matched`, `pairs_kept`) and
        `start_defect` (`register_views`) beside `stages_ms`."""
        cfg = self.cfg
        dev = self.device
        set_full_precision()
        timer = StageTimer(dev)
        with timer.active():
            imgs = self._upload(images)
            n, H, W = imgs.shape[:3]
            cams, _, reachable, conf, start_defect = register_views(
                imgs, cfg, draws, _generator(dev, seed))

            with timer.stage("warp"):
                scale = warp_scale(cams)
                canvas_hw = _pano_canvas_shape((H, W), n, cfg)
                k_rinvs, corner, roi_uvs, _ = warp_inputs(
                    cams, scale, (H, W), n, canvas_hw, cfg)
                self._frozen = dict(cams=cams, k_rinvs=k_rinvs, scale=scale,
                                    corners=corner.expand(n, 2),
                                    roi_uvs=roi_uvs, canvas_hw=canvas_hw)
                warped, masks = self._warp(imgs)
                # the views outside the largest match component sit at R = I:
                # the frozen seam masks leave them out of every compose too
                masks = masks & torch.as_tensor(reachable, device=dev)[
                    :, None, None]
            with timer.stage("exposure"):
                warped = _apply_exposure(warped, masks, cfg)
            with timer.stage("seam"):
                if _needs_host_seam(cfg):
                    sm = torch.as_tensor(_host_seam_masks(
                        *_read_back(warped, masks), cfg), device=dev)
                else:
                    sm = _seam_masks(warped, masks, cfg)
                self._frozen["seam_masks"] = sm
            with timer.stage("blend"):
                pano, valid = _blend_resolved(
                    warped, self._frozen["seam_masks"], masks, cfg)
            # the bbox whatever cfg.crop says, as the JAX stream crops
            out = _to_uint8(pano, valid, "bbox")
        self.stages_ms = timer.summary()
        metrics = {"n_images": n, "pair_confidences": conf.tolist(),
                   "focal": float(cams.focal[0]),
                   "reachable": reachable.tolist(), **timer.counts()}
        if start_defect is not None:
            metrics["start_defect"] = start_defect
        return out, metrics

    def frozen(self, name: str):
        """A frozen piece of the registration: "cams" (CameraParams),
        "scale", "seam_masks" ((N, Hc, Wc) bool), "canvas_hw", or the warp's
        "k_rinvs", "corners", "roi_uvs"."""
        if self._frozen is None:
            raise RuntimeError("call calibrate() first")
        return self._frozen[name]

    def compose(self, images) -> np.ndarray:
        """Stitch a new frame set of the rig with the frozen registration:
        warp, gain compensation, blend with the frozen seam masks, crop.
        Returns the pano (uint8)."""
        if self._frozen is None:
            raise RuntimeError("call calibrate() before compose()")
        cfg = self.cfg
        timer = StageTimer(self.device)
        with timer.active():
            with timer.stage("upload"):
                imgs = self._upload(images)
            with timer.stage("warp"):
                warped, masks = self._warp(imgs)
            with timer.stage("exposure"):
                warped = _apply_exposure(warped, masks, cfg)
            with timer.stage("blend"):
                pano, valid = _blend_resolved(
                    warped, self._frozen["seam_masks"], masks, cfg)
            # the bbox whatever cfg.crop says, as the JAX stream crops
            out = _to_uint8(pano, valid, "bbox")
        self.stages_ms = timer.summary()
        return out
