"""Batched pair stitching on one card (`imagestitch_tpu.parallel.batch.
stitch_pairs_batched`): the throughput configuration, B independent pairs
per call (bench.py's 8 pairs at 1080p and 32 at 480x640).

The two kernels run once per batch: the detector maps (K1) once for the
2B views' pyramids (`features.detect_batched`, on grays at the work scale
with `work_megapix`), and the warp (K2) once for the 2B views into 2B
canvases, each view with its pair's canvas corner and its pair's surface
scale (the projectors K2 does not carry warp by the plain warp). Matching
and RANSAC, the cameras, the bundle adjustment and the wave correction,
exposure compensation and the seam + blend run pair by pair, through the
same functions as `stitch_pair_impl`;
the bundle adjustment's LM loop reads its stop test back to the host at
every step, so a batched adjuster is later work.

`stitch_pairs_sharded` splits the B pairs over a mesh's "data" axis: each
data device runs `stitch_pairs_batched_impl` on its contiguous chunk (so
K1 and K2 run once per shard), RANSAC scores its hypotheses over the
"model" axis when the mesh has one, and the outputs are gathered to the
mesh's first device in pair order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from imagestitch_tpu_torch.config import PipelineConfig
from imagestitch_tpu_torch.features import detect_batched
from imagestitch_tpu_torch.matching.matcher import draw_pair, match_pairs
from imagestitch_tpu_torch.ops.image import rgb_to_gray
from imagestitch_tpu_torch.parallel.mesh import (Mesh, data_sharding,
                                                 run_on_devices, use_mesh)
from imagestitch_tpu_torch.pipeline import (
    _apply_exposure, _generator, _megapix_scale, _normalize_scans, _pano_canvas_shape, _refuse_host_seam, _seam_and_blend,
    _work_grays, pair_cameras, pair_metrics, resolve_device,
    set_full_precision, warp_inputs, warp_scale, warp_views)
from imagestitch_tpu_torch.types import index
from imagestitch_tpu_torch.utils import log


def stitch_pairs_batched(pairs, config: PipelineConfig | None = None,
                         seed: int = 0, device=None, draws=None):
    """pairs: (B, 2, H, W, 3) RGB (uint8 or float). Returns, as tensors on
    the device, (panos (B, Hc, Wc, 3), valids (B, Hc, Wc), corners (B, 2),
    metrics: each of `stitch_pair_impl`'s metrics stacked over B). The
    canvases are not cropped.

    seam.orient="auto" resolves to "vertical" (horizontal panorama batches
    want the vertical seam; pass "horizontal" for stacked pairs). Runs on
    `device` (default: the CUDA card; with no card it raises). RANSAC
    draws come from a torch.Generator seeded with `seed`, pair after pair,
    unless `draws` maps pair b to its (u_first, u_refit)."""
    cfg = _batch_config(config)
    dev = resolve_device(device)
    x = _pairs_tensor(pairs, dev)
    return stitch_pairs_batched_impl(x, cfg, draws, _generator(dev, seed))


def _batch_config(config: PipelineConfig | None) -> PipelineConfig:
    """orient "auto" pinned to "vertical"; a host seam raises."""
    cfg = config or PipelineConfig()
    if cfg.seam.orient == "auto":
        cfg = cfg.replace(seam=dataclasses.replace(cfg.seam,
                                                   orient="vertical"))
    _refuse_host_seam(cfg)
    return cfg


def _pairs_tensor(pairs, dev: torch.device) -> torch.Tensor:
    set_full_precision()
    x = torch.as_tensor(np.asarray(pairs) if not isinstance(
        pairs, torch.Tensor) else pairs, device=dev).to(torch.float32)
    if x.ndim != 5 or x.shape[1] != 2:
        raise ValueError(f"pairs: (B, 2, H, W, C) expected, got "
                         f"{tuple(x.shape)}")
    return x


def stitch_pairs_sharded(pairs, mesh: Mesh,
                         config: PipelineConfig | None = None, seed: int = 0,
                         draws=None):
    """`stitch_pairs_batched` with the B pairs split over `mesh`'s "data"
    axis and each pair's RANSAC hypotheses over its "model" axis, if it
    has one. Returns the same tensors on the mesh's first device, in pair
    order.

    Every pair's draws are taken first, in pair order, from a
    torch.Generator seeded with `seed` on the first device (unless
    `draws` maps pair b to its (u_first, u_refit)), and each shard gets
    its pairs' draws: the result is the unsplit batch's."""
    cfg = _batch_config(config)
    home = mesh.first()
    x = _pairs_tensor(pairs, home)
    B = x.shape[0]
    if draws is None:
        fcfg = _normalize_scans(cfg)
        gen = _generator(home, seed)
        draws = [draw_pair(fcfg.matcher, fcfg.ransac, gen, home)
                 for _ in range(B)]
    sharding = data_sharding(mesh, 5)

    def shard(d, chunk, a):
        with use_mesh(mesh.row("data", d)):
            return stitch_pairs_batched_impl(
                chunk, cfg, {k: draws[a + k] for k in range(len(chunk))})

    outs = run_on_devices([
        (dev, functools.partial(shard, d, chunk, a))
        for d, (dev, chunk, (a, _)) in enumerate(zip(
            sharding.devices, sharding.split(x), sharding.ranges(B)))
        if len(chunk)])

    def gather(parts):
        return sharding.gather(parts, home)

    return (gather([o[0] for o in outs]), gather([o[1] for o in outs]),
            gather([o[2] for o in outs]),
            {k: gather([o[3][k] for o in outs]) for k in outs[0][3]})


def stitch_pairs_batched_impl(pairs: torch.Tensor, cfg: PipelineConfig,
                              draws=None,
                              generator: torch.Generator | None = None):
    """(B, 2, H, W, 3) float32 pairs on one device -> (panos, valids,
    corners, metrics), with `cfg` taken as given (no orient resolution):
    the front of each pair (detect, match, cameras, warp) with SCANS mode
    normalized, the seam and blend with `cfg` itself, as
    `stitch_pair_impl` does. Stages of the active timer: detect, match,
    each pair's `pair_cameras` stages, warp (each pair's warp inputs and
    the one launch), exposure and seam_blend."""
    fcfg = _normalize_scans(cfg)
    B, _, H, W = pairs.shape[:4]
    views = pairs.reshape((2 * B,) + tuple(pairs.shape[2:])).contiguous()
    ids = [(2 * b, 2 * b + 1) for b in range(B)]
    ws = _megapix_scale(cfg.work_megapix, (H, W))
    with log.stage("detect"):
        feats = detect_batched(_work_grays(rgb_to_gray(views), (H, W), ws),
                               fcfg.detector)
    with log.stage("match"):
        mis = match_pairs(feats, ids, fcfg.matcher, fcfg.ransac,
                          None if draws is None
                          else {p: draws[b] for b, p in enumerate(ids)},
                          generator)

    canvas_hw = _pano_canvas_shape((H, W), 2, cfg)
    fs, cams, scales, inputs = [], [], [], []
    for b, (i, j) in enumerate(ids):
        f1, f2 = index(feats, i), index(feats, j)
        c = pair_cameras(f1, f2, mis[b], ((H, W), (H, W)), fcfg, ws)
        with log.stage("warp"):
            s = warp_scale(c)
            inputs.append(warp_inputs(c, s, (H, W), 2, canvas_hw, fcfg))
        fs.append((f1, f2))
        cams.append(c)
        scales.append(s)
    with log.stage("warp"):
        corners = torch.stack([inp[1] for inp in inputs])
        warped, masks = warp_views(
            views, torch.cat([inp[0] for inp in inputs]),
            torch.stack(scales).reshape(B).repeat_interleave(2),
            corners.repeat_interleave(2, dim=0),
            torch.cat([inp[2] for inp in inputs]), canvas_hw,
            fcfg.warp.kind)

    panos, valids, metrics = [], [], []
    with log.stage("exposure"):
        per_pair = [_apply_exposure(warped[2 * b:2 * b + 2],
                                    masks[2 * b:2 * b + 2], cfg)
                    for b in range(B)]
    with log.stage("seam_blend"):
        for b in range(B):
            pano, valid = _seam_and_blend(per_pair[b],
                                          masks[2 * b:2 * b + 2], cfg,
                                          src_w=W, src_h=H)
            panos.append(pano)
            valids.append(valid)
            metrics.append(pair_metrics(*fs[b], mis[b], cams[b],
                                        inputs[b][3], inputs[b][2]))
    return (torch.stack(panos), torch.stack(valids), corners,
            {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]})
