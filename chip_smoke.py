#!/usr/bin/env python3
"""Smoke run of imagestitch_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and no
result line is printed):

1. device     — card name, `nvidia-smi` name and power limit.
2. build      — nvcc builds the kernels of imagestitch_tpu_torch/csrc into
                build/ (seconds, ptxas register report).
3. detect     — the detector-maps kernel against its plain version on both
                views' five 1080p pyramid levels, one launch per view for
                all levels (B=1, as the main path) and one per level at
                B=2: FAST/NMS equal everywhere, Harris within
                1e-4·max|Harris|, blur within 1e-3 intensity, each map's
                max error. Then one stitch's detect work: the wrapper, the
                plain version, the share of pixels past FAST's compass
                test (the kernel alone: phase 12).
4. warp       — the warp kernel against its plain version: the main-path
                geometry (cylindrical, N=2, 1080x1920x3 into 1458x4032),
                spherical and plane at 480x640, and a mixed-size pair.
                Masks agree except within 1e-3 px of the validity boundary;
                values agree within 1e-2 where both are valid. Then, at the
                main-path shapes: ms, the kernel alone (its arguments
                checked and its outputs allocated outside the window) with
                L2 flushed by a 256 MB write before each call, the CUDA-
                event median of 20 single calls; warm_ms, the kernel alone
                over 20 back-to-back calls; wrapper_ms, warp_batched_cuda
                whole over 20 back-to-back calls; plain_ms; library_ms and
                library_warm_ms, F.grid_sample on precomputed maps, read as
                ms and warm_ms; fill_ms, zeros written into same-shaped
                canvases and masks, flushed (the outputs' write alone).
5. sift_maps  — the SIFT octave-maps kernel against its plain version at
                the four 1080p octave shapes (the first octave and three
                later ones): the same nonzero score support, all five maps
                within 1e-4; then one SIFT stitch's octave maps (8 calls,
                8 CUDA launches as the kernel library counts them) through
                the wrapper, and the plain version (the kernel alone:
                phase 12).
6. dma_layouts — the slab-load probe kernel against its plain version on
                the seeded 1080x1920x3 source, 468 steps, planar and tiled,
                h = 16, 24, 32, 48: equal bit for bit (max error 0), also
                at every grid of 1-16 steps (16 more last steps). Then the
                probe's entry point (tools.exp_dma_layouts.run) with the
                launch counts: warm and cold ms, GB/s, the bound (the
                source bytes the slabs cover, read once), the slab bytes
                over the memory rate (slab_hbm_ms), and for each h the
                card's L2 ceiling (tools.exp_dma_layouts.ceilings: one
                block per SM copies the L2-resident source into shared
                memory with bulk copies, as many bytes as the slabs, warm;
                l2_ceiling_ms and _tbps) with the probe's slab rate as a
                share of it (l2_share_warm, l2_share_cold), and beside it
                the same bytes read with 16-byte loads (l2_loads_ms and
                _tbps, not a ceiling: the probe outruns it at h = 16).
7. reference  — a small pair (192x256) stitched on the card and on the CPU
                (the plain versions) with the same RANSAC draws agree.
8. sift_reference — the same with DetectorConfig(kind="sift").
9. main_path  — stitch_pair with the default PipelineConfig on the 1080p
                rotation pair and the 1080p translation pair: h_valid,
                plausible focal / warped offset / pano width, and the
                kernels' launch counts (detector maps 2, warp 1, SIFT 0,
                slab probe 0 per stitch). Then the median wall time of warm
                stitches.
10. sift_path — stitch_pair with DetectorConfig(kind="sift") on the 1080p
                rotation pair (cylindrical warp) and on the 40%-overlap
                1080p pair with the plane warp (the configuration bench.py
                times): h_valid, focal / offset / pano width, launch counts
                (SIFT maps 8, warp 1, detector maps 0, slab probe 0 per
                stitch; K3's CUDA launches 8 per stitch), the median wall
                time of warm stitches.
11. chain_reference — a 4-view 160x224 synthetic_sequence chain
                (stitch_chain_impl, no bundle adjustment) on the card and
                on the CPU with the same RANSAC draws per pair: equal
                counts, h_valid, reachable and corner, focal within 1e-3,
                valid-mask IoU >= 0.999.
12. chain_path — stitch_chain with the default PipelineConfig on bench.py's
                chain8_1080p (8 views of 1080x1920) and chain4_cyl (4 of
                480x640) sequences, 50% overlap: every h_valid and
                reachable true, the pano's width within 10% of
                W + (N-1)·shift, launches per stitch (detector maps 1, warp
                1, SIFT 0, slab probe 0), the median wall ms of 3 warm
                stitches. Then K1 at B = 8 on the 8 views' five 1080p
                levels and K2 into the 8-view canvas (1458x16704), each
                against its plain version to the tolerances of phases
                detect and warp, with their times (K2's kernel alone, L2
                flushed and warm).
13. stitcher_path — stitch() on a 4-view 1080x1920 sequence, and Stitcher on
                a 3-view 480x640 sequence whose middle view is cropped to
                432x600 and on a 2x2 480x640 synthetic_grid: every view
                reachable, the pano extending as the JAX package's tests
                ask, launches per stitch (detector maps 1, warp 1), the
                median wall ms of 3 warm 1080p stitches and their
                StageTimer stages.
14. photo_reference — stitch_pair_impl on the real-photo rotation pair on
                the card and on the CPU with the same draws: both held to
                the JAX package's committed golden (tests/data/
                golden_photo_pano.*: focal 2%, inliers 0.7x, corner and
                bbox 8 px, PSNR > 30 dB at 4x down) and to each other.
15. multiband_path — bench.py's configs[2] (DP colour seam, 5-band
                multi-band blend) on its 1080p pair: launches (detector
                maps 2, warp 1), the median of 5 warm stitches, the stage
                split; card against CPU at 192x256 with 3 bands
                (multiband_reference).
16. stream_path — StreamStitcher: calibrate on the 4-view 1080p sequence
                (canvas 1458x8256; launches: detector maps 1, warp 1),
                compose of the calibration frames within 1.0 mean of the
                calibration pano, 10 brightened frame sets composed
                (launches per compose: detector maps 0, warp 1), the
                median compose ms and its split; card against CPU on a
                panning camera's views, bundle adjustment on.
17. batched_path — stitch_pairs_batched at bench.py's shapes (8 pairs at
                1080p, 32 at 480x640, copies of one pair): launches per
                batch (detector maps 1, warp 1), pairs/s beside the
                per-pair loop's, the stage split; on batches of distinct
                pairs, K1 and K2 (one scale per view, max error 0)
                against their plain versions with their times, and four
                1080p pairs against stitch_pair_impl with the same draws.
18. options_reference — the options of ROADMAP item 13 on the card
                against the CPU with the same draws: on the 192x256
                rotation pair the ramp blend with the colour-gradient seam,
                the Voronoi seam, CHANNELS and CHANNELS_BLOCKS, ORB wta_k 3
                and 4, the interior crop and the eight projectors K2 does
                not carry (launches: detector maps 2, warp 0 for those, 1
                for the others); the reprojection bundle adjuster through
                Stitcher on a 3-view 192x256 panning sequence.
19. detailed_path — Stitcher with OpenCV stitching_detailed's defaults
                (work_megapix 0.6, horizontal wave correction, spherical
                warp, GAIN_BLOCKS, the graph-cut colour seam at
                seam_megapix 0.1, multi-band) on a panning
                camera's four 1080x1920 views: every view reachable, focal
                within 5% of 1728 px, the pano's width within 5% of the
                pan's spherical extent, launches per stitch (detector maps
                1 for four 581x1033 work views, warp 1 into 4 x 1458x8256),
                the median of 3 warm stitches and their stages; K1 at the
                work-scale batch and K2 on its spherical launch's inputs
                against their plain versions with their times; card
                against CPU on three 160x224 views.
20. ramp_path — stitch_pair with the ramp blend and the colour-gradient
                DP seam on the 1080p rotation and 40%-overlap translation
                pairs: h_valid, focal / offset / width, launches (detector
                maps 2, warp 1 per pair), the median of 5 warm stitches of
                each, the rotation pair's stage split.
21. host_seam_reference — the host seams card against CPU with the same
                draws on the 192x256 rotation pair (graph cut COLOR and
                COLOR_GRAD, the full DP, the graph cut at seam_megapix
                0.1) and a 3-view 192x256 panning Stitcher (graph cut):
                the panos within the reference phase's limits, and the
                split of the card's own canvases equal to the same split
                on the CPU (equal seam masks).
22. graphcut_path — stitch_pair with the graph-cut seam on bench.py's
                1080p 40%-overlap pair at seam_megapix 0.1 and at full
                resolution: launches (detector maps 2, warp 1), the median
                of 5 warm stitches, the split's readback / seam / blend ms
                and the bytes read back.
23. scans_reference — SCANS mode card against CPU at 192x256: the pair,
                the spliced chain, the Stitcher and StreamStitcher.calibrate.
24. scans_path — stitch_pair(mode="scans") on the same 1080p pair (median
                of 5, launches 2 and 1, the stage split) and a scans
                Stitcher on three translated 480x640 views.
25. pano_reference — parallel.stitch_chain_pano (the N-1 pair seams
                resolved independently, then merged) on 4 views of 192x256
                on the card and on the CPU with the same draws (seams
                vertical, no bundle adjustment): corner equal, focal
                within 1e-3, valid IoU >= 0.999, canvas within 0.5 on
                average; on the card equal to stitch_chain_impl (empty
                triple overlaps: the two seam schedules agree).
26. pano_path — stitch_chain_pano on chain8_1080p: launches (K1 1, K2 1),
                the median of 3 walls alternating with stitch_chain_impl
                and stitch_chain on the same views, and the seam stage of
                the 7 independent pair seams beside the 7 sequential ones.
27. sharded_path — stitch_pairs_sharded (8 distinct 1080p pairs),
                stitch_chain_pano_sharded (chain8_1080p) and
                stitch_pair_hostseam_sharded (graph cut at seam_megapix
                0.1) equal, bit for bit, to stitch_pairs_batched,
                stitch_chain_pano and stitch_pair's split, on a mesh of
                every card and on meshes naming the one card twice and
                four times ({"data": 2}, {"data": 2, "model": 2}): logic
                checks of the split on one card, not a multi-card
                measurement; K1 and K2 once per data shard.
28. aot       — aot.stitch_pair_program(1080, 1920) into a fresh directory:
                the cold build of both libraries and a second call
                (was_cached False, then True) with their seconds, its call
                equal to stitch_pair_impl; cached_export round-tripping a
                tensor function on the card; clear().
29. cli       — `imagestitch_tpu_torch.cli demo --size 1080x1920` on the
                card writes a PNG wider than 1920; then
                examples/stitch_photo_torch.py on the card into build/:
                its metrics line and PNG equal to stitch_pair on
                photo_rotation_pair() with seed 0, launches K1 2, K2 1.
30. api_path  — the public one-image warp (`warp.warper.warp_image`) of a
                1080p rotation view into 1458x4032: cylindrical, spherical
                and plane one K2 launch each, bit for bit the plain path on
                the card, and within tests/test_torch_warp.py's tolerance
                of the CPU (its 5e-3 in coordinate ulps, 0.08 at 1920 px,
                where both are valid); with a mask, nearest sampling or
                mercator no
                launch; use_kernel=True on a CPU tensor raises; every
                subpackage's `__all__` imports.
31. serve_path — the serving loop (tools/serve_demo.py): the tool with
                its defaults (192x256, the demo configuration, 32
                requests, batch 8, 4 producers), every request ok; then
                PipelineConfig() on 16 1080x1920 pairs made in advance,
                batch 8, 8 producers: every request ok, K1 and K2 once per
                dispatch, each crop equal bit for bit to
                stitch_pairs_batched(seed=k) on its dispatch's pairs;
                dispatch sizes, req/s, p50 / p95 latency, each dispatch's
                wall split (dispatch, then readback + crop).
32. warm_start — aot.stitch_pair_program(1080, 1920) into the default
                directory and one call in-process (K1 2, K2 1), then
                tools/warm_start_probe.py in two fresh processes: the JAX
                probe's keys, was_cached and h_valid true, pano_sum equal
                to the in-process call's, each process's wall.
    lm_bundle — the LM kernel against the plain loop at the pair's and
                the chain's shapes of the ray adjustment, then both timed.
    dp_seam   — the DP seam kernel on the costs a 1080p rotation pair's
                stitch hands it under the ORB pair cell's and the SIFT
                cell's configurations: one launch, the seam columns equal
                to the plain loop's bit for bit; the stitches' seam_blend
                and seam_dp stages with the kernel and with the plain loop
                forced; the plain loop's and the wrapper's wall; the
                kernel alone, L2 flushed and warm.
    crop_u8   — the crop kernel on the canvases `_to_uint8` hands it at the
                end of the ORB pair's, the SIFT pair's and the chain
                cell's stitches (1458 x 4032, 1944 x 4032, the chain's
                planar multi-band canvas): one launch, the uint8 crop
                equal to the host path's byte for byte; `_to_uint8`'s
                wall through the kernel and with the host path forced and
                the bytes each reads back; the kernel alone, L2 flushed
                and warm, beside its bound.
    stitcher_pano — the `stitcher_pano_1080p` configuration (OpenCV's
                cv::Stitcher PANORAMA preset) through Stitcher on three
                4-view 1080p pans of the benchmark's scenes (steps 20, 25
                and 30 deg), with the adjusters' re-anchor on the nearest
                rotation to view 0's start and with it reverted to the
                start as it is: `start_defect`, the pairs matched and kept,
                the LM launches, and the reference's focal, extent and
                tile numbers (`stitchbench/reference.py`); the re-anchored
                stitches within the configuration's limits.
33. stages    — wall ms of each stage of the 1080p ORB rotation stitch and
                of the 1080p SIFT plane stitch, and the device's busy share
                of one stitch of each (torch.profiler, after the timing);
                then one `record_function` range per StageTimer stage
                entered in a traced stitch() of four 1080p views and
                stitch_pair of the rotation pair, with their ms.
34. kernel_times — K1's and K3's work for one stitch, the kernels alone from
                torch.profiler kernel events (median of 20 rounds) with L2
                flushed by a 256 MB write and warm; K1 also as ten
                one-level launches, as the chain's one launch for 8 views,
                as the batches' for 16 1080p and 64 480x640 views and as
                the detailed path's for four 581x1033 work views; K3
                also by kernel name and by octave, and the CUDA kernels the
                trace shows per stitch (8); K2 at N=1 through
                `ops.cuda_warp.warp` (api_path's cylindrical call), flushed
                and warm, beside its bound and F.grid_sample. Last, since
                once the profiler has traced the card, later launches cost
                the host more.
35. kernels   — one line {"kernels": [...]}, K1-K4, then the LM, the DP
                seam and the crop kernels: launches on the main path (`launches`) and
                on each path (`launches_by_path`, counted from 0 over the
                path's run), error against the plain version,
                kernel / plain / library ms and the least time the card
                could take (bound_ms).

Then the card's name and power limit, and the last line
{"ok": true, "device": {...}}. Needs one card; builds everything it runs.
`python3 chip_smoke.py PHASE...` runs the device and build phases and the
named ones alone, without the kernels line.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
# detector-maps float32 operations per pixel, at most: FAST 16
# differences, the arcs' min and max with neighbouring arcs sharing their
# eight common ring pixels (a doubling tree over them, 3 x 16; the two
# end pixels, 16; the better of each pair and the best pair, 32) and the
# threshold (6): 118, which the compass test skips on most pixels; NMS
# 11; Harris 2 gradients + 3 products + 3 x 12 box adds + 8 (49); blur
# 2 x (7 mul + 6 add) (26). The bytes bound the kernel either way.
DETECT_OPS_PER_PX = 118 + 11 + 49 + 26
# warp float32 operations per canvas pixel and image: 15 for the 3x3
# projection, 2 divides, 8 compares, 3 channels x 6 for the bilinear
# blend; per canvas column (and per row) and image: a divide by scale and
# a sincos (~20 each)
WARP_OPS_PER_PX = 15 + 2 + 8 + 18
WARP_OPS_PER_LINE = 1 + 40
# SIFT octave maps, float32 operations per octave pixel beyond the blurs:
# S+2 DoG differences, S+1 levels x 2 gradients x (difference, halving),
# per interior layer 26 x 2 comparisons + |D| and the contrast test + 18
# for the Hessian edge test
SIFT_S = 3
SIFT_OPS_EXTRA_PER_PX = (SIFT_S + 2) + 4 * (SIFT_S + 1) + SIFT_S * (52 + 2 + 18)
# bytes per octave pixel: the base read once, dog S+2, score S, gx and gy
# S+1 each and gS written once, float32
SIFT_BYTES_PER_PX = 4 * (1 + (SIFT_S + 2) + SIFT_S + 2 * (SIFT_S + 1) + 1)
N_TIMED = 20
# the CUDA kernels of the SIFT octave maps (K3), by name, and how many one
# SIFT stitch launches (one per call: 4 octaves x 2 images)
K3_NAMES = ("sift_octave_kernel",)
K3_CUDA_LAUNCHES_PER_STITCH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, iters: int = N_TIMED, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters`
    back-to-back calls after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / FP32_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def phase_device(state):
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    import imagestitch_tpu_torch  # noqa: F401  (fails on a lone script)
    from imagestitch_tpu_torch.utils.timing import smi_line
    state["name"] = torch.cuda.get_device_name(0)
    state["smi"] = smi_line()
    state["rot"] = _rotation_pair_1080()
    emit({"phase": "device", "name": state["name"], "smi": state["smi"],
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build(state):
    from imagestitch_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_library()
    ptxas = [ln.strip() for ln in cuda_build.build_info["log"].splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": cuda_build.build_info["built"],
          "path": os.path.relpath(cuda_build.build_info["path"], HERE),
          "ptxas": ptxas})


def _rotation_pair_1080():
    from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair
    return synthetic_rotation_pair(1080, 1920)


def phase_detect(state):
    """K1 on both views' 1080p five-level pyramids: the multi-level launch
    (B=1 per view, as the main path runs it) and the one-level launch at
    B=2, each level against the plain version. Then one stitch's detect
    work (both views' five levels): the wrapper calls in CUDA events
    (wrapper_ms), the plain version, and the share of pixels that pass
    the kernel's FAST compass test. The kernel alone is timed in phase
    kernel_times, after the stitches."""
    import torch
    from imagestitch_tpu_torch.ops.cuda_detect import (detect_maps_cuda,
                                                       detect_maps_levels,
                                                       detect_maps_plain)
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    img1, img2, _, _ = state["rot"]
    rgb = torch.stack([torch.as_tensor(img1), torch.as_tensor(img2)])
    gray = rgb_to_gray(rgb.cuda().float())
    levels = [lv.contiguous() for lv in build_pyramid(gray, 5, 1.3)]
    views = [[lv[b:b + 1].contiguous() for lv in levels] for b in range(2)]
    worst = {"nms": 0.0, "harris": 0.0, "harris_rel": 0.0, "blur": 0.0}
    for pyr in views:
        for lv, k in zip(pyr, detect_maps_levels(pyr, 20.0)):
            _hold_detect(k, detect_maps_plain(lv, 20.0), tuple(lv.shape),
                         worst)
    for lv in levels:
        _hold_detect(detect_maps_cuda(lv, 20.0), detect_maps_plain(lv, 20.0),
                     tuple(lv.shape), worst)

    def stitch():
        return [detect_maps_levels(pyr, 20.0) for pyr in views]

    def one_level():
        return [detect_maps_cuda(x, 20.0) for pyr in views for x in pyr]

    state["k1_calls"] = (stitch, one_level)
    wrapper = cuda_ms(stitch)
    plain = cuda_ms(lambda: [detect_maps_plain(x, 20.0) for pyr in views
                             for x in pyr], iters=5)
    px = sum(x.numel() for pyr in views for x in pyr)
    b_ms, b_by = bound_ms(16.0 * px, DETECT_OPS_PER_PX * px)
    passed = sum(int(_compass_pass(x[0], 20.0).sum()) for pyr in views
                 for x in pyr)
    state["k1"] = {
        "name": "detect_maps", "route": "cuda",
        "source": "imagestitch_tpu_torch/csrc/detect_maps.cu",
        "replaces": "imagestitch_tpu/ops/pallas_detect.py:136",
        "max_abs_err": max(worst["nms"], worst["harris"], worst["blur"]),
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "case": "kernel alone, L2 flushed",
        "wrapper_ms": wrapper}
    emit({"phase": "detect", "shapes": [list(lv.shape) for lv in levels],
          "nms_equal": True, "max_abs_err": worst, "wrapper_ms": wrapper,
          "plain_ms": plain, "bound_ms": b_ms,
          "bound_by": b_by, "mpx_per_stitch": px / 1e6,
          "compass_pass_share": passed / px,
          "card": state["name"], "smi": state["smi"]})


def _compass_pass(img, t):
    """Pixels of an (H, W) image that pass the kernel's FAST compass test:
    two neighbouring ring pixels of 0, 4, 8, 12 both brighter than t, or
    both darker than -t (the differences wrap around the image)."""
    import torch
    d = [torch.roll(img, (-dy, -dx), (0, 1)) - img
         for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
    out = torch.zeros_like(img, dtype=torch.bool)
    for i in range(4):
        a, b = d[i], d[(i + 1) % 4]
        out |= ((a > t) & (b > t)) | ((a < -t) & (b < -t))
    return out


def _hold_detect(k, p, shape, worst):
    """FAST/NMS equal, Harris within 1e-4·max|Harris|, blur within 1e-3;
    each map's max error folded into `worst`."""
    import torch
    check(torch.equal(k[0], p[0]), f"FAST/NMS differs at {shape}: "
          f"{int((k[0] != p[0]).sum())} pixels")
    h_err = float((k[1] - p[1]).abs().max())
    h_rel = h_err / max(float(p[1].abs().max()), 1e-30)
    b_err = float((k[2] - p[2]).abs().max())
    check(h_rel <= 1e-4, f"Harris rel err {h_rel} at {shape}")
    check(b_err <= 1e-3, f"blur err {b_err} at {shape}")
    for key, v in (("harris", h_err), ("harris_rel", h_rel), ("blur", b_err)):
        worst[key] = max(worst[key], v)


def _compare_warp(case, imgs, k_rinvs, scale, corner, roi_uvs, canvas_hw,
                  kind, src_sizes=None):
    import torch
    from imagestitch_tpu_torch.ops.cuda_warp import warp_batched_cuda
    from imagestitch_tpu_torch.testing import near_validity_boundary
    from imagestitch_tpu_torch.warp.warper import warp_batched_plain
    n = imgs.shape[0]
    corners = corner.expand(n, 2)
    ok_k = warp_batched_cuda(imgs, k_rinvs, scale, corners, roi_uvs,
                             canvas_hw, kind, src_sizes)
    ok_p = warp_batched_plain(imgs, k_rinvs, scale, corners, roi_uvs,
                              canvas_hw, kind, src_sizes)
    torch.cuda.synchronize()
    (out_k, val_k), (out_p, val_p) = ok_k, ok_p
    sizes = ([tuple(imgs.shape[1:3])] * n if src_sizes is None
             else [tuple(int(x) for x in s) for s in src_sizes])
    near = near_validity_boundary(k_rinvs, scale, corners, canvas_hw, kind,
                                  sizes)
    mism = val_k != val_p
    bad = int((mism & ~near).sum())
    both = val_k & val_p
    err = float((out_k - out_p).abs()[both].max()) if bool(both.any()) \
        else 0.0
    check(bad == 0, f"{case}: {bad} mask pixels differ away from the "
          "validity boundary")
    check(err <= 1e-2, f"{case}: value error {err} where both are valid")
    check(bool(val_k.any()), f"{case}: nothing valid")
    return {"case": case, "kind": kind, "canvas": list(canvas_hw),
            "valid_px": int(val_k.sum()), "mask_mismatch_near_boundary":
            int(mism.sum()), "max_abs_err": err}


def _grid_sample_call(imgs, k_rinvs, scale, corners, canvas, kind):
    """K2's library yardstick: F.grid_sample on maps precomputed with the
    plain version's backward projection (one surface scale or one per
    image), bilinear, zeros outside. Timed only; the port never calls it.
    Returns the call."""
    import torch
    import torch.nn.functional as F
    from imagestitch_tpu_torch.warp.projectors import PROJECTORS
    from imagestitch_tpu_torch.warp.warper import image_scale
    n, h, w = imgs.shape[:3]
    Hc, Wc = canvas
    grids = []
    for i in range(n):
        proj = PROJECTORS[kind].from_backward(k_rinvs[i],
                                              image_scale(scale, i))
        u = (torch.arange(Wc, device=imgs.device, dtype=torch.float32)
             + corners[i, 0].float())[None, :].expand(Hc, Wc)
        v = (torch.arange(Hc, device=imgs.device, dtype=torch.float32)
             + corners[i, 1].float())[:, None].expand(Hc, Wc)
        xm, ym, _ = proj.backward(u, v)
        grids.append(torch.stack([xm / (w - 1) * 2 - 1,
                                  ym / (h - 1) * 2 - 1], dim=-1))
    grid = torch.stack(grids).contiguous()
    del grids
    src_cf = imgs.permute(0, 3, 1, 2).contiguous()

    def call():
        return F.grid_sample(src_cf, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    return call


def phase_warp(state):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from imagestitch_tpu_torch.config import PipelineConfig, WarpConfig
    from imagestitch_tpu_torch.ops.cuda_warp import warp_batched_cuda
    from imagestitch_tpu_torch.pipeline import (
        _pano_canvas_shape, register_pair, set_full_precision, warp_inputs,
        warp_scale)
    from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair
    from imagestitch_tpu_torch.warp.warper import warp_batched_plain

    set_full_precision()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = PipelineConfig()
    results = []

    # main-path geometry: cameras from a stitch of the 1080p rotation pair
    img1, img2, _, _ = state["rot"]
    a = torch.as_tensor(img1).cuda().float()
    b = torch.as_tensor(img2).cuda().float()
    _, _, _, cams = register_pair(a, b, cfg, generator=gen)
    state["rot_cams"] = cams
    scale = warp_scale(cams)
    canvas = _pano_canvas_shape((1080, 1920), 2, cfg)
    k_rinvs, corner, roi_uvs, _ = warp_inputs(cams, scale, (1080, 1920), 2,
                                              canvas, cfg)
    imgs = torch.stack([a, b]).contiguous()
    results.append(_compare_warp("main_1080p", imgs, k_rinvs, scale, corner,
                                 roi_uvs, canvas, "cylindrical"))
    main = (imgs, k_rinvs, scale, corner.expand(2, 2), roi_uvs, canvas)

    # spherical and plane at 480x640, cameras from a stitch of that pair
    s1, s2, _, _ = synthetic_rotation_pair(480, 640)
    a = torch.as_tensor(s1).cuda().float()
    b = torch.as_tensor(s2).cuda().float()
    _, _, _, cams = register_pair(a, b, cfg, generator=gen)
    scale = warp_scale(cams)
    imgs_s = torch.stack([a, b]).contiguous()
    for kind in ("spherical", "plane"):
        cfg_k = cfg.replace(warp=WarpConfig(kind=kind))
        cv = _pano_canvas_shape((480, 640), 2, cfg_k)
        kr, cn, ru, _ = warp_inputs(cams, scale, (480, 640), 2, cv, cfg_k)
        results.append(_compare_warp(f"{kind}_480p", imgs_s, kr, scale, cn,
                                     ru, cv, kind))

    # mixed sizes: the second image cut to 440x600, edge-padded back
    sizes = np.asarray([[480, 640], [440, 600]], np.int32)
    b_small = b[:440, :600]
    b_pad = F.pad(b_small.permute(2, 0, 1)[None], (0, 40, 0, 40),
                  mode="replicate")[0].permute(1, 2, 0)
    imgs_m = torch.stack([a, b_pad]).contiguous()
    cv = _pano_canvas_shape((480, 640), 2, cfg)
    kr, cn, ru, _ = warp_inputs(cams, scale, (480, 640), 2, cv, cfg, sizes)
    results.append(_compare_warp("mixed_sizes", imgs_m, kr, scale, cn, ru,
                                 cv, "cylindrical", sizes))

    # timing at the main-path shapes: the kernel alone (its arguments
    # packed and its outputs allocated outside the window) warm, back to
    # back, and with L2 flushed before each call; the whole wrapper; the
    # plain version; grid_sample on precomputed maps, warm and flushed
    from imagestitch_tpu_torch.ops.cuda_warp import warp_launcher
    from imagestitch_tpu_torch.utils.timing import FLUSH_BYTES, median_ms
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    imgs, k_rinvs, scale, corners, roi_uvs, canvas = main
    launch, _, _ = warp_launcher(imgs, k_rinvs, scale, corners, roi_uvs,
                                 canvas, "cylindrical")
    warm = cuda_ms(launch)
    cold = median_ms(launch, N_TIMED, dev, flush)
    wrapper = cuda_ms(lambda: warp_batched_cuda(
        imgs, k_rinvs, scale, corners, roi_uvs, canvas, "cylindrical"))
    plain = cuda_ms(lambda: warp_batched_plain(
        imgs, k_rinvs, scale, corners, roi_uvs, canvas, "cylindrical"),
        iters=5)
    # library yardstick: grid_sample on precomputed maps (timed only)
    lib_call = _grid_sample_call(imgs, k_rinvs, scale, corners, canvas,
                                 "cylindrical")
    Hc, Wc = canvas
    lib_warm = cuda_ms(lib_call)
    lib_cold = median_ms(lib_call, N_TIMED, dev, flush)
    # what writing the outputs alone takes: zeros into same-shaped
    # canvases and masks (two fills), L2 flushed
    out_z = torch.empty((2, Hc, Wc, 3), dtype=torch.float32, device=dev)
    val_z = torch.empty((2, Hc, Wc), dtype=torch.bool, device=dev)
    fill_ms = median_ms(lambda: (out_z.zero_(), val_z.zero_()), N_TIMED,
                        dev, flush)
    del flush, out_z, val_z
    nbytes = imgs.numel() * 4 + 2 * Hc * Wc * (3 * 4 + 1)
    b_ms, b_by = bound_ms(nbytes, 2 * (WARP_OPS_PER_PX * Hc * Wc
                                       + WARP_OPS_PER_LINE * (Hc + Wc)))
    state["k2"] = {
        "name": "warp_batched", "route": "cuda",
        "source": "imagestitch_tpu_torch/csrc/warp.cu",
        "replaces": "imagestitch_tpu/ops/pallas_warp.py:426",
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": cold, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_cold, "case": "kernel alone, L2 flushed",
        "warm_ms": warm, "wrapper_ms": wrapper, "library_warm_ms": lib_warm,
        "fill_ms": fill_ms}
    emit({"phase": "warp", "cases": results, "ms": cold, "warm_ms": warm,
          "wrapper_ms": wrapper, "plain_ms": plain, "library_ms": lib_cold,
          "library_warm_ms": lib_warm, "fill_ms": fill_ms, "bound_ms": b_ms,
          "card": state["name"], "smi": state["smi"]})


def _sift_octave_bases(gray, n_octaves: int = 4):
    """The octave bases SIFT detection gives one (H, W) image: the image,
    then each octave's level S halved (the plain version's levels)."""
    from imagestitch_tpu_torch.ops.cuda_sift import (octave_levels,
                                                     octave_shapes)
    from imagestitch_tpu_torch.ops.image import resize
    H, W = gray.shape
    shapes = octave_shapes(H, W, n_octaves)
    bases = [gray.contiguous()]
    for o in range(1, len(shapes)):
        gs = octave_levels(bases[-1], o == 1, SIFT_S, 1.6)[SIFT_S]
        bases.append(resize(gs, shapes[o]).contiguous())
    return bases


def phase_sift_maps(state):
    import torch
    from imagestitch_tpu_torch.ops.cuda_sift import (
        cuda_launches, octave_blurs, sift_octave_maps_cuda,
        sift_octave_maps_plain)
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    img1, img2, _, _ = state["rot"]
    ct = 0.04 * 255.0 / SIFT_S
    calls = []                                 # (base, first) per octave
    for img in (img1, img2):
        gray = rgb_to_gray(torch.as_tensor(img).cuda().float())
        calls += [(b, o == 0) for o, b in enumerate(_sift_octave_bases(gray))]
    names = ("dog", "score", "gx", "gy", "gS")
    worst = dict.fromkeys(names, 0.0)
    cases = []
    for base, first in calls[:4]:              # the four octave shapes
        k = sift_octave_maps_cuda(base, first, SIFT_S, 1.6, ct)
        p = sift_octave_maps_plain(base, first, SIFT_S, 1.6, ct)
        torch.cuda.synchronize()
        shape = list(base.shape)
        diff = int(((k[1] > 0) != (p[1] > 0)).sum())
        check(diff == 0, f"SIFT score support differs at {shape}: {diff} px")
        for name, a, b in zip(names, k, p):
            err = float((a - b).abs().max())
            check(err <= 1e-4, f"SIFT {name} err {err} at {shape}")
            worst[name] = max(worst[name], err)
        cases.append({"shape": shape, "first": first,
                      "extrema": int((p[1] > 0).sum())})

    # one SIFT stitch: 4 octaves x 2 images, one call each: the wrapper
    # here, the kernels alone in phase kernel_times
    def stitch():
        return [sift_octave_maps_cuda(b, f, SIFT_S, 1.6, ct)
                for b, f in calls]

    state["k3_call"] = stitch
    n0 = cuda_launches()
    stitch()
    per_stitch = cuda_launches() - n0
    check(per_stitch == K3_CUDA_LAUNCHES_PER_STITCH,
          f"{per_stitch} CUDA launches for one stitch's octave maps")
    # each octave's two calls (one per image) for the split by octave
    state["k3_octaves"] = [
        lambda o=o: [sift_octave_maps_cuda(b, f, SIFT_S, 1.6, ct)
                     for b, f in calls[o::4]] for o in range(4)]
    wrapper = cuda_ms(stitch)
    plain = cuda_ms(lambda: [sift_octave_maps_plain(b, f, SIFT_S, 1.6, ct)
                             for b, f in calls], iters=3, warmup=1)
    nbytes = ops = 0.0
    for base, first in calls:
        px = base.numel()
        pre, chain = octave_blurs(SIFT_S, 1.6, first)
        blur = sum(2 * (2 * k - 1) for k, _ in ([pre] if pre else [])
                   + list(chain))
        nbytes += SIFT_BYTES_PER_PX * px
        ops += (blur + SIFT_OPS_EXTRA_PER_PX) * px
    b_ms, b_by = bound_ms(nbytes, ops)
    state["k3"] = {
        "name": "sift_octave_maps", "route": "cuda",
        "source": "imagestitch_tpu_torch/csrc/sift_octave.cu",
        "replaces": "imagestitch_tpu/ops/pallas_sift.py:172",
        "max_abs_err": max(worst.values()), "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "case": "kernel alone, L2 flushed", "wrapper_ms": wrapper,
        "cuda_launches_per_stitch": per_stitch}
    emit({"phase": "sift_maps", "cases": cases, "support_equal": True,
          "calls_per_stitch": len(calls),
          "cuda_launches_per_stitch": per_stitch,
          "max_abs_err": worst, "wrapper_ms": wrapper, "plain_ms": plain,
          "bound_ms": b_ms,
          "octave_px_per_stitch": int(sum(b.numel() for b, _ in calls)),
          "mbytes_per_stitch": nbytes / 1e6,
          "card": state["name"], "smi": state["smi"]})


def _covered_bytes(h: int, steps: int) -> int:
    """Source bytes the probe's slabs cover in this run (each read once):
    the union of the windows over every step and chunk, counted on the
    (8, 128) cells the origins are aligned to."""
    import numpy as np
    from imagestitch_tpu_torch.ops.slab_probe import NCH, SLAB_W, origins
    from imagestitch_tpu_torch.tools import exp_dma_layouts as tool
    cells = np.zeros((tool.H // 8, tool.W // 128), bool)
    step = np.arange(steps, dtype=np.int64)
    for ch in range(NCH):
        sy, sx = origins(step, ch, tool.H, tool.W, h)
        for y, x in zip(sy // 8, sx // 128):
            cells[y:y + h // 8, x:x + SLAB_W // 128] = True
    return int(cells.sum()) * 8 * 128 * 4 * tool.C


def phase_dma_layouts(state):
    """The slab-load probe (K4): the kernel against its plain version on the
    full source and grid at both layouts and every slab height, and at
    short grids, whose last steps have other origins; then the probe's
    entry point with the launch counts reset before it and read after it.
    bound_ms is the source bytes the slabs cover over the memory rate (the
    function must read them once; every reread may come from L2), and
    slab_hbm_ms the slab bytes over that rate. The L2 ceiling, timed warm
    after the entry point, is what the probe is held to: its slabs all
    come from L2."""
    import torch
    from imagestitch_tpu_torch.ops import cuda_slab_probe
    from imagestitch_tpu_torch.ops.slab_probe import (NCH, STEPS,
                                                      slab_probe_plain)
    from imagestitch_tpu_torch.tools import exp_dma_layouts as tool
    planar, tiled = tool.source("cuda")
    srcs = {"planar": planar, "tiled": tiled}
    cases = {}
    for h in tool.HS:
        for layout, src in srcs.items():
            is_t = layout == "tiled"
            k = cuda_slab_probe.slab_probe_cuda(src, h, is_t)
            p = slab_probe_plain(src, h, is_t)
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            check(torch.equal(k, p), f"slab probe h={h} {layout}: kernel "
                  f"differs from plain, max error {err}")
            plain = cuda_ms(lambda: slab_probe_plain(src, h, is_t), iters=3,
                            warmup=1)
            for steps in range(1, 17):
                ks = cuda_slab_probe.slab_probe_cuda(src, h, is_t, steps)
                ps = slab_probe_plain(src, h, is_t, steps)
                check(torch.equal(ks, ps), f"slab probe h={h} {layout} "
                      f"steps={steps}: kernel differs from plain")
            cases[(h, layout)] = {"max_abs_err": err, "plain_ms": plain,
                                  "checksum": float(p.double().sum()),
                                  "short_grids_equal": 16}

    reps = 20
    _reset_counts()
    rows = tool.run("cuda", reps=reps)
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 0, "sift_octave_maps": 0, "warp_batched": 0,
            "slab_probe": len(rows) * (3 + 2 * reps)}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")

    ceiling = {h: tool.ceilings(planar, int(tool.slab_gb(h) * 1e9), reps)
               for h in tool.HS}

    out = []
    for r in rows:
        c = cases[(r["h"], r["layout"])]
        check(r["checksum"] == c["checksum"], f"entry point h={r['h']} "
              f"{r['layout']}: sum {r['checksum']} vs plain {c['checksum']}")
        slab = tool.slab_gb(r["h"], STEPS) * 1e9
        uniq = _covered_bytes(r["h"], STEPS)
        # one float32 add per element of each slab's (8, 128) block
        b_ms, b_by = bound_ms(uniq, STEPS * NCH * 8 * 128)
        ceil = ceiling[r["h"]]
        out.append({**r, **c, **ceil, "bound_ms": b_ms, "bound_by": b_by,
                    "unique_mb": uniq / 1e6,
                    "slab_hbm_ms": slab / HBM_BYTES_PER_S * 1e3,
                    "blocks": cuda_slab_probe.probe_blocks(planar.device,
                                                           STEPS),
                    "l2_share_warm": slab / r["warm_ms"] / 1e9
                    / ceil["l2_ceiling_tbps"],
                    "l2_share_cold": slab / r["cold_ms"] / 1e9
                    / ceil["l2_ceiling_tbps"]})
    # the kernels line: the warp's slab height (48) on its planar source,
    # with L2 flushed
    main = next(o for o in out if o["h"] == 48 and o["layout"] == "planar")
    state["k4"] = {
        "name": "slab_probe", "route": "cuda",
        "source": "imagestitch_tpu_torch/csrc/slab_probe.cu",
        "replaces": "tools/exp_dma_layouts.py:93",
        "launches": launches["slab_probe"],
        "max_abs_err": max(o["max_abs_err"] for o in out),
        "ms": main["cold_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "case": "h=48 planar, L2 flushed",
        "warm_ms": main["warm_ms"], "slab_hbm_ms": main["slab_hbm_ms"],
        "l2_ceiling_ms": main["l2_ceiling_ms"]}
    emit({"phase": "dma_layouts", "steps": STEPS, "launches": launches,
          "cases": out, "card": state["name"], "smi": state["smi"]})


def _card_vs_cpu(name, config=None):
    """A 192x256 rotation pair stitched on the card and on the CPU with the
    same RANSAC draws: both h_valid, equal keypoint counts, focal within
    1e-3, pano within 1 intensity on average."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair
    img1, img2, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    pc, mc = stitch_pair(img1, img2, config, seed=0, device="cuda",
                         draws=draws)
    pp, mp = stitch_pair(img1, img2, config, seed=0, device="cpu",
                         draws=draws)
    check(mc["h_valid"] and mp["h_valid"], "h_valid false on the small pair")
    check((mc["kpts1"], mc["kpts2"]) == (mp["kpts1"], mp["kpts2"]),
          f"keypoints card {mc['kpts1']}, {mc['kpts2']} vs CPU "
          f"{mp['kpts1']}, {mp['kpts2']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"focal card {mc['focal']} vs CPU {mp['focal']}")
    check(pc.shape == pp.shape, f"pano {pc.shape} vs CPU {pp.shape}")
    diff = np.abs(pc.astype(np.float64) - pp.astype(np.float64))
    check(diff.mean() < 1.0, f"pano mean abs diff {diff.mean()}")
    emit({"phase": name, "shape": list(pc.shape),
          "focal_card": mc["focal"], "focal_cpu": mp["focal"],
          "kpts": [mc["kpts1"], mc["kpts2"], mp["kpts1"], mp["kpts2"]],
          "matches": [mc["num_matches"], mp["num_matches"]],
          "inliers": [mc["num_inliers"], mp["num_inliers"]],
          "pano_mean_abs_diff": float(diff.mean())})


def phase_reference(state):
    _card_vs_cpu("reference")


def phase_sift_reference(state):
    from imagestitch_tpu_torch import DetectorConfig, PipelineConfig
    _card_vs_cpu("sift_reference",
                 PipelineConfig(detector=DetectorConfig(kind="sift")))


def _wrappers():
    from imagestitch_tpu_torch.ops import (cuda_crop, cuda_detect, cuda_dp,
                                           cuda_lm, cuda_sift,
                                           cuda_slab_probe, cuda_warp)
    return {"detect_maps": cuda_detect, "sift_octave_maps": cuda_sift,
            "warp_batched": cuda_warp, "slab_probe": cuda_slab_probe,
            "lm_bundle": cuda_lm, "dp_seam": cuda_dp, "crop_u8": cuda_crop}


def _reset_counts():
    for mod in _wrappers().values():
        mod.launch_count = 0


def _read_counts():
    return {name: mod.launch_count for name, mod in _wrappers().items()}


def _matches(launches, want):
    """Whether the launches of the kernels `want` names are as it says
    (the other kernels are only recorded)."""
    return all(launches[name] == n for name, n in want.items())


KERNEL_KEYS = {"k1": "detect_maps", "k2": "warp_batched",
               "k3": "sift_octave_maps", "k4": "slab_probe",
               "lm": "lm_bundle", "dp": "dp_seam", "crop": "crop_u8"}


def _record_path(state, path, launches):
    """Each kernel's launches on one path, counted from 0 before the path
    was driven and read right after."""
    for key, name in KERNEL_KEYS.items():
        state.setdefault(key, {}).setdefault(
            "launches_by_path", {})[path] = launches[name]


def _warm_walls(fn, n: int = 5):
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    return walls


def phase_main_path(state):
    import numpy as np
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    img1, img2, _, f_true = state["rot"]
    t1, t2, shift = synthetic_pair(1080, 1920)
    pairs = [("rotation", img1, img2), ("translation", t1, t2)]

    _reset_counts()
    results = {name: stitch_pair(a, b) for name, a, b in pairs}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2 * len(pairs), "sift_octave_maps": 0,
            "warp_batched": len(pairs), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    state["k1"]["launches"] = launches["detect_maps"]
    state["k2"]["launches"] = launches["warp_batched"]
    state["k4"]["launches_stitching"] = launches["slab_probe"]
    _record_path(state, "main_path", launches)
    state["lm"]["launches"] = launches["lm_bundle"]
    state["dp"]["launches"] = launches["dp_seam"]
    state["crop"]["launches"] = launches["crop_u8"]

    summary = _check_pairs(results, f_true, shift)
    walls = _warm_walls(lambda: stitch_pair(img1, img2))
    emit({"phase": "main_path", "launches": launches, "pairs": summary,
          "wall_ms_median": walls[len(walls) // 2], "wall_ms": walls,
          "card": state["name"], "smi": state["smi"]})


def _check_pairs(results, f_true, shift):
    """h_valid and a textured pano on every pair; the rotation pair's focal
    within 5% of the truth and its views' warped offset within 10% of
    focal x 10 degrees; the translation pair's pano width within 10% of
    1920 + shift."""
    import numpy as np
    summary = {}
    for name, (pano, m) in results.items():
        check(m["h_valid"], f"{name}: h_valid false")
        check(pano.dtype == np.uint8 and pano.ndim == 3, f"{name}: pano")
        check(pano.shape[1] > 1920, f"{name}: pano width {pano.shape[1]}")
        check(pano.std() > 20, f"{name}: flat pano")
        roi = np.asarray(m["roi_uv"])
        du = 0.5 * ((roi[1, 0] + roi[1, 2]) - (roi[0, 0] + roi[0, 2]))
        summary[name] = {"pano": list(pano.shape), "focal": m["focal"],
                         "kpts": [m["kpts1"], m["kpts2"]],
                         "matches": m["num_matches"],
                         "inliers": m["num_inliers"], "warped_du": du}
    rot = summary["rotation"]
    check(abs(rot["focal"] - f_true) / f_true < 0.05,
          f"rotation focal {rot['focal']} vs {f_true}")
    # the views are 10 degrees of yaw apart: on the cylinder their centres
    # lie focal x 10° apart (the sign follows the rotation's direction)
    du_true = f_true * np.deg2rad(10.0)
    check(abs(abs(rot["warped_du"]) - du_true) < 0.1 * du_true,
          f"rotation warped offset {rot['warped_du']} vs {du_true}")
    tw = summary["translation"]["pano"][1]
    check(abs(tw - (1920 + shift)) < 0.1 * (1920 + shift),
          f"translation pano width {tw} vs {1920 + shift}")
    return summary


def _sift_configs():
    from imagestitch_tpu_torch import (DetectorConfig, PipelineConfig,
                                       WarpConfig)
    sift = DetectorConfig(kind="sift")
    return (PipelineConfig(detector=sift),
            PipelineConfig(detector=sift, warp=WarpConfig(kind="plane")))


def phase_sift_path(state):
    """stitch_pair with the SIFT detector: the rotation pair with the
    cylindrical warp, and bench.py's SIFT configuration (plane warp) on
    synthetic_pair(1080, 1920, overlap=0.4, seed=1)."""
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    img1, img2, _, f_true = state["rot"]
    t1, t2, shift = synthetic_pair(1080, 1920, overlap=0.4, seed=1)
    state["sift_pair"] = (t1, t2)
    cyl, plane = _sift_configs()
    runs = [("rotation", img1, img2, cyl), ("translation", t1, t2, plane)]

    from imagestitch_tpu_torch.ops.cuda_sift import cuda_launches
    _reset_counts()
    n0 = cuda_launches()
    results = {name: stitch_pair(a, b, c) for name, a, b, c in runs}
    torch.cuda.synchronize()
    launches = _read_counts()
    k3_cuda = cuda_launches() - n0
    want = {"detect_maps": 0, "sift_octave_maps": 8 * len(runs),
            "warp_batched": len(runs), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    check(k3_cuda == K3_CUDA_LAUNCHES_PER_STITCH * len(runs),
          f"{k3_cuda} K3 CUDA launches in {len(runs)} stitches")
    state["k3"]["launches"] = launches["sift_octave_maps"]
    state["k4"]["launches_stitching"] += launches["slab_probe"]
    _record_path(state, "sift_path", launches)

    summary = _check_pairs(results, f_true, shift)
    walls = _warm_walls(lambda: stitch_pair(t1, t2, plane))
    emit({"phase": "sift_path", "launches": launches,
          "k3_cuda_launches": k3_cuda, "pairs": summary,
          "timed": "translation, plane warp",
          "wall_ms_median": walls[len(walls) // 2], "wall_ms": walls,
          "card": state["name"], "smi": state["smi"]})


# bench.py's chain configurations: (name, views, height, width)
CHAIN_CASES = (("chain8_1080p", 8, 1080, 1920), ("chain4_cyl", 4, 480, 640))


def phase_chain_reference(state):
    """A 4-view 160x224 chain on the card and on the CPU with the same
    RANSAC draws per pair, without bundle adjustment: on a near-pure
    translation the adjuster walks a flat valley where float32 rounding
    moves its stop by percents (ROADMAP Queue C), so both sides hold the
    chained cameras."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import CameraConfig, PipelineConfig
    from imagestitch_tpu_torch.pipeline import (set_full_precision,
                                                stitch_chain_impl)
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    views, _ = synthetic_sequence(4, 160, 224, overlap=0.5, seed=9)
    g = torch.Generator().manual_seed(2)
    draws = {(i, i + 1): (torch.rand((2048, 4), generator=g),
                          torch.rand((256, 4), generator=g))
             for i in range(3)}
    cfg = PipelineConfig(camera=CameraConfig(ba_refine=False))
    set_full_precision()
    out = {}
    for dev in ("cuda", "cpu"):
        imgs = torch.as_tensor(np.stack(views), device=dev)
        p, v, c, m = stitch_chain_impl(imgs, cfg, draws)
        out[dev] = (p.cpu().numpy(), v.cpu().numpy(), c.cpu().numpy(),
                    {k: x.cpu().numpy() for k, x in m.items()})
    (pc, vc, cc, mc), (pp, vp, cp, mp) = out["cuda"], out["cpu"]
    for k in ("num_inliers", "h_valid", "reachable"):
        check(np.array_equal(mc[k], mp[k]), f"chain {k}: card {mc[k]} vs "
              f"CPU {mp[k]}")
    check(bool(mc["h_valid"].all() and mc["reachable"].all()),
          f"chain h_valid {mc['h_valid']}, reachable {mc['reachable']}")
    check(np.array_equal(cc, cp), f"chain corner card {cc} vs CPU {cp}")
    rel = abs(float(mc["focal"]) - float(mp["focal"])) / float(mp["focal"])
    check(rel < 1e-3, f"chain focal card {mc['focal']} vs CPU {mp['focal']}")
    iou = float((vc & vp).sum() / max((vc | vp).sum(), 1))
    check(iou >= 0.999, f"chain valid-mask IoU {iou}")
    both = vc & vp
    emit({"phase": "chain_reference", "canvas": list(vc.shape),
          "focal_card": float(mc["focal"]), "focal_cpu": float(mp["focal"]),
          "inliers": [mc["num_inliers"].tolist(), mp["num_inliers"].tolist()],
          "corner": cc.tolist(), "iou": iou,
          "canvas_mean_abs_diff": float(np.abs(pc[both] - pp[both]).mean())})


def phase_chain_path(state):
    """stitch_chain on chain8_1080p and chain4_cyl with the launch counts
    reset before and read after; then K1 at B = 8 and K2 into the 8-view
    canvas against their plain versions at those shapes."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import stitch_chain
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    seqs = {name: synthetic_sequence(n, h, w, overlap=0.5, seed=7)
            for name, n, h, w in CHAIN_CASES}
    _reset_counts()
    results = {name: stitch_chain(views) for name, (views, _) in seqs.items()}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": len(seqs), "sift_octave_maps": 0,
            "warp_batched": len(seqs), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "chain_path", launches)

    summary = {}
    for name, n, h, w in CHAIN_CASES:
        views, shift = seqs[name]
        pano, m = results[name]
        check(all(m["h_valid"]), f"{name}: h_valid {m['h_valid']}")
        check(all(m["reachable"]), f"{name}: reachable {m['reachable']}")
        check(pano.dtype == np.uint8 and pano.std() > 20, f"{name}: pano")
        want_w = w + (n - 1) * shift
        check(abs(pano.shape[1] - want_w) < 0.1 * want_w,
              f"{name}: pano width {pano.shape[1]} vs {want_w}")
        walls = _warm_walls(lambda v=views: stitch_chain(v), 3)
        summary[name] = {"pano": list(pano.shape), "want_width": want_w,
                         "focal": m["focal"], "inliers": m["num_inliers"],
                         "canvas_overflow": m["canvas_overflow"],
                         "wall_ms_median": walls[1], "wall_ms": walls,
                         "first_ms": m["stitch_chain_total"]}
    stages = _chain_stages(seqs["chain8_1080p"][0], 3)
    k1, state["k1_chain_call"] = _hold_k1_batch(seqs["chain8_1080p"][0])
    state["k1"]["chain8"] = k1
    k2 = _hold_k2_chain(state, seqs["chain8_1080p"][0])
    emit({"phase": "chain_path", "launches": launches, "chains": summary,
          "chain8_stages_ms": stages, "k1_b8": k1, "k2_chain8": k2,
          "card": state["name"], "smi": state["smi"]})


def _chain_stages(views, n_warm: int):
    """Wall ms of each stage of one default-config stitch_chain
    (synchronized between stages, median of `n_warm` runs after a first
    one): the steps of pipeline.register_chain and stitch_chain_impl."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.config import PipelineConfig
    from imagestitch_tpu_torch.features import detect_batched
    from imagestitch_tpu_torch.matching.matcher import match_pairs
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    from imagestitch_tpu_torch.types import stack
    cfg = PipelineConfig()
    n = len(views)
    h, w = views[0].shape[:2]
    pairs = [(i, i + 1) for i in range(n - 1)]

    def one(marks):
        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        mark("start")
        imgs = torch.as_tensor(np.stack(views), device="cuda").float()
        mark("upload")
        feats = detect_batched(rgb_to_gray(imgs), cfg.detector)
        mark("detect")
        mis = stack(match_pairs(feats, pairs, cfg.matcher, cfg.ransac,
                                generator=gen))
        mark("match_ransac")
        sizes = torch.tensor([[h, w]] * n, dtype=torch.int32, device="cuda")
        cams = P.estimate_cameras(mis.H, mis.h_valid, sizes)
        cams = P._adjust(cams, feats, mis, pairs,
                         (mis.confidence > 1.0) & mis.h_valid, cfg)
        mark("cameras_ba")
        scale = P.warp_scale(cams)
        canvas = P._pano_canvas_shape((h, w), n, cfg)
        warped, masks, _, _, _ = P._warp_all_shared(imgs, cams, scale,
                                                    canvas, cfg)
        mark("warp")
        warped = P._apply_exposure(warped, masks, cfg)
        mark("exposure")
        pano, valid = P._seam_and_blend(warped, masks, cfg, w, h)
        mark("seam_blend")
        P._to_uint8(pano, valid)
        mark("readback_crop")

    runs = []
    for _ in range(n_warm + 1):
        marks = []
        one(marks)
        runs.append({marks[i][0]: (marks[i][1] - marks[i - 1][1]) * 1e3
                     for i in range(1, len(marks))})
    runs = runs[1:]
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    return {"ms": stages, "total_ms": sum(stages.values())}


def _hold_k1_batch(views):
    """K1 in one launch for the views' five levels against the plain
    version (phase detect's tolerances). Returns (the numbers: shapes,
    errors, wrapper and plain ms, bound; the call, which phase
    kernel_times times alone)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    gray = rgb_to_gray(torch.as_tensor(np.stack(views)).cuda().float())
    return _hold_k1_levels(build_pyramid(gray, 5, 1.3))


def _hold_k1_levels(levels):
    """K1 in one launch for these (B, H_l, W_l) pyramid levels against the
    plain version (`_hold_k1_batch`'s numbers and call)."""
    from imagestitch_tpu_torch.ops.cuda_detect import (detect_maps_levels,
                                                       detect_maps_plain)
    levels = [lv.contiguous() for lv in levels]
    worst = {"nms": 0.0, "harris": 0.0, "harris_rel": 0.0, "blur": 0.0}
    for lv, k in zip(levels, detect_maps_levels(levels, 20.0)):
        _hold_detect(k, detect_maps_plain(lv, 20.0), tuple(lv.shape), worst)

    def call():
        return detect_maps_levels(levels, 20.0)

    px = sum(lv.numel() for lv in levels)
    b_ms, b_by = bound_ms(16.0 * px, DETECT_OPS_PER_PX * px)
    out = {"views": levels[0].shape[0],
           "shapes": [list(lv.shape) for lv in levels],
           "max_abs_err": worst, "wrapper_ms": cuda_ms(call),
           "plain_ms": cuda_ms(lambda: [detect_maps_plain(lv, 20.0)
                                        for lv in levels], iters=3, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": 16.0 * px}
    return out, call


def _hold_k2_chain(state, views):
    """K2 into the 8-view chain canvas, cameras from registering the chain
    on the card, against the plain version (phase warp's tolerances), with
    its times (`_hold_k2`)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch.config import PipelineConfig
    from imagestitch_tpu_torch.pipeline import (
        _pano_canvas_shape, register_chain, set_full_precision, warp_inputs,
        warp_scale)
    set_full_precision()
    dev = torch.device("cuda")
    cfg = PipelineConfig()
    n = len(views)
    h, w = views[0].shape[:2]
    imgs = torch.as_tensor(np.stack(views), device=dev).float().contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _, _, cams, _ = register_chain(imgs, cfg, generator=gen)
    scale = warp_scale(cams)
    canvas = _pano_canvas_shape((h, w), n, cfg)
    k_rinvs, corner, roi_uvs, overflow = warp_inputs(cams, scale, (h, w), n,
                                                     canvas, cfg)
    out = _hold_k2("chain8_1080p", imgs, k_rinvs, scale, corner.expand(n, 2),
                   roi_uvs, canvas, "cylindrical")
    out["canvas_overflow"] = bool(overflow)
    state["k2"]["chain8"] = {k: out[k] for k in (
        "canvas", "max_abs_err", "ms", "warm_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")}
    return out


def _hold_k2(case, imgs, k_rinvs, scale, corners, roi_uvs, canvas, kind):
    """K2 on these inputs against its plain version (`_compare_warp`), then
    the kernel alone with L2 flushed (ms) and warm, the plain version, and
    F.grid_sample on precomputed maps with L2 flushed (library_ms)."""
    import torch
    from imagestitch_tpu_torch.ops.cuda_warp import warp_launcher
    from imagestitch_tpu_torch.utils.timing import FLUSH_BYTES, median_ms
    from imagestitch_tpu_torch.warp.warper import warp_batched_plain
    res = _compare_warp(case, imgs, k_rinvs, scale, corners, roi_uvs,
                        canvas, kind)
    launch, _, _ = warp_launcher(imgs, k_rinvs, scale, corners, roi_uvs,
                                 canvas, kind)
    dev = imgs.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cold = median_ms(launch, N_TIMED, dev, flush)
    lib = _grid_sample_call(imgs, k_rinvs, scale, corners, canvas, kind)
    lib_cold = median_ms(lib, N_TIMED, dev, flush)
    del flush, lib
    warm = cuda_ms(launch)
    plain = cuda_ms(lambda: warp_batched_plain(
        imgs, k_rinvs, scale, corners, roi_uvs, canvas, kind),
        iters=2, warmup=1)
    n = imgs.shape[0]
    Hc, Wc = canvas
    nbytes = imgs.numel() * 4 + n * Hc * Wc * (3 * 4 + 1)
    b_ms, b_by = bound_ms(nbytes, n * (WARP_OPS_PER_PX * Hc * Wc
                                       + WARP_OPS_PER_LINE * (Hc + Wc)))
    return {**res, "views": n, "ms": cold, "warm_ms": warm,
            "plain_ms": plain, "library_ms": lib_cold, "bound_ms": b_ms,
            "bound_by": b_by, "output_gb": n * Hc * Wc * 13 / 1e9,
            "input_gb": imgs.numel() * 4 / 1e9}


def phase_stitcher_path(state):
    """stitch() on a 4-view 1080p sequence; Stitcher on a mixed-size 3-view
    480x640 sequence and on a 2x2 480x640 grid (canvas height 1.8x: the
    grid's pano is 1.5x a view's height), launch counts reset before and
    read after; then 3 warm 1080p stitches with their stage times."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import (PipelineConfig, Stitcher, WarpConfig,
                                       stitch)
    from imagestitch_tpu_torch.utils.io import (synthetic_grid,
                                                synthetic_sequence)
    seq4, shift4 = synthetic_sequence(4, 1080, 1920, overlap=0.5, seed=7)
    seq3, shift3 = synthetic_sequence(3, 480, 640, overlap=0.7, seed=11)
    seq3[1] = np.ascontiguousarray(seq3[1][:432, :600])
    grid, sx, sy = synthetic_grid(2, 2, 480, 640)
    grid_cfg = PipelineConfig(warp=WarpConfig(canvas_scale_h=1.8))
    runs = {"seq4_1080p": lambda: stitch(seq4),
            "mixed3_480p": lambda: Stitcher().stitch(seq3),
            "grid2x2_480p": lambda: Stitcher(grid_cfg).stitch(grid)}
    _reset_counts()
    results = {name: fn() for name, fn in runs.items()}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": len(runs), "sift_octave_maps": 0,
            "warp_batched": len(runs), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "stitcher_path", launches)

    extents = {"seq4_1080p": (1920 + 2 * shift4, 0),
               "mixed3_480p": (640 + shift3, 0),
               "grid2x2_480p": (640 + 0.6 * sx, 480 + 0.6 * sy)}
    summary = {}
    for name, (pano, m) in results.items():
        check(all(m["reachable"]), f"{name}: reachable {m['reachable']}")
        check(pano.dtype == np.uint8 and pano.std() > 20, f"{name}: pano")
        min_w, min_h = extents[name]
        check(pano.shape[1] > min_w and pano.shape[0] > min_h,
              f"{name}: pano {pano.shape[:2]}, want more than "
              f"{min_h} x {min_w}")
        summary[name] = {"pano": list(pano.shape), "focal": m["focal"],
                         "pair_confidences": m["pair_confidences"],
                         "canvas_overflow": m["canvas_overflow"]}
    walls, stages = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = stitch(seq4)
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append({k: v for k, v in m.items() if k in STAGES})
    order = sorted(range(3), key=walls.__getitem__)
    emit({"phase": "stitcher_path", "launches": launches, "runs": summary,
          "timed": "seq4_1080p", "wall_ms_median": walls[order[1]],
          "wall_ms": sorted(walls),
          "stages_ms": {k: float(np.median([st[k] for st in stages]))
                        for k in STAGES},
          "card": state["name"], "smi": state["smi"]})


def _golden(name, pano, valid, corner, m, meta, gold):
    """tests/test_golden.py's tolerances against the committed golden of
    the photo pair: focal within 2%, inliers >= 0.7x, corner and bbox
    within 8 px, PSNR > 30 dB on the 4x box-downsampled pano."""
    import numpy as np

    def box(img):
        h, w = img.shape[0] // 4 * 4, img.shape[1] // 4 * 4
        img = img[:h, :w].astype(np.float32)
        return img.reshape(h // 4, 4, w // 4, 4, -1).mean(axis=(1, 3))

    ys, xs = np.nonzero(valid)
    bbox = [int(ys.min()), int(xs.min()), int(ys.max()) + 1,
            int(xs.max()) + 1]
    down = box(pano[bbox[0]:bbox[2], bbox[1]:bbox[3]])
    vdown = box(valid[bbox[0]:bbox[2], bbox[1]:bbox[3], None].astype(
        np.float32))[..., 0]
    h = min(down.shape[0], gold.shape[0])
    w = min(down.shape[1], gold.shape[1])
    both = vdown[:h, :w] > 0.99
    mse = float(np.mean((down[:h, :w][both] - gold[:h, :w][both]) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    focal, inl = float(m["focal"]), int(m["num_inliers"])
    check(bool(m["h_valid"]), f"{name}: h_valid false")
    check(abs(focal - meta["focal"]) / meta["focal"] < 0.02,
          f"{name}: focal {focal} vs golden {meta['focal']}")
    check(inl >= int(0.7 * meta["num_inliers"]),
          f"{name}: {inl} inliers vs golden {meta['num_inliers']}")
    check(max(abs(int(corner[0]) - meta["corner"][0]),
              abs(int(corner[1]) - meta["corner"][1])) <= 8,
          f"{name}: corner {corner.tolist()} vs golden {meta['corner']}")
    check(max(abs(a - b) for a, b in zip(bbox, meta["bbox"])) <= 8,
          f"{name}: bbox {bbox} vs golden {meta['bbox']}")
    check(both.mean() > 0.8 and psnr > 30.0, f"{name}: PSNR {psnr}")
    return {"focal": focal, "inliers": inl, "corner": corner.tolist(),
            "bbox": bbox, "psnr_db": psnr}


def phase_photo_reference(state):
    """stitch_pair_impl (the default configuration) on the real-photo
    rotation pair, on the card and on the CPU with the same RANSAC draws:
    both held to the JAX package's committed golden
    (tests/data/golden_photo_pano.{png,json}) and to each other (equal
    counts and corner, focal within 1e-3, valid-mask IoU >= 0.999, pano
    within 1 intensity on average where both are valid)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig
    from imagestitch_tpu_torch.pipeline import (set_full_precision,
                                                stitch_pair_impl)
    from imagestitch_tpu_torch.utils.io import imread, photo_rotation_pair
    data = os.path.join(HERE, "tests", "data")
    with open(os.path.join(data, "golden_photo_pano.json")) as f:
        meta = json.load(f)
    gold = imread(os.path.join(data, "golden_photo_pano.png")).astype(
        np.float32)
    a, b, _, f_true = photo_rotation_pair()
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    set_full_precision()
    out, held = {}, {}
    for dev in ("cuda", "cpu"):
        p, v, c, m = stitch_pair_impl(torch.as_tensor(a, device=dev),
                                      torch.as_tensor(b, device=dev),
                                      PipelineConfig(), draws)
        out[dev] = (p.cpu().numpy(), v.cpu().numpy(), c.cpu().numpy(),
                    {k: x.cpu().numpy() for k, x in m.items()})
        held[dev] = _golden(f"photo {dev}", *out[dev], meta, gold)
    (pc, vc, cc, mc), (pp, vp, cp, mp) = out["cuda"], out["cpu"]
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers"):
        check(int(mc[k]) == int(mp[k]), f"photo {k}: card {mc[k]} vs CPU "
              f"{mp[k]}")
    check(np.array_equal(cc, cp), f"photo corner card {cc} vs CPU {cp}")
    rel = abs(float(mc["focal"]) - float(mp["focal"])) / float(mp["focal"])
    check(rel < 1e-3, f"photo focal card {mc['focal']} vs CPU {mp['focal']}")
    iou = float((vc & vp).sum() / max((vc | vp).sum(), 1))
    both = vc & vp
    diff = float(np.abs(pc[both] - pp[both]).mean())
    check(iou >= 0.999 and diff < 1.0, f"photo IoU {iou}, diff {diff}")
    emit({"phase": "photo_reference", "golden": meta, "card": held["cuda"],
          "cpu": held["cpu"], "f_true": f_true, "iou": iou,
          "canvas_mean_abs_diff": diff})


def phase_multiband_path(state):
    """bench.py's configs[2]: the DP colour seam and a 5-band multi-band
    blend on synthetic_pair(1080, 1920, overlap=0.4, seed=0) through
    stitch_pair: launches (detector maps 2, warp 1), h_valid, the pano's
    width, the median of 5 warm stitches and the stage split; then card
    against CPU at 192x256 with 3 bands."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import (BlendConfig, PipelineConfig,
                                       SeamConfig, stitch_pair)
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    cfg = PipelineConfig(seam=SeamConfig(kind="dp_color"),
                         blend=BlendConfig(kind="multiband", num_bands=5))
    i1, i2, shift = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    _reset_counts()
    pano, m = stitch_pair(i1, i2, cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "multiband_path", launches)
    check(m["h_valid"], "multiband: h_valid false")
    check(pano.dtype == np.uint8 and pano.std() > 20, "multiband: pano")
    check(abs(pano.shape[1] - (1920 + shift)) < 0.1 * (1920 + shift),
          f"multiband pano width {pano.shape[1]} vs {1920 + shift}")
    walls = _warm_walls(lambda: stitch_pair(i1, i2, cfg))
    stages = _stage_breakdown(i1, i2, cfg, 3, trace=False)
    _card_vs_cpu("multiband_reference", PipelineConfig(
        blend=BlendConfig(kind="multiband", num_bands=3)))
    emit({"phase": "multiband_path", "launches": launches,
          "pano": list(pano.shape), "focal": m["focal"],
          "inliers": m["num_inliers"], "wall_ms_median": walls[2],
          "wall_ms": walls, "stages": stages, "card": state["name"],
          "smi": state["smi"]})


STREAM_FRAMES = 10


def phase_stream_path(state):
    """StreamStitcher: calibrate on the 4-view 1080x1920 sequence of phase
    stitcher_path (canvas 1458x8256), then compose 10 frame sets
    brightened by 12-21: calibrate's wall ms and launches (detector maps 1,
    warp 1), compose of the calibration frames within 1.0 mean of the
    calibration pano, each brightened set brighter in the same shape,
    launches per compose (detector maps 0, warp 1), the median compose ms
    and its split. Then card against CPU with the default configuration
    (bundle adjustment on) on a panning camera's four 160x224 views."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import StreamStitcher
    from imagestitch_tpu_torch.matching.matcher import pair_list
    from imagestitch_tpu_torch.utils.io import (synthetic_pan_sequence,
                                                synthetic_sequence)
    seq4, shift4 = synthetic_sequence(4, 1080, 1920, overlap=0.5, seed=7)
    ss = StreamStitcher()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pano_cal, m = ss.calibrate(seq4)
    cal_ms = (time.perf_counter() - t0) * 1e3
    cal_launches = _read_counts()
    want = {"detect_maps": 1, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(cal_launches, want), f"calibrate launches {cal_launches}, "
          f"want {want}")
    _record_path(state, "stream_calibrate", cal_launches)
    cal_stages = dict(ss.stages_ms)
    check(all(m["reachable"]), f"stream reachable {m['reachable']}")
    check(pano_cal.shape[1] > 1920 + 2 * shift4 and pano_cal.std() > 20,
          f"stream calibration pano {pano_cal.shape}")
    canvas = ss.frozen("canvas_hw")
    check(tuple(canvas) == (1458, 8256), f"stream canvas {canvas}")
    same = ss.compose(seq4)
    gate = float(np.abs(same.astype(np.float64) - pano_cal).mean()) \
        if same.shape == pano_cal.shape else float("inf")
    check(gate < 1.0, f"compose of the calibration frames: {same.shape} vs "
          f"{pano_cal.shape}, mean abs diff {gate}")

    frames = [[np.clip(v.astype(np.int32) + 12 + k, 0, 255).astype(np.uint8)
               for v in seq4] for k in range(STREAM_FRAMES)]
    _reset_counts()
    walls, splits = [], []
    for fr in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = ss.compose(fr)
        walls.append((time.perf_counter() - t0) * 1e3)
        splits.append(dict(ss.stages_ms))
        check(p.shape == pano_cal.shape and p.mean() > pano_cal.mean(),
              f"brightened compose {p.shape}, mean {p.mean()} vs "
              f"{pano_cal.mean()}")
    comp_launches = _read_counts()
    want = {"detect_maps": 0, "sift_octave_maps": 0,
            "warp_batched": STREAM_FRAMES, "slab_probe": 0}
    check(_matches(comp_launches, want), f"{STREAM_FRAMES} composes launched "
          f"{comp_launches}, want {want}")
    _record_path(state, "stream_compose", comp_launches)
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}

    # card against CPU, bundle adjustment on, the same draws per pair
    views = synthetic_pan_sequence(4)
    g = torch.Generator().manual_seed(3)
    draws = {p: (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g)) for p in pair_list(4)}
    pc, mc = StreamStitcher().calibrate(views, draws=draws)
    pp, mp = StreamStitcher(device="cpu").calibrate(views, draws=draws)
    check(mc["reachable"] == mp["reachable"] == [True] * 4,
          f"pan reachable card {mc['reachable']} vs CPU {mp['reachable']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"pan focal card {mc['focal']} vs CPU {mp['focal']}")
    check(pc.shape == pp.shape, f"pan pano {pc.shape} vs CPU {pp.shape}")
    diff = float(np.abs(pc.astype(np.float64) - pp).mean())
    check(diff < 1.0, f"pan pano mean abs diff {diff}")
    walls_sorted = sorted(walls)
    emit({"phase": "stream_path", "canvas": list(canvas),
          "pano": list(pano_cal.shape), "focal": m["focal"],
          "calibrate_ms": cal_ms, "calibrate_stages_ms": cal_stages,
          "calibrate_launches": cal_launches,
          "compose_same_mean_abs_diff": gate,
          "compose_ms_median": walls_sorted[len(walls) // 2],
          "compose_ms": walls_sorted, "compose_split_ms": split,
          "compose_launches": comp_launches, "composes": STREAM_FRAMES,
          "pan_card_vs_cpu": {"focal_card": mc["focal"],
                              "focal_cpu": mp["focal"],
                              "pano": list(pc.shape),
                              "pano_mean_abs_diff": diff},
          "card": state["name"], "smi": state["smi"]})


# bench.py's batched shapes (configs[4]): (name, pairs, height, width)
BATCH_CASES = (("pairs8_1080p", 8, 1080, 1920), ("pairs32_vga", 32, 480, 640))


def _batch_split(pairs_np, cfg):
    """Wall ms of each stage of one stitch_pairs_batched call (a
    StageTimer made active, synchronized between stages: upload and the
    stages inside), the second of two runs."""
    import torch
    from imagestitch_tpu_torch.parallel.batch import (
        stitch_pairs_batched_impl)
    from imagestitch_tpu_torch.utils.log import StageTimer
    for _ in range(2):
        timer = StageTimer("cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with timer.active():
            with timer.stage("upload"):
                x = torch.as_tensor(pairs_np, device="cuda").float()
            stitch_pairs_batched_impl(x, cfg, generator=gen)
    return timer.summary()


def phase_batched_path(state):
    """stitch_pairs_batched at bench.py's shapes with B copies of one pair
    (synthetic_pair(H, W, overlap=0.4, seed=0)): 8 pairs at 1080x1920 (16
    canvases of 1458x4032) and 32 at 480x640 (64 of 648x1344). Launches per
    batch (detector maps 1, warp 1), every pair h_valid, pairs/s (median
    of 3 calls), the per-pair loop over stitch_pair_impl as the yardstick
    (median of 3), the stage split. Then a batch of distinct pairs at each
    shape (other seeds and overlaps, so other surface scales): K1 on its
    views and K2 on its launch's own inputs (one scale per view) against
    their plain versions, K2 with max error 0; and at 1080p each of the
    first 4 pairs equal to stitch_pair_impl on it with the same draws
    (equal corner and inliers, canvas within 0.5 on average)."""
    import dataclasses
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig, stitch_pairs_batched
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.pipeline import (_pano_canvas_shape,
                                                stitch_pair_impl)
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    cfg = PipelineConfig()
    vert = cfg.replace(seam=dataclasses.replace(cfg.seam, orient="vertical"))
    bench = {}
    for name, b, h, w in BATCH_CASES:
        i1, i2, _ = synthetic_pair(h, w, overlap=0.4, seed=0)
        pair = np.stack([i1, i2])
        bench[name] = np.broadcast_to(pair, (b,) + pair.shape).copy()
    _reset_counts()
    outs = {name: stitch_pairs_batched(p) for name, p in bench.items()}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": len(bench), "sift_octave_maps": 0,
            "warp_batched": len(bench), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "batched", launches)

    summary = {}
    state.setdefault("k1_batched_calls", {})
    for name, b, h, w in BATCH_CASES:
        panos, valids, corners, m = outs[name]
        canvas = _pano_canvas_shape((h, w), 2, cfg)
        check(tuple(panos.shape) == (b,) + tuple(canvas) + (3,),
              f"{name}: panos {tuple(panos.shape)}")
        check(bool(m["h_valid"].all()), f"{name}: h_valid {m['h_valid']}")
        check(bool(torch.isfinite(panos).all()), f"{name}: non-finite pano")
        widths = valids.any(dim=1).sum(dim=1)
        check(bool((widths > w).all()), f"{name}: pano widths {widths}")
        pairs = bench[name]

        def batched(p=pairs):
            out = stitch_pairs_batched(p)
            torch.cuda.synchronize()
            return out

        def loop(p=pairs):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            x = torch.as_tensor(p, device="cuda").float()
            for k in range(x.shape[0]):
                stitch_pair_impl(x[k, 0], x[k, 1], vert, generator=gen)
            torch.cuda.synchronize()

        walls = _warm_walls(batched, 3)
        loop_walls = _warm_walls(loop, 3)
        summary[name] = {
            "pairs": b, "canvas": list(canvas),
            "pairs_per_s": b / (walls[1] / 1e3), "wall_ms_median": walls[1],
            "wall_ms": walls,
            "loop_pairs_per_s": b / (loop_walls[1] / 1e3),
            "loop_wall_ms_median": loop_walls[1], "loop_wall_ms": loop_walls,
            "stages_ms": _batch_split(pairs, vert),
            "focal": m["focal"].tolist(), "inliers": m["num_inliers"].tolist()}
    del outs

    # distinct pairs: K2's own inputs captured from the batch's launch
    k1_held, k2_held, equal = {}, {}, []
    for name, b, h, w in BATCH_CASES:
        pairs = np.stack([np.stack(synthetic_pair(
            h, w, overlap=0.3 + 0.3 * k / b, seed=10 + k)[:2])
            for k in range(b)])
        g = torch.Generator().manual_seed(6)
        draws = {k: (torch.rand((2048, 4), generator=g),
                     torch.rand((256, 4), generator=g)) for k in range(b)}
        seen = []
        inner = P.warp_batched

        def spy(*args, **kw):
            seen.append(args)
            return inner(*args, **kw)

        P.warp_batched = spy
        try:
            panos, valids, corners, m = stitch_pairs_batched(pairs,
                                                             draws=draws)
        finally:
            P.warp_batched = inner
        check(len(seen) == 1, f"{name}: {len(seen)} warp calls")
        imgs, k_rinvs, scale, cn, roi_uvs, canvas, kind = seen[0]
        n_scales = int(torch.unique(scale).numel())
        check(n_scales == b, f"{name}: {n_scales} distinct scales of {b}")
        k2 = _hold_k2(name, imgs, k_rinvs, scale, cn, roi_uvs, canvas, kind)
        check(k2["max_abs_err"] == 0.0, f"{name}: K2 max error "
              f"{k2['max_abs_err']}")
        k2_held[name] = {**k2, "distinct_scales": n_scales}
        views = [v for pair in pairs for v in pair]
        k1_held[name], state["k1_batched_calls"][name] = _hold_k1_batch(
            views)
        if name == "pairs8_1080p":
            x = torch.as_tensor(pairs, device="cuda").float()
            for k in range(min(4, b)):
                p1, v1, c1, m1 = stitch_pair_impl(x[k, 0], x[k, 1], vert,
                                                  draws[k])
                d = float((p1 - panos[k]).abs().mean())
                ok = (torch.equal(c1, corners[k])
                      and int(m1["num_inliers"]) == int(m["num_inliers"][k]))
                check(ok and d < 0.5, f"pair {k}: corner {c1.tolist()} vs "
                      f"{corners[k].tolist()}, inliers "
                      f"{int(m1['num_inliers'])} vs "
                      f"{int(m['num_inliers'][k])}, mean diff {d}")
                equal.append({"pair": k, "mean_abs_diff": d,
                              "bit_equal": bool(torch.equal(p1, panos[k])
                                                and torch.equal(v1,
                                                                valids[k]))})
        del panos, valids, imgs
    state["k1"]["batched"] = k1_held
    state["k2"]["batched"] = {n: {k: v[k] for k in (
        "canvas", "views", "max_abs_err", "ms", "warm_ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by")} for n, v in k2_held.items()}
    emit({"phase": "batched_path", "launches": launches, "bench": summary,
          "distinct_equal_single": equal, "k1": k1_held, "k2": k2_held,
          "card": state["name"], "smi": state["smi"]})


# OpenCV stitching_detailed's defaults (its graph-cut colour seam at
# seam_megapix 0.1 among them); the ramp pair's seam and blend; the
# projectors K2 does not carry (the plain warp serves them, as in the JAX
# package)
EXTENDED_KINDS = ("fisheye", "stereographic", "mercator",
                  "transverseMercator", "compressedPlaneA2B1",
                  "compressedPlaneA1.5B1", "paniniA2B1", "paniniA1.5B1")
PAN_FOCAL = 1728.0          # synthetic_pan_sequence(4, 1080, 1920): 0.9 W


def _detailed_config(work_megapix=0.6):
    from imagestitch_tpu_torch import (BlendConfig, CameraConfig,
                                       ExposureConfig, PipelineConfig,
                                       SeamConfig, WarpConfig)
    return PipelineConfig(
        work_megapix=work_megapix,
        camera=CameraConfig(wave_correct=True, wave_kind="horiz"),
        warp=WarpConfig(kind="spherical"),
        exposure=ExposureConfig(kind="gain_blocks"),
        seam=SeamConfig(kind="graphcut", seam_megapix=0.1),
        blend=BlendConfig(kind="multiband"))


def _ramp_config():
    from imagestitch_tpu_torch import BlendConfig, PipelineConfig, SeamConfig
    return PipelineConfig(seam=SeamConfig(kind="dp_colorgrad"),
                          blend=BlendConfig(kind="ramp"))


def _pan_draws(n, seed):
    import torch
    from imagestitch_tpu_torch.matching.matcher import pair_list
    g = torch.Generator().manual_seed(seed)
    return {p: (torch.rand((2048, 4), generator=g),
                torch.rand((256, 4), generator=g)) for p in pair_list(n)}


def _add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _option_pair(name, config, k2_launches, total, interior=False):
    """The 192x256 rotation pair with `config` on the card and on the CPU
    with the same RANSAC draws: both h_valid, equal keypoint counts, focal
    within 1e-3, the card's launches (K1 2, K2 `k2_launches`), the panos
    within 1 intensity on average. With `interior` the crop rectangles
    may differ by 2 px (a mask pixel at the validity boundary can move
    the largest rectangle), and the mean is taken over the common
    top-left region."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair
    img1, img2, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    _reset_counts()
    pc, mc = stitch_pair(img1, img2, config, device="cuda", draws=draws)
    torch.cuda.synchronize()
    launches = _read_counts()
    _add_counts(total, launches)
    want = {"detect_maps": 2, "sift_octave_maps": 0,
            "warp_batched": k2_launches, "slab_probe": 0}
    check(_matches(launches, want),
          f"{name}: launches {launches}, want {want}")
    pp, mp = stitch_pair(img1, img2, config, device="cpu", draws=draws)
    check(mc["h_valid"] and mp["h_valid"], f"{name}: h_valid false")
    check((mc["kpts1"], mc["kpts2"]) == (mp["kpts1"], mp["kpts2"]),
          f"{name}: keypoints card {mc['kpts1']}, {mc['kpts2']} vs CPU "
          f"{mp['kpts1']}, {mp['kpts2']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"{name}: focal card {mc['focal']} vs {mp['focal']}")
    if interior:
        check(all(abs(a - b) <= 2 for a, b in zip(pc.shape, pp.shape)),
              f"{name}: pano {pc.shape} vs CPU {pp.shape}")
        h, w = min(pc.shape[0], pp.shape[0]), min(pc.shape[1], pp.shape[1])
        pc, pp = pc[:h, :w], pp[:h, :w]
    check(pc.shape == pp.shape, f"{name}: pano {pc.shape} vs {pp.shape}")
    diff = float(np.abs(pc.astype(np.float64) - pp).mean())
    check(diff < 1.0, f"{name}: pano mean abs diff {diff}")
    check(pc.std() > 20, f"{name}: flat pano")
    return {"pano": list(pc.shape), "focal_card": mc["focal"],
            "focal_cpu": mp["focal"], "kpts": [mc["kpts1"], mc["kpts2"]],
            "inliers": [mc["num_inliers"], mp["num_inliers"]],
            "pano_mean_abs_diff": diff, "launches": launches}


def phase_options_reference(state):
    """The options of ROADMAP item 13, each on the card against the CPU
    with the same draws: on the 192x256 rotation pair the ramp blend with
    the colour-gradient seam, the Voronoi seam, the CHANNELS and
    CHANNELS_BLOCKS compensators, ORB wta_k 3 and 4, the interior crop
    and each of the eight projectors K2 does not carry (K2 launches 0);
    the reprojection bundle adjuster through Stitcher on a 3-view 192x256
    panning sequence (focal within 1e-3, about 7x the 1.5e-4 measured
    between the card and the CPU: its damped normal matrix has a
    condition number near 1.5e8, so float32 rounding walks its 25 steps
    apart, 4e-4 between the port and JAX on the CPU)."""
    import dataclasses
    import torch
    from imagestitch_tpu_torch import (DetectorConfig, ExposureConfig,
                                       PipelineConfig, SeamConfig, Stitcher,
                                       WarpConfig)
    from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence
    base = PipelineConfig()
    cases = {
        "ramp_colorgrad": (_ramp_config(), 1),
        "voronoi": (base.replace(seam=SeamConfig(kind="voronoi")), 1),
        "channels": (base.replace(exposure=ExposureConfig(kind="channels")),
                     1),
        "channels_blocks": (base.replace(
            exposure=ExposureConfig(kind="channels_blocks")), 1),
        "wta_k3": (base.replace(detector=DetectorConfig(wta_k=3)), 1),
        "wta_k4": (base.replace(detector=DetectorConfig(wta_k=4)), 1),
        "crop_interior": (base.replace(crop="interior"), 1),
    }
    for kind in EXTENDED_KINDS:
        cases[kind] = (base.replace(warp=WarpConfig(kind=kind)), 0)
    total = {}
    out = {name: _option_pair(name, cfg, k2, total,
                              interior=name == "crop_interior")
           for name, (cfg, k2) in cases.items()}

    views = synthetic_pan_sequence(3, 192, 256)
    draws = _pan_draws(3, 4)
    cfg = base.replace(camera=dataclasses.replace(base.camera,
                                                  ba_kind="reproj"))
    _reset_counts()
    pc, mc = Stitcher(cfg).stitch(views, draws=draws)
    torch.cuda.synchronize()
    launches = _read_counts()
    _add_counts(total, launches)
    check(launches["detect_maps"] == 1 and launches["warp_batched"] == 1,
          f"reproj: launches {launches}")
    pp, mp = Stitcher(cfg, device="cpu").stitch(views, draws=draws)
    check(mc["reachable"] == mp["reachable"] == [True] * 3,
          f"reproj: reachable {mc['reachable']} vs {mp['reachable']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"reproj: focal card {mc['focal']} vs {mp['focal']}")
    for ax in (0, 1):
        check(abs(pc.shape[ax] - pp.shape[ax]) <= 0.05 * pp.shape[ax],
              f"reproj: pano {pc.shape} vs {pp.shape}")
    out["ba_reproj_pan3"] = {"pano": list(pc.shape), "pano_cpu":
                             list(pp.shape), "focal_card": mc["focal"],
                             "focal_cpu": mp["focal"], "focal_rel": rel,
                             "launches": launches}
    _record_path(state, "options_reference", total)
    emit({"phase": "options_reference", "cases": out,
          "k2_launches_extended_kinds": {k: out[k]["launches"][
              "warp_batched"] for k in EXTENDED_KINDS},
          "card": state["name"], "smi": state["smi"]})


def phase_detailed_path(state):
    """Stitcher with OpenCV stitching_detailed's defaults (work_megapix
    0.6, horizontal wave correction, spherical warp, GAIN_BLOCKS, the
    graph-cut colour seam at seam_megapix 0.1, multi-band) on a panning
    camera's
    four 1080x1920 views (focal 1728 px, 10 degrees apart): every view
    reachable, the focal within 5% of 1728, the pano's width within 5% of
    the pan's spherical extent (1728 x (30 degrees + 2 atan(960/1728))),
    launches per stitch (K1 1 for the four 581x1033 work views, K2 1 into
    the 4 x 1458x8256 spherical canvas); the median of 3 warm stitches
    and their StageTimer stages. Then K1 at the work-scale batch and K2 on
    its launch's own inputs against their plain versions, timed (K2 with
    grid_sample beside it; K1 alone in phase kernel_times), and the
    configuration on the card against the CPU on three 160x224 views
    (work_megapix 0.02, same draws)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import Stitcher
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence
    views = synthetic_pan_sequence(4, 1080, 1920)
    cfg = _detailed_config()
    st = Stitcher(cfg)
    seen = []
    inner = P.warp_batched

    def spy(*args, **kw):
        seen.append(args)
        return inner(*args, **kw)

    _reset_counts()
    P.warp_batched = spy
    try:
        pano, m = st.stitch(views)
    finally:
        P.warp_batched = inner
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 1, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "detailed_path", launches)
    check(m["reachable"] == [True] * 4, f"reachable {m['reachable']}")
    check(abs(m["focal"] - PAN_FOCAL) < 0.05 * PAN_FOCAL,
          f"focal {m['focal']} vs {PAN_FOCAL}")
    span = PAN_FOCAL * (np.deg2rad(30.0) + 2 * np.arctan(960 / PAN_FOCAL))
    check(abs(pano.shape[1] - span) < 0.05 * span,
          f"pano width {pano.shape[1]} vs the pan's extent {span:.1f}")
    check(pano.dtype == np.uint8 and pano.std() > 20, "detailed: pano")
    check(len(seen) == 1, f"{len(seen)} warp kernel calls")
    imgs, k_rinvs, scale, corners, roi_uvs, canvas, kind = seen[0][:7]
    check(kind == "spherical" and tuple(canvas) == (1458, 8256),
          f"K2 {kind} into {canvas}")

    walls, stages = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, mw = st.stitch(views)
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append({k: v for k, v in mw.items() if k in STAGES})
    order = sorted(range(3), key=walls.__getitem__)

    x = torch.as_tensor(np.stack(views), device="cuda").float()
    ws = P._megapix_scale(cfg.work_megapix, (1080, 1920))
    g = P._work_grays(rgb_to_gray(x), (1080, 1920), ws)
    check(tuple(g.shape) == (4, 581, 1033), f"work views {tuple(g.shape)}")
    k1, state["k1_detailed_call"] = _hold_k1_levels(build_pyramid(
        g, cfg.detector.nlevels, cfg.detector.scale_factor))
    del x, g
    state["k1"]["detailed"] = k1
    k2 = _hold_k2("detailed_4x1080p", imgs, k_rinvs, scale, corners,
                  roi_uvs, canvas, kind)
    state["k2"]["detailed"] = {k: k2[k] for k in (
        "canvas", "views", "max_abs_err", "ms", "warm_ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by")}
    del imgs, seen

    small = synthetic_pan_sequence(3)
    scfg = _detailed_config(0.02)
    draws = _pan_draws(3, 5)
    pc, mc = Stitcher(scfg).stitch(small, draws=draws)
    pp, mp = Stitcher(scfg, device="cpu").stitch(small, draws=draws)
    check(mc["reachable"] == mp["reachable"] == [True] * 3,
          f"small: reachable {mc['reachable']} vs {mp['reachable']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"small: focal card {mc['focal']} vs {mp['focal']}")
    check(pc.shape == pp.shape, f"small: pano {pc.shape} vs {pp.shape}")
    diff = float(np.abs(pc.astype(np.float64) - pp).mean())
    check(diff < 1.0, f"small: pano mean abs diff {diff}")
    emit({"phase": "detailed_path", "launches": launches,
          "pano": list(pano.shape), "focal": m["focal"],
          "pan_extent_px": span, "pair_confidences": m["pair_confidences"],
          "canvas_overflow": m["canvas_overflow"],
          "wall_ms_median": walls[order[1]], "wall_ms": sorted(walls),
          "first_ms": sum(m[k] for k in STAGES if k in m),
          "stages_ms": {k: float(np.median([st_[k] for st_ in stages]))
                        for k in STAGES if k in stages[0]},
          "k1_work_views": k1, "k2_spherical": k2,
          "card_vs_cpu_3x160x224": {"focal_card": mc["focal"],
                                    "focal_cpu": mp["focal"],
                                    "pano": list(pc.shape),
                                    "pano_mean_abs_diff": diff},
          "card": state["name"], "smi": state["smi"]})


def phase_ramp_path(state):
    """stitch_pair with the ramp blend and the colour-gradient DP seam on
    the 1080p rotation pair and on the 40%-overlap 1080p translation pair
    (synthetic_pair(1080, 1920, overlap=0.4, seed=0)): h_valid, the
    rotation pair's focal and warped offset, the translation pair's pano
    width, launches per pair (K1 2, K2 1); the median of 5 warm stitches
    of each and the rotation pair's stage split."""
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    img1, img2, _, f_true = state["rot"]
    t1, t2, shift = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    cfg = _ramp_config()
    runs = [("rotation", img1, img2), ("translation", t1, t2)]
    _reset_counts()
    results = {name: stitch_pair(a, b, cfg) for name, a, b in runs}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2 * len(runs), "sift_octave_maps": 0,
            "warp_batched": len(runs), "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "ramp_path", launches)
    summary = _check_pairs(results, f_true, shift)
    walls = {name: _warm_walls(lambda a=a, b=b: stitch_pair(a, b, cfg))
             for name, a, b in runs}
    stages = _stage_breakdown(img1, img2, cfg, 3, trace=False)
    emit({"phase": "ramp_path", "launches": launches, "pairs": summary,
          "wall_ms_median": {k: w[2] for k, w in walls.items()},
          "wall_ms": walls, "rotation_stages": stages,
          "card": state["name"], "smi": state["smi"]})


def _affine_draws(pairs, seed, p=2):
    """Injected draws of the affine matcher: (2048, p) per pair, one
    pass."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {q: (torch.rand((2048, p), generator=g), None) for q in pairs}


def _hold_split(name, warped, masks, cfg):
    """The host-seam split of the card's canvases against the same split
    of the same canvases moved to the CPU: the device's bbox, marginals,
    decimation, quantization and splice must give equal seam masks, and
    the blends agree within 1e-2 and on the valid mask."""
    import numpy as np
    from imagestitch_tpu_torch import pipeline as P
    pc, vc, sc = P._host_seam_blend(warped, masks, cfg)
    pp, vp, sp = P._host_seam_blend(warped.cpu(), masks.cpu(), cfg)
    sc = sc.cpu().numpy() if hasattr(sc, "cpu") else np.asarray(sc)
    sp = sp.numpy() if hasattr(sp, "numpy") else np.asarray(sp)
    check(np.array_equal(sc, sp), f"{name}: seam masks differ on the "
          f"same canvases ({int((sc != sp).sum())} px)")
    vc = vc.cpu().numpy()
    check(np.array_equal(vc, vp.numpy()), f"{name}: valid masks differ")
    err = float((pc.cpu() - pp).abs().max())
    check(err <= 1e-2, f"{name}: blend card vs CPU max error {err}")
    return {"view0_px": int(sc[0].sum()), "blend_max_abs_err": err}


def phase_host_seam_reference(state):
    """The host seams card against CPU with the same draws: on the
    192x256 rotation pair the graph cut (COLOR, COLOR_GRAD), the full DP
    and the graph cut at seam_megapix 0.1; a 3-view 192x256 panning
    Stitcher with the graph cut. Each case: `stitch_pair` (or the
    Stitcher) on the card and on the CPU within `_card_vs_cpu`'s limits
    (keypoints equal, focal 1e-3, pano mean 1.0), and the split
    (`_host_seam_blend`) of the card's own canvases against the same
    split on the CPU (`_hold_split`: equal seam masks)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import (PipelineConfig, SeamConfig, Stitcher,
                                       pipeline as P)
    from imagestitch_tpu_torch.utils.io import (synthetic_pan_sequence,
                                                synthetic_rotation_pair)
    cases = {"graphcut": SeamConfig(kind="graphcut"),
             "graphcut_colorgrad": SeamConfig(kind="graphcut_colorgrad"),
             "dp_full": SeamConfig(kind="dp_color", full_components=True),
             "graphcut_megapix": SeamConfig(kind="graphcut",
                                            seam_megapix=0.1)}
    img1, img2, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    total, out = {}, {}
    for name, seam in cases.items():
        cfg = PipelineConfig(seam=seam)
        _reset_counts()
        out[name] = _option_pair(name, cfg, 1, total)
        a = torch.as_tensor(img1, device="cuda")
        b = torch.as_tensor(img2, device="cuda")
        warped, masks, _, _ = P.stitch_pair_front_impl(a, b, cfg, draws)
        out[name]["split"] = _hold_split(name, warped, masks, cfg)
    views = synthetic_pan_sequence(3, 192, 256)
    cfg = PipelineConfig(seam=SeamConfig(kind="graphcut"))
    sdraws = _pan_draws(3, 6)
    _reset_counts()
    pc, mc = Stitcher(cfg).stitch(views, draws=sdraws)
    torch.cuda.synchronize()
    launches = _read_counts()
    _add_counts(total, launches)
    check(launches["detect_maps"] == 1 and launches["warp_batched"] == 1,
          f"stitcher3: launches {launches}")
    pp, mp = Stitcher(cfg, device="cpu").stitch(views, draws=sdraws)
    check(mc["reachable"] == mp["reachable"] == [True] * 3,
          f"stitcher3: reachable {mc['reachable']} vs {mp['reachable']}")
    rel = abs(mc["focal"] - mp["focal"]) / mp["focal"]
    check(rel < 1e-3, f"stitcher3: focal {mc['focal']} vs {mp['focal']}")
    check(pc.shape == pp.shape, f"stitcher3: pano {pc.shape} vs {pp.shape}")
    diff = float(np.abs(pc.astype(np.float64) - pp).mean())
    check(diff < 1.0, f"stitcher3: pano mean abs diff {diff}")
    out["stitcher3_graphcut"] = {"pano": list(pc.shape), "focal_rel": rel,
                                 "pano_mean_abs_diff": diff,
                                 "launches": launches}
    _record_path(state, "host_seam_reference", total)
    emit({"phase": "host_seam_reference", "cases": out,
          "card": state["name"], "smi": state["smi"]})


def phase_graphcut_path(state):
    """stitch_pair with the graph-cut colour seam on synthetic_pair(1080,
    1920, overlap=0.4, seed=0), at seam_megapix 0.1 and at full
    resolution (bench.py's two graph-cut runs): h_valid, the pano's width
    within 10% of 1920 + shift, launches (K1 2, K2 1 per pair), the
    median of 5 warm stitches, and the split's seam_readback / seam /
    blend stages (median of 3 front + `_host_seam_blend` runs, each under
    an active StageTimer) with the bytes read back (full resolution: the
    overlap's uint8 crop)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import (PipelineConfig, SeamConfig,
                                       stitch_pair, pipeline as P)
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    from imagestitch_tpu_torch.utils.log import StageTimer
    i1, i2, shift = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    runs = {"seam_megapix_0.1": SeamConfig(kind="graphcut",
                                           seam_megapix=0.1),
            "full_resolution": SeamConfig(kind="graphcut",
                                          seam_megapix=-1.0)}
    out, total = {}, {}
    for name, seam in runs.items():
        cfg = PipelineConfig(seam=seam)
        _reset_counts()
        pano, m = stitch_pair(i1, i2, cfg)
        torch.cuda.synchronize()
        launches = _read_counts()
        _add_counts(total, launches)
        want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
                "slab_probe": 0}
        check(_matches(launches, want),
              f"{name}: launches {launches}, want {want}")
        check(m["h_valid"], f"{name}: h_valid false")
        check(pano.dtype == np.uint8 and pano.std() > 20, f"{name}: pano")
        check(abs(pano.shape[1] - (1920 + shift)) < 0.1 * (1920 + shift),
              f"{name}: pano width {pano.shape[1]} vs {1920 + shift}")
        walls = _warm_walls(lambda cfg=cfg: stitch_pair(i1, i2, cfg))
        a = torch.as_tensor(i1, device="cuda")
        b = torch.as_tensor(i2, device="cuda")
        timers, fronts = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warped, masks, _, _ = P.stitch_pair_front_impl(a, b, cfg)
            torch.cuda.synchronize()
            fronts.append((time.perf_counter() - t0) * 1e3)
            timers.append(StageTimer("cuda"))
            with timers[-1].active():
                P._host_seam_blend(warped, masks, cfg)
        del warped, masks
        out[name] = {
            "launches": launches, "pano": list(pano.shape),
            "focal": m["focal"], "wall_ms_median": walls[2],
            "wall_ms": walls, "front_ms": float(np.median(fronts)),
            "split_ms": {k: float(np.median([t.summary()[k]
                                             for t in timers]))
                         for k in ("seam_readback", "seam", "blend")},
            "readback_bytes": timers[0].counts()["readback_bytes"],
            "entry_stages_ms": {k: m[k] for k in ("front",
                                                  "host_seam_blend")}}
    _record_path(state, "graphcut_path", total)
    emit({"phase": "graphcut_path", "runs": out, "card": state["name"],
          "smi": state["smi"]})


def _scans_config(**kw):
    from imagestitch_tpu_torch import PipelineConfig
    return PipelineConfig(mode="scans", **kw)


def phase_scans_reference(state):
    """SCANS mode card against CPU with the same draws at 192x256: the
    similarity pair (`stitch_pair`), a 3-view translated chain with the
    skip pairs (`stitch_chain`, chain_splice), the Stitcher (affine bundle
    adjustment) and `StreamStitcher.calibrate` on the same views: equal
    reachable, the panos' shapes equal and within 1.0 on average, and
    launches (the pair K1 2, K2 1; the others K1 1, K2 1)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import (StreamStitcher, Stitcher,
                                       stitch_chain, stitch_pair)
    from imagestitch_tpu_torch.matching.matcher import pair_list
    from imagestitch_tpu_torch.utils.io import (synthetic_affine_pair,
                                                synthetic_sequence)
    a, b, _ = synthetic_affine_pair(192, 256, angle_deg=6.0, scale=1.04,
                                    seed=5)
    views = list(synthetic_sequence(3, 192, 256, overlap=0.5, seed=50)[0])
    chain_pairs = [(0, 1), (1, 2), (0, 2)]
    cfg = _scans_config()
    ccfg = _scans_config(chain_splice=True)
    runs = {
        "pair": (lambda dev, d: stitch_pair(a, b, cfg, device=dev,
                                            draws=d[(0, 1)]),
                 [(0, 1)], 2),
        "chain_splice": (lambda dev, d: stitch_chain(views, ccfg,
                                                     device=dev, draws=d),
                         chain_pairs, 1),
        "stitcher": (lambda dev, d: Stitcher(cfg, dev).stitch(views,
                                                              draws=d),
                     pair_list(3), 1),
        "stream_calibrate": (lambda dev, d: StreamStitcher(
            cfg, dev).calibrate(views, draws=d), pair_list(3), 1),
    }
    out, total = {}, {}
    for k, (name, (fn, pairs, k1)) in enumerate(runs.items()):
        d = _affine_draws(pairs, 10 + k)
        _reset_counts()
        pc, mc = fn("cuda", d)
        torch.cuda.synchronize()
        launches = _read_counts()
        _add_counts(total, launches)
        check(launches["detect_maps"] == k1
              and launches["warp_batched"] == 1,
              f"scans {name}: launches {launches}")
        pp, mp = fn("cpu", d)
        for key in ("reachable", "h_valid"):
            if key in mc:
                check(mc[key] == mp[key], f"scans {name}: {key} "
                      f"{mc[key]} vs {mp[key]}")
        check(pc.shape == pp.shape,
              f"scans {name}: pano {pc.shape} vs {pp.shape}")
        diff = float(np.abs(pc.astype(np.float64) - pp).mean())
        check(diff < 1.0, f"scans {name}: pano mean abs diff {diff}")
        check(pc.std() > 20, f"scans {name}: flat pano")
        out[name] = {"pano": list(pc.shape), "pano_mean_abs_diff": diff,
                     "launches": launches}
    _record_path(state, "scans_reference", total)
    emit({"phase": "scans_reference", "cases": out, "card": state["name"],
          "smi": state["smi"]})


def phase_scans_path(state):
    """SCANS mode at full size: stitch_pair(mode="scans") on
    synthetic_pair(1080, 1920, overlap=0.4, seed=0) (bench.py's scans
    pair): h_valid, the pano's width within 10% of 1920 + shift, launches
    (K1 2, K2 1), the median of 5 warm stitches and the stage split, and
    K2 on that launch's own inputs (the plane kind with affine cameras)
    against its plain version, timed; and a scans Stitcher on three
    translated 480x640 views: every view reachable, the pano wider than
    640 + 1.9 shifts, launches (K1 1, K2 1)."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import Stitcher, stitch_pair
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.utils.io import (synthetic_pair,
                                                synthetic_sequence)
    i1, i2, shift = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    cfg = _scans_config()
    seen = []
    inner = P.warp_batched

    def spy(*args, **kw):
        seen.append(args)
        return inner(*args, **kw)

    _reset_counts()
    P.warp_batched = spy
    try:
        pano, m = stitch_pair(i1, i2, cfg)
    finally:
        P.warp_batched = inner
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(launches, want), f"scans pair: launches {launches}")
    check(m["h_valid"] and m["focal"] == 1.0, f"scans pair: {m['h_valid']}")
    check(pano.dtype == np.uint8 and pano.std() > 20, "scans pair: pano")
    check(abs(pano.shape[1] - (1920 + shift)) < 0.1 * (1920 + shift),
          f"scans pano width {pano.shape[1]} vs {1920 + shift}")
    check(len(seen) == 1, f"scans pair: {len(seen)} warp kernel calls")
    imgs, k_rinvs, scale, corners, roi_uvs, canvas, kind = seen[0][:7]
    check(kind == "plane", f"scans pair: K2 kind {kind}")
    k2 = _hold_k2("scans_plane_1080p", imgs, k_rinvs, scale, corners,
                  roi_uvs, canvas, kind)
    state["k2"]["scans_plane"] = {k: k2[k] for k in (
        "canvas", "max_abs_err", "ms", "warm_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")}
    del imgs, seen
    walls = _warm_walls(lambda: stitch_pair(i1, i2, cfg))
    stages = _stage_breakdown(i1, i2, cfg, 3, trace=False)
    seq, sshift = synthetic_sequence(3, 480, 640, overlap=0.5, seed=7)
    _reset_counts()
    sp, sm = Stitcher(cfg).stitch(list(seq))
    torch.cuda.synchronize()
    slaunch = _read_counts()
    check(slaunch["detect_maps"] == 1 and slaunch["warp_batched"] == 1,
          f"scans Stitcher: launches {slaunch}")
    check(sm["reachable"] == [True] * 3, f"scans Stitcher: {sm['reachable']}")
    check(sp.shape[1] > 640 + 1.9 * sshift and sp.std() > 20,
          f"scans Stitcher pano {sp.shape} (shift {sshift})")
    total = dict(launches)
    _add_counts(total, slaunch)
    _record_path(state, "scans_path", total)
    emit({"phase": "scans_path", "launches": launches,
          "pano": list(pano.shape), "inliers": m["num_inliers"],
          "wall_ms_median": walls[2], "wall_ms": walls, "stages": stages,
          "k2_plane_affine": k2,
          "stitcher3_480p": {"pano": list(sp.shape), "launches": slaunch,
                             "stages_ms": {k: sm[k] for k in STAGES
                                           if k in sm}},
          "card": state["name"], "smi": state["smi"]})


def _chain_pano_draws(n, seed):
    """Per consecutive pair (i, i+1) of an n-view chain, seeded CPU draws
    (u_first, u_refit)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {(i, i + 1): (torch.rand((2048, 4), generator=g),
                         torch.rand((256, 4), generator=g))
            for i in range(n - 1)}


def phase_pano_reference(state):
    """stitch_chain_pano on 4 views of 192x256 (synthetic_sequence,
    overlap 0.5; seams pinned vertical; no bundle adjustment, as phase
    chain_reference, since on a near-pure translation the adjuster's stop
    moves by percents with float32 rounding) on the card and on the CPU
    with the same draws: corner equal, focal within 1e-3, valid IoU >=
    0.999, the canvas within 0.5 on average where both cover. On the card,
    its valid equals stitch_chain_impl's and its pano is within 1e-3 of
    it: the chain has empty triple overlaps, so the independent and the
    sequential seam schedules agree."""
    import dataclasses
    import numpy as np
    import torch
    from imagestitch_tpu_torch import CameraConfig, PipelineConfig
    from imagestitch_tpu_torch.parallel import stitch_chain_pano
    from imagestitch_tpu_torch.pipeline import stitch_chain_impl
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    views, _ = synthetic_sequence(4, 192, 256, overlap=0.5, seed=5)
    cfg = PipelineConfig(camera=CameraConfig(ba_refine=False))
    cfg = cfg.replace(seam=dataclasses.replace(cfg.seam, orient="vertical"))
    draws = _chain_pano_draws(4, 4)
    out = {dev: stitch_chain_pano(views, cfg, device=dev, draws=draws)
           for dev in ("cuda", "cpu")}
    (pc, vc, cc, mc), (pp, vp, cp, mp) = out["cuda"], out["cpu"]
    pc_, vc_ = pc.cpu(), vc.cpu()
    check(bool(mc["h_valid"].all() and mc["reachable"].all()),
          f"h_valid {mc['h_valid']}, reachable {mc['reachable']}")
    check(torch.equal(cc.cpu(), cp), f"corner card {cc} vs CPU {cp}")
    for k in ("num_inliers", "h_valid", "reachable"):
        check(torch.equal(mc[k].cpu(), mp[k]), f"{k}: card {mc[k]} vs "
              f"CPU {mp[k]}")
    fc, fp = float(mc["focal"]), float(mp["focal"])
    check(abs(fc - fp) <= 1e-3 * fp, f"focal card {fc} vs CPU {fp}")
    iou = float((vc_ & vp).sum()) / max(float((vc_ | vp).sum()), 1.0)
    check(iou >= 0.999, f"valid IoU {iou}")
    both = vc_ & vp
    diff = float((pc_ - pp).abs()[both].mean())
    check(diff < 0.5, f"pano mean abs diff {diff}")
    imgs = torch.as_tensor(np.stack(views), device="cuda")
    ps, vs, cs, _ = stitch_chain_impl(imgs, cfg, draws)
    seq_diff = float((ps - pc).abs().max())
    check(torch.equal(vs, vc) and torch.equal(cs, cc) and seq_diff <= 1e-3,
          f"independent vs sequential seams: valid equal "
          f"{torch.equal(vs, vc)}, max diff {seq_diff}")
    emit({"phase": "pano_reference", "canvas": list(vc.shape),
          "focal_card": fc, "focal_cpu": fp, "iou": iou,
          "pano_mean_abs_diff": diff, "vs_sequential_max_abs_diff": seq_diff,
          "inliers": mc["num_inliers"].tolist()})


def _seam_stage_ms(views, n_warm: int = 3):
    """Wall ms of the seam stage of chain8 on the card (synchronized,
    median of `n_warm` runs after a first one, on one front's canvases):
    the 7 independent pair seams and their merge (parallel.pano), beside
    the 7 sequential seams of stitch_chain_impl (default configuration,
    orient "auto")."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.parallel import pano
    cfg = PipelineConfig()
    h, w = views[0].shape[:2]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    imgs = torch.as_tensor(np.stack(views), device="cuda").float()
    warped, masks, _, _ = P.stitch_chain_front_impl(imgs, cfg,
                                                    generator=gen)
    max_w = -(-int(round(1.1 * w)) // 128) * 128

    def independent():
        pano._independent_pair_seams(warped, masks, cfg, max_w)

    def sequential():
        P._seam_masks(warped, masks, cfg, max_w=max_w,
                      max_h=-(-int(round(1.1 * h)) // 128) * 128)

    out = {}
    for name, fn in (("independent", independent),
                     ("sequential", sequential)):
        fn()
        walls = _warm_walls(fn, n_warm)
        out[name] = {"ms_median": float(np.median(walls)), "ms": walls}
    return out


def phase_pano_path(state):
    """stitch_chain_pano on chain8_1080p (8 views of 1080x1920, canvas
    1458x16704, the default configuration): every h_valid and reachable,
    launches (K1 1, K2 1); walls (median of 3),
    alternating with stitch_chain_impl (uncropped tensors on the card,
    as stitch_chain_pano returns) and the entry stitch_chain (read back
    and cropped) on the same views; the seam stage of the 7 independent
    pair seams beside the 7 sequential ones."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig, stitch_chain
    from imagestitch_tpu_torch.parallel import stitch_chain_pano
    from imagestitch_tpu_torch.pipeline import (_generator,
                                                stitch_chain_impl)
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    name, n, h, w = CHAIN_CASES[0]
    views, shift = synthetic_sequence(n, h, w, overlap=0.5, seed=7)
    _reset_counts()
    p, v, c, m = stitch_chain_pano(views)
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 1, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(launches, want), f"kernel launches {launches}, want {want}")
    _record_path(state, "pano_path", launches)
    check(bool(m["h_valid"].all() and m["reachable"].all()),
          f"h_valid {m['h_valid']}, reachable {m['reachable']}")
    check(bool(torch.isfinite(p).all()), "non-finite pano")
    width = int(v.any(dim=0).sum())
    want_w = w + (n - 1) * shift
    check(abs(width - want_w) < 0.1 * want_w,
          f"pano width {width} vs {want_w}")
    imgs = torch.as_tensor(np.stack(views), device="cuda")
    ps, vs, cs, _ = stitch_chain_impl(imgs, PipelineConfig(),
                                      generator=_generator("cuda", 0))
    iou = float((vs & v).sum()) / max(float((vs | v).sum()), 1.0)
    check(torch.equal(cs, c) and iou >= 0.999,
          f"stitch_chain_impl's corner {cs.tolist()} vs {c.tolist()}, "
          f"valid IoU {iou}")
    seq = {"valid_iou": iou, "valid_equal": bool(torch.equal(vs, v)),
           "mean_abs_diff": float((ps - p).abs()[vs & v].mean())}
    state["pano8"] = (views, (p, v, c, m))
    del ps, vs, imgs

    def pano_call():
        stitch_chain_pano(views)

    def impl_call():
        x = torch.as_tensor(np.stack(views), device="cuda")
        stitch_chain_impl(x, PipelineConfig(),
                          generator=_generator(x.device, 0))

    walls = {"stitch_chain_pano": [], "stitch_chain_impl": [],
             "stitch_chain": []}
    for _ in range(3):
        for key, fn in (("stitch_chain_pano", pano_call),
                        ("stitch_chain_impl", impl_call),
                        ("stitch_chain", lambda: stitch_chain(views))):
            walls[key] += _warm_walls(fn, 1)
    emit({"phase": "pano_path", "case": name, "launches": launches,
          "canvas": list(v.shape), "width": width, "want_width": want_w,
          "focal": float(m["focal"]), "inliers": m["num_inliers"].tolist(),
          "vs_sequential": seq,
          "wall_ms_median": {k: float(np.median(x))
                             for k, x in walls.items()},
          "wall_ms": walls, "seam_stage": _seam_stage_ms(views),
          "card": state["name"], "smi": state["smi"]})


def _equal_outputs(name, a, b):
    """(pano, valid, corner, metrics) equal bit for bit, or the phase
    fails."""
    import torch
    for what, x, y in zip(("pano", "valid", "corner"), a[:3], b[:3]):
        check(torch.equal(x, y), f"{name}: {what} differs")
    for k in b[3]:
        check(torch.equal(a[3][k], b[3][k]), f"{name}: metric {k} differs")


def phase_sharded_path(state):
    """The sharded entry points against their unsplit runs, bit for bit:
    stitch_pairs_sharded on 8 distinct 1080p pairs against
    stitch_pairs_batched with the same seed; stitch_chain_pano_sharded on
    chain8_1080p against stitch_chain_pano; stitch_pair_hostseam_sharded
    (graph cut at seam_megapix 0.1) on the 1080p 40%-overlap pair against
    stitch_pair's split (front + _host_seam_blend) on the same draws.
    First on make_mesh({"data": device_count}), then on meshes that name
    the one card twice ({"data": 2}) and four times ({"data": 2,
    "model": 2}): the split, the gathers, the per-shard launches (K1 and
    K2 once per data shard) and the hypothesis split run on one card.
    Those runs are logic checks on one card, not a multi-card
    measurement: their walls are one card's. With four cards
    (`python3 chip_smoke.py sharded_path` on them) the first mesh spans
    them, shards on distinct cards running in threads, and a {"data": 2,
    "model": 2} mesh of the four is added."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig, SeamConfig
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.parallel import (
        make_mesh, stitch_chain_pano, stitch_chain_pano_sharded,
        stitch_pair_hostseam_sharded, stitch_pairs_batched,
        stitch_pairs_sharded)
    from imagestitch_tpu_torch.utils.io import (synthetic_pair,
                                                synthetic_sequence)
    n_pairs = 8
    pairs = np.stack([np.stack(synthetic_pair(
        1080, 1920, overlap=0.3 + 0.3 * k / n_pairs, seed=10 + k)[:2])
        for k in range(n_pairs)])
    batched = stitch_pairs_batched(pairs, seed=3)
    check(bool(batched[3]["h_valid"].all()),
          f"batched h_valid {batched[3]['h_valid']}")
    if "pano8" in state:        # phase pano_path's run on these views
        views, pano_ref = state.pop("pano8")
    else:
        views, _ = synthetic_sequence(8, 1080, 1920, overlap=0.5, seed=7)
        pano_ref = stitch_chain_pano(views)
    i1, i2, _ = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    gcfg = PipelineConfig(seam=SeamConfig(kind="graphcut", seam_megapix=0.1))
    g = torch.Generator().manual_seed(8)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    warped, masks, corner, gm = P.stitch_pair_front_impl(
        torch.as_tensor(i1, device="cuda"), torch.as_tensor(i2, device="cuda"),
        gcfg, draws)
    hp, hv, _ = P._host_seam_blend(warped, masks, gcfg)
    host_ref = (hp, hv, corner, gm)
    del warped, masks

    n_dev = torch.cuda.device_count()
    meshes = {f"data{n_dev}": ({"data": n_dev}, None),
              "data2_one_card": ({"data": 2}, ["cuda:0"] * 2),
              "data2_model2_one_card": ({"data": 2, "model": 2},
                                        ["cuda:0"] * 4)}
    if n_dev >= 4:              # the hypothesis split across cards too
        meshes["data2_model2"] = ({"data": 2, "model": 2}, None)
    runs, total = {}, {}
    for label, (axes, devices) in meshes.items():
        mesh = make_mesh(axes, devices)
        shards = axes["data"]
        res = {}
        for entry, fn, ref, want in (
                ("stitch_pairs_sharded",
                 lambda: stitch_pairs_sharded(pairs, mesh, seed=3), batched,
                 (shards, shards)),
                ("stitch_chain_pano_sharded",
                 lambda: stitch_chain_pano_sharded(views, mesh), pano_ref,
                 (shards, shards)),
                ("stitch_pair_hostseam_sharded",
                 lambda: stitch_pair_hostseam_sharded(i1, i2, mesh, gcfg,
                                                      draws=draws),
                 host_ref, (2, 1))):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = _read_counts()
            _add_counts(total, launches)
            got = (launches["detect_maps"], launches["warp_batched"])
            check(got == want and launches["sift_octave_maps"] == 0
                  and launches["slab_probe"] == 0,
                  f"{label} {entry}: launches {launches}, want K1, K2 "
                  f"{want}")
            _equal_outputs(f"{label} {entry}", out, ref)
            del out
            res[entry] = {"launches": launches, "equal": True,
                          "wall_ms": wall}
        runs[label] = {"axes": axes, "devices": [str(d) for d in
                                                 mesh.devices.flat],
                       "data_shards": shards, "entries": res}
    _record_path(state, "sharded_path", total)
    emit({"phase": "sharded_path",
          "note": "logic checks: a mesh that names one card more than "
                  "once runs its shards one after another on that card; "
                  "no wall here is a multi-card speed measurement",
          "device_count": n_dev, "runs": runs,
          "inliers": batched[3]["num_inliers"].tolist(),
          "card": state["name"], "smi": state["smi"]})


def phase_aot(state):
    """aot.stitch_pair_program(1080, 1920) into a fresh directory under
    build/: the cold build of both libraries (was_cached False) and a
    second call (was_cached True), each with its seconds; its call equal
    to stitch_pair_impl on the rotation pair with the same draws (bit
    for bit; launches K1 2, K2 1); cached_export round-tripping a small
    tensor function on the card; clear() removing the blob and both
    library directories."""
    import shutil
    import tempfile
    import torch
    from imagestitch_tpu_torch import aot
    from imagestitch_tpu_torch.pipeline import stitch_pair_impl
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="aot-", dir=os.path.join(HERE, "build"))
    try:
        t0 = time.perf_counter()
        call, cached = aot.stitch_pair_program(1080, 1920, directory=d)
        cold_s = time.perf_counter() - t0
        check(not cached, "cold stitch_pair_program reported was_cached")
        t0 = time.perf_counter()
        call, cached2 = aot.stitch_pair_program(1080, 1920, directory=d)
        warm_s = time.perf_counter() - t0
        check(cached2, "second stitch_pair_program: was_cached false")
        img1, img2 = state["rot"][:2]
        g = torch.Generator().manual_seed(9)
        draws = (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g))
        a = torch.as_tensor(img1, device="cuda").float()
        b = torch.as_tensor(img2, device="cuda").float()
        _reset_counts()
        got = call(a, b, draws)
        torch.cuda.synchronize()
        launches = _read_counts()
        want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
                "slab_probe": 0}
        check(_matches(launches, want), f"program call: launches {launches}")
        _record_path(state, "aot", launches)
        _equal_outputs("stitch_pair_program", got,
                       stitch_pair_impl(a, b, draws=draws))

        def fn(x, y):
            return (x @ y).sum(dim=1), x + 1.0

        x = torch.arange(12.0, device="cuda").reshape(3, 4)
        y = torch.ones((4, 5), device="cuda")
        t0 = time.perf_counter()
        ex, c1 = aot.cached_export("smoke", fn, (x, y), directory=d)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex2, c2 = aot.cached_export("smoke", fn, (x, y), directory=d)
        load_s = time.perf_counter() - t0
        ref = fn(x, y)
        same = all(torch.equal(p, q) for e in (ex, ex2)
                   for p, q in zip(e(x, y), ref))
        check(not c1 and c2 and same,
              f"cached_export: was_cached {c1}, {c2}; equal {same}")
        listed = sorted(os.listdir(d))
        removed = aot.clear(d)
        check(removed == 3, f"clear removed {removed} of {listed}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "aot", "cold_build_s": cold_s, "was_cached": cached,
          "second_call_s": warm_s, "was_cached_second": cached2,
          "launches": launches, "call_equals_impl": True,
          "export_s": export_s, "load_s": load_s, "cleared": removed,
          "cleared_entries": listed, "card": state["name"],
          "smi": state["smi"]})


def phase_cli(state):
    """python -m imagestitch_tpu_torch.cli demo --size 1080x1920 on the
    card: a PNG wider than 1920, launches of one stitch_pair (detector maps
    2, warp 1)."""
    import torch
    from imagestitch_tpu_torch.cli import main as cli_main
    from imagestitch_tpu_torch.utils.io import imread
    out = os.path.join(HERE, "build", "cli_demo_1080p.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    _reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["demo", "--size", "1080x1920", "-o", out])
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(rc == 0 and _matches(launches, want),
          f"cli rc {rc}, launches {launches}")
    _record_path(state, "cli", launches)
    img = imread(out)
    check(img.shape[1] > 1920 and img.std() > 20, f"cli pano {img.shape}")
    example = _run_example(state)
    emit({"phase": "cli", "pano": list(img.shape), "wall_ms": wall,
          "launches": launches, "example": example})


def _run_example(state):
    """examples/stitch_photo_torch.py on the card into build/: its metrics
    line equal to stitch_pair's on photo_rotation_pair() with seed 0, its
    PNG equal to that pano, launches K1 2 and K2 1 (the "example" path)."""
    import contextlib
    import importlib.util
    import io
    import numpy as np
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import imread, photo_rotation_pair
    path = os.path.join(HERE, "examples", "stitch_photo_torch.py")
    spec = importlib.util.spec_from_file_location("stitch_photo_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = os.path.join(HERE, "build", "example_photo_pano.png")
    if os.path.exists(out):
        os.remove(out)
    text = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = mod.main([out])
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(rc == 0 and _matches(launches, want),
          f"example rc {rc}, launches {launches}, want {want}")
    _record_path(state, "example", launches)
    img1, img2, _, focal_true = photo_rotation_pair()
    pano, metrics = stitch_pair(img1, img2, seed=0)
    lines = text.getvalue().splitlines()
    line = mod.summary(pano, metrics, focal_true)
    check(lines == [line, f"wrote {out}"] and metrics["h_valid"],
          f"example printed {lines}, stitch_pair gives {line!r}")
    check(np.array_equal(imread(out), pano), "example PNG differs from "
          "stitch_pair's pano")
    return {"line": line, "wall_ms": wall, "launches": launches}


API_CANVAS = (1458, 4032)      # the 1080p rotation pair's pano canvas


def _subpackage_exports():
    """Every name of every `__all__` of the port's package and its
    subpackages imports: the lists the port keeps of the JAX package's
    public names (held against it on the CPU by tests/test_torch_api.py).
    Returns {subpackage: number of names}."""
    import importlib
    import pkgutil
    import imagestitch_tpu_torch as pkg
    subs = [""] + sorted(m.name for m in pkgutil.iter_modules(pkg.__path__)
                         if m.ispkg)
    counts = {}
    for sub in subs:
        mod = importlib.import_module(
            "imagestitch_tpu_torch" + ("." + sub if sub else ""))
        names = list(getattr(mod, "__all__", ()))
        missing = [n for n in names if not hasattr(mod, n)]
        check(not missing, f"imagestitch_tpu_torch.{sub}: {missing} do not "
              "import")
        counts[sub or "imagestitch_tpu_torch"] = len(names)
    check(counts["imagestitch_tpu_torch"] > 0 and counts.get("warp", 0) > 0,
          f"exports {counts}")
    return counts


def phase_api_path(state):
    """The public one-image warp, `warp.warper.warp_image`, of the first
    1080p rotation view with its camera from the main-path geometry, into
    the 1458x4032 canvas: for cylindrical, spherical and plane one K2
    launch (through `ops.cuda_warp.warp`), the image, mask, corner and size
    equal to `use_kernel=False` on the card bit for bit, and the same call
    on the CPU within tests/test_torch_warp.py's tolerance (masks differ
    only within 1e-3 px of the validity boundary; values, where both are
    valid, within its 5e-3 counted in float32 ulps of a source coordinate
    at its 80-px views, which is 16 times as many at this view's 1920 px:
    0.08); with `mask=`, `interp="nearest"` and the
    mercator projector no launch; `use_kernel=True` on a CPU tensor
    raises; every subpackage's exports import. Launch counts reset before
    each call and read after it."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch.pipeline import warp_scale
    from imagestitch_tpu_torch.testing import near_validity_boundary
    from imagestitch_tpu_torch.warp.projectors import _camera_mats
    from imagestitch_tpu_torch.warp.warper import (roi_bounds,
                                                   warp_batched_plain,
                                                   warp_image)
    img1, img2 = state["rot"][:2]
    if "rot_cams" not in state:          # run alone: register the pair
        from imagestitch_tpu_torch.config import PipelineConfig
        from imagestitch_tpu_torch.pipeline import register_pair
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state["rot_cams"] = register_pair(
            torch.as_tensor(img1).cuda().float(),
            torch.as_tensor(img2).cuda().float(), PipelineConfig(),
            generator=gen)[3]
    cams = state["rot_cams"]
    img = torch.as_tensor(img1, device="cuda")          # uint8 (H, W, 3)
    K, R = cams.K()[0], cams.R[0]
    k_rinv = _camera_mats(K, R)[1]
    scale = warp_scale(cams)
    H, W = img.shape[:2]
    val_tol = 5e-3 * float(np.spacing(np.float32(max(H, W)))
                           / np.spacing(np.float32(80)))
    fields = ("image", "mask", "corner", "size")
    total, kinds = {}, {}

    def counted(call):
        _reset_counts()
        out = call()
        torch.cuda.synchronize()
        launches = _read_counts()
        _add_counts(total, launches)
        return out, launches

    for kind in ("cylindrical", "spherical", "plane"):
        rk, launches = counted(lambda: warp_image(img, K, R, scale,
                                                  API_CANVAS, kind))
        want = {"detect_maps": 0, "sift_octave_maps": 0, "warp_batched": 1,
                "slab_probe": 0}
        check(_matches(launches, want),
              f"{kind}: launches {launches}, want {want}")
        rp, launches = counted(lambda: warp_image(
            img, K, R, scale, API_CANVAS, kind, use_kernel=False))
        check(launches["warp_batched"] == 0, f"{kind}: plain launched K2")
        unequal = [f for f in fields
                   if not torch.equal(getattr(rk, f), getattr(rp, f))]
        check(not unequal, f"{kind}: kernel route differs from the plain "
              f"path in {unequal}")
        rc = warp_image(img.cpu(), K.cpu(), R.cpu(), scale.cpu(),
                        API_CANVAS, kind, use_kernel=False)
        check(torch.equal(rc.corner, rk.corner.cpu())
              and torch.equal(rc.size, rk.size.cpu()),
              f"{kind}: corner/size card {rk.corner.tolist()} "
              f"{rk.size.tolist()} vs CPU {rc.corner.tolist()} "
              f"{rc.size.tolist()}")
        near = near_validity_boundary(k_rinv[None], scale, rk.corner[None],
                                      API_CANVAS, kind, [(H, W)])[0].cpu()
        vk, vc = rk.mask.cpu(), rc.mask
        bad = int(((vk != vc) & ~near).sum())
        both = vk & vc
        err = float((rk.image.cpu() - rc.image).abs()[both].max()) \
            if bool(both.any()) else 0.0
        check(bad == 0, f"{kind}: {bad} mask pixels differ from the CPU "
              "away from the validity boundary")
        check(err <= val_tol, f"{kind}: value error {err} against the "
              f"CPU, above {val_tol}")
        outside = rk.image.abs().masked_fill(rk.mask[..., None], 0.0)
        check(float(outside.max()) == 0.0, f"{kind}: values outside the "
              "mask")
        kinds[kind] = {"valid_px": int(vk.sum()),
                       "mask_mismatch_vs_cpu": int((vk != vc).sum()),
                       "max_abs_err_vs_cpu": err, "value_tol": val_tol,
                       "px_above_5e-3": int(((rk.image.cpu() - rc.image)
                                             .abs().amax(-1) > 5e-3)
                                            [both].sum()),
                       "launches": 1}

    mask = torch.ones((H, W), dtype=torch.bool, device="cuda")
    plain = {"mask": dict(mask=mask), "nearest": dict(interp="nearest"),
             "mercator": dict(kind="mercator")}
    for name, kw in plain.items():
        kw = {"kind": "cylindrical", **kw}
        r, launches = counted(lambda: warp_image(img, K, R, scale,
                                                 API_CANVAS, **kw))
        check(sum(launches.values()) == 0,
              f"{name}: launches {launches}, want none")
        check(bool(r.mask.any()), f"{name}: nothing valid")
    try:
        warp_image(img.cpu(), K.cpu(), R.cpu(), scale.cpu(), API_CANVAS,
                   use_kernel=True)
    except ValueError:
        pass
    else:
        check(False, "use_kernel=True on a CPU tensor did not raise")
    exports = _subpackage_exports()

    check(total["warp_batched"] == 3 and total["detect_maps"] == 0,
          f"api_path launches {total}")
    _record_path(state, "api_path", total)
    # the cylindrical call's K2 inputs, for its time alone in kernel_times;
    # the plain version's time here, before any profiler use
    roi = torch.stack(roi_bounds(K, R, scale, (H, W), "cylindrical"))
    args = (img.float()[None], k_rinv[None], scale,
            torch.floor(roi[:2]).to(torch.int32)[None], roi[None],
            API_CANVAS, "cylindrical")
    state["k2_api"] = args
    state.setdefault("k2", {})["api_n1"] = {"plain_ms": cuda_ms(
        lambda: warp_batched_plain(*args), iters=2, warmup=1)}
    emit({"phase": "api_path", "kinds": kinds, "launches": total,
          "plain_cases": sorted(plain), "exports": exports,
          "card": state["name"], "smi": state["smi"]})


# the serving loop at full width: requests, batch, producers, H, W
SERVE_FULL = (16, 8, 8, 1080, 1920)
# the JAX warm-start probe's output keys (tools/warm_start_probe.py:53-61)
PROBE_KEYS = ["warm_start_s", "deserialize_s", "compile_s", "run_s",
              "was_cached", "h_valid", "pano_sum"]


def _latency_summary(latencies, wall):
    import numpy as np
    lat = np.array(latencies) * 1e3
    return {"requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95))}


def phase_serve_path(state):
    """The serving loop (`tools/serve_demo.py`) on the card. (a) The tool
    itself with its defaults (192x256, the demo configuration, 32
    requests, batch 8, 4 producers, linger 20 ms): every request ok with a
    pano, K1 and K2 once for the warm-up and once per dispatch. (b) The
    loop at full width: PipelineConfig() on 16 1080x1920 pairs made
    before the clock (each producer's pairs as the tool makes them), batch
    8, 8 producers, after the all-zero warm-up: every request ok, K1 and
    K2 once per dispatch, K3 and K4 never (the "serve" path), and each
    served crop equal bit for bit to stitch_pairs_batched(seed=k) on its
    dispatch's pairs with the demo's crop. Prints the dispatch sizes,
    req/s, p50 and p95 latency and each dispatch's wall split (dispatch,
    then readback + crop)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from imagestitch_tpu_torch import PipelineConfig, stitch_pairs_batched
    from imagestitch_tpu_torch.tools import serve_demo

    out = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        rc = serve_demo.main([])
    torch.cuda.synchronize()
    launches_a = _read_counts()
    lines = out.getvalue().splitlines()
    n_a = sum(ln.strip().startswith("served batch of") for ln in lines)
    want = {"detect_maps": 1 + n_a, "sift_octave_maps": 0,
            "warp_batched": 1 + n_a, "slab_probe": 0}
    check(rc == 0 and _matches(launches_a, want) and "served 32 requests" in
          lines[-1] and not any("SOME INVALID" in ln for ln in lines),
          f"serve_demo defaults: rc {rc}, launches {launches_a}, want "
          f"{want}; {lines[-3:]}")

    n_req, batch, producers, h, w = SERVE_FULL
    cfg = PipelineConfig()
    per = n_req // producers
    pairs = [list(serve_demo.synthetic_requests(7 + i, per, h, w))
             for i in range(producers)]
    warm_s = serve_demo.warm(cfg, batch, h, w, "cuda")
    record = []
    _reset_counts()
    latencies, wall = serve_demo.serve(pairs, cfg, batch, 20.0, "cuda",
                                       record)
    torch.cuda.synchronize()
    launches = _read_counts()
    n = len(record)
    want = {"detect_maps": n, "sift_octave_maps": 0, "warp_batched": n,
            "slab_probe": 0}
    check(_matches(launches, want),
          f"serve 1080p: launches {launches}, want {want}")
    check(sum(e["n"] for e in record) == n_req
          and [e["seed"] for e in record] == list(range(n)),
          f"serve 1080p: dispatches {[(e['seed'], e['n']) for e in record]}")
    _record_path(state, "serve", launches)
    for e in record:
        x = np.stack([r.pair for r in e["reqs"]])
        panos, valids, _, _ = stitch_pairs_batched(x, cfg, seed=e["seed"])
        panos, valids = panos.cpu().numpy(), valids.cpu().numpy()
        for b, r in enumerate(e["reqs"]):
            want_crop = serve_demo.crop(panos[b], valids[b])
            check(r.ok and r.pano is not None
                  and np.array_equal(r.pano, want_crop),
                  f"serve 1080p dispatch {e['seed']} pair {b}: ok {r.ok}, "
                  f"crop {None if r.pano is None else r.pano.shape} not "
                  "equal to stitch_pairs_batched's")
        del panos, valids
    full = {**_latency_summary(latencies, wall), "batch": batch,
            "producers": producers, "size": [h, w], "warm_s": warm_s,
            "dispatches": [e["n"] for e in record],
            "dispatch_ms": [e["dispatch_s"] * 1e3 for e in record],
            "readback_crop_ms": [e["readback_crop_s"] * 1e3
                                 for e in record],
            "crops": [list(r.pano.shape) for e in record
                      for r in e["reqs"]],
            "crops_equal_batched": True}
    emit({"phase": "serve_path", "defaults": {
        "lines": [ln for ln in lines if not ln.startswith("  served")],
        "dispatches": n_a, "launches": launches_a},
        "full_width": full, "launches": launches,
        "card": state["name"], "smi": state["smi"]})


def phase_warm_start(state):
    """The deploy path's first stitch. In-process:
    aot.stitch_pair_program(1080, 1920) into the default directory (built
    or found) and one call with a generator seeded 0 on
    synthetic_pair(1080, 1920, overlap=0.4, seed=0): h_valid, K1 2 and K2
    1 (the "warm_start" path). Then `tools/warm_start_probe.py` twice,
    each in a fresh process (timeout 300 s): the JAX probe's keys,
    was_cached and h_valid true, pano_sum equal to the in-process call's.
    Prints both probe lines and each process's whole wall (with its
    `import torch` and CUDA context, which the probe's bootstrap leaves
    out of its own numbers)."""
    import subprocess
    import torch
    from imagestitch_tpu_torch import aot
    from imagestitch_tpu_torch.config import PipelineConfig
    from imagestitch_tpu_torch.pipeline import _generator
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    t0 = time.perf_counter()
    call, cached = aot.stitch_pair_program(1080, 1920, PipelineConfig())
    program_s = time.perf_counter() - t0
    i1, i2, _ = synthetic_pair(1080, 1920, overlap=0.4, seed=0)
    a = torch.as_tensor(i1, device="cuda").float()
    b = torch.as_tensor(i2, device="cuda").float()
    _reset_counts()
    pano, _, _, m = call(a, b, _generator(torch.device("cuda"), 0))
    pano_sum = float(pano.sum())
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {"detect_maps": 2, "sift_octave_maps": 0, "warp_batched": 1,
            "slab_probe": 0}
    check(_matches(launches, want) and bool(m["h_valid"]),
          f"warm_start: launches {launches}, h_valid {bool(m['h_valid'])}")
    _record_path(state, "warm_start", launches)
    del pano, a, b
    torch.cuda.empty_cache()
    probes = []
    for k in range(2):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "imagestitch_tpu_torch.tools."
             "warm_start_probe", "1080", "1920"], cwd=HERE,
            capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"probe {k}: rc {p.returncode}\n"
              f"{p.stderr[-3000:]}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        check(list(line) == PROBE_KEYS and line["was_cached"] is True
              and line["h_valid"] is True and line["pano_sum"] == pano_sum,
              f"probe {k}: {line}, in-process pano_sum {pano_sum}")
        probes.append({"probe": line, "process_wall_s": wall})
    emit({"phase": "warm_start", "program_s": program_s,
          "was_cached": cached, "launches": launches, "pano_sum": pano_sum,
          "fresh_processes": probes, "card": state["name"],
          "smi": state["smi"]})


def _k2_api_calls(args):
    """K2 at N=1 as `warp_image` runs it: the one-image wrapper's call
    (`ops.cuda_warp.warp`), F.grid_sample on the same maps (timed only),
    and (bound_ms, bound_by): the view read once and the canvas and mask
    written once over the memory rate, or the operations."""
    from imagestitch_tpu_torch.ops.cuda_warp import warp
    imgs, k_rinvs, scale, corners, roi_uvs, canvas, kind = args

    def call():
        return warp(imgs[0], k_rinvs[0], scale, corners[0], roi_uvs[0],
                    canvas, kind)

    Hc, Wc = canvas
    bound = bound_ms(imgs.numel() * 4 + Hc * Wc * (3 * 4 + 1),
                     WARP_OPS_PER_PX * Hc * Wc
                     + WARP_OPS_PER_LINE * (Hc + Wc))
    return call, _grid_sample_call(imgs, k_rinvs, scale, corners, canvas,
                                   kind), bound


STAGES = ("detect", "match", "cameras", "bundle_adjust", "warp", "exposure",
          "seam_blend")


def phase_kernel_times(state):
    """K1 and K3 alone for one stitch's work, from torch.profiler kernel
    events, median of 20 rounds: with L2 flushed by a 256 MB write before
    each round (ms) and without (warm_ms); K1 also as ten one-level
    launches (one_level_ms, flushed); K3 also split by kernel name
    (ms_by_name) and by octave (octave_ms: each octave's two calls, one
    per image), and the CUDA kernels one stitch's calls ran. It runs
    after every timed stitch: once the profiler has traced the card,
    later launches cost the host more."""
    import torch
    from imagestitch_tpu_torch.utils.timing import (FLUSH_BYTES, kernel_ms,
                                                    kernel_split_ms,
                                                    median_ms)
    stitch, one_level = state.pop("k1_calls")
    chain8 = state.pop("k1_chain_call")
    batched = state.pop("k1_batched_calls")
    sift = state.pop("k3_call")
    octaves = state.pop("k3_octaves")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    k1 = state["k1"]
    k1["ms"] = kernel_ms(stitch, N_TIMED, ("detect_maps",), flush)
    k1["one_level_ms"] = kernel_ms(one_level, N_TIMED, ("detect_maps",),
                                   flush)
    k1["chain8"]["ms"] = kernel_ms(chain8, N_TIMED, ("detect_maps",), flush)
    for name, call in batched.items():
        k1["batched"][name]["ms"] = kernel_ms(call, N_TIMED,
                                              ("detect_maps",), flush)
    detailed = state.pop("k1_detailed_call")
    k1["detailed"]["ms"] = kernel_ms(detailed, N_TIMED, ("detect_maps",),
                                     flush)
    k3 = state["k3"]
    cold = kernel_split_ms(sift, N_TIMED, K3_NAMES, flush)
    k3["ms"] = cold["ms"]
    k3["ms_by_name"] = cold["by_name"]
    check(cold["kernels"] == K3_CUDA_LAUNCHES_PER_STITCH,
          f"the trace shows {cold['kernels']} K3 kernels per stitch")
    k3["cuda_kernels_traced"] = cold["kernels"]
    k3["octave_ms"] = [kernel_ms(fn, N_TIMED, K3_NAMES, flush)
                       for fn in octaves]
    api_warp, api_lib, api_bound = _k2_api_calls(state.pop("k2_api"))
    k2n1 = state["k2"]["api_n1"]
    k2n1["ms"] = kernel_ms(api_warp, N_TIMED, ("warp_kernel",), flush)
    k2n1["library_ms"] = median_ms(api_lib, N_TIMED, flush.device, flush)
    del flush
    k1["warm_ms"] = kernel_ms(stitch, N_TIMED, ("detect_maps",))
    k1["chain8"]["warm_ms"] = kernel_ms(chain8, N_TIMED, ("detect_maps",))
    for name, call in batched.items():
        k1["batched"][name]["warm_ms"] = kernel_ms(call, N_TIMED,
                                                   ("detect_maps",))
    k1["detailed"]["warm_ms"] = kernel_ms(detailed, N_TIMED,
                                          ("detect_maps",))
    warm = kernel_split_ms(sift, N_TIMED, K3_NAMES)
    k3["warm_ms"] = warm["ms"]
    k3["warm_ms_by_name"] = warm["by_name"]
    k3["octave_warm_ms"] = [kernel_ms(fn, N_TIMED, K3_NAMES)
                            for fn in octaves]
    k2n1["warm_ms"] = kernel_ms(api_warp, N_TIMED, ("warp_kernel",))
    k2n1["bound_ms"], k2n1["bound_by"] = api_bound
    emit({"phase": "kernel_times",
          "detect_maps": {k: k1[k] for k in ("ms", "warm_ms",
                                              "one_level_ms", "wrapper_ms",
                                              "bound_ms", "chain8",
                                              "batched", "detailed")},
          "sift_octave_maps": {k: k3[k] for k in (
              "ms", "warm_ms", "ms_by_name", "warm_ms_by_name", "octave_ms",
              "octave_warm_ms", "cuda_kernels_traced", "wrapper_ms",
              "bound_ms")},
          "warp_api_n1": k2n1,
          "card": state["name"], "smi": state["smi"]})


def _stage_breakdown(img1, img2, cfg, n_warm: int, trace: bool = True):
    """Wall ms of each stage of one stitch (synchronized between stages,
    median of `n_warm` runs after a first one), and with `trace` the
    device's busy share of one stitch from a torch.profiler trace. The
    front runs with SCANS mode normalized and the seam with `cfg` as
    given, as `stitch_pair_impl` does."""
    import numpy as np
    import torch
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.features import detect as detect_features
    from imagestitch_tpu_torch.matching.matcher import match_pair
    from imagestitch_tpu_torch.ops.image import rgb_to_gray
    H, W = img1.shape[:2]
    fcfg = P._normalize_scans(cfg)

    def one(marks):
        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        mark("start")
        a = torch.as_tensor(img1, device="cuda").float()
        b = torch.as_tensor(img2, device="cuda").float()
        mark("upload")
        f1 = detect_features(rgb_to_gray(a), fcfg.detector)
        f2 = detect_features(rgb_to_gray(b), fcfg.detector)
        mark("detect")
        mi = match_pair(f1, f2, 0, 1, fcfg.matcher, fcfg.ransac,
                        generator=gen)
        mark("match_ransac")
        cams = P.pair_cameras(f1, f2, mi, ((H, W), (H, W)), fcfg)
        mark("cameras_ba")
        scale = P.warp_scale(cams)
        canvas = P._pano_canvas_shape((H, W), 2, fcfg)
        warped, masks, _, _, _ = P._warp_all_shared(
            torch.stack([a, b]), cams, scale, canvas, fcfg)
        mark("warp")
        warped = P._apply_exposure(warped, masks, cfg)
        mark("exposure")
        pano, valid = P._seam_and_blend(warped, masks, cfg, W, H)
        mark("seam_blend")
        P._to_uint8(pano, valid)
        mark("readback_crop")

    runs = []
    for _ in range(n_warm + 1):
        marks = []
        one(marks)
        runs.append({marks[i][0]: (marks[i][1] - marks[i - 1][1]) * 1e3
                     for i in range(1, len(marks))})
    runs = runs[1:]
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    if not trace:
        return {"ms": stages, "total_ms": sum(stages.values())}

    busy = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one([])
            wall = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0]
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        busy = {"wall_ms": wall, "device_ms": dev_ms,
                "busy_share": dev_ms / wall,
                "top": [[e.key[:60], e.self_device_time_total / 1e3,
                         e.count] for e in top]}
    except Exception as e:      # the trace is a report, not a check
        busy = {"not_measured": repr(e)[:200]}
    return {"ms": stages, "total_ms": sum(stages.values()), "profile": busy}


def _stage_ranges(img1, img2):
    """stitch() of the 4-view 1080p sequence and stitch_pair of the 1080p
    rotation pair under torch.profiler: every StageTimer stage entered
    leaves one `record_function` range of its name on the host's side of
    the trace. Returns {stage: {"count", "ms", "timer_ms"}}: ms summed
    over the ranges beside the timer's own ms for the stage."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from imagestitch_tpu_torch import stitch, stitch_pair
    from imagestitch_tpu_torch.utils import log
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    seq4, _ = synthetic_sequence(4, 1080, 1920, overlap=0.5, seed=7)
    entered = []
    stage = log.StageTimer.stage

    def spy(self, name, *tensors):
        entered.append(name)
        return stage(self, name, *tensors)

    log.StageTimer.stage = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, m4 = stitch(seq4)
            _, m2 = stitch_pair(img1, img2)
            torch.cuda.synchronize()
    finally:
        log.StageTimer.stage = stage
    names = set(entered)
    timer_ms = {**m4, **m2}
    ranges = {n: {"count": 0, "ms": 0.0, "timer_ms": timer_ms.get(n)}
              for n in sorted(names)}
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            ranges[e.name]["count"] += 1
            ranges[e.name]["ms"] += e.time_range.elapsed_us() / 1e3
    want = {n: entered.count(n) for n in names}
    got = {n: r["count"] for n, r in ranges.items()}
    check(names and got == want, f"stage ranges {got}, stages entered "
          f"{want}")
    return ranges


def _lm_case(shape):
    """The ray adjustment's inputs at a cell's shape on the card: "pair" (2
    cameras, 1 pair of 512 matches), "chain" (4 cameras, 3 consecutive and
    2 skip pairs of 512, a fifth of the points outside the inliers).
    Returns (cameras, x0, (src, dst, pt_valid, pair_from, pair_to,
    pair_valid))."""
    import torch
    from imagestitch_tpu_torch.geometry import bundle
    from imagestitch_tpu_torch.testing import bundle_problem
    if shape == "pair":
        cams, *pts = bundle_problem(2, [(0, 1)], 512, seed=11)
    else:
        cams, *pts = bundle_problem(
            4, [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)], 512, seed=12,
            masked=0.2)
    cams = cams.replace(**{f: getattr(cams, f).to("cuda") for f in
                           ("focal", "aspect", "ppx", "ppy", "R", "t")})
    x0 = torch.cat([cams.focal[:, None], bundle.R_to_rodrigues(cams.R)],
                   dim=1).reshape(-1)
    return cams, x0, [t.to("cuda") for t in pts]


def phase_lm_bundle(state):
    """The LM kernel (csrc/lm_bundle.cu) at the pair's and the chain's
    shapes of the ray adjustment, 25 iterations at most: against the plain
    loop on the same card inputs (final error within 1e-4, focals within
    1e-4 relative, re-anchored rotations within 1e-5; iterations of each);
    then the plain loop's wall per adjustment (median of 5, synchronized),
    the wrapper's wall (launch and the one readback, median of 20) and,
    last, the kernel alone from torch.profiler kernel events (median of
    20, warm: its inputs are 40 KB)."""
    import statistics
    from imagestitch_tpu_torch.geometry import bundle
    from imagestitch_tpu_torch.ops import cuda_lm
    from imagestitch_tpu_torch.utils import log
    from imagestitch_tpu_torch.utils.timing import kernel_split_ms
    import torch
    out = {}
    calls = {}
    for shape in ("pair", "chain"):
        cams, x0, (src, dst, ptv, pf, pt, pv) = _lm_case(shape)
        res = bundle._ray_residuals(src, dst, ptv, pf, pt, pv, cams.ppx,
                                    cams.ppy)

        def plain():
            timer = log.StageTimer(sync=False)
            with timer.active():
                x = bundle._lm_minimize(res, x0, 25)
            return x, timer.counts()["lm_iters"]

        def kernel(args=(x0, src, dst, ptv, pv, pf, pt, cams.ppx,
                         cams.ppy)):
            return cuda_lm.lm_minimize("ray", *args, 25)

        xp, itp = plain()
        xk, itk, ek = kernel()
        r = res(xp)
        ep = float((r * r).sum())
        p4, k4 = xp.reshape(-1, 4).double(), xk.reshape(-1, 4).double()
        Rp = bundle.rodrigues_to_R(p4[:, 1:].float()).double()
        Rk = bundle.rodrigues_to_R(k4[:, 1:].float()).double()
        f_rel = float(((k4[:, 0] - p4[:, 0]).abs() / p4[:, 0]).max())
        R_abs = float((Rk[0].T @ Rk - Rp[0].T @ Rp).abs().max())
        check(abs(ek - ep) <= 1e-4 * ep and f_rel <= 1e-4 and R_abs <= 1e-5,
              f"LM kernel {shape}: error {ek} against {ep}, focal "
              f"{f_rel}, rotation {R_abs}")
        walls = {}
        for name, fn, n in (("plain_ms", plain, 5), ("wrapper_ms", kernel,
                                                     20)):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[name] = statistics.median(ts)
        out[shape] = dict(iters_kernel=itk, iters_plain=itp, error=ek,
                          error_plain=ep, focal_rel=f_rel, rot_abs=R_abs,
                          **walls)
        calls[shape] = kernel
    for shape, fn in calls.items():
        split = kernel_split_ms(fn, N_TIMED, ("lm_kernel",))
        check(split["kernels"] == 1,
              f"{split['kernels']} LM kernels per adjustment")
        out[shape]["kernel_ms"] = split["ms"]
        out[shape]["kernel_ms_per_iter"] = \
            split["ms"] / out[shape]["iters_kernel"]
    state.setdefault("lm", {}).update(
        name="lm_bundle", route="cuda",
        source="imagestitch_tpu_torch/csrc/lm_bundle.cu", replaces=None,
        ms=out["pair"]["kernel_ms"], plain_ms=out["pair"]["plain_ms"],
        bound_ms=None, bound_by="latency", library_ms=None,
        case="the pair's ray adjustment, warm", chain=out["chain"])
    emit({"phase": "lm_bundle", **out, "card": state["name"],
          "smi": state["smi"]})


def _dp_cell_costs(state):
    """The DP seam's costs as `stitch_pair` of the 1080p rotation pair
    hands them to the kernel, under the ORB pair cell's configuration
    (365 x 544) and the SIFT cell's (486 x 640)."""
    from imagestitch_tpu_torch import (DetectorConfig, MatcherConfig,
                                       PipelineConfig, WarpConfig,
                                       stitch_pair)
    from imagestitch_tpu_torch.ops import cuda_dp
    img1, img2, _, _ = state["rot"]
    cfgs = {"pair": PipelineConfig(),
            "sift": PipelineConfig(
                detector=DetectorConfig(kind="sift"),
                matcher=MatcherConfig(match_conf=0.51),
                warp=WarpConfig(kind="plane", canvas_scale_h=1.8))}
    launch = cuda_dp.seam_path
    out = {}
    for name, cfg in cfgs.items():
        seen = []

        def spy(cost, transitions):
            seen.append(cost.clone())
            return launch(cost, transitions)

        cuda_dp.seam_path = spy
        try:
            stitch_pair(img1, img2, cfg)
        finally:
            cuda_dp.seam_path = launch
        check(len(seen) == 1, f"{len(seen)} DP seams in one {name} stitch")
        out[name] = (cfg, seen[0])
    return out


def phase_dp_seam(state):
    """The DP seam kernel (csrc/dp_seam.cu) on the costs of the ORB pair
    cell and of the SIFT cell (`_dp_cell_costs`): one launch per seam and
    the seam columns equal to the plain loop's bit for bit. Then, per
    cell, the `seam_blend` and `seam_dp` stages of warm stitches with the
    kernel and with the plain loop forced (median of 5); the plain loop's
    and the wrapper's wall (synchronized; median of 5 and 20); last, the
    kernel alone from torch.profiler kernel events (median of 20), with L2
    flushed by a 256 MB write and warm."""
    import statistics
    import torch
    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.seam import dp
    from imagestitch_tpu_torch.utils.timing import (FLUSH_BYTES,
                                                    kernel_split_ms)
    img1, img2, _, _ = state["rot"]
    out = {}
    calls = {}
    for name, (cfg, cost) in _dp_cell_costs(state).items():
        _reset_counts()
        k = dp.dp_seam_path(cost)
        launches = _read_counts()["dp_seam"]
        p = dp._dp_seam_path_plain(cost)
        check(launches == 1 and torch.equal(k, p),
              f"DP kernel {name}: {launches} launches, seam columns apart "
              f"from the plain loop's in {int((k != p).sum())} rows")
        stages = {}
        takes = dp.takes_kernel
        for path, forced in (("kernel", takes),
                             ("plain", lambda dev: False)):
            dp.takes_kernel = forced
            try:
                ms = [stitch_pair(img1, img2, cfg)[1] for _ in range(6)][1:]
            finally:
                dp.takes_kernel = takes
            stages[path] = {s: statistics.median(m[s] for m in ms)
                            for s in ("seam_blend", "seam_dp",
                                      "stitch_pair_total")}
        walls = {}
        for key, fn, n in (
                ("plain_ms", lambda c=cost: dp._dp_seam_path_plain(c), 5),
                ("wrapper_ms", lambda c=cost: dp.dp_seam_path(c), 20)):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[key] = statistics.median(ts)
        out[name] = dict(shape=list(cost.shape), launches=launches,
                         stages_ms=stages, **walls)
        calls[name] = lambda c=cost: dp.dp_seam_path(c)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for name, fn in calls.items():
        cold = kernel_split_ms(fn, N_TIMED, ("dp_seam_kernel",), flush)
        check(cold["kernels"] == 1,
              f"{cold['kernels']} DP kernels per seam in the trace")
        out[name]["kernel_ms"] = cold["ms"]
    del flush
    for name, fn in calls.items():
        out[name]["kernel_warm_ms"] = kernel_split_ms(
            fn, N_TIMED, ("dp_seam_kernel",))["ms"]
    state.setdefault("dp", {}).update(
        name="dp_seam", route="cuda",
        source="imagestitch_tpu_torch/csrc/dp_seam.cu", replaces=None,
        max_abs_err=0, ms=out["pair"]["kernel_ms"],
        warm_ms=out["pair"]["kernel_warm_ms"],
        plain_ms=out["pair"]["plain_ms"], bound_ms=None,
        bound_by="latency", library_ms=None,
        case="the pair cell's (365, 544) cost, L2 flushed",
        sift=out["sift"])
    emit({"phase": "dp_seam", **out, "card": state["name"],
          "smi": state["smi"]})


# the cells whose stitches end in the crop kernel, by the phase's names
CROP_CELLS = {"pair": "default_1080p.pair_closed1",
              "sift": "sift_plane_1080p.pair_closed1",
              "chain": "detailed_1080p.chain4_closed1"}


def _crop_canvases(state):
    """The canvas and mask `_to_uint8` hands the crop kernel at the end of
    a stitch under each of `CROP_CELLS`' configurations: the pairs' on the
    1080p rotation pair, the chain's on one pan of its cell's pool."""
    import torch
    import imagestitch_tpu_torch as tist
    from imagestitch_tpu_torch.ops import cuda_crop
    from stitchbench import harness
    bench = harness.load_benchmark()
    img1, img2, _, _ = state["rot"]
    launch = cuda_crop.crop_u8
    out = {}
    for name, workload in CROP_CELLS.items():
        cell = harness.resolve_cell(bench, workload)
        cfg = harness.pipeline_config(tist, cell["config"].get("pipeline",
                                                               {}))
        seen = []

        def spy(pano, valid):
            seen.append((pano.clone(), valid.clone()))
            return launch(pano, valid)

        cuda_crop.crop_u8 = spy
        try:
            if name == "chain":
                item, = harness.make_pool(
                    cell["config"], {**cell["traffic"], "pool": 1}, 24,
                    torch.device("cuda"))
                tist.stitch_chain(item.views, cfg)
            else:
                tist.stitch_pair(img1, img2, cfg)
        finally:
            cuda_crop.crop_u8 = launch
        check(len(seen) == 1, f"{len(seen)} crop launches in one {name} "
              f"stitch")
        out[name] = seen[0]
    return out


def phase_crop_u8(state):
    """The crop kernel (csrc/crop_u8.cu) on the canvases of the ORB pair,
    the SIFT pair and the chain cells (`_crop_canvases`): one launch, the
    uint8 crop equal to the host path's byte for byte. Then `_to_uint8`'s
    wall through the kernel and with the host path forced (synchronized;
    median of 20 and 5) and the bytes each reads back; last the kernel
    alone from torch.profiler kernel events (median of 20), with L2
    flushed by a 256 MB write and warm, beside its bound: 16 B a pixel,
    the canvas and mask read and the uint8 canvas written once."""
    import statistics
    import numpy as np
    import torch
    from imagestitch_tpu_torch import pipeline as P
    from imagestitch_tpu_torch.ops import cuda_crop
    from imagestitch_tpu_torch.utils import log
    from imagestitch_tpu_torch.utils.timing import (FLUSH_BYTES,
                                                    kernel_split_ms)
    takes = P._crop_takes_kernel
    host = lambda dev: False  # noqa: E731

    def to_uint8(pano, valid, forced):
        P._crop_takes_kernel = forced
        timer = log.StageTimer("cuda")
        try:
            with timer.active():
                return P._to_uint8(pano, valid), timer.counts()
        finally:
            P._crop_takes_kernel = takes

    out = {}
    calls = {}
    for name, (pano, valid) in _crop_canvases(state).items():
        H, W = pano.shape[:2]
        _reset_counts()
        got, counts = to_uint8(pano, valid, takes)
        launches = _read_counts()["crop_u8"]
        want, host_counts = to_uint8(pano, valid, host)
        check(launches == 1 and got.shape == want.shape
              and np.array_equal(got, want),
              f"crop kernel {name}: {launches} launches, crop {got.shape} "
              f"against the host path's {want.shape}")
        walls = {}
        for key, forced, n in (("wrapper_ms", takes, 20),
                               ("host_ms", host, 5)):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                to_uint8(pano, valid, forced)
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[key] = statistics.median(ts)
        bound, by = bound_ms(H * W * (12 + 1 + 3), H * W * 3 * 2)
        out[name] = dict(canvas=[H, W], planar=cuda_crop._planar(pano),
                         crop=list(got.shape), launches=launches,
                         readback_bytes=counts["readback_bytes"],
                         host_readback_bytes=host_counts["readback_bytes"],
                         bound_ms=bound, bound_by=by, **walls)
        calls[name] = lambda p=pano, v=valid: cuda_crop.crop_u8(p, v)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for name, fn in calls.items():
        cold = kernel_split_ms(fn, N_TIMED, ("crop_u8_kernel",), flush)
        check(cold["kernels"] == 1,
              f"{cold['kernels']} crop kernels per readback in the trace")
        out[name]["kernel_ms"] = cold["ms"]
    del flush
    for name, fn in calls.items():
        out[name]["kernel_warm_ms"] = kernel_split_ms(
            fn, N_TIMED, ("crop_u8_kernel",))["ms"]
    pair = out["pair"]
    state.setdefault("crop", {}).update(
        name="crop_u8", route="cuda",
        source="imagestitch_tpu_torch/csrc/crop_u8.cu", replaces=None,
        max_abs_err=0, ms=pair["kernel_ms"], warm_ms=pair["kernel_warm_ms"],
        plain_ms=pair["host_ms"], bound_ms=pair["bound_ms"],
        bound_by=pair["bound_by"], library_ms=None,
        case="the ORB pair's 1458 x 4032 canvas, L2 flushed",
        sift=out["sift"], chain=out["chain"])
    emit({"phase": "crop_u8", **out, "card": state["name"],
          "smi": state["smi"]})


def phase_stitcher_pano(state):
    """The `stitcher_pano_1080p` configuration through Stitcher on 4-view
    1080p pans of the benchmark's scenes, with the re-anchor on the
    nearest rotation and with it reverted (`geometry.bundle._anchor` the
    start as it is): each stitch's `start_defect`, pairs, LM launches and
    the plain reference's numbers; the re-anchored ones within the
    configuration's limits."""
    import numpy as np
    import torch
    import imagestitch_tpu_torch as ist
    from imagestitch_tpu_torch.geometry import bundle
    from stitchbench import find, harness, reference, scenes
    config = harness.load_json(os.path.join(
        HERE, "stitchbench", "configs", "stitcher_pano_1080p.json"))
    cfg = harness.pipeline_config(ist, config["pipeline"])
    h, w = config["view_hw"]
    f = float(config["focal_px"])
    anchor = bundle._anchor
    out = {}
    for step in (20.0, 25.0, 30.0):
        rots, half = find.part("poses", "pan").cameras((step,), 4)
        views = scenes.render_views(rots, half, h, w, f,
                                    np.random.default_rng(int(step)),
                                    torch.device("cuda"))
        ref, valid = reference.render(views, rots, f, "spherical", True)
        host = list(views.cpu().numpy())
        runs = {}
        for name, fn in (("re_anchored", anchor),
                         ("start_as_is", lambda r0: r0)):
            bundle._anchor = fn
            try:
                _reset_counts()
                pano, m = ist.Stitcher(cfg).stitch(host, seed=7)
                torch.cuda.synchronize()
                lm = _read_counts()["lm_bundle"]
            finally:
                bundle._anchor = anchor
            got = reference.judge(pano, m["focal"], {"f": f}, ref, valid,
                                  True)
            runs[name] = dict(start_defect=m["start_defect"],
                              pairs_matched=m["pairs_matched"],
                              pairs_kept=m["pairs_kept"], lm_launches=lm,
                              reachable=m["reachable"],
                              pano=list(pano.shape), **got)
        cured = runs["re_anchored"]
        check(cured["lm_launches"] == 1 and all(cured["reachable"]),
              f"step {step}: {cured}")
        for key, limit in config["limits"].items():
            check(cured[key] <= limit,
                  f"step {step}: {key} {cured[key]} over {limit}")
        out[f"step{int(step)}"] = runs
    emit({"phase": "stitcher_pano", **out, "limits": config["limits"],
          "card": state["name"], "smi": state["smi"]})


def phase_stages(state):
    """Stage breakdowns of the 1080p ORB rotation stitch (default config)
    and of the 1080p SIFT plane stitch (bench.py's SIFT configuration),
    then the StageTimer stages' ranges in a torch.profiler trace
    (`_stage_ranges`)."""
    from imagestitch_tpu_torch.config import PipelineConfig
    img1, img2, _, _ = state["rot"]
    t1, t2 = state["sift_pair"]
    orb = _stage_breakdown(img1, img2, PipelineConfig(), 3)
    sift = _stage_breakdown(t1, t2, _sift_configs()[1], 3)
    emit({"phase": "stages", "orb_rotation": orb, "sift_plane": sift,
          "stage_ranges": _stage_ranges(img1, img2),
          "card": state["name"], "smi": state["smi"]})


def main(only=()) -> int:
    """Every phase; with phase names (`only`), the device and build phases
    and those alone, and no kernels line."""
    state = {}
    phases = [("device", phase_device), ("build", phase_build),
              ("detect", phase_detect), ("warp", phase_warp),
              ("sift_maps", phase_sift_maps),
              ("dma_layouts", phase_dma_layouts),
              ("reference", phase_reference),
              ("sift_reference", phase_sift_reference),
              ("main_path", phase_main_path), ("sift_path", phase_sift_path),
              ("chain_reference", phase_chain_reference),
              ("chain_path", phase_chain_path),
              ("stitcher_path", phase_stitcher_path),
              ("photo_reference", phase_photo_reference),
              ("multiband_path", phase_multiband_path),
              ("stream_path", phase_stream_path),
              ("batched_path", phase_batched_path),
              ("options_reference", phase_options_reference),
              ("detailed_path", phase_detailed_path),
              ("ramp_path", phase_ramp_path),
              ("host_seam_reference", phase_host_seam_reference),
              ("graphcut_path", phase_graphcut_path),
              ("scans_reference", phase_scans_reference),
              ("scans_path", phase_scans_path),
              ("pano_reference", phase_pano_reference),
              ("pano_path", phase_pano_path),
              ("sharded_path", phase_sharded_path), ("aot", phase_aot),
              ("cli", phase_cli), ("api_path", phase_api_path),
              ("serve_path", phase_serve_path),
              ("warm_start", phase_warm_start),
              ("lm_bundle", phase_lm_bundle), ("dp_seam", phase_dp_seam),
              ("crop_u8", phase_crop_u8),
              ("stitcher_pano", phase_stitcher_pano),
              ("stages", phase_stages), ("kernel_times", phase_kernel_times)]
    unknown = set(only) - {name for name, _ in phases}
    if unknown:
        print(f"chip_smoke: no phase {sorted(unknown)}", file=sys.stderr)
        return 2
    for name, fn in phases:
        if only and name not in ("device", "build", *only):
            continue
        try:
            fn(state)
        except Exception as e:          # any failure ends the run, non-zero
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed: {e}", file=sys.stderr)
            return 1
    import torch
    if not only:
        emit({"kernels": [state[k] for k in KERNEL_KEYS]})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
