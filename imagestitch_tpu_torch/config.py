"""Frozen per-stage configuration dataclasses.

Field for field the same as `imagestitch_tpu.config` (same names, defaults
and kind validation), so a JAX config converts with
`imagestitch_tpu_torch.convert.config_from_dict(dataclasses.asdict(cfg))`.
The defaults reproduce the reference's literals (ORB nfeatures 510 -> 512,
scale 1.3, 5 levels, edge 31, FAST 20; ratio 0.3; RANSAC 3 px; feather
sharpness 5; 20x20 seam dilate).

A few fields only steer the TPU schedule and change no output here
(`WarpConfig.row_rebase`); they stay so the two config trees mirror each
other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DetectorConfig:
    """Feature detector configuration: ORB (the `nfeatures` ..
    `harris_block_size` and grid fields) or SIFT (the `sift_*` fields);
    `max_keypoints` is the padded capacity of either."""

    kind: str = "orb"             # orb | sift
    nfeatures: int = 512
    scale_factor: float = 1.3
    nlevels: int = 5
    edge_threshold: int = 31
    first_level: int = 0
    wta_k: int = 2                # 2|3|4
    pattern: str = "framework"    # framework | opencv
    patch_size: int = 31
    fast_threshold: int = 20
    harris_block_size: int = 7
    grid_rows: int = 1
    grid_cols: int = 3
    sift_octaves: int = 4
    sift_scales: int = 3
    sift_sigma: float = 1.6
    sift_contrast_thresh: float = 0.04
    max_keypoints: int = 1536
    per_level_overretain: float = 2.0

    def __post_init__(self):
        assert self.wta_k in (2, 3, 4), "wta_k can be only 2, 3 or 4"
        assert self.kind in ("orb", "sift"), \
            f"unknown detector kind: {self.kind!r}"
        assert self.pattern in ("framework", "opencv"), \
            f"unknown BRIEF pattern: {self.pattern!r}"


@dataclass(frozen=True)
class MatcherConfig:
    """BestOf2Nearest matcher configuration."""

    match_conf: float = 0.3
    num_matches_thresh1: int = 6
    num_matches_thresh2: int = 6
    max_matches: int = 512
    conf_thresh: float = 1.0
    range_width: int = -1
    motion: str = "homography"    # homography | affine | affine_partial

    def __post_init__(self):
        motions = ("homography", "affine", "affine_partial")
        assert self.motion in motions, \
            f"unknown matcher motion: {self.motion!r}"


@dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC homography configuration."""

    num_hypotheses: int = 2048
    reproj_threshold: float = 3.0
    confidence: float = 0.995
    lm_iters: int = 10
    seed: int = 0x34985739


@dataclass(frozen=True)
class CameraConfig:
    """Intrinsics recovery + bundle adjustment."""

    ba_refine: bool = True
    ba_kind: str = "ray"          # ray | reproj
    ba_iters: int = 25
    ba_conf_thresh: float = 1.0
    wave_correct: bool = False
    wave_kind: str = "horiz"      # horiz | vert


@dataclass(frozen=True)
class WarpConfig:
    """Rotation warper configuration; `kind` is checked against the
    projector registry."""

    kind: str = "cylindrical"
    canvas_scale_w: float = 2.1
    canvas_scale_h: float = 1.35
    # TPU warp-kernel schedule knob; no effect on this package's output
    row_rebase: bool = False

    def __post_init__(self):
        from imagestitch_tpu_torch.warp.projectors import PROJECTORS
        assert self.kind in PROJECTORS, \
            f"unknown warp kind: {self.kind!r} (have {sorted(PROJECTORS)})"


@dataclass(frozen=True)
class ExposureConfig:
    """Gain exposure compensation."""

    kind: str = "gain"            # gain|gain_blocks|channels|channels_blocks|none
    block_size: int = 32

    def __post_init__(self):
        kinds = ("gain", "gain_blocks", "channels", "channels_blocks",
                 "none")
        assert self.kind in kinds, f"unknown exposure kind: {self.kind!r}"


@dataclass(frozen=True)
class SeamConfig:
    """Seam finder configuration."""

    kind: str = "dp_color"
    dilate_kernel: int = 20
    orient: str = "auto"
    dp_scale: int = 4
    full_components: bool = False
    seam_megapix: float = -1.0

    def __post_init__(self):
        kinds = ("dp_color", "dp_colorgrad", "voronoi", "graphcut",
                 "graphcut_colorgrad", "none")
        assert self.kind in kinds, f"unknown seam kind: {self.kind!r}"
        assert self.dp_scale in (1, 2, 4), \
            f"dp_scale must be 1, 2 or 4, got {self.dp_scale!r}"


@dataclass(frozen=True)
class BlendConfig:
    """Blender configuration."""

    kind: str = "feather"         # feather|multiband|ramp|none
    feather_sharpness: float = 5.0
    num_bands: int = 5

    def __post_init__(self):
        kinds = ("feather", "multiband", "ramp", "none")
        assert self.kind in kinds, f"unknown blend kind: {self.kind!r}"


@dataclass(frozen=True)
class PipelineConfig:
    mode: str = "panorama"        # panorama | scans
    detector: DetectorConfig = DetectorConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    camera: CameraConfig = CameraConfig()
    warp: WarpConfig = WarpConfig()
    exposure: ExposureConfig = ExposureConfig()
    seam: SeamConfig = SeamConfig()
    blend: BlendConfig = BlendConfig()
    work_megapix: float = -1.0
    compose_megapix: float = -1.0
    chain_splice: bool = False
    crop: str = "bbox"            # bbox | interior

    def __post_init__(self):
        assert self.mode in ("panorama", "scans"), \
            f"unknown pipeline mode: {self.mode!r}"
        assert self.crop in ("bbox", "interior"), \
            f"unknown crop mode: {self.crop!r}"
        assert not (self.mode == "panorama"
                    and self.matcher.motion != "homography"), \
            "matcher.motion %r requires PipelineConfig(mode='scans')" \
            % self.matcher.motion

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
