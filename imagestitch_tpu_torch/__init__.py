"""imagestitch_tpu_torch — the panorama pipelines of `imagestitch_tpu` in
PyTorch, for an NVIDIA H100.

Same stages, layouts and configuration as the JAX package (ORB or SIFT
features); its three stitching TPU kernels are hand-written CUDA kernels
here (`ops.cuda_detect`, `ops.cuda_sift`, `ops.cuda_warp`, sources in
`csrc/`), built with nvcc at first use. The
entry points run on the CUDA card unless the caller names another device
(the CPU runs every kernel's plain version).

High-level API: `imagestitch_tpu_torch.stitch_pair(img1, img2)` for two
images, `stitch(images)` (or `Stitcher(config).stitch(images)`) for N
views of any sizes and layout, `stitch_chain(images)` for N same-size
views in sequence, `stitch_pairs_batched(pairs)` for a batch of pairs,
`StreamStitcher(config)` to calibrate a fixed rig once and compose every
frame set after, and `Timelapser` to place frames alone on one canvas.
Over several devices: `parallel` (a mesh, `stitch_pairs_sharded`,
`stitch_chain_pano` and its split); the libraries built ahead of time:
`aot`. The command line: `python -m imagestitch_tpu_torch.cli
stitch|demo`.
"""

__version__ = "0.2.0"

from imagestitch_tpu_torch.config import (
    BlendConfig,
    CameraConfig,
    DetectorConfig,
    ExposureConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
    SeamConfig,
    WarpConfig,
)
from imagestitch_tpu_torch.parallel.batch import stitch_pairs_batched
from imagestitch_tpu_torch.pipeline import (Stitcher, stitch, stitch_chain,
                                            stitch_pair)
from imagestitch_tpu_torch.stream import StreamStitcher
from imagestitch_tpu_torch.timelapse import Timelapser
from imagestitch_tpu_torch.types import CameraParams, ImageFeatures, MatchesInfo

__all__ = [
    "BlendConfig",
    "CameraConfig",
    "CameraParams",
    "DetectorConfig",
    "ExposureConfig",
    "ImageFeatures",
    "MatcherConfig",
    "MatchesInfo",
    "PipelineConfig",
    "RansacConfig",
    "SeamConfig",
    "Stitcher",
    "StreamStitcher",
    "Timelapser",
    "WarpConfig",
    "stitch",
    "stitch_chain",
    "stitch_pair",
    "stitch_pairs_batched",
    "__version__",
]
