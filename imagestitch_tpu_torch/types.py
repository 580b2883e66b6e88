"""Data contracts between pipeline stages, as tensor dataclasses.

Same fields, shapes and dtypes as `imagestitch_tpu.types` (the `cv::detail`
ImageFeatures / MatchesInfo / CameraParams of the reference, padded to a
fixed capacity with a validity mask). Each class is a frozen dataclass of
tensors with `replace()`; a batch is a leading dimension on every field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ImageFeatures(_Replace):
    """Detected keypoints + descriptors for one image (padded to capacity K)."""

    xy: torch.Tensor           # (K, 2) float32 — keypoint (x, y)
    response: torch.Tensor     # (K,)  float32 — Harris (ORB) or |DoG| (SIFT)
    angle: torch.Tensor        # (K,)  float32 — orientation, radians
    size: torch.Tensor         # (K,)  float32 — keypoint diameter, pixels
    level: torch.Tensor        # (K,)  int32   — pyramid level / octave
    valid: torch.Tensor        # (K,)  bool
    descriptors: torch.Tensor  # (K, 256) uint8 in {0,1} (ORB) or
    #                            (K, 128) float32, unit norm (SIFT)
    img_size: torch.Tensor     # (2,) int32 — (height, width)

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def num_valid(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


@dataclass(frozen=True)
class MatchesInfo(_Replace):
    """Match set + homography for one ordered image pair (padded to M).
    H maps src image points to dst image points."""

    src_idx: torch.Tensor      # ()  int32
    dst_idx: torch.Tensor      # ()  int32
    pairs: torch.Tensor        # (M, 2) int32
    distance: torch.Tensor     # (M,) float32
    valid: torch.Tensor        # (M,) bool
    inliers: torch.Tensor      # (M,) bool
    num_inliers: torch.Tensor  # ()  int32
    H: torch.Tensor            # (3, 3) float32
    h_valid: torch.Tensor      # ()  bool
    confidence: torch.Tensor   # ()  float32

    def num_matches(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


@dataclass(frozen=True)
class CameraParams(_Replace):
    """Per-camera intrinsics + rotation, batched over N cameras."""

    focal: torch.Tensor   # (N,) float32
    aspect: torch.Tensor  # (N,) float32
    ppx: torch.Tensor     # (N,) float32
    ppy: torch.Tensor     # (N,) float32
    R: torch.Tensor       # (N, 3, 3) float32
    t: torch.Tensor       # (N, 3) float32

    def K(self) -> torch.Tensor:
        """Intrinsic matrices, (N, 3, 3)."""
        n = self.focal.shape[0]
        K = torch.zeros((n, 3, 3), dtype=torch.float32,
                        device=self.focal.device)
        K[:, 0, 0] = self.focal
        K[:, 0, 2] = self.ppx
        K[:, 1, 1] = self.focal * self.aspect
        K[:, 1, 2] = self.ppy
        K[:, 2, 2] = 1.0
        return K


def stack(items):
    """Per-view ImageFeatures or per-pair MatchesInfo (any one class of
    this module) stacked along a new leading axis: the batched form."""
    cls = type(items[0])
    return cls(**{f.name: torch.stack([getattr(x, f.name) for x in items])
                  for f in dataclasses.fields(cls)})


def index(batch, i: int):
    """Item `i` of a stacked batch (every field indexed on its leading
    axis)."""
    return type(batch)(**{f.name: getattr(batch, f.name)[i]
                          for f in dataclasses.fields(batch)})


def to_device(item, device):
    """An item of this module's classes with every field on `device`."""
    return type(item)(**{f.name: getattr(item, f.name).to(device)
                         for f in dataclasses.fields(item)})
