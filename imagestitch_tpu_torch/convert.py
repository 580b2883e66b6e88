"""State carried across from the JAX package.

The system has no weights: its parameters are the configuration, the BRIEF
pattern (this package's own copy) and the RANSAC draws; its state between
stages is ImageFeatures, MatchesInfo and CameraParams. These helpers build
this package's objects from the JAX package's, handed over as plain Python
/ NumPy values, so each stage can be fed the JAX stage's own inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imagestitch_tpu_torch import config as _config
from imagestitch_tpu_torch.types import CameraParams, ImageFeatures, MatchesInfo

_SUB = {
    "detector": _config.DetectorConfig,
    "matcher": _config.MatcherConfig,
    "ransac": _config.RansacConfig,
    "camera": _config.CameraConfig,
    "warp": _config.WarpConfig,
    "exposure": _config.ExposureConfig,
    "seam": _config.SeamConfig,
    "blend": _config.BlendConfig,
}


def config_from_dict(d: dict) -> _config.PipelineConfig:
    """PipelineConfig from `dataclasses.asdict` of a JAX PipelineConfig."""
    kw = {}
    for f in dataclasses.fields(_config.PipelineConfig):
        v = d[f.name]
        kw[f.name] = _SUB[f.name](**v) if f.name in _SUB else v
    return _config.PipelineConfig(**kw)


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _fields_from_numpy(cls, fields: dict, dtypes: dict, device):
    return cls(**{f.name: _t(fields[f.name], dtypes[f.name], device)
                  for f in dataclasses.fields(cls)})


def features_from_numpy(fields: dict, device="cpu") -> ImageFeatures:
    """ImageFeatures from a dict of NumPy arrays (the JAX pytree's
    fields): binary ORB descriptors become uint8, float SIFT descriptors
    float32."""
    desc = (torch.float32
            if np.issubdtype(np.asarray(fields["descriptors"]).dtype,
                             np.floating) else torch.uint8)
    return _fields_from_numpy(ImageFeatures, fields, dict(
        xy=torch.float32, response=torch.float32, angle=torch.float32,
        size=torch.float32, level=torch.int32, valid=torch.bool,
        descriptors=desc, img_size=torch.int32), device)


def matches_from_numpy(fields: dict, device="cpu") -> MatchesInfo:
    """MatchesInfo from a dict of NumPy arrays."""
    return _fields_from_numpy(MatchesInfo, fields, dict(
        src_idx=torch.int32, dst_idx=torch.int32, pairs=torch.int32,
        distance=torch.float32, valid=torch.bool, inliers=torch.bool,
        num_inliers=torch.int32, H=torch.float32, h_valid=torch.bool,
        confidence=torch.float32), device)


def cameras_from_numpy(fields: dict, device="cpu") -> CameraParams:
    """CameraParams from a dict of NumPy arrays."""
    return _fields_from_numpy(CameraParams, fields, {
        f.name: torch.float32 for f in dataclasses.fields(CameraParams)},
        device)
