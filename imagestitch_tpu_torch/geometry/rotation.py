"""Camera recovery for the sequential-chain topology
(`imagestitch_tpu.geometry.rotation.estimate_cameras`): the shared focal
from the chain's homographies, rotations chained R_{i+1} = R_i·K⁻¹·H_i⁻¹·K,
principal points at the image centres."""

from __future__ import annotations

import numpy as np
import torch

from imagestitch_tpu_torch.geometry.autocalib import estimate_focal
from imagestitch_tpu_torch.types import CameraParams


def _K_of(focal, aspect, ppx, ppy) -> np.ndarray:
    K = np.eye(3, dtype=np.float64)
    K[0, 0] = focal
    K[0, 2] = ppx
    K[1, 1] = focal * aspect
    K[1, 2] = ppy
    return K


def estimate_cameras(Hs_chain: torch.Tensor, pair_valid: torch.Tensor,
                     img_sizes: torch.Tensor) -> CameraParams:
    """Hs_chain: (N-1, 3, 3), Hs_chain[i] mapping image i's
    center-normalized points into image i+1's; img_sizes (N, 2) [h, w]."""
    dev = Hs_chain.device
    num_images = Hs_chain.shape[0] + 1
    focal = estimate_focal(Hs_chain, pair_valid, img_sizes, num_images)
    one = torch.ones((), dtype=torch.float32, device=dev)
    K = torch.diag(torch.stack([focal, focal, one]))
    Kinv = torch.diag(torch.stack([1.0 / focal, 1.0 / focal, one]))
    Rs = [torch.eye(3, dtype=torch.float32, device=dev)]
    for i in range(num_images - 1):
        Rs.append(Rs[-1] @ (Kinv @ torch.linalg.inv(Hs_chain[i]) @ K))
    sizes = img_sizes.to(device=dev, dtype=torch.float32)
    return CameraParams(
        focal=focal.expand(num_images).clone(),
        aspect=torch.ones(num_images, dtype=torch.float32, device=dev),
        ppx=0.5 * sizes[:, 1],
        ppy=0.5 * sizes[:, 0],
        R=torch.stack(Rs),
        t=torch.zeros((num_images, 3), dtype=torch.float32, device=dev),
    )
