"""OpenCV's plane warper's surface: (u, v) at scale s is the ray
(u/s, v/s, 1)."""

import torch


def to_ray(u: torch.Tensor, v: torch.Tensor, s: float) -> torch.Tensor:
    return torch.stack([u / s, v / s, torch.ones_like(u)], dim=-1)


def from_ray(r: torch.Tensor, s: float):
    x, y, z = r.unbind(-1)
    return s * x / z, s * y / z
