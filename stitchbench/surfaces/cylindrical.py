"""OpenCV's cylindrical warper's surface: (u, v) at scale s is the ray
(sin(u/s), v/s, cos(u/s))."""

import torch


def to_ray(u: torch.Tensor, v: torch.Tensor, s: float) -> torch.Tensor:
    a = u / s
    return torch.stack([torch.sin(a), v / s, torch.cos(a)], dim=-1)


def from_ray(r: torch.Tensor, s: float):
    x, y, z = r.unbind(-1)
    return s * torch.atan2(x, z), s * y / torch.sqrt(x * x + z * z)
