"""OpenCV's spherical warper's surface: (u, v) at scale s is the ray
(sin(pi - v/s) sin(u/s), cos(pi - v/s), sin(pi - v/s) cos(u/s))."""

import math

import torch


def to_ray(u: torch.Tensor, v: torch.Tensor, s: float) -> torch.Tensor:
    a = u / s
    sb = torch.sin(math.pi - v / s)
    return torch.stack([sb * torch.sin(a), torch.cos(math.pi - v / s),
                        sb * torch.cos(a)], dim=-1)


def from_ray(r: torch.Tensor, s: float):
    x, y, z = r.unbind(-1)
    w = (y / torch.linalg.norm(r, dim=-1)).clamp(-1.0, 1.0)
    return s * torch.atan2(x, z), s * (math.pi - torch.acos(w))
