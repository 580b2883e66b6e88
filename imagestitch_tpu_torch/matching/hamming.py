"""Descriptor distance matrices: exact Hamming distances between binary
descriptors (ORB), squared L2 between float ones (SIFT).

With bits a, b in {0, 1}, popcount(a XOR b) = Σa + Σb − 2·a·b, so the
(N, M) distance matrix is one (N, B) x (B, M) matrix product plus rank-1
corrections (`imagestitch_tpu.matching.hamming`). Here the product is a
float32 matmul: every value is an integer <= B (256 bits, or 384 and 512
for the one-hot wta_k 3 and 4 codes), exact in float32 as long as TF32 is
off (the entry points turn it off).
"""

from __future__ import annotations

import torch


def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor
                            ) -> torch.Tensor:
    """(N, M) float32 Hamming distances between (N, B) and (M, B) bits."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dot = a @ b.T
    return a.sum(dim=1)[:, None] + b.sum(dim=1)[None, :] - 2.0 * dot


def l2_distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, M) squared-L2 distances between float descriptor sets,
    |a|^2 + |b|^2 - 2 a.b, clamped at 0. The cross term rounds both
    operands to bfloat16 and sums in float32, as the JAX package's bf16
    product does."""
    a = d1.to(torch.bfloat16).to(torch.float32)
    b = d2.to(torch.bfloat16).to(torch.float32)
    dot = a @ b.T
    s1 = (d1.to(torch.float32) ** 2).sum(dim=1)
    s2 = (d2.to(torch.float32) ** 2).sum(dim=1)
    return torch.clamp(s1[:, None] + s2[None, :] - 2.0 * dot, min=0.0)
