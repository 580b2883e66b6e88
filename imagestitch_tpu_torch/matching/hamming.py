"""Exact Hamming distances between binary descriptors.

With bits a, b in {0, 1}, popcount(a XOR b) = Σa + Σb − 2·a·b, so the
(N, M) distance matrix is one (N, B) x (B, M) matrix product plus rank-1
corrections (`imagestitch_tpu.matching.hamming`). Here the product is a
float32 matmul: every value is an integer <= 256, exact in float32 as long
as TF32 is off (the entry points turn it off).
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
