"""BRIEF sampling patterns for the ORB descriptor (host NumPy).

Copied from `imagestitch_tpu.features.pattern` so that this package
imports nothing of the JAX one: the seeded-Gaussian framework pattern
(BRIEF's G-II distribution, σ = patch_size/5), OpenCV's learned
`bit_pattern_31_` table (data/orb_pattern_cv.npy, BSD-3-Clause, the same
bytes as the JAX package's copy), the sampling tuples of the wta_k 3/4
descriptors and the intensity-centroid disc.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

PATTERN_SEED = 0x34985739  # the reference's RNG seed


@functools.lru_cache(maxsize=None)
def brief_pattern(n_pairs: int = 256, patch_size: int = 31,
                  seed: int = PATTERN_SEED) -> np.ndarray:
    """Deterministic (2*n_pairs, 2) int32 array of (x, y) sample offsets,
    Gaussian σ = patch_size/5 clipped to |p| <= patch_size//2 - 2."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    rmax = patch_size // 2 - 2
    pts = np.zeros((2 * n_pairs, 2), np.int32)
    count = 0
    while count < 2 * n_pairs:
        cand = rng.normal(0.0, sigma, size=(2 * n_pairs, 2))
        cand = np.round(cand).astype(np.int32)
        norm = np.sqrt((cand ** 2).sum(1))
        cand = cand[norm <= rmax]
        take = min(len(cand), 2 * n_pairs - count)
        pts[count:count + take] = cand[:take]
        count += take
    # identical endpoints give constant bits: nudge the second point in x
    a = pts[0::2]
    b = pts[1::2]
    same = np.all(a == b, axis=1)
    b[same, 0] = np.clip(b[same, 0] + 1, -rmax, rmax)
    pts[1::2] = b
    return pts


@functools.lru_cache(maxsize=None)
def brief_pattern_opencv() -> np.ndarray:
    """OpenCV's learned 256-pair table as (512, 2) int32 (x, y) offsets,
    pairs interleaved like `brief_pattern`."""
    data = np.load(Path(__file__).resolve().parent / "data"
                   / "orb_pattern_cv.npy")                  # (256, 4) int8
    return data.reshape(512, 2).astype(np.int32)


@functools.lru_cache(maxsize=None)
def ic_angle_offsets(half_patch: int = 15):
    """Circular-patch offsets and weights for the intensity-centroid angle:
    flattened (P,) int32 offset grids over the (2h+1)² patch and a float32
    mask of the disc u_max(v) = round(sqrt(h² - v²))."""
    h = half_patch
    vs, us = np.mgrid[-h:h + 1, -h:h + 1]
    umax = np.round(np.sqrt(np.maximum(h * h - vs.astype(np.float64) ** 2,
                                       0.0)))
    inside = (np.abs(us) <= umax).astype(np.float32)
    return (us.reshape(-1).astype(np.int32),
            vs.reshape(-1).astype(np.int32),
            inside.reshape(-1))


@functools.lru_cache(maxsize=None)
def orb_tuple_pattern(tuple_size: int, ntuples: int = 128,
                      patch_size: int = 31,
                      seed: int = PATTERN_SEED) -> np.ndarray:
    """Sampling tuples of the wta_k 3/4 descriptors: each of `ntuples`
    code symbols compares `tuple_size` distinct points drawn from the
    framework pattern's point pool. Returns (ntuples*tuple_size, 2) int32
    offsets."""
    pool = brief_pattern(256, patch_size, seed)
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    out = np.zeros((ntuples * tuple_size, 2), np.int32)
    for i in range(ntuples):
        chosen: list[tuple[int, int]] = []
        while len(chosen) < tuple_size:
            p = tuple(pool[rng.integers(0, len(pool))])
            if p not in chosen:
                chosen.append(p)
        out[i * tuple_size:(i + 1) * tuple_size] = chosen
    return out
