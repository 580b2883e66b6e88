"""SIFT octave maps: for one octave of one (H, W) float32 image, the S+3
chained Gaussian levels and from them

  dog   (S+2, H, W)   difference-of-Gaussian layers
  score (S, H, W)     |D| at strict 26-neighbour extrema of the interior
                      layers 1..S passing the contrast and edge tests,
                      0 elsewhere and within 8 px of the border
  gx    (S+1, H, W)   edge-clamped central differences of levels 1..S+1
  gy    (S+1, H, W)
  gS    (H, W)        level S, the next octave's downsampling source

the outputs of `imagestitch_tpu.features.sift._octave_maps` (its XLA
path). On a CUDA tensor `sift_octave_maps` launches the hand-written
kernel of `csrc/sift_octave.cu` (it replaces the TPU kernel
`imagestitch_tpu/ops/pallas_sift.py:sift_octave_maps`) or raises; on a CPU
tensor it runs `sift_octave_maps_plain`, the same function in plain
tensor code. `launch_count` counts calls that launched the kernel (one
per octave; each call is one CUDA launch).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from imagestitch_tpu_torch.ops.image import (gaussian_kernel1d,
                                             sep_filter_planes)

EDGE_RATIO = 10.0
BORDER = 8
MAX_TAPS = 15
MAX_S = 6
# the kernel's tile variants, (TW, TH, threads per block, HB: the largest
# base halo its frame holds), indexed as imagestitch_sift_octave's
# `variant` (csrc/sift_octave.cu): 64x64 tiles for octaves that fill the
# card, 32x32 (two blocks an SM) for smaller ones, and a 60-px frame for
# wider blurs
TILES = ((64, 64, 512, 33), (32, 32, 256, 33), (32, 32, 256, 60))

launch_count = 0


def octave_shapes(H: int, W: int, num_octaves: int):
    """Per-octave (H, W): the next octave halves the last while
    min(h, w) // 2 >= 16."""
    shapes = [(H, W)]
    while len(shapes) < num_octaves and min(shapes[-1]) // 2 >= 16:
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    return shapes


@functools.lru_cache(maxsize=None)
def octave_blurs(S: int, sigma0: float, first_octave: bool):
    """(ksize, sigma) of each blur of one octave: the 7-tap sigma0
    pre-blur on the first octave (None otherwise), then the S+2 chained
    increments sqrt(sig_s^2 - sig_{s-1}^2), ksize max(3, 2 round(3 dsig)
    + 1) capped at 15."""
    pre = (7, sigma0) if first_octave else None
    chain = []
    for s in range(1, S + 3):
        sig_prev = sigma0 * (2.0 ** ((s - 1) / S))
        sig_cur = sigma0 * (2.0 ** (s / S))
        dsig = float(np.sqrt(max(sig_cur ** 2 - sig_prev ** 2, 1e-6)))
        k = max(3, int(2 * round(3 * dsig) + 1))
        chain.append((min(k, MAX_TAPS), dsig))
    return pre, tuple(chain)


@functools.lru_cache(maxsize=None)
def octave_halos(S: int, sigma0: float, first_octave: bool):
    """(base halo, per-level halos): how far past an output tile each
    level of one octave is needed, from the taps. The last level (S+2)
    needs 1 px, for the 3x3 DoG neighbourhood and the central
    differences; each blur adds its radius to the level before it, and
    the first octave's pre-blur its own to the base. S = 3, sigma0 = 1.6:
    levels 30, 26, 21, 15, 8, 1, the base 33 on the first octave and 30
    on the others."""
    pre, chain = octave_blurs(S, sigma0, first_octave)
    halos = [1]
    for k, _ in reversed(chain):
        halos.append(halos[-1] + (k - 1) // 2)
    levels = tuple(reversed(halos))
    base = levels[0] + ((pre[0] - 1) // 2 if pre is not None else 0)
    return base, levels


def octave_levels(base: torch.Tensor, first_octave: bool, S: int,
                  sigma0: float) -> list[torch.Tensor]:
    """The S+3 chained Gaussian levels of one octave, each blurred from the
    last with reflect-101 borders (level 0 of the first octave carries
    sigma0)."""
    pre, chain = octave_blurs(S, sigma0, first_octave)
    img = base.to(torch.float32)
    if pre is not None:
        k = gaussian_kernel1d(*pre, device=img.device)
        img = sep_filter_planes(img[None], k, k)[0]
    levels = [img]
    for ks, sig in chain:
        k = gaussian_kernel1d(ks, sig, device=img.device)
        levels.append(sep_filter_planes(levels[-1][None], k, k)[0])
    return levels


def dog_extrema_scores(dog: torch.Tensor, contrast_thresh: float,
                       edge_ratio: float = EDGE_RATIO) -> torch.Tensor:
    """Extremum scores of an (L, H, W) DoG stack: |D| where the voxel is a
    strict extremum of its 26 neighbours (wrapping shifts, as jnp.roll),
    |D| >= contrast_thresh / 2 and the Hessian passes the edge-ratio test;
    0 on the first and last layer and within 8 px of the border."""
    L, H, W = dog.shape
    d = dog
    is_max = torch.ones_like(d, dtype=torch.bool)
    is_min = torch.ones_like(d, dtype=torch.bool)
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == dy == dx == 0:
                    continue
                nb = torch.roll(d, (dl, dy, dx), (0, 1, 2))
                is_max &= d > nb
                is_min &= d < nb
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    score = torch.where(is_max | is_min, d.abs(), zero)
    ct = float(np.float32(0.5 * contrast_thresh))
    score = torch.where(d.abs() >= ct, score, zero)

    dxx = torch.roll(d, -1, 2) + torch.roll(d, 1, 2) - 2 * d
    dyy = torch.roll(d, -1, 1) + torch.roll(d, 1, 1) - 2 * d
    dxy = 0.25 * (torch.roll(d, (-1, -1), (1, 2))
                  + torch.roll(d, (1, 1), (1, 2))
                  - torch.roll(d, (-1, 1), (1, 2))
                  - torch.roll(d, (1, -1), (1, 2)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    score = torch.where(edge_ok, score, zero)
    score[0] = 0.0
    score[-1] = 0.0
    ys = torch.arange(H, device=d.device)
    xs = torch.arange(W, device=d.device)
    my = ((ys >= BORDER) & (ys < H - BORDER)).to(d.dtype)
    mx = ((xs >= BORDER) & (xs < W - BORDER)).to(d.dtype)
    return score * my[None, :, None] * mx[None, None, :]


def grad(img: torch.Tensor):
    """Central-difference gradients (gx, gy) of (..., H, W) with
    edge-clamped borders."""
    p = torch.nn.functional.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def sift_octave_maps_plain(base: torch.Tensor, first_octave: bool,
                           S: int = 3, sigma0: float = 1.6,
                           contrast_thresh: float = 34.0,
                           edge_ratio: float = EDGE_RATIO):
    """(H, W) float32 octave base -> (dog, score, gx, gy, gS) in plain
    tensor code."""
    levels = octave_levels(base, first_octave, S, sigma0)
    dog = torch.stack([levels[i + 1] - levels[i]
                       for i in range(len(levels) - 1)])
    score = dog_extrema_scores(dog, contrast_thresh, edge_ratio)
    gx, gy = grad(torch.stack(levels[1:S + 2]))
    return dog, score[1:S + 1], gx, gy, levels[S]


@functools.lru_cache(maxsize=None)
def _fn():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    fn = load_library().imagestitch_sift_octave
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_float)]
                   + [ctypes.POINTER(ctypes.c_int)] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _plan(S: int, sigma0: float, first_octave: bool):
    """Every blur's float32 taps as the plain version computes them, as
    ctypes arrays: the flat taps (the pre-blur first), each blur's length,
    and the halo of each stage (the base, then each blur's output)."""
    pre, chain = octave_blurs(S, sigma0, first_octave)
    blurs = ([pre] if pre is not None else []) + list(chain)
    taps = [gaussian_kernel1d(k, s).numpy() for k, s in blurs]
    flat = np.concatenate(taps).astype(np.float32)
    lens = [len(t) for t in taps]
    hb, levels = octave_halos(S, sigma0, first_octave)
    halos = ((hb,) + levels) if first_octave else levels
    return ((ctypes.c_float * len(flat))(*flat.tolist()),
            (ctypes.c_int * len(lens))(*lens),
            (ctypes.c_int * len(halos))(*halos))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_variant(H: int, W: int, hb: int, sms: int) -> int:
    """The kernel's tile variant for an (H, W) octave with base halo hb on
    a card of `sms` multiprocessors: 64x64 tiles where there are at least
    as many as multiprocessors, else 32x32 (a lone wave of big tiles
    leaves most of the card idle); the 60-px frame for halos past 33."""
    if hb > TILES[0][3]:
        if hb > TILES[2][3]:
            raise ValueError(f"a base halo of {hb} px fits no tile variant")
        return 2
    tw, th = TILES[0][:2]
    return 0 if -(-H // th) * -(-W // tw) >= sms else 1


def _launch(base: torch.Tensor, first_octave: bool, S: int, sigma0: float,
            contrast_thresh: float, edge_ratio: float, variant=None):
    """One launch of the kernel; returns (dog, score, gx, gy, gS), views
    into one allocation."""
    if not base.is_cuda:
        raise ValueError("sift_octave_maps_cuda needs a CUDA tensor")
    if base.dtype != torch.float32 or base.ndim != 2:
        raise ValueError(f"expected (H, W) float32, got {base.dtype} "
                         f"{tuple(base.shape)}")
    if not base.is_contiguous():
        raise ValueError("sift_octave_maps_cuda needs a contiguous tensor")
    H, W = base.shape
    if min(H, W) <= MAX_TAPS // 2:
        raise ValueError(f"octave {H}x{W} is smaller than the blur radius")
    if not 1 <= S <= MAX_S:
        raise ValueError(f"the kernel takes 1..{MAX_S} scales per octave, "
                         f"not {S}")
    if base.numel() >= 2 ** 31:
        raise ValueError(f"octave {H}x{W} has 2^31 pixels or more")
    taps, lens, halos = _plan(S, float(sigma0), bool(first_octave))
    if variant is None:
        variant = tile_variant(H, W, halos[0], _sm_count(base.device))
    # dog S+2, score S, gx S+1, gy S+1, gS 1
    flat = torch.empty((4 * S + 5, H, W), dtype=torch.float32,
                       device=base.device)
    dog, score, gx, gy, gs = flat.split([S + 2, S, S + 1, S + 1, 1])
    ct_half = float(np.float32(0.5 * contrast_thresh))
    r1sq = float(np.float32((edge_ratio + 1.0) ** 2))
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _fn()(base.data_ptr(), dog.data_ptr(), score.data_ptr(),
                       gx.data_ptr(), gy.data_ptr(), gs.data_ptr(), H, W,
                       S, int(first_octave), taps, lens, halos, ct_half,
                       float(edge_ratio), r1sq, variant, stream)
    from imagestitch_tpu_torch.ops.cuda_build import (check,
                                                       count_launch)
    check(status, "sift_octave kernel launch")
    count_launch(globals())
    return dog, score, gx, gy, gs[0]


def cuda_launches() -> int:
    """The CUDA launches of the kernel since its library was loaded, as
    the library counts them where it launches (one per call)."""
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    return ctypes.c_longlong.in_dll(
        load_library(), "imagestitch_sift_octave_launches").value


def sift_octave_maps_cuda(base: torch.Tensor, first_octave: bool,
                          S: int = 3, sigma0: float = 1.6,
                          contrast_thresh: float = 34.0,
                          edge_ratio: float = EDGE_RATIO):
    """Launch the CUDA kernel once on an (H, W) float32 contiguous CUDA
    tensor; returns (dog, score, gx, gy, gS)."""
    return _launch(base, first_octave, S, sigma0, contrast_thresh,
                   edge_ratio)


def sift_octave_maps(base: torch.Tensor, first_octave: bool, S: int = 3,
                     sigma0: float = 1.6, contrast_thresh: float = 34.0,
                     edge_ratio: float = EDGE_RATIO):
    """(H, W) float32 -> (dog, score, gx, gy, gS): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if base.is_cuda:
        return sift_octave_maps_cuda(base.to(torch.float32).contiguous(),
                                     first_octave, S, sigma0,
                                     contrast_thresh, edge_ratio)
    if base.device.type != "cpu":
        raise ValueError(f"sift_octave_maps: unsupported device "
                         f"{base.device}")
    return sift_octave_maps_plain(base, first_octave, S, sigma0,
                                  contrast_thresh, edge_ratio)
