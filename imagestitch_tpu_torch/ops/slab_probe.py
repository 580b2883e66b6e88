"""Slab-load probe: the port's counterpart of the TPU microbenchmark
`tools/exp_dma_layouts.py` (its constants and origin rule are copied here).

For each of `steps` steps and NCH chunks the probe copies a (C, h, 384)
window of a float32 source into on-chip memory, at a pseudo-random
(8, 128)-aligned origin, and sums each window's first (8, 128) block of
channel 0 over the chunks in order. It returns the last step's sum, as the
TPU kernel does (its grid runs in order and every step overwrites the one
output block). The source is planar (C, H, W) or 128-column tiled
(C, W/128, H, 128); both give the same sum.

`slab_probe_plain` is the plain tensor version: it gathers every slab of
every step, in chunks of steps so that its memory stays bounded.
"""

from __future__ import annotations

import torch

NCH = 8
SLAB_H, SLAB_W = 48, 384
STEPS = 468           # x NCH chunks = 3744 ~ the warp's live chunk count
TILE_W = 128
_CHUNK_BYTES = 64 << 20   # slab bytes the plain version gathers at once


def window_counts(pad_h: int, pad_w: int, h: int) -> tuple[int, int]:
    """How many row origins (every 8 rows) and column origins (every 128
    columns) the origin rule draws from."""
    return max((pad_h - h) // 8, 1), max((pad_w - SLAB_W) // TILE_W, 1)


def origins(step, ch, pad_h: int, pad_w: int, h: int):
    """(sy, sx) of chunk `ch` of `step`: an LCG on (step, ch) mod 2^32 ->
    an (8, 128)-aligned origin whose (h, 384) window lies in bounds.
    `step` and `ch` are ints or int64 tensors (the product is kept in
    int64 and wrapped with a mask)."""
    ny, nx = window_counts(pad_h, pad_w, h)
    r = (step * 2654435761 + ch * 40503) & 0xFFFFFFFF
    return ((r >> 8) % ny) * 8, ((r >> 19) % nx) * TILE_W


def to_tiled(planar: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (C, W/128, H, 128), contiguous, on the same device."""
    C, H, W = planar.shape
    if W % TILE_W:
        raise ValueError(f"width {W} is not a multiple of {TILE_W}")
    return planar.reshape(C, H, W // TILE_W, TILE_W).permute(
        0, 2, 1, 3).contiguous()


def source_hw(src: torch.Tensor, tiled: bool) -> tuple[int, int]:
    """(pad_h, pad_w) the origins are drawn in, from the source's shape."""
    if tiled:
        return src.shape[2], src.shape[1] * TILE_W
    return src.shape[1], src.shape[2]


def check_args(src: torch.Tensor, h: int, tiled: bool, steps: int) -> None:
    """Raise on a source or slab height the probe does not take."""
    if src.dtype != torch.float32 or src.ndim != (4 if tiled else 3):
        raise ValueError(
            f"expected a {'(C, W/128, H, 128)' if tiled else '(C, H, W)'} "
            f"float32 source, got {src.dtype} {tuple(src.shape)}")
    if tiled and src.shape[3] != TILE_W:
        raise ValueError(f"tiled source rows must be {TILE_W} wide")
    pad_h, pad_w = source_hw(src, tiled)
    if not (8 <= h <= SLAB_H and h % 8 == 0):
        raise ValueError(f"slab height {h} is not a multiple of 8 in "
                         f"8..{SLAB_H}")
    if pad_h < h + 8 or pad_w < SLAB_W or pad_w % TILE_W:
        raise ValueError(f"source {pad_h}x{pad_w} is too small for "
                         f"{h}x{SLAB_W} slabs")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


def slab_probe_plain(src: torch.Tensor, h: int, tiled: bool,
                     steps: int = STEPS) -> torch.Tensor:
    """The probe in plain tensor code: every slab of every step gathered
    whole, each step's (8, 128) sum formed over the chunks in order; returns
    the last step's sum."""
    check_args(src, h, tiled, steps)
    pad_h, pad_w = source_hw(src, tiled)
    C = src.shape[0]
    dev = src.device
    if tiled:
        # (C, nt, H, 128) -> windows (C, nt - 2, H/8 windows, 3, h, 128)
        win = src.unfold(2, h, 8).unfold(1, SLAB_W // TILE_W, 1)
        win = win.permute(0, 1, 2, 5, 4, 3)
    else:
        # (C, H, W) -> windows (C, H/8 windows, W/128 windows, h, 384)
        win = src.unfold(1, h, 8).unfold(2, SLAB_W, TILE_W)
    ch = torch.arange(NCH, device=dev)
    per_step = NCH * C * h * SLAB_W * 4
    chunk = max(1, _CHUNK_BYTES // per_step)
    for s0 in range(0, steps, chunk):
        step = torch.arange(s0, min(s0 + chunk, steps), device=dev)
        sy, sx = origins(step[:, None], ch[None, :], pad_h, pad_w, h)
        iy, ix = sy // 8, sx // TILE_W
        if tiled:
            slabs = win[:, ix, iy]           # (C, S, NCH, 3, h, 128)
            block = slabs[0, :, :, 0, 0:8, :]
        else:
            slabs = win[:, iy, ix]           # (C, S, NCH, h, 384)
            block = slabs[0, :, :, 0:8, 0:TILE_W]
        acc = torch.zeros((step.numel(), 8, TILE_W), dtype=torch.float32,
                          device=dev)
        for c in range(NCH):
            acc = acc + block[:, c]
    return acc[-1].contiguous()
