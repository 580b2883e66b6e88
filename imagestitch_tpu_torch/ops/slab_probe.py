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
every step (`gather_slabs`), in chunks of steps so that its memory stays
bounded.

The card's kernel copies each slab with one 4-D tensor-map copy and runs
one persistent block per multiprocessor. `tensor_map_spec` (the map's
dims, strides and box) and `coord_dims` (which map dims take a slab's row
and tile) are what the wrapper hands the kernel. `tensor_map_coords` and
`block_ranges` mirror arithmetic that the kernel does itself (a slab's
coordinates from those dims; which slabs each block copies). The CPU
tests check these copies; the card tests (`tests/test_torch_cuda.py`: the
kernel against `slab_probe_plain` at grids below, at and above the
multiprocessor count) check the kernel's own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NCH = 8
SLAB_H, SLAB_W = 48, 384
STEPS = 468           # x NCH chunks = 3744 ~ the warp's live chunk count
TILE_W = 128
TILES = SLAB_W // TILE_W
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


class TensorMapSpec(NamedTuple):
    """A 4-D tensor map over the source, innermost dimension first:
    `dims` (elements), `strides` (bytes, of dims 1-3; dim 0 is dense) and
    `box`, the (elements) extent one copy lands in shared memory, dense in
    the same order."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]


def tensor_map_spec(src_shape, tiled: bool, h: int) -> TensorMapSpec:
    """The map that copies a whole (C, h, 384) slab in one box.

    planar (C, H, W): dims {128, W/128, H, C}, box {128, 3, h, C}; the slab
    lands as (C, h, 3, 128), the memory order of (C, h, 384).
    tiled (C, W/128, H, 128): dims {128, H, W/128, C}, box {128, h, 3, C};
    the slab lands as (C, 3, h, 128).
    A box side is at most 256 elements and the inner one 512 bytes."""
    if tiled:
        C, nt, H, _ = src_shape
        dims, box = (TILE_W, H, nt, C), (TILE_W, h, TILES, C)
    else:
        C, H, W = src_shape
        dims, box = (TILE_W, W // TILE_W, H, C), (TILE_W, TILES, h, C)
    strides = tuple(4 * math.prod(dims[:i + 1]) for i in range(3))
    return TensorMapSpec(dims, strides, box)


def coord_dims(tiled: bool) -> tuple[int, int]:
    """The map dimensions that take a slab's row origin and its tile."""
    return (1, 2) if tiled else (2, 1)


def tensor_map_coords(sy: int, sx: int, tiled: bool) -> tuple[int, ...]:
    """A slab's coordinates in its tensor map (innermost first): row sy and
    tile sx / 128 in the dims `coord_dims` names, 0 elsewhere. The kernel
    places them the same way (`issue_slab` in `csrc/slab_probe.cu`)."""
    coords = [0, 0, 0, 0]
    ydim, xdim = coord_dims(tiled)
    coords[ydim], coords[xdim] = sy, sx // TILE_W
    return tuple(coords)


def block_ranges(units: int, blocks: int) -> list[range]:
    """The persistent grid's schedule: block b copies a contiguous range of
    the `units` slabs (NCH per step, in (step, chunk) order), q = units //
    blocks of them and one more for the first units % blocks blocks. A
    mirror of the kernel's own (`slab_probe_kernel`: first, count)."""
    q, r = divmod(units, blocks)
    return [range(b * q + min(b, r), (b + 1) * q + min(b + 1, r))
            for b in range(blocks)]


def _windows(src: torch.Tensor, h: int, tiled: bool) -> torch.Tensor:
    """Every slab the origin rule can draw, as a view: tiled (C, nt - 2,
    H/8 windows, 3, h, 128), planar (C, H/8 windows, W/128 windows, h,
    384)."""
    if tiled:
        win = src.unfold(2, h, 8).unfold(1, TILES, 1)
        return win.permute(0, 1, 2, 5, 4, 3)
    return src.unfold(1, h, 8).unfold(2, SLAB_W, TILE_W)


def gather_slabs(src: torch.Tensor, h: int, tiled: bool,
                 step: torch.Tensor) -> torch.Tensor:
    """The slabs of the given steps (int64, any shape S) and every chunk:
    tiled (C, *S, NCH, 3, h, 128), planar (C, *S, NCH, h, 384)."""
    pad_h, pad_w = source_hw(src, tiled)
    ch = torch.arange(NCH, device=src.device)
    sy, sx = origins(step[..., None], ch, pad_h, pad_w, h)
    iy, ix = sy // 8, sx // TILE_W
    win = _windows(src, h, tiled)
    return win[:, ix, iy] if tiled else win[:, iy, ix]


def slab_probe_plain(src: torch.Tensor, h: int, tiled: bool,
                     steps: int = STEPS) -> torch.Tensor:
    """The probe in plain tensor code: every slab of every step gathered
    whole, each step's (8, 128) sum formed over the chunks in order; returns
    the last step's sum."""
    check_args(src, h, tiled, steps)
    C = src.shape[0]
    dev = src.device
    per_step = NCH * C * h * SLAB_W * 4
    chunk = max(1, _CHUNK_BYTES // per_step)
    for s0 in range(0, steps, chunk):
        step = torch.arange(s0, min(s0 + chunk, steps), device=dev)
        slabs = gather_slabs(src, h, tiled, step)
        if tiled:
            block = slabs[0, :, :, 0, 0:8, :]
        else:
            block = slabs[0, :, :, 0:8, 0:TILE_W]
        acc = torch.zeros((step.numel(), 8, TILE_W), dtype=torch.float32,
                          device=dev)
        for c in range(NCH):
            acc = acc + block[:, c]
    return acc[-1].contiguous()
