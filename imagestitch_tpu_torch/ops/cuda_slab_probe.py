"""Slab-load probe (`ops/slab_probe.py`) on the card: the hand-written
kernel of `csrc/slab_probe.cu`, which replaces the TPU kernel
`tools/exp_dma_layouts.py:build`.

On CUDA tensors `slab_probe` launches the kernel or raises; on CPU tensors
it runs `slab_probe.slab_probe_plain`. `launch_count` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from imagestitch_tpu_torch.ops.slab_probe import (STEPS, TILE_W,
                                                  check_args,
                                                  slab_probe_plain,
                                                  source_hw, window_counts)

launch_count = 0


def _fn():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    fn = load_library().imagestitch_slab_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return fn


def slab_probe_cuda(src: torch.Tensor, h: int, tiled: bool,
                    steps: int = STEPS) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous, 16-byte aligned float32 CUDA
    source; returns the last step's (8, 128) sum."""
    global launch_count
    if not src.is_cuda:
        raise ValueError("slab_probe_cuda needs a CUDA tensor")
    check_args(src, h, tiled, steps)
    if not src.is_contiguous() or src.data_ptr() % 16:
        raise ValueError("slab_probe_cuda needs a contiguous, 16-byte "
                         "aligned source")
    pad_h, pad_w = source_hw(src, tiled)
    ny, nx = window_counts(pad_h, pad_w, h)
    out = torch.empty((8, TILE_W), dtype=torch.float32, device=src.device)
    fn = _fn()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            src.data_ptr(), out.data_ptr(), src.shape[0], pad_h, pad_w, h,
            int(tiled), ny, nx, steps, stream)
    from imagestitch_tpu_torch.ops.cuda_build import check
    check(status, "slab_probe kernel launch")
    launch_count += 1
    return out


def slab_probe(src: torch.Tensor, h: int, tiled: bool,
               steps: int = STEPS) -> torch.Tensor:
    """The probe's last-step (8, 128) sum: the CUDA kernel for a CUDA
    source, the plain version for a CPU source."""
    if src.is_cuda:
        return slab_probe_cuda(src, h, tiled, steps)
    if src.device.type != "cpu":
        raise ValueError(f"slab_probe: unsupported device {src.device}")
    return slab_probe_plain(src, h, tiled, steps)

