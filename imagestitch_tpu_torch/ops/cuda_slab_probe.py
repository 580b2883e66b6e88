"""Slab-load probe (`ops/slab_probe.py`) on the card: the hand-written
kernel of `csrc/slab_probe.cu`, which replaces the TPU kernel
`tools/exp_dma_layouts.py:build`.

On CUDA tensors `slab_probe` launches the kernel or raises; on CPU tensors
it runs `slab_probe.slab_probe_plain`. `launch_count` counts kernel
launches. The wrapper hands the kernel the tensor map of
`slab_probe.tensor_map_spec` (encoded in C, per call) and the persistent
grid of `probe_blocks`.

`l2_ceiling_cuda` runs the same library's L2 ceiling: one block per
multiprocessor keeps 1-D bulk copies of an L2-resident source in flight
into shared memory (the probe's own path, without its tensor map and its
reads). `l2_loads_cuda` reads the source the same way with 16-byte loads,
a reading beside the ceiling, not a ceiling (the probe's copies outrun it
at small slab heights). Neither ports a TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from imagestitch_tpu_torch.ops.slab_probe import (STEPS, TILE_W,
                                                  check_args, coord_dims,
                                                  slab_probe_plain,
                                                  source_hw,
                                                  tensor_map_spec,
                                                  window_counts)

launch_count = 0


def _lib():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    lib = load_library()
    lib.imagestitch_slab_probe.restype = ctypes.c_int
    lib.imagestitch_slab_probe.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    for fn in (lib.imagestitch_l2_ceiling, lib.imagestitch_l2_loads):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 3
    return lib


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def probe_blocks(device: torch.device, steps: int) -> int:
    """The persistent grid: one block per multiprocessor, at most one per
    step (so each block copies at least a step's NCH slabs)."""
    return min(sm_count(device), steps)


def _check_source(src: torch.Tensor, what: str) -> None:
    if not src.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if not src.is_contiguous() or src.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned "
                         "source")


def slab_probe_cuda(src: torch.Tensor, h: int, tiled: bool,
                    steps: int = STEPS) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous, 16-byte aligned float32 CUDA
    source; returns the last step's (8, 128) sum."""
    _check_source(src, "slab_probe_cuda")
    check_args(src, h, tiled, steps)
    ny, nx = window_counts(*source_hw(src, tiled), h)
    spec = tensor_map_spec(tuple(src.shape), tiled, h)
    ydim, xdim = coord_dims(tiled)
    out = torch.empty((8, TILE_W), dtype=torch.float32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.imagestitch_slab_probe(
            src.data_ptr(), out.data_ptr(), (ctypes.c_uint64 * 4)(*spec.dims),
            (ctypes.c_uint64 * 3)(*spec.strides),
            (ctypes.c_uint32 * 4)(*spec.box), ydim, xdim, ny, nx, steps,
            probe_blocks(src.device, steps), stream)
    if status < 0:
        raise RuntimeError(f"slab_probe: cuTensorMapEncodeTiled failed with "
                           f"CUresult {-status} for {spec}")
    from imagestitch_tpu_torch.ops.cuda_build import (check,
                                                       count_launch)
    check(status, "slab_probe kernel launch")
    count_launch(globals())
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


def _l2_read(symbol: str, src: torch.Tensor, nbytes: int, what: str):
    _check_source(src, what)
    if src.dtype != torch.float32:
        raise ValueError(f"{what} needs a float32 source, got {src.dtype}")
    blocks = sm_count(src.device)
    out = torch.empty(blocks, dtype=torch.float32, device=src.device)
    read = ctypes.c_longlong(0)
    fn = getattr(_lib(), symbol)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(src.data_ptr(), src.numel(), nbytes, blocks,
                    out.data_ptr(), ctypes.byref(read), stream)
    from imagestitch_tpu_torch.ops.cuda_build import check
    check(status, f"{what} kernel launch")
    return out, read.value


def l2_ceiling_cuda(src: torch.Tensor,
                    nbytes: int) -> tuple[torch.Tensor, int]:
    """Copy `nbytes` (rounded up to whole 32 KB chunks) of a float32 CUDA
    source, L2-resident when the caller has just read it, into shared
    memory: one block per multiprocessor, the chunks split over the blocks
    as the probe splits its slabs, seven 1-D bulk copies in flight on
    each. Returns the blocks' last-copied floats, shape (blocks,), and the
    bytes copied."""
    return _l2_read("imagestitch_l2_ceiling", src, nbytes,
                    "l2_ceiling_cuda")


def l2_loads_cuda(src: torch.Tensor,
                  nbytes: int) -> tuple[torch.Tensor, int]:
    """Read at least `nbytes` of a float32 CUDA source with one block of
    1024 threads per multiprocessor, each with four 16-byte loads in
    flight; returns the blocks' sums, shape (blocks,), and the bytes read
    (whole rounds)."""
    return _l2_read("imagestitch_l2_loads", src, nbytes,
                    "l2_loads_cuda")
