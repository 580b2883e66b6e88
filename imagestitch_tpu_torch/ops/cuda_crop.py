"""The readback and crop of a panorama in one launch of the hand-written
kernel of `csrc/crop_u8.cu`: one pass over the (H, W, 3) float32 canvas
and its (H, W) bool mask writes the canvas as uint8 (NumPy's
`np.clip(p, 0, 255).astype(np.uint8)`) and the valid pixels' bounding
box. Then only the box's four ints (16 bytes) and the cropped uint8
pixels cross to the host, the crop in one strided copy into a page-locked
staging buffer, and the caller gets its own NumPy copy of it. No host
pass over a canvas-sized array remains. `launch_count` counts the
launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

BBOX_BYTES = 16      # the bounding box's four int32 read back

launch_count = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"imagestitch_crop_u8": [_P, _P, _I, _I, _I, _P, _P, _P],
               "imagestitch_crop_copy": [_P, _I, _I, _I, _I, _I, _I, _P, _P]}
_fns: dict = {}
# one page-locked buffer per device, grown to a power of two holding the
# largest crop seen; the lock is held from the copy into it to the copy
# out, since `Stitcher` and the stream may be called from threads
_staging: dict[int, torch.Tensor] = {}
_staging_lock = threading.Lock()


def _entry(name: str):
    """The C entry point `name` of the kernel library, typed once."""
    fn = _fns.get(name)
    if fn is None:
        from imagestitch_tpu_torch.ops.cuda_build import load_library
        fn = getattr(load_library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _fns[name] = fn
    return fn


def _planar(pano: torch.Tensor) -> bool:
    """Whether the canvas is three contiguous channel planes (the
    multi-band blend's) rather than interleaved."""
    return not pano.is_contiguous() and pano.permute(2, 0, 1).is_contiguous()


def crop_u8(pano: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """The bbox crop of a CUDA (H, W, 3) float32 panorama as a host uint8
    array that the caller owns: the rows and columns holding the valid
    pixels of the (H, W) bool `valid`, each channel clipped to [0, 255]
    and truncated toward zero (NaN gives 0); with no valid pixel, the
    panorama's first pixel, (1, 1, 3). The same bytes as `_crop_valid` and
    the clip and cast of `pipeline._to_uint8` on the host. One kernel
    launch, then two copies to the host: the box's 16 bytes and the crop."""
    if pano.ndim != 3 or pano.shape[2] != 3 or pano.shape[0] < 1 or \
            pano.shape[1] < 1:
        raise ValueError(f"the crop kernel takes (H, W, 3) panoramas, got "
                         f"{tuple(pano.shape)}")
    if tuple(valid.shape) != tuple(pano.shape[:2]):
        raise ValueError(f"mask {tuple(valid.shape)} for a panorama "
                         f"{tuple(pano.shape)}")
    if pano.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"the crop kernel takes a float32 panorama and a "
                         f"bool mask, got {pano.dtype}, {valid.dtype}")
    if not pano.is_cuda or valid.device != pano.device:
        raise ValueError("cuda_crop.crop_u8 needs a CUDA panorama and its "
                         "mask on the same device")
    H, W = pano.shape[:2]
    planar = _planar(pano)
    pano = pano if planar else pano.contiguous()
    valid = valid.contiguous()
    dev = pano.device
    from imagestitch_tpu_torch.ops.cuda_build import check, count_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
        bbox = torch.empty(4, dtype=torch.int32, device=dev)
        status = _entry("imagestitch_crop_u8")(
            pano.data_ptr(), valid.data_ptr(), H, W, int(planar),
            out.data_ptr(), bbox.data_ptr(), stream)
        check(status, "crop kernel launch")
        count_launch(globals())
        ny0, nx0, y1, x1 = bbox.tolist()
        y0, x0 = (0, 0) if y1 < 0 else (-ny0, -nx0)
        h, w = (1, 1) if y1 < 0 else (y1 - y0 + 1, x1 - x0 + 1)
        n = h * w * 3
        with _staging_lock:
            buf = _staging.get(dev.index)
            if buf is None or buf.numel() < n:
                buf = torch.empty(1 << (n - 1).bit_length(),
                                  dtype=torch.uint8, pin_memory=True)
                _staging[dev.index] = buf
            status = _entry("imagestitch_crop_copy")(
                out.data_ptr(), H, W, y0, x0, h, w, buf.data_ptr(), stream)
            check(status, "crop copy")
            torch.cuda.current_stream().synchronize()
            return buf[:n].numpy().reshape(h, w, 3).copy()
