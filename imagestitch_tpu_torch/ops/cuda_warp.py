"""Batched rotation warp: N (H, W, C) images into N (Hc, Wc) canvases of
one shared pano frame, with the signature and layouts of
`imagestitch_tpu/ops/pallas_warp.py:pallas_warp_batched`.

On CUDA tensors `warp_batched` launches the hand-written kernel of
`csrc/warp.cu` or raises; on CPU tensors it runs
`warp.warper.warp_batched_plain`, the JAX package's XLA warp path in plain
tensor code. `launch_count` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

KIND_IDS = {"cylindrical": 0, "spherical": 1, "plane": 2}
_NF, _NI = 16, 4     # per-image parameter widths (csrc/warp.cu)

launch_count = 0


def _fn():
    from imagestitch_tpu_torch.ops.cuda_build import load_library
    fn = load_library().imagestitch_warp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    return fn


def warp_batched_cuda(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                      corners: torch.Tensor, roi_uvs: torch.Tensor,
                      canvas_hw: tuple[int, int], kind: str = "cylindrical",
                      src_sizes=None):
    """Launch the CUDA warp on (N, H, W[, C]) float32 contiguous CUDA
    images. Returns (out (N, Hc, Wc[, C]) float32, valid (N, Hc, Wc) bool)."""
    global launch_count
    if not imgs.is_cuda:
        raise ValueError("warp_batched_cuda needs CUDA tensors")
    if imgs.dtype != torch.float32 or imgs.ndim not in (3, 4):
        raise ValueError(f"expected (N, H, W[, C]) float32, got {imgs.dtype}"
                         f" {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("warp_batched_cuda needs contiguous images")
    if kind not in KIND_IDS:
        raise ValueError(f"the warp kernel has no projector {kind!r}")
    dev = imgs.device
    N, H, W = imgs.shape[:3]
    C = 1 if imgs.ndim == 3 else imgs.shape[3]
    Hc, Wc = canvas_hw
    if k_rinvs.shape != (N, 3, 3) or roi_uvs.shape != (N, 4) \
            or corners.shape != (N, 2):
        raise ValueError("k_rinvs (N,3,3), corners (N,2), roi_uvs (N,4) "
                         "expected")
    fpar = torch.zeros((N, _NF), dtype=torch.float32, device=dev)
    fpar[:, :9] = k_rinvs.reshape(N, 9).to(device=dev, dtype=torch.float32)
    fpar[:, 9] = torch.as_tensor(scale, dtype=torch.float32,
                                 device=dev).reshape(-1)
    fpar[:, 10:14] = roi_uvs.to(device=dev, dtype=torch.float32)
    fpar[:, 14] = float(KIND_IDS[kind])
    ipar = torch.empty((N, _NI), dtype=torch.int32, device=dev)
    ipar[:, :2] = corners.to(device=dev, dtype=torch.int32)
    if src_sizes is None:
        ipar[:, 2] = H
        ipar[:, 3] = W
    else:
        ipar[:, 2:] = torch.as_tensor(src_sizes, dtype=torch.int32,
                                      device=dev).reshape(N, 2)
    out = torch.empty((N, Hc, Wc, C), dtype=torch.float32, device=dev)
    valid = torch.empty((N, Hc, Wc), dtype=torch.bool, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(imgs.data_ptr(), out.data_ptr(), valid.data_ptr(),
                    fpar.data_ptr(), ipar.data_ptr(), N, H, W, C, Hc, Wc,
                    stream)
    from imagestitch_tpu_torch.ops.cuda_build import check
    check(status, "warp kernel launch")
    launch_count += 1
    if imgs.ndim == 3:
        out = out[..., 0]
    return out, valid


def warp_batched(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                 corners: torch.Tensor, roi_uvs: torch.Tensor,
                 canvas_hw: tuple[int, int], kind: str = "cylindrical",
                 src_sizes=None):
    """Warp (N, H, W[, C]) images into N (Hc, Wc) canvases in one launch.

    k_rinvs: (N, 3, 3) K·R⁻¹ backward projections; corners: (N, 2) (x, y)
    canvas origins in pano coordinates; roi_uvs: (N, 4) [u0, v0, u1, v1]
    per-image surface ROIs; src_sizes: optional (N, 2) [h, w] true sizes
    of images padded to a common shape. Returns (out, valid)."""
    if imgs.is_cuda:
        return warp_batched_cuda(imgs, k_rinvs, scale, corners, roi_uvs,
                                 canvas_hw, kind, src_sizes)
    if imgs.device.type != "cpu":
        raise ValueError(f"warp_batched: unsupported device {imgs.device}")
    from imagestitch_tpu_torch.warp.warper import warp_batched_plain
    squeeze = imgs.ndim == 3
    x = imgs[..., None] if squeeze else imgs
    out, valid = warp_batched_plain(x, k_rinvs, scale, corners, roi_uvs,
                                    canvas_hw, kind, src_sizes)
    return (out[..., 0] if squeeze else out), valid
