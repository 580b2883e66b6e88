"""Batched rotation warp: N (H, W, C) images into N (Hc, Wc) canvases of
one shared pano frame, with the signature and layouts of
`imagestitch_tpu/ops/pallas_warp.py:pallas_warp_batched`.

On CUDA tensors `warp_batched` launches the hand-written kernel of
`csrc/warp.cu` or raises; on CPU tensors it runs
`warp.warper.warp_batched_plain`, the JAX package's XLA warp path in plain
tensor code. `warp` is its one-image form (`pallas_warp`), the kernel route
of `warp.warper.warp_image`. `launch_count` counts the kernel launches of
`warp_batched_cuda`; `warp_launcher`, which exists only to time the kernel
apart from the wrapper, launches uncounted.

On the main path the launch is the only device work: the kernel reads
k_rinvs, scale, corners and roi_uvs through pointers to the caller's
tensors (one is converted only when it is not already on the card as
float32 or int32 in a layout the kernel reads), and the true sizes go by
value.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

KIND_IDS = {"cylindrical": 0, "spherical": 1, "plane": 2}
MAX_C = 8            # channels the kernel's row buffers hold (csrc/warp.cu)
MAX_SIZED = 64       # images whose true sizes go by value (csrc/warp.cu)

launch_count = 0
_fn = None


def _entry():
    """The C entry point, looked up and typed once."""
    global _fn
    if _fn is None:
        from imagestitch_tpu_torch.ops.cuda_build import load_library
        fn = load_library().imagestitch_warp
        fn.restype = ctypes.c_int
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, ctypes.c_float, I, P, I, I, P, P,
                       I, I, I, I, I, I, I, P]
        _fn = fn
    return _fn


def _on(t: torch.Tensor, dev, dtype) -> torch.Tensor:
    """t on `dev` as `dtype`, contiguous; no device work when it already
    is."""
    if t.device != dev or t.dtype != dtype:
        t = t.to(device=dev, dtype=dtype)
    return t.contiguous()


def _args(imgs, k_rinvs, scale, corners, roi_uvs, canvas_hw, kind,
          src_sizes):
    """Check the inputs and allocate the outputs. Returns (the C entry
    point's arguments but the stream, out, valid, kept): `kept` holds the
    tensors and buffers the arguments point into."""
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
    if C > MAX_C:
        raise ValueError(f"the warp kernel takes at most {MAX_C} channels, "
                         f"got {C}")
    Hc, Wc = canvas_hw
    if k_rinvs.shape != (N, 3, 3) or roi_uvs.shape != (N, 4) \
            or corners.shape != (N, 2):
        raise ValueError("k_rinvs (N,3,3), corners (N,2), roi_uvs (N,4) "
                         "expected")
    k_rinvs = _on(k_rinvs, dev, torch.float32)
    roi_uvs = _on(roi_uvs, dev, torch.float32)
    if corners.device != dev or corners.dtype != torch.int32:
        corners = corners.to(device=dev, dtype=torch.int32)
    if not isinstance(scale, torch.Tensor) and np.ndim(scale) > 0:
        scale = torch.as_tensor(np.asarray(scale, np.float32))
    if isinstance(scale, torch.Tensor) and (scale.is_cuda
                                            or scale.numel() != 1):
        if scale.numel() != 1 and tuple(scale.shape) != (N,):
            raise ValueError(f"scale: one value or (N,) = ({N},), got "
                             f"{tuple(scale.shape)}")
        scale = _on(scale.reshape(-1), dev, torch.float32)
        s_ptr, s_val = scale.data_ptr(), 0.0
        s_stride = 0 if scale.numel() == 1 else 1
    else:
        s_ptr, s_val, s_stride = None, float(scale), 0
    sizes = None
    if src_sizes is not None:
        if N > MAX_SIZED:
            raise ValueError(f"src_sizes: at most {MAX_SIZED} images, "
                             f"got {N}")
        if isinstance(src_sizes, torch.Tensor):
            src_sizes = src_sizes.cpu()
        hw = np.asarray(src_sizes, np.int64).reshape(-1).tolist()
        sizes = (ctypes.c_int * (2 * N))(*hw)
    out = torch.empty((N, Hc, Wc, C), dtype=torch.float32, device=dev)
    valid = torch.empty((N, Hc, Wc), dtype=torch.bool, device=dev)
    args = (imgs.data_ptr(), out.data_ptr(), valid.data_ptr(),
            k_rinvs.data_ptr(), s_ptr, s_val, s_stride, corners.data_ptr(),
            corners.stride(0), corners.stride(1), roi_uvs.data_ptr(),
            sizes, N, H, W, C, Hc, Wc, KIND_IDS[kind])
    return args, out, valid, (imgs, k_rinvs, scale, corners, roi_uvs, sizes)


def _launch(args, dev) -> None:
    with torch.cuda.device(dev):
        status = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        from imagestitch_tpu_torch.ops.cuda_build import check
        check(status, "warp kernel launch")


def warp_launcher(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                  corners: torch.Tensor, roi_uvs: torch.Tensor,
                  canvas_hw: tuple[int, int], kind: str = "cylindrical",
                  src_sizes=None):
    """For timing only: check the arguments of one warp and allocate its
    outputs. Returns (launch, out, valid): launch() runs the kernel alone
    into out and valid and does not add to `launch_count`, so the main
    path's count stays its own."""
    args, out, valid, kept = _args(imgs, k_rinvs, scale, corners, roi_uvs,
                                   canvas_hw, kind, src_sizes)
    _entry()

    def launch(kept=kept):      # kept: what the arguments point into
        _launch(args, imgs.device)

    return launch, out, valid


def warp_batched_cuda(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                      corners: torch.Tensor, roi_uvs: torch.Tensor,
                      canvas_hw: tuple[int, int], kind: str = "cylindrical",
                      src_sizes=None):
    """Launch the CUDA warp on (N, H, W[, C]) float32 contiguous CUDA
    images. Returns (out (N, Hc, Wc[, C]) float32, valid (N, Hc, Wc) bool)."""
    args, out, valid, _kept = _args(imgs, k_rinvs, scale, corners, roi_uvs,
                                    canvas_hw, kind, src_sizes)
    _launch(args, imgs.device)
    from imagestitch_tpu_torch.ops.cuda_build import count_launch
    count_launch(globals())
    if imgs.ndim == 3:
        out = out[..., 0]
    return out, valid


def warp_batched(imgs: torch.Tensor, k_rinvs: torch.Tensor, scale,
                 corners: torch.Tensor, roi_uvs: torch.Tensor,
                 canvas_hw: tuple[int, int], kind: str = "cylindrical",
                 src_sizes=None):
    """Warp (N, H, W[, C]) images into N (Hc, Wc) canvases in one launch.

    k_rinvs: (N, 3, 3) K·R⁻¹ backward projections; scale: the surface
    scale, one for every image (a number or a one-element tensor) or one
    per image ((N,): a batch of stitches, each with its own scale);
    corners: (N, 2) (x, y)
    canvas origins in pano coordinates; roi_uvs: (N, 4) [u0, v0, u1, v1]
    per-image surface ROIs; src_sizes: optional host (N, 2) [h, w] true
    sizes of images padded to a common shape. Returns (out, valid)."""
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


def warp(img: torch.Tensor, k_rinv: torch.Tensor, scale, corner: torch.Tensor,
         roi_uv: torch.Tensor, canvas_hw: tuple[int, int],
         kind: str = "cylindrical"):
    """Warp one (H, W[, C]) image into one (Hc, Wc) canvas: `warp_batched`
    on a batch of one, so one kernel launch on a CUDA tensor and the plain
    version on a CPU tensor. k_rinv: (3, 3) K·R⁻¹; scale: a number or a
    one-element tensor; corner: (2,) (x, y) canvas origin; roi_uv: (4,)
    [u0, v0, u1, v1]. Returns (out (Hc, Wc[, C]), valid (Hc, Wc))."""
    out, valid = warp_batched(img[None], k_rinv[None], scale, corner[None],
                              roi_uv[None], canvas_hw, kind)
    return out[0], valid[0]
