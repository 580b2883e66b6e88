"""The bundle adjustment's Levenberg–Marquardt loop in one launch of the
hand-written kernel of `csrc/lm_bundle.cu`: one thread block runs the
whole minimisation of `geometry/bundle._lm_minimize` for the ray or the
reprojection residual, and the host reads x, the final error and the
iterations run back with one copy.

The kernel holds the damped normal equations and their factor in shared
memory, so it takes at most `MAX_PARAMS` parameters (32 ray cameras, 18
reprojection cameras); `geometry/bundle` takes the plain loop for more,
and for CPU tensors. `launch_count` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

MAX_PARAMS = 128     # A and its factor: 2 x 64 KB of shared memory
PARAMS_PER_CAMERA = {"ray": 4, "reproj": 7}
KIND_IDS = {"ray": 0, "reproj": 1}

launch_count = 0
_fn = None


def fits(n_params: int) -> bool:
    """Whether the kernel's shared-memory system holds `n_params`."""
    return n_params <= MAX_PARAMS


def _entry():
    """The C entry point, looked up and typed once."""
    global _fn
    if _fn is None:
        from imagestitch_tpu_torch.ops.cuda_build import load_library
        fn = load_library().imagestitch_lm_bundle
        fn.restype = ctypes.c_int
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, P, P]
        _fn = fn
    return _fn


def _on(t: torch.Tensor, dev, dtype) -> torch.Tensor:
    """t on `dev` as `dtype`, contiguous; no device work when it already
    is."""
    if t.device != dev or t.dtype != dtype:
        t = t.to(device=dev, dtype=dtype)
    return t.contiguous()


def lm_minimize(kind: str, x0: torch.Tensor, src_pts: torch.Tensor,
                dst_pts: torch.Tensor, pt_valid: torch.Tensor,
                pair_valid: torch.Tensor, pair_from: torch.Tensor,
                pair_to: torch.Tensor, ppx: torch.Tensor | None,
                ppy: torch.Tensor | None, iters: int):
    """Minimise the `kind` ("ray" or "reproj") residual of
    `geometry/bundle` from x0 ((N·K,) float32 on a CUDA device, K
    parameters per camera) over (P, T, 2) correspondences with the plain
    loop's damping schedule and stopping rule, in one launch. pt_valid:
    (P, T) bool; pair_valid, pair_from, pair_to: (P,); ppx, ppy: (N,) the
    ray residual's principal points (unused by "reproj").

    Returns (x (N·K,) float32 on x0's device, iterations run, final
    error); the one readback is the call's only sync."""
    if kind not in KIND_IDS:
        raise ValueError(f"the LM kernel has no residual {kind!r}")
    n = x0.numel()
    K = PARAMS_PER_CAMERA[kind]
    if n % K or not fits(n):
        raise ValueError(f"the LM kernel takes N·{K} <= {MAX_PARAMS} "
                         f"parameters, got {n}")
    P, T = pt_valid.shape
    if src_pts.shape != (P, T, 2) or dst_pts.shape != (P, T, 2) \
            or pair_valid.shape != (P,) or pair_from.shape != (P,) \
            or pair_to.shape != (P,):
        raise ValueError("src_pts, dst_pts (P, T, 2), pt_valid (P, T), "
                         "pair_valid, pair_from, pair_to (P,) expected")
    if kind == "ray" and any(v is None or v.shape != (n // K,)
                             for v in (ppx, ppy)):
        raise ValueError("the ray residual needs ppx, ppy (N,)")
    if not x0.is_cuda:
        raise ValueError("cuda_lm.lm_minimize needs CUDA tensors")
    dev = x0.device
    x0 = _on(x0, dev, torch.float32)
    src = _on(src_pts, dev, torch.float32)
    dst = _on(dst_pts, dev, torch.float32)
    ptv = _on(pt_valid, dev, torch.bool)
    pv = _on(pair_valid, dev, torch.bool)
    pf = _on(pair_from, dev, torch.int64)
    pt = _on(pair_to, dev, torch.int64)
    pp = [None if v is None else _on(v, dev, torch.float32)
          for v in (ppx, ppy)]
    out = torch.empty(n + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _entry()(
            KIND_IDS[kind], x0.data_ptr(), src.data_ptr(), dst.data_ptr(),
            ptv.data_ptr(), pv.data_ptr(), pf.data_ptr(), pt.data_ptr(),
            *(None if v is None else v.data_ptr() for v in pp), n // K, P,
            T, int(iters), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    from imagestitch_tpu_torch.ops.cuda_build import check, count_launch
    check(status, "LM kernel launch")
    count_launch(globals())
    host = out.cpu()
    iters_run = int(host[n + 1])
    if iters_run < 0:
        raise ValueError("bundle adjustment: a pair index lies outside "
                         "the cameras")
    return (out[:n].view(torch.float32), iters_run,
            float(host[n:n + 1].view(torch.float32)))
