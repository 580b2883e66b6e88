"""The DP seam in one launch of the hand-written kernel of
`csrc/dp_seam.cu`: one thread block runs the forward recurrence of
`seam/dp.dp_seam_path` over every cost row, the argmin of the last row
and the backtrack, and writes the seam's columns to the device. Nothing
is read back. It takes rows of any width; `launch_count` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

launch_count = 0
_fn = None


def _entry():
    """The C entry point, looked up and typed once."""
    global _fn
    if _fn is None:
        from imagestitch_tpu_torch.ops.cuda_build import load_library
        fn = load_library().imagestitch_dp_seam
        fn.restype = ctypes.c_int
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P]
        _fn = fn
    return _fn


def seam_path(cost: torch.Tensor, transitions: int) -> torch.Tensor:
    """The minimal top-to-bottom path through (H, W) float32 costs on a
    CUDA device, with `seam/dp.dp_seam_path`'s rules (rows with no cost
    under BIG are free; the first minimum among left, straight, right; the
    lowest column of the last row's minimum), over `transitions` >= H - 1
    row steps, those past H - 1 free. Returns the seam column per row,
    (H,) int64 on the cost's device, without a sync."""
    if cost.ndim != 2 or cost.shape[0] < 1 or cost.shape[1] < 1:
        raise ValueError(f"the DP kernel takes (H, W) costs with H, W >= 1,"
                         f" got {tuple(cost.shape)}")
    H, W = cost.shape
    if transitions < H - 1:
        raise ValueError(f"{transitions} transitions for {H} cost rows")
    if cost.dtype != torch.float32:
        raise ValueError(f"the DP kernel takes float32 costs, got "
                         f"{cost.dtype}")
    if not cost.is_cuda:
        raise ValueError("cuda_dp.seam_path needs a CUDA tensor")
    cost = cost.contiguous()
    dev = cost.device
    m_scratch = torch.empty(2 * W, dtype=torch.float32, device=dev)
    choices = torch.empty((transitions, W), dtype=torch.int8, device=dev)
    cols = torch.empty(H, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        status = _entry()(cost.data_ptr(), H, W, transitions,
                          m_scratch.data_ptr(), choices.data_ptr(),
                          cols.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    from imagestitch_tpu_torch.ops.cuda_build import check, count_launch
    check(status, "DP seam kernel launch")
    count_launch(globals())
    return cols
