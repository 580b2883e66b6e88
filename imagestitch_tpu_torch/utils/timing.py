"""Timing of one call on the card, warm or with L2 flushed: what
`chip_smoke.py` and the slab-load probe tool (`tools/exp_dma_layouts.py`)
use to time a kernel alone. `median_ms` times a bare launch with CUDA
events; `kernel_ms` reads the device time of the named kernels a call
runs from `torch.profiler`, so it times a kernel alone through its public
wrapper."""

from __future__ import annotations

import statistics
import time

import torch

FLUSH_BYTES = 256 << 20     # > 5x the H100's 50 MB L2
_SLEEP_CYCLES = 2_000_000   # ~1 ms: the host enqueues the call meanwhile


def median_ms(fn, reps: int, device: torch.device,
              flush: torch.Tensor | None = None) -> float:
    """Median ms of one fn() call over `reps`, after one warm-up call; with
    `flush`, the buffer is written before each call. On the card: CUDA
    events around the call alone, the stream held by a sleep kernel so
    that the host's launch time stays outside them. On the CPU: the host
    clock."""
    fn()
    if device.type != "cuda":
        ts = []
        for i in range(reps):
            if flush is not None:
                flush.fill_(float(i))
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(statistics.median(ts))
    pairs = []
    for i in range(reps):
        if flush is not None:
            flush.fill_(float(i))
        torch.cuda._sleep(_SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs))


def kernel_ms(fn, rounds: int, names: tuple[str, ...],
              flush: torch.Tensor | None = None) -> float:
    """Median over `rounds` fn() calls of the summed device time of the
    CUDA kernels each call runs whose names hold one of `names`, from
    torch.profiler kernel events: the host's launch time and every other
    kernel stay outside. With `flush`, the buffer is written before each
    call; without, a short sleep kernel runs there instead. That kernel
    marks where one call's kernels end: a call whose trace lost kernels,
    or lost the mark before it (another kernel count than most calls
    show), is left out, and the function raises if half or more are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(rounds):
            if flush is not None:
                flush.fill_(float(i))
            else:
                torch.cuda._sleep(1000)
            fn()
        torch.cuda.synchronize()
    calls, cur = [], []
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if any(n in e.name for n in names):
            cur.append(e.time_range.elapsed_us())
        elif cur:
            calls.append(cur)
            cur = []
    if cur:
        calls.append(cur)
    full = statistics.mode(len(c) for c in calls) if calls else 0
    sums = [sum(c) for c in calls if len(c) == full]
    if not full or 2 * len(sums) <= rounds:
        raise RuntimeError(f"{len(sums)} of {rounds} calls traced whole "
                           f"({[len(c) for c in calls]} kernels matching "
                           f"{names})")
    return float(statistics.median(sums)) / 1e3
