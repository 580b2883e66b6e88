"""Timing of one call on the card, warm or with L2 flushed: what
`chip_smoke.py` and the slab-load probe tool (`tools/exp_dma_layouts.py`)
use to time a kernel alone."""

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
