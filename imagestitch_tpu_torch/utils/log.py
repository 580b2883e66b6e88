"""Per-stage wall-clock timers (`imagestitch_tpu.utils.log.StageTimer`):
each named stage's wall time is summed over its entries and returned as a
metrics dict. On a CUDA device a stage ends with
`torch.cuda.synchronize()`, so the device work a stage launched counts
to it."""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimer:
    """Sums wall ms per named stage; `device` (a CUDA device) is
    synchronized at the end of every stage."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.sync = self.device is not None and self.device.type == "cuda"
        self.times_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize(self.device)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            time.perf_counter() - t0) * 1e3

    def summary(self) -> dict[str, float]:
        return dict(self.times_ms)
