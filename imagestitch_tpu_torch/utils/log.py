"""Logging and per-stage wall-clock timers (`imagestitch_tpu.utils.log`):
each named stage's wall time is summed over its entries and returned as a
metrics dict, and each stage runs inside a `torch.profiler` range of its
name (the JAX package's `TraceAnnotation`), so a trace names the stages.
With `sync`, a stage ends by synchronizing its CUDA devices, so the device
work a stage launched counts to it."""

from __future__ import annotations

import contextlib
import logging
import time

import torch


def get_logger(name: str = "imagestitch_tpu_torch") -> logging.Logger:
    """The named logger at INFO with one stream handler (added once)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class StageTimer:
    """Sums wall ms per named stage. With `sync` (default), a stage ends
    with `torch.cuda.synchronize` of `device` (when it is a CUDA device)
    and of the CUDA devices of the tensors passed to `stage`."""

    def __init__(self, device=None, sync: bool = True):
        self.device = torch.device(device) if device is not None else None
        self.sync = sync
        self.times_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *tensors):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if self.sync:
                devices = {t.device for t in tensors
                           if isinstance(t, torch.Tensor) and t.is_cuda}
                if self.device is not None and self.device.type == "cuda":
                    devices.add(self.device)
                for d in devices:
                    torch.cuda.synchronize(d)
            self.times_ms[name] = self.times_ms.get(name, 0.0) + (
                time.perf_counter() - t0) * 1e3

    def summary(self) -> dict[str, float]:
        return dict(self.times_ms)
