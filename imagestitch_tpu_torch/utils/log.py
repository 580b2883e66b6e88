"""Logging and per-stage wall-clock timers (`imagestitch_tpu.utils.log`):
each named stage's wall time is summed over its entries and returned as a
metrics dict, and each stage runs inside a `torch.profiler` range of its
name (the JAX package's `TraceAnnotation`), so a trace names the stages.
With `sync`, a stage ends by synchronizing its CUDA devices, so the device
work a stage launched counts to it. A timer also sums named counters.

An entry point makes its timer *active* (`with timer.active():`) for the
code it calls: the module-level `stage` and `count` act on the active
timer of the current context, and do nothing where none is active
(`stage` then opens no range). The active timer is a `contextvars`
variable, so a thread starts with none: the shards a mesh runs in threads
and the serving batcher record nothing unless they make a timer of their
own active."""

from __future__ import annotations

import contextlib
import contextvars
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
    """Sums wall ms per named stage and counts per named counter. With
    `sync` (default), a stage ends with `torch.cuda.synchronize` of
    `device` (when it is a CUDA device) and of the CUDA devices of the
    tensors passed to `stage`."""

    def __init__(self, device=None, sync: bool = True):
        self.device = torch.device(device) if device is not None else None
        self.sync = sync
        self.times_ms: dict[str, float] = {}
        self.counters: dict[str, int] = {}

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

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def summary(self) -> dict[str, float]:
        """Wall ms per stage."""
        return dict(self.times_ms)

    def counts(self) -> dict[str, int]:
        return dict(self.counters)

    @contextlib.contextmanager
    def active(self):
        """Make this timer the one `stage` and `count` act on in the
        current context, until the block ends."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


_ACTIVE: contextvars.ContextVar[StageTimer | None] = contextvars.ContextVar(
    "imagestitch_tpu_torch_active_timer", default=None)


def stage(name: str, *tensors):
    """A stage of the active timer (`StageTimer.stage`), or with none
    active a `nullcontext`."""
    timer = _ACTIVE.get()
    if timer is None:
        return contextlib.nullcontext()
    return timer.stage(name, *tensors)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the active timer's counter `name`; nothing with none
    active."""
    timer = _ACTIVE.get()
    if timer is not None:
        timer.count(name, n)
