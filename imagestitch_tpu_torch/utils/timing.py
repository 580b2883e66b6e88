"""Timing of one call on the card, warm or with L2 flushed: what
`chip_smoke.py` and the slab-load probe tool (`tools/exp_dma_layouts.py`)
use to time a kernel alone. `median_ms` times a bare launch with CUDA
events; `kernel_ms` reads the device time of the named kernels a call
runs from `torch.profiler`, so it times a kernel alone through its public
wrapper. `smi_line` names the card beside a time."""

from __future__ import annotations

import statistics
import subprocess
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
    CUDA kernels each call runs whose names hold one of `names`
    (`kernel_split_ms`'s "ms")."""
    return kernel_split_ms(fn, rounds, names, flush)["ms"]


def kernel_split_ms(fn, rounds: int, names: tuple[str, ...],
                    flush: torch.Tensor | None = None) -> dict:
    """Device time of the CUDA kernels fn() runs whose names hold one of
    `names`, from torch.profiler kernel events: the host's launch time
    and every other kernel stay outside. Returns "ms", the median over
    `rounds` calls of their summed time; "by_name", for each of `names`
    the median over the calls of its kernels' summed time; "kernels",
    the number of such kernels one call runs. With `flush`, the buffer
    is written before each call; without, a short sleep kernel runs there
    instead. That kernel marks where one call's kernels end: a call whose
    trace lost kernels, or lost the mark before it (another kernel count
    than most calls show), is left out. If half or more are, the rounds
    are traced once more, and the function raises if that trace too
    loses half of them."""
    for _ in range(2):
        calls = _traced_calls(fn, rounds, names, flush)
        full = statistics.mode(len(c) for c in calls) if calls else 0
        whole = [c for c in calls if len(c) == full]
        if full and 2 * len(whole) > rounds:
            break
    else:
        raise RuntimeError(f"{len(whole)} of {rounds} calls traced whole "
                           f"({[len(c) for c in calls]} kernels matching "
                           f"{names})")

    def median(pick) -> float:
        return float(statistics.median(
            sum(us for name, us in c if pick(name)) for c in whole)) / 1e3

    return {"ms": median(lambda name: True),
            "by_name": {n: median(lambda name, n=n: n in name)
                        for n in names},
            "kernels": full}


def _traced_calls(fn, rounds, names, flush):
    """One torch.profiler trace of `rounds` fn() calls: per call, the
    (name, us) of its kernels whose names hold one of `names`."""
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
            cur.append((e.name, e.time_range.elapsed_us()))
        elif cur:
            calls.append(cur)
            cur = []
    if cur:
        calls.append(cur)
    return calls


def smi_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
