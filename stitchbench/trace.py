"""Reading a `torch.profiler` trace of the traced window: the device's busy
time (the union of its kernels, copies and memsets), device time by
operation name, and the idle gaps named by the host range open during
them. The events stay in memory; nothing is written.

The kernel-time arithmetic follows `imagestitch_tpu_torch.utils.timing`
(`_traced_calls`: the device's kernels in a profiler trace, durations
by name), copied here so that the yardstick does not move with the
program.
"""

from __future__ import annotations

import bisect
import collections

WINDOW = "stitchbench.window"
# kineto activity types of the device's own work; a `record_function`
# range is mirrored on the device's timeline as a "gpu_user_annotation",
# which is not work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def raw_events(prof) -> list[tuple[str, str, int, int]]:
    """(kind, name, start ns, end ns) of every event of a finished
    `torch.profiler.profile`, read from its kineto results without
    building the profiler's event tree (which takes minutes on a traced
    stitch). `kind` is kineto's activity type ("kernel", "gpu_memcpy",
    "user_annotation", ...), or where the event does not say (older
    torch), "user_annotation" / "gpu_user_annotation" for a range and
    "kernel" for other device events."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    host_ranges = {e.name() for e in events
                   if e.device_type() != DeviceType.CUDA
                   and _is_range(e)}
    out = []
    for e in events:
        if hasattr(e, "activity_type"):
            kind = e.activity_type()
        elif e.device_type() == DeviceType.CUDA:
            kind = ("gpu_user_annotation" if e.name() in host_ranges
                    else "kernel")
        else:
            kind = "user_annotation" if _is_range(e) else "cpu_op"
        out.append((kind, e.name(), e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out


def _is_range(e) -> bool:
    """A host `record_function` range: asked of the event where it can
    say, else told by its name (an operator's holds "::", a runtime
    call's starts with "cu")."""
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    n = e.name()
    return "::" not in n and not n.startswith("cu")


def summarize(events) -> dict:
    """From `raw_events` of a trace holding one `WINDOW` range:
    {"window_s", "busy_s", "device_ops": [(name, s)] by time, "idle_gaps":
    [(host range, s)] by time, "kernel_s": {name: s}} over the window."""
    ranges = sorted((a, b, n) for t, n, a, b in events
                    if t == "user_annotation")
    wins = [(a, b) for a, b, n in ranges if n == WINDOW]
    if not wins:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = wins[0]
    spans = []
    by_name: dict[str, float] = collections.defaultdict(float)
    for t, n, a, b in events:
        if t not in DEVICE_WORK:
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[n] += (b - a) * 1e-9
    spans.sort()
    merged: list[list[int]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = []
    cur = w0
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    starts = [a for a, _, _ in ranges]
    idle: dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        # the innermost range open at the gap's middle: the latest start
        name = "(no host range)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ranges[i][1] >= mid:
                name = ranges[i][2]
                break
        idle[name] += (b - a) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
        "kernel_s": dict(by_name),
    }


def kernel_seconds(summary: dict, names: tuple[str, ...]) -> float:
    """Device seconds in the window of the kernels whose names hold one of
    `names`."""
    return sum(s for n, s in summary["kernel_s"].items()
               if any(k in n for k in names))
