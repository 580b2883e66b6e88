"""Cells of BENCHMARK.json cut to a size a CPU test run can hold: the
views at 540x960 (the focal and the work megapixels follow, so
registration stays as well posed as at 1080p), a pool of two, no warm-up,
one request in the window."""

from __future__ import annotations

import time

import torch

from stitchbench import harness

HW = (540, 960)


def small_cell(workload: str, bench: dict | None = None, **traffic) -> dict:
    cell = harness.resolve_cell(bench or harness.load_benchmark(), workload)
    cell["config"] = harness.resized(cell["config"], HW)
    t = cell["traffic"]
    t.update(pool=min(int(t["pool"]), 3 if t["driver"] == "rig" else 2),
             warmup=0, traced_requests=1, checked_panos=1)
    if t["driver"] == "serve":
        t.update(clients=2, batch=2, first=2, traced_requests=2)
    t.update(traffic)
    return cell


def run_small(cell: dict, trace: bool = False, seed: int = 2**31 + 11,
              seconds: float = 0.01) -> dict:
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda s: None)
