"""The benchmark's machinery, driven by data: a cell of `BENCHMARK.json`
names a configuration (`configs/<name>.json`), a traffic mix
(`traffic/<name>.json`) and metrics (`metrics/<name>.py`); a mix names
its driver (`drivers/<name>.py`) and its cameras (`poses/<name>.py`), a
configuration its reference surface (`surfaces/<name>.py`). This module
finds each by that name (`find.part`); nothing here knows a cell, a mix,
a scene or a surface.

A run: set-up (the program imported, the pool of views rendered on the
device from the seed and copied to the host once, the first call timed,
the warm-up calls), then either the measured window (`--trace 0`: the
end-to-end metrics) or a short traced window (`--trace 1`: the per-layer
metrics), then the comparison with the plain reference that decides
`correct`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from stitchbench import find, reference, scenes

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


# ---------------------------------------------------------------- finding


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def resolve_cell(bench: dict, workload: str) -> dict:
    """The cell `workload` with its configuration entry and file, its
    traffic file and the metrics it reports: {"workload", "config",
    "traffic", "end_to_end", "per_layer"}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "workload": cell,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    return find.part("metrics", name).read


def load_driver(name: str):
    """The `Driver` class (a `ClosedLoop`) of `drivers/<name>.py`."""
    return find.part("drivers", name).Driver


def load_poses(name: str):
    """The module `poses/<name>.py`: `views(traffic)`, `draw(traffic,
    count, rng)` and `cameras(angles, n)`."""
    return find.part("poses", name)


def pipeline_config(ist, settings: dict):
    """The program's PipelineConfig: its defaults with `settings` (the
    configuration file's "pipeline": top-level fields, and nested groups
    by their field name) replaced."""
    base = ist.PipelineConfig()
    top = {}
    for key, val in settings.items():
        cur = getattr(base, key)
        top[key] = (dataclasses.replace(cur, **val)
                    if dataclasses.is_dataclass(cur) else val)
    return dataclasses.replace(base, **top)


def resized(config: dict, view_hw) -> dict:
    """A copy of a configuration at another view size, for rehearsals and
    tests on the CPU: the focal follows the width, the work and compose
    megapixels the area."""
    out = json.loads(json.dumps(config))
    h0, w0 = config["view_hw"]
    out["view_hw"] = list(view_hw)
    out["focal_px"] = config["focal_px"] * view_hw[1] / w0
    area = view_hw[0] * view_hw[1] / (h0 * w0)
    pipe = out.setdefault("pipeline", {})
    for key in ("work_megapix", "compose_megapix"):
        if pipe.get(key, -1) > 0:
            pipe[key] = pipe[key] * area
    return out


# ---------------------------------------------------------------- inputs


@dataclasses.dataclass
class Item:
    """One pool entry: host uint8 views (n, h, w, 3) and their truth."""
    views: np.ndarray
    rotations: np.ndarray


def make_pool(config: dict, traffic: dict, seed: int,
              device: torch.device) -> list[Item]:
    """The traffic's pool of views, rendered on `device` from `seed` and
    copied to the host once; the cameras of each item from the traffic's
    `poses`."""
    h, w = config["view_hw"]
    f = float(config["focal_px"])
    count = int(traffic["pool"])
    ss = np.random.SeedSequence(seed).spawn(2)[0]
    rng = np.random.default_rng(ss)
    poses = load_poses(traffic["poses"])
    angles = poses.draw(traffic, count, rng)
    n = poses.views(traffic)
    pool = []
    for child, ang in zip(ss.spawn(count), angles):
        rots, half_span = poses.cameras(ang, n)
        views = scenes.render_views(rots, half_span, h, w, f,
                                    np.random.default_rng(child), device)
        pool.append(Item(views.cpu().numpy(), rots))
        del views
    return pool


def request_seeds(seed: int) -> np.random.Generator:
    """The RANSAC seeds of a run's calls, one after the other."""
    return np.random.default_rng(np.random.SeedSequence(seed).spawn(2)[1])


# ---------------------------------------------------------------- drivers


@dataclasses.dataclass
class Request:
    index: int
    item: int
    t0: float = 0.0
    t1: float = 0.0
    pano: np.ndarray | None = None
    focal: float | None = None
    metrics: dict = dataclasses.field(default_factory=dict)
    error: str | None = None
    ok: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class ClosedLoop:
    """One client that sends the next request when the last has returned:
    request i takes pool item i mod len(pool). Subclasses define `call`
    (item, seed) -> (pano, focal, metrics, ok)."""

    judged = ("focal_rel_err", "extent_rel_err", "tile_mad")

    def __init__(self, ist, cfg, config: dict, traffic: dict, pool,
                 device: torch.device, seeds: np.random.Generator):
        self.ist, self.cfg, self.config, self.traffic = ist, cfg, config, traffic
        self.pool, self.device, self.seeds = pool, device, seeds
        self.count = 0

    def prepare(self) -> None:
        """Set-up beyond the calls (a rig's calibration)."""

    def one(self, item: int) -> Request:
        r = Request(self.count, item)
        self.count += 1
        seed = int(self.seeds.integers(1 << 62))
        with torch.profiler.record_function("stitchbench.request"):
            r.t0 = time.perf_counter()
            try:
                r.pano, r.focal, r.metrics, r.ok = self.call(item, seed)
            except Exception as e:       # noqa: BLE001  (counted as failed)
                r.error = f"{type(e).__name__}: {e}"
            r.t1 = time.perf_counter()
        return r

    def window(self, seconds: float | None, count: int | None = None,
               start_item: int = 0):
        """Requests back to back until `seconds` have passed (the one in
        flight then completes) or `count` are done. Returns (requests,
        t_start, t_end, latencies in seconds)."""
        reqs = []
        t_start = time.perf_counter()
        i = start_item
        while True:
            if count is not None and len(reqs) >= count:
                break
            if seconds is not None and \
                    time.perf_counter() - t_start >= seconds:
                break
            reqs.append(self.one(i % len(self.pool)))
            i += 1
        return reqs, t_start, time.perf_counter(), [r.seconds for r in reqs]


# ---------------------------------------------------------------- a run

FORBIDDEN = ("jax", "jaxlib", "flax", "imagestitch_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is,
    whole, one of FORBIDDEN: `imagestitch_tpu_torch` is not
    `imagestitch_tpu`."""
    import sys
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile over all values (linear between the closest
    ranks, Python's `statistics.quantiles` inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    if q == 50:
        return float(statistics.median(values))
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[int(q) - 1])


def end_to_end(name: str, latencies, completed: int, window_s: float,
               setup_s: float) -> float:
    """An end-to-end metric by its name: `setup_s`, `panos_per_s`
    (completed panoramas over the whole window, the overrun of the last
    request included) or `latency_p<q>_ms` (over every request of the
    window)."""
    if name == "setup_s":
        return setup_s
    if name == "panos_per_s":
        return completed / window_s
    if name.startswith("latency_p") and name.endswith("_ms"):
        return percentile(latencies, float(name[len("latency_p"):-3])) * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


class Context:
    """What a per-layer reader sees: the cell's files, the program's
    configuration object, the traced requests, the trace's summary, the
    first call's seconds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def views_per_request(self) -> int:
        return load_poses(self.traffic["poses"]).views(self.traffic)


def judge_requests(reqs, pool, config: dict, device, compare_idx) -> dict:
    """The numbers that decide `correct`, the worst over `reqs`: focal
    and extent on every request that returned a panorama, the panorama
    against the reference on the requests at `compare_idx`."""
    ref_cfg = config["reference"]
    renders = {}
    worst: dict[str, float] = {}
    for i, r in enumerate(reqs):
        if r.pano is None or not r.ok:
            continue
        if r.item not in renders:
            it = pool[r.item]
            renders[r.item] = reference.render(
                torch.as_tensor(it.views, device=device), it.rotations,
                float(config["focal_px"]), ref_cfg["surface"],
                ref_cfg["wave_correct"])
        ref, valid = renders[r.item]
        got = reference.judge(r.pano, r.focal, {"f": float(config["focal_px"])},
                              ref, valid, i in compare_idx)
        if r.focal is None:
            del got["focal_rel_err"]
        for k, v in got.items():
            worst[k] = max(worst.get(k, -math.inf), v)
    return worst


def verdict(worst: dict, limits: dict, judged) -> tuple[dict, bool]:
    """Each judged number beside its limit, and whether every one is
    within it; a number that no request gave reads null and fails."""
    checks = {k: {"value": (worst[k] if math.isfinite(worst.get(k, math.inf))
                            else None), "limit": limits[k]}
              for k in judged}
    return checks, all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values())


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, log=print) -> dict:
    """One run of a resolved cell. Returns the result line's object."""
    import imagestitch_tpu_torch as ist
    config, traffic = cell["config"], cell["traffic"]
    cfg = pipeline_config(ist, config.get("pipeline", {}))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pool = make_pool(config, traffic, seed, device)
    driver = load_driver(traffic["driver"])(ist, cfg, config, traffic,
                                            pool, device, request_seeds(seed))
    t0 = time.perf_counter()
    driver.prepare()
    first, _, _, _ = driver.window(None, count=traffic.get("first", 1))
    first_call_s = time.perf_counter() - t0
    warm, _, _, _ = driver.window(None, count=int(traffic["warmup"]),
                                  start_item=len(first))
    start = len(first) + len(warm)
    setup_s = time.perf_counter() - t_process
    summary = None
    cpu_s = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("stitchbench.window"):
                reqs, w0, w1, lat = driver.window(
                    None, count=int(traffic["traced_requests"]),
                    start_item=start)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        from stitchbench import trace as trace_mod
        summary = trace_mod.summarize(trace_mod.raw_events(prof))
        del prof
    else:
        cpu0 = time.process_time()
        reqs, w0, w1, lat = driver.window(seconds, start_item=start)
        cpu_s = time.process_time() - cpu0
    window_s = w1 - w0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = len(reqs)
    failed = sum(1 for r in reqs if r.error is not None or not r.ok)
    for r in reqs:
        if r.error is not None:
            log(f"request {r.index} (item {r.item}) raised: {r.error}")
    metrics = {}
    if trace:
        ctx = Context(cell=cell["workload"], config=config, traffic=traffic,
                      cfg=cfg, requests=reqs, trace=summary,
                      first_call_s=first_call_s,
                      view_hw=tuple(config["view_hw"]))
        for m in cell["per_layer"]:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        completed = attempted - failed
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": end_to_end(
                m["name"], lat, completed, window_s, setup_s),
                "unit": m["unit"]}
    # the reference, once the window has closed and the peak is read
    judged = driver.judged
    del driver
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(3)[2])
    n_cmp = len(reqs) if trace else min(len(reqs),
                                        int(traffic["checked_panos"]))
    compare_idx = set(rng.choice(len(reqs), n_cmp, replace=False).tolist()) \
        if reqs else set()
    worst = judge_requests(reqs, pool, config, device, compare_idx)
    limits = config["limits"]
    checks, within = verdict(worst, limits, judged)
    correct = attempted > 0 and failed == 0 and within
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"][:10]]}
    out["checks"] = checks
    half = len(lat) // 2
    out["_extra"] = {"window_s": window_s, "first_call_s": first_call_s,
                     "p50_halves_ms": [percentile(x, 50) * 1e3
                                       for x in (lat[:half], lat[half:])
                                       if x],
                     "cpu_s": cpu_s, "threads": torch.get_num_threads(),
                     "latencies_ms": [round(x * 1e3, 1) for x in lat],
                     "items": [r.item for r in reqs],
                     "other_numbers": {k: v for k, v in worst.items()
                                       if k not in limits}}
    return out
