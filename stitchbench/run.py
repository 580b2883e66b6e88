"""Run one cell of the benchmark once.

    python3 stitchbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `stitchbench/`
and the program (`imagestitch_tpu_torch/`), on a machine with the CUDA
cards the cell asks for. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, each number that decided
`correct` beside its limit; the same numbers end standard error. Without
a card, with too few, or once the window has closed with `jax`,
`jaxlib`, `flax` or `imagestitch_tpu` loaded, it prints no result and
exits with another code than 0. The process keeps to `THREADS` CPU
threads, whatever the machine's count.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# load from one process with few threads, alike on every machine
THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

# every build and kernel cache under the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "stitchbench-cache" / _sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(out: dict) -> None:
    """Print the extras and the checks to standard error, the result line
    last on standard output."""
    extra = out.pop("_extra", {})
    print("stitchbench: " + json.dumps(extra), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


def main(argv=None, device=None, bench_path=None) -> int:
    """`device`: run there without looking for a card (tests)."""
    args = parse(argv)
    import torch
    torch.set_num_threads(THREADS)
    from stitchbench import harness
    cell = harness.resolve_cell(harness.load_benchmark(bench_path),
                                args.workload)
    if device is None:
        chips = int(cell["workload"]["chips"])
        if not torch.cuda.is_available():
            print("stitchbench: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"stitchbench: {torch.cuda.device_count()} CUDA devices, "
                  f"the cell asks for {chips}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device(device), T_PROCESS,
                           log=lambda s: print(s, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"stitchbench: loaded in this process: {found}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
