"""Slab-load microbenchmark on the card: the cost of staging (C, h, 384)
source windows in shared memory, planar against 128-column-tiled sources.
The counterpart of the TPU tool `tools/exp_dma_layouts.py`.

For h in (16, 24, 32, 48) and each layout, the probe kernel
(`ops/cuda_slab_probe.py`, `csrc/slab_probe.cu`) copies 468 x 8 slabs of a
seeded (3, 1080, 1920) float32 source into shared memory, one tensor-map
copy per slab, on one persistent block per multiprocessor. Each line
gives the median time of one probe call:

- warm: calls back to back, the 24.9 MB source resident in the 50 MB L2;
- cold: before each call a write of a 256 MB buffer evicts L2,

with the slab bytes moved and the rate (slab bytes / time). Times on the
card are CUDA-event medians; with --device cpu the plain version runs and
is timed on the host clock. `--steps 468 396` times each grid in turn
(396 steps are three full waves of one-step blocks, one block an SM, on
132 SMs). `ceilings` times the card's L2 ceiling for the same bytes,
which `chip_smoke.py`'s dma_layouts phase prints beside the probe.

    python3 -m imagestitch_tpu_torch.tools.exp_dma_layouts [--device cpu]
        [--steps N ...]

The script runs against whichever `imagestitch_tpu_torch` the import path
finds first, so running this file by its path with another checkout's
root first on PYTHONPATH times that checkout's kernel with the same
harness.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from imagestitch_tpu_torch.ops import cuda_slab_probe
from imagestitch_tpu_torch.ops.cuda_slab_probe import slab_probe
from imagestitch_tpu_torch.ops.slab_probe import (NCH, SLAB_W, STEPS,
                                                  to_tiled)
from imagestitch_tpu_torch.pipeline import resolve_device
from imagestitch_tpu_torch.utils.timing import FLUSH_BYTES, median_ms

H, W, C = 1080, 1920, 3
HS = (16, 24, 32, 48)
SEED = 0


def source(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The seeded (C, H, W) planar float32 source and its tiled form."""
    rng = np.random.default_rng(SEED)
    planar = torch.as_tensor(rng.random((C, H, W)).astype(np.float32),
                             device=device)
    return planar, to_tiled(planar)


def slab_gb(h: int, steps: int = STEPS) -> float:
    """GB of slabs one probe call copies."""
    return steps * NCH * C * h * SLAB_W * 4 / 1e9


def run(device=None, hs=HS, steps: int = STEPS, reps: int = 20,
        flush_bytes: int = FLUSH_BYTES) -> list[dict]:
    """Time the probe at each slab height and layout; one row each with
    warm and cold ms, the slab GB moved, GB/s and the output's sum. Each
    row calls the probe 3 + 2 x reps times."""
    dev = resolve_device(device)
    planar, tiled = source(dev)
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device=dev)
    rows = []
    for h in hs:
        gb = slab_gb(h, steps)
        for layout, src in (("planar", planar), ("tiled", tiled)):
            is_t = layout == "tiled"

            def one(src=src, h=h, is_t=is_t):
                return slab_probe(src, h, is_t, steps)

            out = one()
            warm = median_ms(one, reps, dev)
            cold = median_ms(one, reps, dev, flush)
            rows.append({"h": h, "layout": layout, "device": dev.type,
                         "steps": steps, "gb": gb, "warm_ms": warm,
                         "cold_ms": cold, "warm_gbps": gb / warm * 1e3,
                         "cold_gbps": gb / cold * 1e3,
                         "checksum": float(out.double().sum())})
    return rows


def ceilings(src: torch.Tensor, nbytes: int, reps: int = 20) -> dict:
    """The card's L2 readings for `nbytes` of slabs, warm, from the CUDA
    source `src`: the ceiling the probe is held to (`l2_ceiling_*`, bulk
    copies, `cuda_slab_probe.l2_ceiling_cuda`) and the 16-byte-load reading
    (`l2_loads_*`, `l2_loads_cuda`), each in ms and TB/s of the bytes it
    read. Raises if a reading's values are not finite."""
    out = {}
    for key, fn in (("l2_ceiling", cuda_slab_probe.l2_ceiling_cuda),
                    ("l2_loads", cuda_slab_probe.l2_loads_cuda)):
        vals, nb = fn(src, nbytes)
        if not bool(torch.isfinite(vals).all()):
            raise RuntimeError(f"{key}: values not finite")
        ms = median_ms(lambda fn=fn: fn(src, nbytes), reps, src.device)
        out[f"{key}_ms"], out[f"{key}_tbps"] = ms, nb / ms / 1e9
    return out


def print_rows(rows: list[dict]) -> None:
    for r in rows:
        print(f"  steps={r['steps']} h={r['h']:2d} {r['layout']:>6}: warm "
              f"{r['warm_ms']:8.4f} ms ({r['warm_gbps']:7.1f} GB/s)  cold "
              f"{r['cold_ms']:8.4f} ms ({r['cold_gbps']:7.1f} GB/s)  "
              f"{r['gb']:.4f} GB [{r['device']}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain version")
    ap.add_argument("--steps", type=int, nargs="+", default=[STEPS],
                    help="grid sizes to time, in turn")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {name}, {NCH} slabs a step of "
          f"{C}x{{h}}x{SLAB_W} float32", file=sys.stderr)
    rows = []
    for steps in args.steps:
        rows += run(dev, steps=steps)
    print_rows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
