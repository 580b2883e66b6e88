"""Readings that the limits of `correct` are set from: the program on many
seeds, the control and the faults, at a cell's own size, in one process.
The benchmark's own runs never run this.

    python3 stitchbench/calibrate.py --config default_1080p \\
        --traffic pair_closed1 --seeds 1,2,3 --variants program,reference_bf16

Per variant and seed: the seed's pool, `--requests` requests (default:
each pool item once) through the traffic's driver, every answer judged
against the reference with its panorama compared; one JSON line each
with the worst of every number. Variants:

- `program`: the program as the configuration states it;
- `reference_bf16`: the control: the reference put in the program's
  place, its geometry computed in bfloat16, the precision below the
  float32 that both configurations state; its answers are its panorama
  and the true focal as bfloat16 holds it;
- `no_ba`: the program's own path without the bundle adjustment
  (`CameraConfig(ba_refine=False)`), which breaks the ray bundle
  adjustment that both configurations state;
- `tf32`: the program with TF32 on for its matrix products (its
  `set_full_precision` switched off);
- `fault_pano`: the program's panorama altered where it is produced, its
  middle sixteenth inverted;
- `fault_slip`: the same, its right half moved right by 1% of its width
  (a slip at the seam);
- `fault_focal`: the program's reported focal 5% high.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("program", "reference_bf16", "no_ba", "tf32", "fault_pano",
            "fault_slip", "fault_focal")


def shift_right_half(pano, px: int | None = None):
    """The right half of a panorama moved `px` to the right (default: 1%
    of its width)."""
    import numpy as np
    px = px or max(1, round(pano.shape[1] / 100))
    out = pano.copy()
    mid = pano.shape[1] // 2
    out[:, mid + px:] = pano[:, mid:pano.shape[1] - px]
    return np.ascontiguousarray(out)


def invert_middle(pano):
    """The middle sixteenth of a panorama inverted."""
    out = pano.copy()
    h, w = out.shape[:2]
    out[h * 3 // 8:h * 5 // 8, w * 3 // 8:w * 5 // 8] ^= 255
    return out


def plant(driver, variant: str) -> None:
    """Alter the driver's answers where they are produced."""
    call = driver.call

    if variant in ("fault_pano", "fault_slip"):
        alter = invert_middle if variant == "fault_pano" else shift_right_half

        def faulty(item, seed):
            pano, focal, m, ok = call(item, seed)
            return alter(pano), focal, m, ok
    elif variant == "fault_focal":
        def faulty(item, seed):
            pano, focal, m, ok = call(item, seed)
            return pano, 1.05 * focal, m, ok
    else:
        return
    driver.call = faulty


def reference_answers(pool, config, device, dtype):
    """The reference put in the program's place, its geometry in `dtype`:
    its panorama (uint8) and the true focal as `dtype` holds it."""
    import torch
    from stitchbench import harness, reference
    reqs = []
    for i, it in enumerate(pool):
        pano, _ = reference.render(
            torch.as_tensor(it.views, device=device), it.rotations,
            float(config["focal_px"]), config["reference"]["surface"],
            config["reference"]["wave_correct"], dtype=dtype)
        r = harness.Request(i, i)
        r.pano = pano.clamp(0, 255).to(torch.uint8).cpu().numpy()
        r.focal = float(torch.tensor(float(config["focal_px"]), dtype=dtype))
        r.ok = True
        reqs.append(r)
    return reqs


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--view-hw", default=None,
                    help="H,W: rehearse at another view size (the focal "
                         "and the work megapixels follow the area)")
    args = ap.parse_args(argv)
    import torch
    from stitchbench import harness
    import imagestitch_tpu_torch as ist
    from imagestitch_tpu_torch import pipeline

    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    config = harness.load_json(harness.BENCH_DIR / "configs"
                               / f"{args.config}.json")
    traffic = harness.load_json(harness.BENCH_DIR / "traffic"
                                / f"{args.traffic}.json")
    if args.view_hw:
        config = harness.resized(config, [int(v) for v in
                                          args.view_hw.split(",")])
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    base_cfg = harness.pipeline_config(ist, config.get("pipeline", {}))
    full_precision = pipeline.set_full_precision
    for variant in args.variants.split(","):
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}")
        cfg = base_cfg
        if variant == "no_ba":
            cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
                cfg.camera, ba_refine=False))

        def tf32_on():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

        pipeline.set_full_precision = (tf32_on if variant == "tf32"
                                       else full_precision)
        for seed in seeds:
            t0 = time.perf_counter()
            pool = harness.make_pool(config, traffic, seed, device)
            n = args.requests or len(pool)
            if variant == "reference_bf16":
                reqs = reference_answers(pool, config, device,
                                         torch.bfloat16)[:n]
            else:
                driver = harness.load_driver(traffic["driver"])(
                    ist, cfg, config, traffic, pool, device,
                    harness.request_seeds(seed))
                plant(driver, variant)
                driver.prepare()
                reqs, _, _, _ = driver.window(None, count=n)
                del driver
            failed = [r.index for r in reqs if r.error or not r.ok]
            per = []
            for r in reqs:
                got = harness.judge_requests([r], pool, config, device, {0})
                per.append({"item": r.item, **{k: round(v, 6)
                                               for k, v in got.items()}})
            worst = {}
            for p in per:
                for k, v in p.items():
                    if k != "item":
                        worst[k] = max(worst.get(k, float("-inf")), v)
            judged = harness.load_driver(traffic["driver"]).judged
            checks, within = harness.verdict(worst, config["limits"], judged)
            line = {"config": args.config, "traffic": args.traffic,
                    "variant": variant, "seed": seed, "requests": len(reqs),
                    "failed": failed, "correct": within and not failed,
                    "worst": worst, "per_request": per,
                    "seconds": round(time.perf_counter() - t0, 2)}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    pipeline.set_full_precision = full_precision
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
