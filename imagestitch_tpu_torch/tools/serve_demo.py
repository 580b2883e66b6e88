"""Batched-serving demo of the port (`tools/serve_demo.py`): a request /
response loop over one `stitch_pairs_batched` call per batch.

  producer threads enqueue (pair, event) requests
  -> a batcher thread collects up to --batch requests or --linger ms
  -> one stitch_pairs_batched dispatch serves them (one detector-maps
     launch and one warp launch for the whole batch on the card)
  -> each request gets the bbox crop of its float32 canvas

    python -m imagestitch_tpu_torch.tools.serve_demo --requests 64 \
        --batch 8 --size 192x256

Runs on --device (default: the CUDA card; with no card it raises).

No padding: the JAX demo pads a partial batch to --batch so that one XLA
executable serves every load level. The port has no executable to keep
and dispatches the n requests it holds: each pair's result does not
depend on the rest of its batch, and dispatch k draws from a generator
seeded with k, pair after pair, so a partial batch's draws are the first
n pairs' draws of a full one.

`serve` runs the loop on given pairs with any configuration and device,
and records each dispatch (its seed, requests and wall split), for tests
and `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

from imagestitch_tpu_torch.config import (CameraConfig, DetectorConfig,
                                          MatcherConfig, PipelineConfig,
                                          RansacConfig)
from imagestitch_tpu_torch.parallel.batch import stitch_pairs_batched
from imagestitch_tpu_torch.pipeline import resolve_device
from imagestitch_tpu_torch.utils.io import synthetic_pair


def demo_config() -> PipelineConfig:
    """The demo's configuration (`tools/serve_demo.py:55-60`)."""
    return PipelineConfig(
        detector=DetectorConfig(nfeatures=192, max_keypoints=512, nlevels=3),
        matcher=MatcherConfig(max_matches=192),
        ransac=RansacConfig(num_hypotheses=512),
        camera=CameraConfig(ba_iters=5),
    )


class Req:
    __slots__ = ("pair", "event", "pano", "ok")

    def __init__(self, pair):
        self.pair = pair
        self.event = threading.Event()
        self.pano = None
        self.ok = False


def dispatch(pairs, cfg: PipelineConfig, seed: int, device):
    """One stitch_pairs_batched call on (n, 2, H, W, 3) pairs, the RANSAC
    draws from a generator seeded with `seed` on the device. Returns
    (panos, valids, h_valid) on the device."""
    panos, valids, _, metrics = stitch_pairs_batched(pairs, cfg, seed=seed,
                                                     device=device)
    return panos, valids, metrics["h_valid"]


def crop(pano: np.ndarray, valid: np.ndarray):
    """The bbox crop of a float32 canvas by its valid mask, None when no
    pixel is valid."""
    ys, xs = np.nonzero(valid)
    if len(ys) == 0:
        return None
    return pano[ys.min():ys.max() + 1, xs.min():xs.max() + 1]


def warm(cfg: PipelineConfig, batch: int, h: int, w: int, device) -> float:
    """Build or load the kernels, then serve one all-zero (batch, 2, h, w,
    3) dispatch. Returns its seconds."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from imagestitch_tpu_torch.ops import cuda_build
        cuda_build.load_library()
    out = dispatch(np.zeros((batch, 2, h, w, 3), np.float32), cfg, 0, dev)
    out[2].cpu()
    return time.perf_counter() - t0


def batcher(reqq: queue.Queue, stop, cfg: PipelineConfig, batch: int,
            linger_ms: float, device, record=None, errors=None):
    """Serve requests until `stop` comes off the queue: block for the first
    request, take more until `batch` or the linger deadline, dispatch them
    (dispatch k seeded with k), read back and crop. A failed dispatch is
    put in `errors`, if given (else raised), and its requests set with ok
    False; the loop goes on. `record`, a list, gets one entry per
    dispatch."""
    dev = resolve_device(device)
    ki = 0
    while True:
        got = [reqq.get()]
        if got[0] is stop:
            return
        deadline = time.perf_counter() + linger_ms / 1e3
        while len(got) < batch:
            tleft = deadline - time.perf_counter()
            if tleft <= 0:
                break
            try:
                r = reqq.get(timeout=tleft)
            except queue.Empty:
                break
            if r is stop:
                reqq.put(stop)  # let the outer loop see it next round
                break
            got.append(r)
        n = len(got)
        seed, ki = ki, ki + 1
        try:
            t0 = time.perf_counter()
            panos, valids, hv = dispatch(np.stack([r.pair for r in got]),
                                         cfg, seed, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            panos = panos.cpu().numpy()
            valids = valids.cpu().numpy()
            hv = hv.cpu().numpy()
            for i, r in enumerate(got):
                r.pano = crop(panos[i], valids[i])
                r.ok = bool(hv[i])
            t2 = time.perf_counter()
        except Exception as e:          # noqa: BLE001  (reported by serve)
            if errors is None:
                raise
            errors.append(e)
            for r in got:
                r.event.set()
            continue
        if record is not None:
            record.append({"seed": seed, "n": n, "reqs": got,
                           "dispatch_s": t1 - t0, "readback_crop_s": t2 - t1})
        for r in got:
            r.event.set()
        print(f"  served batch of {n} "
              f"({'all valid' if hv.all() else 'SOME INVALID'})", flush=True)


def producer(reqq: queue.Queue, pairs, latencies: list,
             lock: threading.Lock):
    """Put each (2, H, W, 3) pair of `pairs` as one request, wait for it,
    keep its latency; a request served without ok or pano fails."""
    for pair in pairs:
        r = Req(np.asarray(pair, np.float32))
        t = time.perf_counter()
        reqq.put(r)
        r.event.wait()
        with lock:
            latencies.append(time.perf_counter() - t)
        assert r.ok and r.pano is not None, "request served without a pano"


def synthetic_requests(seed0: int, count: int, h: int, w: int):
    """A producer's pairs, made as it goes: synthetic_pair(h, w, overlap=
    0.5) with seeds from default_rng(seed0)."""
    rng = np.random.default_rng(seed0)
    for _ in range(count):
        i1, i2, _ = synthetic_pair(h, w, overlap=0.5,
                                   seed=int(rng.integers(1 << 30)))
        yield np.stack([i1, i2]).astype(np.float32)


def serve(producer_pairs, cfg: PipelineConfig, batch: int, linger_ms: float,
          device, record=None):
    """Run one batcher thread and one producer thread per entry of
    `producer_pairs` (each an iterable of pairs) until every request is
    served. Returns (latencies in seconds, wall seconds); raises the first
    failure of the batcher or a producer."""
    reqq: queue.Queue = queue.Queue()
    stop = object()
    errors: list = []
    bt = threading.Thread(target=batcher, daemon=True,
                          args=(reqq, stop, cfg, batch, linger_ms, device,
                                record, errors))
    bt.start()
    latencies: list = []
    lock = threading.Lock()

    def run(pairs):
        try:
            producer(reqq, pairs, latencies, lock)
        except Exception as e:          # noqa: BLE001  (raised below)
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(p,))
               for p in producer_pairs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    reqq.put(stop)
    bt.join()
    if errors:
        raise errors[0]
    return latencies, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--linger", type=float, default=20.0,
                    help="max ms the batcher waits to fill a batch")
    ap.add_argument("--size", default="192x256")
    ap.add_argument("--producers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    H, W = (int(x) for x in args.size.split("x"))
    B = args.batch
    cfg = demo_config()
    dev = resolve_device(args.device)

    secs = warm(cfg, B, H, W, dev)
    print(f"compile+warm: {secs:.1f}s device={dev} batch={B}")

    per = args.requests // args.producers
    latencies, wall = serve(
        [synthetic_requests(7 + i, per, H, W) for i in range(args.producers)],
        cfg, B, args.linger, dev)

    served = per * args.producers
    lat = np.array(latencies) * 1e3
    print(f"served {served} requests in {wall:.2f}s "
          f"({served / wall:.1f} req/s); latency p50 "
          f"{np.percentile(lat, 50):.0f} ms "
          f"p95 {np.percentile(lat, 95):.0f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
