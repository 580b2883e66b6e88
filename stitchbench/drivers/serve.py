"""The `serve` driver: `tools.serve_demo.serve`, closed-loop producers of
pairs and one batcher.

A traffic mix names it as `"driver": "serve"`."""

import math
import time

import numpy as np
import torch

from stitchbench.harness import ClosedLoop, Request


class Driver(ClosedLoop):
    """`tools.serve_demo.serve`: `clients` closed-loop producers of pairs,
    one batcher thread (batch, linger); every dispatch recorded. A
    producer sends its next pair until the window has passed. The server
    answers with the panorama alone, so no focal is judged."""

    judged = ("extent_rel_err", "tile_mad")

    def prepare(self):
        from imagestitch_tpu_torch.tools import serve_demo
        self.serve_demo = serve_demo
        self.pairs = [np.ascontiguousarray(it.views, dtype=np.float32)
                      for it in self.pool]
        self.item_of = {id(p): i for i, p in enumerate(self.pairs)}

    def window(self, seconds, count=None, start_item=0):
        clients = int(self.traffic["clients"])
        t_start = time.perf_counter()
        counter = iter(range(start_item, 1 << 62))

        def producer():
            issued = 0
            while True:
                if count is not None and issued >= math.ceil(count / clients):
                    return
                if seconds is not None and \
                        time.perf_counter() - t_start >= seconds:
                    return
                issued += 1
                yield self.pairs[next(counter) % len(self.pairs)]

        record: list = []
        with torch.profiler.record_function("stitchbench.serve"):
            latencies, _ = self.serve_demo.serve(
                [producer() for _ in range(clients)], self.cfg,
                int(self.traffic["batch"]), float(self.traffic["linger_ms"]),
                self.device, record)
        t_end = time.perf_counter()
        reqs = []
        for d in record:
            for r in d["reqs"]:
                q = Request(len(reqs), self.item_of[id(r.pair)])
                q.pano = (None if r.pano is None else
                          np.clip(r.pano, 0, 255).astype(np.uint8))
                q.ok = bool(r.ok) and r.pano is not None
                q.metrics = {"dispatch_s": d["dispatch_s"],
                             "readback_crop_s": d["readback_crop_s"],
                             "dispatch": d["seed"]}
                reqs.append(q)
        return reqs, t_start, t_end, latencies
