"""Fresh-process first call of the port (`tools/warm_start_probe.py`).

Measures the deploy path of a process that has never stitched: load the
ahead-of-time build (`aot.stitch_pair_program`), then one real stitch,
then a second. The device bootstrap (the CUDA context) is paid on a
trivial op before timing, as the JAX probe pays its backend's.

Prints ONE JSON line with the JAX probe's keys:
  warm_start_s   deserialize_s + the first call (run + readback)
  deserialize_s  stitch_pair_program finding and loading the libraries
                 built ahead of time (the CUDA kernels and the native seam
                 runtime; the port keeps no program blob, so nothing is
                 deserialized)
  compile_s      the first call minus the second: first-use cost, not a
                 compiler (lazy CUDA module loading, the cuBLAS / cuSOLVER
                 handles, the caching allocator's growth)
  run_s          the second call (run + readback)
  was_cached     both libraries were on disk already
  h_valid, pano_sum  the first call's registration flag and canvas sum

Run as:  python -m imagestitch_tpu_torch.tools.warm_start_probe <H> <W> [device]
(H and W default to 1080 and 1920; the device to the CUDA card, and
without one it raises.)
"""

import json
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    h = int(argv[0]) if len(argv) > 0 else 1080
    w = int(argv[1]) if len(argv) > 1 else 1920

    import torch
    from imagestitch_tpu_torch.pipeline import _generator, resolve_device

    dev = resolve_device(argv[2] if len(argv) > 2 else None)
    float(torch.ones(8, device=dev).sum())  # device bootstrap

    from imagestitch_tpu_torch import aot
    from imagestitch_tpu_torch.config import PipelineConfig
    from imagestitch_tpu_torch.utils.io import synthetic_pair

    i1, i2, _ = synthetic_pair(h, w, overlap=0.4, seed=0)
    a1 = torch.as_tensor(i1, device=dev).float()
    a2 = torch.as_tensor(i2, device=dev).float()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    call, was_cached = aot.stitch_pair_program(h, w, PipelineConfig(),
                                               device=dev)
    t1 = time.perf_counter()
    pano, valid, corner, metrics = call(a1, a2, _generator(dev, 0))
    s = float(pano.sum())  # readback = completion barrier
    t2 = time.perf_counter()
    pano2, _, _, _ = call(a1, a2, _generator(dev, 0))
    float(pano2.sum())
    t3 = time.perf_counter()
    print(json.dumps({
        "warm_start_s": t2 - t0,
        "deserialize_s": t1 - t0,
        "compile_s": max((t2 - t1) - (t3 - t2), 0.0),
        "run_s": t3 - t2,
        "was_cached": bool(was_cached),
        "h_valid": bool(metrics["h_valid"]),
        "pano_sum": s,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
