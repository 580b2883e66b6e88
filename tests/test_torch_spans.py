"""The spans and counters inside the port's entry points, on the CPU at
small sizes (`utils/log`'s active `StageTimer`).

- `stitch_pair`, `stitch_chain` and `Stitcher.stitch`, on the DP seam and
  on the host graph cut, return every stage named inside them beside
  their own (the pair's `stitch_pair_total`, or `front` and
  `host_seam_blend`; the Stitcher's `seam_blend`, with the one readback
  and crop `readback_crop` inside), and the counters `lm_iters` and
  `readback_bytes`. `lm_iters` equals the
  iterations `geometry/bundle._lm_minimize` ran, counted by a wrapped
  residual function (1 call before the loop, 3 per iteration: the
  residuals, the Jacobian, the trial's error).
- `readback_bytes` equals the bytes of the arrays read back, computed
  from their shapes: the float32 canvas and its mask (`_to_uint8` on the
  CPU; on the card it reads back the bbox's 16 B and the uint8 crop,
  `tests/test_torch_crop_dispatch.py`), the DP backtrack's int8 choices,
  the graph cut's seam inputs.
- In a CPU `torch.profiler` trace every stage is a range nested in its
  entry's outer stage, each `lm_step` in `bundle_adjust` and each
  `seam_dp` (the DP seam) in `seam_blend`.
- With no active timer nothing opens a range or counts; threads keep
  their timers apart; the profiler changes no result.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.geometry import bundle  # noqa: E402
from imagestitch_tpu_torch.seam import dp  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402
from imagestitch_tpu_torch.utils.io import (  # noqa: E402
    synthetic_pan_sequence, synthetic_rotation_pair)

torch.set_num_threads(2)

BA_ITERS = 10
BASE = tist.PipelineConfig(
    detector=tist.DetectorConfig(nfeatures=256, max_keypoints=768),
    matcher=tist.MatcherConfig(max_matches=256),
    ransac=tist.RansacConfig(num_hypotheses=512),
    camera=tist.CameraConfig(ba_iters=BA_ITERS))
# stitching_detailed's options at this size: the graph cut at a seam
# megapixel count below the canvas's, multi-band, GAIN_BLOCKS
GRAPHCUT = BASE.replace(
    seam=tist.SeamConfig(kind="graphcut", seam_megapix=0.05),
    blend=tist.BlendConfig(kind="multiband"),
    exposure=tist.ExposureConfig(kind="gain_blocks"),
    camera=tist.CameraConfig(ba_iters=BA_ITERS, wave_correct=True))
CASES = {
    "pair_dp": ("pair", BASE),
    # full resolution: only the overlap's crop is read back
    "pair_graphcut": ("pair", BASE.replace(
        seam=tist.SeamConfig(kind="graphcut"))),
    "chain_dp": ("chain", BASE),
    "chain_graphcut": ("chain", GRAPHCUT),
    # all pairs matched, seams along the spanning tree, the same 3 views
    "stitcher_dp": ("stitcher", BASE),
    "stitcher_graphcut": ("stitcher", GRAPHCUT),
}

# the stages inside an entry, by the entry's outer stages
FRONT = ("detect", "match", "cameras", "bundle_adjust", "warp", "exposure")
DEVICE_SEAM = ("seam_blend", "seam_dp", "readback_crop")
HOST_SEAM = ("seam_readback", "seam", "blend", "readback_crop")
COUNTERS = ("lm_iters", "readback_bytes")


def outer_stages(case):
    kind, cfg = CASES[case]
    if kind == "stitcher":
        # the Stitcher's front stages stand alone, its readback is a stage
        # of its seam_blend
        seam = HOST_SEAM if tpipe._needs_host_seam(cfg) else DEVICE_SEAM
        return {"seam_blend": tuple(s for s in seam if s != "seam_blend")}
    if tpipe._needs_host_seam(cfg):
        return {"front": FRONT, "host_seam_blend": HOST_SEAM}
    return {f"stitch_{kind}_total": FRONT + DEVICE_SEAM}


def stage_names(case):
    outer = outer_stages(case)
    return {*outer, *(s for inner in outer.values() for s in inner),
            *FRONT, "lm_step"}


def _views(kind):
    if kind == "pair":
        return list(synthetic_rotation_pair(192, 256)[:2])
    return synthetic_pan_sequence(3)


def _stitch(case, seed=3):
    kind, cfg = CASES[case]
    views = _views(kind)
    if kind == "pair":
        return tist.stitch_pair(*views, cfg, seed=seed, device="cpu")
    if kind == "stitcher":
        return tist.Stitcher(cfg, device="cpu").stitch(views, seed=seed)
    return tist.stitch_chain(views, cfg, seed=seed, device="cpu")


class Spies:
    """Wrap `_lm_minimize` (its residual calls), `dp_seam_path` (the cost
    shapes) and `_crop_quantize_impl` (the crop's extent) where the
    stitch calls them."""

    def __init__(self, mp):
        self.residual_calls, self.dp_shapes, self.crops = [], [], []
        lm, path, crop = (bundle._lm_minimize, dp.dp_seam_path,
                          tpipe._crop_quantize_impl)

        def lm_spy(residuals, x0, iters):
            calls = [0]

            def counted(x):
                calls[0] += 1
                return residuals(x)

            out = lm(counted, x0, iters)
            self.residual_calls.append(calls[0])
            return out

        def path_spy(cost):
            self.dp_shapes.append(tuple(cost.shape))
            return path(cost)

        def crop_spy(warped, masks, y0, x0, hh, ww):
            self.crops.append((warped.shape[0], hh, ww))
            return crop(warped, masks, y0, x0, hh, ww)

        mp.setattr(bundle, "_lm_minimize", lm_spy)
        mp.setattr(dp, "dp_seam_path", path_spy)
        mp.setattr(tpipe, "_crop_quantize_impl", crop_spy)


def _ranges(prof, names):
    """(start, end) ns of the trace's host ranges of each of `names`, read
    from kineto's events (the profiler's event tree is not built)."""
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out and e.device_type() != DeviceType.CUDA:
            out[e.name()].append((e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
    return out


@pytest.fixture(scope="module")
def runs():
    """Each case stitched twice with the spies in place: as is, and
    inside a CPU profiler."""
    out = {}
    for case in CASES:
        with pytest.MonkeyPatch.context() as mp:
            spies = Spies(mp)
            pano, m = _stitch(case)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                pano_p, m_p = _stitch(case)
        out[case] = dict(pano=pano, m=m, pano_p=pano_p, m_p=m_p,
                         spies=spies,
                         ranges=_ranges(prof, stage_names(case)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_entry_metrics_hold_every_stage_and_counter(runs, case):
    m = runs[case]["m"]
    assert stage_names(case) <= set(m)
    assert set(COUNTERS) <= set(m)
    assert all(m[s] >= 0.0 for s in stage_names(case))
    # the run as is, then the profiled run: one adjustment each
    calls = runs[case]["spies"].residual_calls
    assert len(calls) == 2 and calls[0] == calls[1]
    assert (calls[0] - 1) % 3 == 0
    assert m["lm_iters"] == (calls[0] - 1) // 3
    assert 1 <= m["lm_iters"] <= BA_ITERS


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_entries_take_the_plain_loop(runs, case):
    """On the CPU every adjustment is the plain loop (`_lm_minimize`, whose
    residual calls the spy counts): no `lm_fused` count."""
    assert "lm_fused" not in runs[case]["m"]
    assert "lm_fused" not in runs[case]["m_p"]
    assert all(c > 1 for c in runs[case]["spies"].residual_calls)


def _canvas_bytes(case):
    """A float32 (Hc, Wc, 3) canvas and its bool mask."""
    kind, cfg = CASES[case]
    hw, n = ((192, 256), 2) if kind == "pair" else ((160, 224), 3)
    Hc, Wc = tpipe._pano_canvas_shape(hw, n, cfg)
    return Hc, Wc, n, Hc * Wc * (3 * 4 + 1)


@pytest.mark.parametrize("case", list(CASES))
def test_readback_bytes_are_the_shapes_read_back(runs, case):
    _, cfg = CASES[case]
    spies = runs[case]["spies"]
    Hc, Wc, n, want = _canvas_bytes(case)
    if case.endswith("_dp"):
        # int8 choices: the rows after the first, padded to 8, by the
        # window's columns; one DP per seam, in each of the two runs
        shapes = spies.dp_shapes[:len(spies.dp_shapes) // 2]
        assert len(shapes) == n - 1
        want += sum(-(-(h - 1) // 8) * 8 * w for h, w in shapes)
    elif case == "pair_graphcut":
        # the overlap's crop as uint8, 3 channels and the mask
        (k, hh, ww), _ = spies.crops
        assert k == 2 and hh * ww < Hc * Wc
        want += k * hh * ww * (3 + 1)
    else:
        # the canvases decimated to seam_megapix, float32 and the masks
        yi, xi, _, _ = tpipe._seam_grid((Hc, Wc), cfg.seam.seam_megapix)
        want += n * len(yi) * len(xi) * (3 * 4 + 1)
    assert runs[case]["m"]["readback_bytes"] == want


@pytest.mark.parametrize("case", list(CASES))
def test_stages_nest_in_the_profiler_trace(runs, case):
    r = runs[case]["ranges"]

    def inside(inner, outer):
        return all(any(a <= s and e <= b for a, b in r[outer])
                   for s, e in r[inner])

    for outer, inner in outer_stages(case).items():
        assert len(r[outer]) == 1, outer
        for name in inner:
            assert r[name] and inside(name, outer), (name, outer)
    assert len(r["lm_step"]) == runs[case]["m_p"]["lm_iters"]
    assert inside("lm_step", "bundle_adjust")
    if "seam_dp" in r:
        assert inside("seam_dp", "seam_blend")


@pytest.mark.parametrize("case", ["pair_dp", "chain_graphcut",
                                  "stitcher_dp", "stitcher_graphcut"])
def test_the_profiler_changes_no_result(runs, case):
    r = runs[case]
    assert np.array_equal(r["pano"], r["pano_p"])
    stages = stage_names(case)
    assert {k: v for k, v in r["m"].items() if k not in stages} == \
        {k: v for k, v in r["m_p"].items() if k not in stages}


def test_no_active_timer_opens_no_range_and_counts_nothing():
    """`register_pair` (with `bundle_adjust`) outside an entry, and after
    a timer was active: nothing is recorded anywhere."""
    a, b = (torch.as_tensor(v).to(torch.float32)
            for v in _views("pair"))
    idle = log.StageTimer("cpu")
    with idle.active():
        pass
    assert log._ACTIVE.get() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, cams = tpipe.register_pair(a, b, BASE)
    assert cams.focal.shape == (2,)
    names = {*FRONT, "lm_step"}
    assert all(not v for v in _ranges(prof, names).values())
    assert idle.summary() == {} and idle.counts() == {}
    with log.stage("detect"):
        log.count("lm_iters")
    assert idle.summary() == {} and idle.counts() == {}


def test_threads_keep_their_timers_apart():
    """Four threads, each with its own timer active, count and enter
    stages at once (a short switch interval); a thread started inside the
    main thread's active block has no timer of its own, and records
    nothing into the main one."""
    timers = [log.StageTimer("cpu") for _ in range(4)]
    main = log.StageTimer("cpu")
    barrier = threading.Barrier(4, timeout=30)
    errors, seen = [], []

    def worker(i):
        try:
            with timers[i].active():
                barrier.wait()
                for _ in range(500):
                    log.count("n", i + 1)
                    with log.stage(f"s{i}"):
                        pass
        except Exception as e:     # reported below, in the main thread
            errors.append(e)

    def bystander():
        seen.append(log._ACTIVE.get())
        log.count("n", 1000)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with main.active():
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(4)]
            threads.append(threading.Thread(target=bystander))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert seen == [None]
    assert main.counts() == {} and main.summary() == {}
    assert [t.counts() for t in timers] == \
        [{"n": 500 * (i + 1)} for i in range(4)]
    assert [sorted(t.summary()) for t in timers] == \
        [[f"s{i}"] for i in range(4)]
