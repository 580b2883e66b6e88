"""Which readback and crop `pipeline._to_uint8` takes, on the CPU and
without a card (`pipeline._crop_takes_kernel`, `ops/cuda_crop`).

- The dispatch: a canvas on a CUDA device with the bbox crop and no stage
  dump goes to the crop kernel; decided from the device, the crop mode
  and the dump alone.
- The host path's rule, which the kernel is held to on the card:
  `np.clip(p, 0, 255).astype(np.uint8)`, so truncation toward zero, NaN
  and -inf 0, +inf 255.
- The kernel path's plumbing (with the launch replaced by a stand-in that
  applies the kernel's rule in torch): the canvas and mask it is handed,
  the same bytes as the host path, `crop_fused` 1 in one
  `readback_crop` stage, `readback_bytes` 16 + the crop's bytes; nothing
  counted when the launch fails.
- The "interior" crop, a stage dump and CPU tensors take the host path:
  the library is never built, no `crop_fused`, the float32 canvas and
  mask counted in `readback_bytes`.
- `stitch_pair`, `stitch_chain`, `Stitcher.stitch` and the stream's
  `calibrate` and `compose` through the kernel path give the host path's
  panoramas.
- The wrapper refuses what the kernel does not take before it builds.

The kernel itself runs only on a card: `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import pipeline as P  # noqa: E402
from imagestitch_tpu_torch.ops import cuda_build, cuda_crop  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402
from imagestitch_tpu_torch.utils.io import (  # noqa: E402
    synthetic_pan_sequence, synthetic_rotation_pair)

torch.set_num_threads(2)

SPECIALS = (0.0, 255.0, 254.9999, 0.5, -0.5, 255.5, -50.0, 300.0,
            float("nan"), float("inf"), float("-inf"))


def canvas(h, w, seed, planar=False):
    """A seeded (h, w, 3) float32 canvas in [-50, 300] with fractional
    parts, every special value of `SPECIALS` sprinkled in; with `planar`,
    laid out as three channel planes (the multi-band blend's)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-50, 300, (h, w, 3)).astype(np.float32)
    flat = p.reshape(-1)
    at = rng.integers(0, flat.size, 4 * len(SPECIALS))
    flat[at] = np.resize(np.asarray(SPECIALS, np.float32), at.size)
    t = torch.as_tensor(p)
    return t.permute(2, 0, 1).contiguous().permute(1, 2, 0) if planar else t


def mask(h, w, kind, seed=0):
    """(h, w) bool: "empty", "one" (a single seeded pixel), "top",
    "bottom", "left", "right" (a blob touching that border), "full"."""
    m = np.zeros((h, w), bool)
    rng = np.random.default_rng(seed)
    y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
    if kind == "one":
        m[y, x] = True
    elif kind == "full":
        m[:] = True
    elif kind != "empty":
        ys = {"top": slice(0, max(h // 2, 1)), "bottom": slice(h // 2, h)}
        xs = {"left": slice(0, max(w // 2, 1)), "right": slice(w // 2, w)}
        m[ys.get(kind, slice(h // 4, h - h // 4)),
          xs.get(kind, slice(w // 4, w - w // 4))] = True
        m[y, x] = kind in ("top", "bottom", "left", "right")
    return torch.as_tensor(m)


MASKS = ("empty", "one", "top", "bottom", "left", "right", "full")
SHAPES = ((1, 1), (7, 13), (64, 97))


class StandIn:
    """The kernel's launch replaced by its rule in torch: each channel
    `fmin(fmax(p, 0), 255)` (NaN gives 0, as `fmaxf`) truncated to uint8,
    cropped to the valid pixels' bbox, the first pixel where none is
    valid. Records the canvas and mask handed over."""

    def __init__(self):
        self.calls = []

    def __call__(self, pano, valid):
        self.calls.append((pano.clone(), valid.clone()))
        q = torch.fmin(torch.fmax(pano, torch.tensor(0.0)),
                       torch.tensor(255.0)).to(torch.uint8)
        ys, xs = torch.nonzero(valid, as_tuple=True)
        if ys.numel() == 0:
            return q[:1, :1].numpy().copy()
        return q[int(ys.min()):int(ys.max()) + 1,
                 int(xs.min()):int(xs.max()) + 1].numpy().copy()


def _force_kernel(monkeypatch):
    stand_in = StandIn()
    monkeypatch.setattr(P, "_crop_takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_crop, "crop_u8", stand_in)
    return stand_in


def _no_build(monkeypatch):
    def boom(*_):
        raise AssertionError("kernel library requested")

    monkeypatch.setattr(cuda_build, "load_library", boom)


def _timed(pano, valid, crop="bbox", dump=None):
    """`_to_uint8` under a timer of its own: (the panorama, the timer)."""
    timer = log.StageTimer(sync=False)
    with np.errstate(invalid="ignore"), timer.active():
        out = P._to_uint8(pano, valid, crop, dump)
    return out, timer


def _host(pano, valid, crop="bbox"):
    """`_to_uint8`'s host path (the dispatch as it is: a CPU tensor)."""
    return _timed(pano, valid, crop)[0]


def test_the_device_alone_decides():
    assert P._crop_takes_kernel(torch.device("cuda")) is True
    assert P._crop_takes_kernel(torch.device("cuda", 1)) is True
    assert P._crop_takes_kernel(torch.device("cpu")) is False


def test_the_host_rule_truncates_and_sends_nan_to_zero():
    """The bytes the kernel must give: clamp, then truncate toward zero;
    NaN and -inf 0, +inf 255 (NumPy's cast on x86)."""
    vals = np.asarray(SPECIALS + (127.99, 1e30, -1e30), np.float32)
    want = [0, 255, 254, 0, 0, 255, 0, 255, 0, 255, 0, 127, 255, 0]
    pano = torch.as_tensor(np.repeat(vals[None, :, None], 3, axis=2))
    out = _host(pano, torch.ones(pano.shape[:2], dtype=torch.bool))
    assert out.dtype == np.uint8 and out.shape == pano.shape
    assert out[0, :, 0].tolist() == want
    assert np.array_equal(out[..., 0], out[..., 2])


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_canvases_take_the_kernel(monkeypatch, shape, kind):
    """Forced dispatch, stand-in launch: the kernel is handed the canvas
    and mask themselves, gives the host path's bytes, counts `crop_fused`
    1 and `readback_bytes` 16 + the crop's bytes in one `readback_crop`
    stage."""
    h, w = shape
    pano = canvas(h, w, seed=h * w, planar=kind in ("full", "right"))
    valid = mask(h, w, kind, seed=h + w)
    want = _host(pano, valid)
    stand_in = _force_kernel(monkeypatch)
    out, timer = _timed(pano, valid)
    (handed, handed_valid), = stand_in.calls
    assert torch.equal(handed_valid, valid)
    assert handed.stride() == pano.stride()
    assert torch.equal(handed.nan_to_num(), pano.nan_to_num())
    assert out.dtype == np.uint8 and np.array_equal(out, want)
    assert timer.counts() == {"crop_fused": 1,
                              "readback_bytes": 16 + out.nbytes}
    assert set(timer.summary()) == {"readback_crop"}


@pytest.mark.parametrize("route", ["interior", "dump", "cpu"])
def test_the_host_path_off_the_kernel(monkeypatch, tmp_path, route):
    """The "interior" crop and a stage dump (dispatch forced) and a CPU
    tensor (not forced): no launch, no build, no `crop_fused`, the float32
    canvas and its mask counted in `readback_bytes`; the dump gets the
    cropped float32 canvas."""
    pano, valid = canvas(40, 56, seed=3), mask(40, 56, "left", seed=4)
    crop = "interior" if route == "interior" else "bbox"
    want = _host(pano, valid, crop)
    _no_build(monkeypatch)
    stand_in = StandIn()
    if route != "cpu":
        monkeypatch.setattr(P, "_crop_takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_crop, "crop_u8", stand_in)
    dump = P._StageDumper(str(tmp_path)) if route == "dump" else None
    n0 = cuda_crop.launch_count
    out, timer = _timed(pano, valid, crop, dump)
    assert not stand_in.calls and cuda_crop.launch_count == n0
    assert np.array_equal(out, want)
    assert timer.counts() == {"readback_bytes": 40 * 56 * 13}
    if route == "dump":
        with np.load(tmp_path / "pano.npz") as z:
            assert z["pano"].dtype == np.float32
            assert z["pano"].shape == out.shape
            assert z["valid"].shape == out.shape[:2]


def test_a_failed_launch_counts_nothing(monkeypatch):
    def fail(pano, valid):
        raise RuntimeError("crop kernel launch: CUDA error 1")

    monkeypatch.setattr(P, "_crop_takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_crop, "crop_u8", fail)
    timer = log.StageTimer(sync=False)
    with timer.active(), pytest.raises(RuntimeError, match="launch"):
        P._to_uint8(canvas(9, 12, seed=1), mask(9, 12, "full"))
    assert timer.counts() == {}


def test_planar_is_told_from_the_strides():
    pano = canvas(6, 10, seed=2)
    assert not cuda_crop._planar(pano)
    assert cuda_crop._planar(canvas(6, 10, seed=2, planar=True))
    assert not cuda_crop._planar(pano.transpose(0, 1))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _no_build(monkeypatch)
    n0 = cuda_crop.launch_count
    p, v = torch.zeros(4, 5, 3), torch.ones(4, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        cuda_crop.crop_u8(torch.zeros(4, 5, 4), v)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        cuda_crop.crop_u8(torch.zeros(0, 5, 3), v[:0])
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        cuda_crop.crop_u8(torch.zeros(20, 3), v)
    with pytest.raises(ValueError, match="mask"):
        cuda_crop.crop_u8(p, v[:3])
    with pytest.raises(ValueError, match="float32"):
        cuda_crop.crop_u8(p.double(), v)
    with pytest.raises(ValueError, match="bool"):
        cuda_crop.crop_u8(p, v.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_crop.crop_u8(p, v)
    assert cuda_crop.launch_count == n0


BASE = tist.PipelineConfig(
    detector=tist.DetectorConfig(nfeatures=256, max_keypoints=768),
    matcher=tist.MatcherConfig(max_matches=256),
    ransac=tist.RansacConfig(num_hypotheses=512),
    camera=tist.CameraConfig(ba_iters=10))


def _entry(name, tmp_path):
    """One entry's run on the CPU: (its panoramas, the counters it
    returned); the stream's are its calibration's and one compose's."""
    if name == "pair":
        a, b, _, _ = synthetic_rotation_pair(192, 256)
        pano, m = tist.stitch_pair(a, b, BASE, seed=3, device="cpu")
        return [pano], m
    views = synthetic_pan_sequence(3)
    if name == "chain":
        pano, m = tist.stitch_chain(views, BASE, seed=3, device="cpu")
    elif name.startswith("stitcher"):
        dump = str(tmp_path / "dump") if name == "stitcher_dump" else None
        pano, m = tist.Stitcher(BASE, device="cpu").stitch(
            views, seed=3, dump_stages=dump)
    else:
        ss = tist.StreamStitcher(BASE, device="cpu")
        pano, m = ss.calibrate(views, seed=3)
        return [pano, ss.compose(views)], m
    return [pano], m


@pytest.mark.parametrize("name", ["pair", "chain", "stitcher",
                                  "stitcher_dump", "stream"])
def test_entries_through_the_kernel_path(monkeypatch, tmp_path, name):
    """Each entry with the dispatch forced and the stand-in: the host
    path's panoramas, `crop_fused` 1 (the stream: one launch each for
    calibrate and compose), and `readback_bytes` lower by the canvas's
    13 B a pixel less 16 + the crop's bytes. A stage dump keeps the host
    path."""
    want, mh = _entry(name, tmp_path)
    stand_in = _force_kernel(monkeypatch)
    got, mk = _entry(name, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
    assert "crop_fused" not in mh
    if name == "stitcher_dump":
        assert not stand_in.calls and "crop_fused" not in mk
        assert mk["readback_bytes"] == mh["readback_bytes"]
        return
    assert len(stand_in.calls) == len(want)
    assert mk["crop_fused"] == 1
    hc, wc = stand_in.calls[0][0].shape[:2]
    assert mh["readback_bytes"] - mk["readback_bytes"] == \
        hc * wc * 13 - 16 - want[0].nbytes
