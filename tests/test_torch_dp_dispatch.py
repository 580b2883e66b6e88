"""Which DP loop a seam takes, on the CPU and without a card
(`seam/dp.takes_kernel`, `ops/cuda_dp`).

- The dispatch: costs on a CUDA device go to the kernel at every width,
  CPU tensors never; decided from the device alone.
- CPU tensors take the plain loop: the library is never built, nothing
  counts `dp_fused`, the stage `seam_dp` is entered once per seam, and the
  backtrack's int8 choices (`dp._transitions(H)` rows) are counted in
  `readback_bytes`.
- The kernel path's plumbing (with the launch replaced by a stand-in that
  returns the plain loop's columns): the cost and the transitions it
  hands the kernel (the window, decimated, transposed for a horizontal
  seam; float32 whatever the cost's dtype), `dp_fused` (not counted when
  the launch fails), the `seam_dp` stage, no `readback_bytes` from the
  choices, and a `stitch_pair` whose panorama is the plain one's.
- The wrapper refuses what the kernel does not take before it builds.

The kernel itself runs only on a card: `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.ops import cuda_build, cuda_dp  # noqa: E402
from imagestitch_tpu_torch.seam import dp  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair  # noqa

torch.set_num_threads(2)

PLAIN = dp._dp_seam_path_plain


def test_the_device_alone_decides():
    assert dp.takes_kernel(torch.device("cuda")) is True
    assert dp.takes_kernel(torch.device("cuda", 1)) is True
    assert dp.takes_kernel(torch.device("cpu")) is False


@pytest.mark.parametrize("width", [1, 31, 544, 2176, 16384, 16385, 30000,
                                   100000])
def test_every_width_goes_to_the_kernel_whole(monkeypatch, width):
    """With the dispatch taken, a cost of any width reaches the launch
    whole, with no narrower path in between."""
    stand_in = StandIn()
    monkeypatch.setattr(dp, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_dp, "seam_path", stand_in)
    cost = _cost(3, width, seed=width)
    with log.StageTimer(sync=False).active():
        cols = dp.dp_seam_path(cost)
    handed, = stand_in.costs
    assert torch.equal(handed, cost)
    assert torch.equal(cols, PLAIN(cost))


@pytest.mark.parametrize("height,rows", [(1, 0), (2, 8), (8, 8), (9, 8),
                                         (10, 16), (365, 368), (486, 488)])
def test_transitions_pad_to_the_chunk(height, rows):
    assert dp._transitions(height) == rows


def _no_build(monkeypatch):
    def boom(*_):
        raise AssertionError("kernel library requested")

    monkeypatch.setattr(cuda_build, "load_library", boom)


def _cost(h, w, seed, free_rows=()):
    """Seeded (h, w) float32 costs with BIG outside a ragged band; rows in
    `free_rows` all BIG (no overlap)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 50, (h, w)).astype(np.float32)
    lo = rng.integers(0, max(w // 4, 1), h)
    cols = np.arange(w)[None, :]
    c[cols < lo[:, None]] = dp.BIG
    c[list(free_rows)] = dp.BIG
    return torch.as_tensor(c)


@pytest.mark.parametrize("h,w", [(1, 7), (2, 5), (37, 53), (64, 1)])
def test_cpu_tensors_take_the_plain_loop(monkeypatch, h, w):
    """No build, no `dp_fused`, one `seam_dp` stage; the choices read back
    are `transitions(h)` rows of w int8."""
    _no_build(monkeypatch)
    n0 = cuda_dp.launch_count
    cost = _cost(h, w, seed=h * w, free_rows=[0] if h > 2 else [])
    timer = log.StageTimer(sync=False)
    with timer.active():
        cols = dp.dp_seam_path(cost)
    counts = timer.counts()
    assert "dp_fused" not in counts
    assert set(timer.summary()) == {"seam_dp"}
    want = dp._transitions(h) * w if h > 1 else 0
    assert counts.get("readback_bytes", 0) == want
    assert cols.shape == (h,) and cols.dtype == torch.int64
    assert int(cols.min()) >= 0 and int(cols.max()) < w
    assert torch.equal(cols, PLAIN(cost))
    assert cuda_dp.launch_count == n0


class StandIn:
    """The kernel's launch replaced: records each cost handed over, checks
    the transitions handed with it, and returns the plain loop's columns,
    computed under a timer of its own (so its readback counts nowhere)."""

    def __init__(self):
        self.costs = []

    def __call__(self, cost, transitions):
        assert transitions == dp._transitions(cost.shape[0])
        self.costs.append(cost.clone())
        with log.StageTimer(sync=False).active():
            return PLAIN(cost)


def _plain_costs(monkeypatch):
    """Spy on the plain loop: the costs it is given."""
    seen = []

    def spy(cost):
        seen.append(cost.clone())
        return PLAIN(cost)

    monkeypatch.setattr(dp, "_dp_seam_path_plain", spy)
    return seen


def _masks_pair(seed, vertical_offset):
    """Two 96x240 shared-frame canvases overlapping in a ragged band,
    offset horizontally or (transposed) vertically."""
    rng = np.random.default_rng(seed)
    h, w = (240, 96) if vertical_offset else (96, 240)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.stack([120 + 60 * np.sin(xx / 9.0 + c) * np.cos(yy / 13.0)
                      for c in range(3)], -1)
    a = scene + rng.normal(0, 4, scene.shape)
    b = 1.15 * scene + rng.normal(0, 4, scene.shape)
    m1 = xx < (0.62 * w + rng.integers(-6, 7, h))[:, None]
    m2 = xx >= (0.38 * w + rng.integers(-6, 7, h))[:, None]
    m1[:3] = False
    m2[-4:] = False
    imgs = np.stack([a * m1[..., None], b * m2[..., None]]).astype(
        np.float32)
    masks = np.stack([m1, m2])
    if vertical_offset:
        imgs = imgs.transpose(0, 2, 1, 3).copy()
        masks = masks.transpose(0, 2, 1).copy()
    return torch.as_tensor(imgs), torch.as_tensor(masks)


@pytest.mark.parametrize("scale,vertical_offset,max_w", [
    (4, False, 128), (1, False, None), (4, True, 128), (2, True, None)])
def test_kernel_path_plumbing(monkeypatch, scale, vertical_offset, max_w):
    """Forced dispatch, stand-in launch: the kernel gets the cost the
    plain loop gets (the window, decimated; transposed for the horizontal
    seam), the split masks are the plain ones, `dp_fused` 1 in one
    `seam_dp` stage, and nothing counts `readback_bytes`."""
    imgs, masks = _masks_pair(7 + scale, vertical_offset)
    args = (imgs[0], imgs[1], masks[0], masks[1])
    kw = dict(max_overlap_w=max_w, max_overlap_h=max_w, orient="auto",
              scale=scale)
    seen = _plain_costs(monkeypatch)
    want = dp.dp_seam_pair(*args, **kw)
    assert len(seen) == 1
    stand_in = StandIn()
    monkeypatch.setattr(dp, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_dp, "seam_path", stand_in)
    timer = log.StageTimer(sync=False)
    with timer.active():
        got = dp.dp_seam_pair(*args, **kw)
    assert timer.counts() == {"dp_fused": 1}
    assert set(timer.summary()) == {"seam_dp"}
    assert len(stand_in.costs) == 1 and len(seen) == 1
    assert torch.equal(stand_in.costs[0], seen[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stitch_pair_through_the_kernel_path(monkeypatch):
    """`stitch_pair` with the dispatch forced and the stand-in: the same
    uint8 panorama as the plain loop's, `dp_fused` 1, and `readback_bytes`
    lower by exactly the choices' bytes."""
    a, b, _, _ = synthetic_rotation_pair(192, 256)
    cfg = tist.PipelineConfig(
        detector=tist.DetectorConfig(nfeatures=256, max_keypoints=768),
        matcher=tist.MatcherConfig(max_matches=256),
        ransac=tist.RansacConfig(num_hypotheses=512),
        camera=tist.CameraConfig(ba_iters=10))
    seen = _plain_costs(monkeypatch)
    pp, mp = tist.stitch_pair(a, b, cfg, seed=3, device="cpu")
    (h, w), = [tuple(c.shape) for c in seen]
    stand_in = StandIn()
    monkeypatch.setattr(dp, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_dp, "seam_path", stand_in)
    pk, mk = tist.stitch_pair(a, b, cfg, seed=3, device="cpu")
    assert np.array_equal(pk, pp)
    assert mk["dp_fused"] == 1 and "dp_fused" not in mp
    assert mk["seam_dp"] >= 0.0 and mp["seam_dp"] >= 0.0
    assert mp["readback_bytes"] - mk["readback_bytes"] == \
        dp._transitions(h) * w
    assert torch.equal(stand_in.costs[0], seen[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16])
def test_other_dtypes_reach_the_kernel_as_float32(monkeypatch, dtype):
    """A cost of another dtype is handed to the kernel as float32, and
    its seam counts `dp_fused` once."""
    stand_in = StandIn()
    monkeypatch.setattr(dp, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_dp, "seam_path", stand_in)
    cost = _cost(37, 53, seed=11, free_rows=[4])
    timer = log.StageTimer(sync=False)
    with timer.active():
        cols = dp.dp_seam_path(cost.to(dtype))
    assert timer.counts() == {"dp_fused": 1}
    handed, = stand_in.costs
    assert handed.dtype == torch.float32
    assert torch.equal(handed, cost.to(dtype).to(torch.float32))
    assert torch.equal(cols, PLAIN(handed))


def test_a_failed_launch_counts_no_dp_fused(monkeypatch):
    def fail(cost, transitions):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(dp, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(cuda_dp, "seam_path", fail)
    timer = log.StageTimer(sync=False)
    with timer.active(), pytest.raises(RuntimeError, match="launch"):
        dp.dp_seam_path(_cost(9, 12, seed=1))
    assert "dp_fused" not in timer.counts()


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _no_build(monkeypatch)
    n0 = cuda_dp.launch_count
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        cuda_dp.seam_path(torch.zeros(4, 0), 8)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        cuda_dp.seam_path(torch.zeros(8), 8)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        cuda_dp.seam_path(torch.zeros(0, 8), 0)
    with pytest.raises(ValueError, match="transitions"):
        cuda_dp.seam_path(torch.zeros(10, 8), 8)
    with pytest.raises(ValueError, match="float32"):
        cuda_dp.seam_path(torch.zeros(4, 8, dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dp.seam_path(torch.zeros(4, 8), 8)
    assert cuda_dp.launch_count == n0
