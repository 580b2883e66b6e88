"""imagestitch_tpu_torch's `Timelapser` against `imagestitch_tpu.
timelapse.Timelapser` (both host NumPy) on seeded frame corners and
sizes: the same canvas rectangle (`dst_roi`) for "as_is" (the union of
the frames) and "crop" (their intersection), the same canvas from
`process` for every frame (equal arrays and dtypes; frames reaching past
the crop canvas are clipped), the same errors: "crop" on frames that do
not all intersect, an unknown kind, `process` before `initialize`."""

import numpy as np
import pytest

from imagestitch_tpu.timelapse import Timelapser as JTimelapser
from imagestitch_tpu_torch import Timelapser


def _frames(seed, n, spread):
    rng = np.random.default_rng(seed)
    corners = [(int(x), int(y)) for x, y in
               rng.integers(-spread, spread, (n, 2))]
    sizes = [(int(w), int(h)) for w, h in rng.integers(40, 90, (n, 2))]
    return corners, sizes


@pytest.mark.parametrize("kind", ["as_is", "crop"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.float32, 3),
                                            (np.uint8, None)])
def test_timelapser_matches_jax(kind, seed, dtype, channels):
    corners, sizes = _frames(seed, 4, 20)
    t = Timelapser(kind).initialize(corners, sizes)
    j = JTimelapser(kind).initialize(corners, sizes)
    assert t.dst_roi == j.dst_roi
    rng = np.random.default_rng(seed + 10)
    for (x, y), (w, h) in zip(corners, sizes):
        shape = (h, w) if channels is None else (h, w, channels)
        img = rng.integers(1, 256, shape).astype(dtype)
        ot, oj = t.process(img, (x, y)), j.process(img, (x, y))
        assert ot.dtype == oj.dtype == dtype
        assert np.array_equal(ot, oj)
    x0, y0, x1, y1 = t.dst_roi
    assert ot.shape[:2] == (y1 - y0, x1 - x0)


def test_timelapser_frame_outside_the_canvas():
    """A frame wholly outside the crop canvas leaves it all zero."""
    corners, sizes = [(0, 0), (10, 5)], [(60, 50), (60, 50)]
    t = Timelapser("crop").initialize(corners, sizes)
    j = JTimelapser("crop").initialize(corners, sizes)
    img = np.full((20, 20, 3), 9, np.uint8)
    for c in [(200, 0), (-100, -100), (15, 10)]:
        assert np.array_equal(t.process(img, c), j.process(img, c))
    assert not t.process(img, (200, 0)).any()


def test_timelapser_errors_match_jax():
    corners, sizes = [(0, 0), (100, 0)], [(50, 40), (50, 40)]
    for cls in (Timelapser, JTimelapser):
        with pytest.raises(ValueError, match="do not all intersect"):
            cls("crop").initialize(corners, sizes)
        cls("as_is").initialize(corners, sizes)
        with pytest.raises(ValueError, match="unknown timelapser kind"):
            cls("blend")
        with pytest.raises(RuntimeError, match="initialize"):
            cls("as_is").process(np.zeros((4, 4, 3), np.uint8), (0, 0))
