"""imagestitch_tpu_torch's interior crop (`utils/crop.py`) against
`imagestitch_tpu.utils.crop` and against a brute force on random masks:
exact (integer arithmetic; the same tie order, the first best column in a
row and then the first best row). `crop="interior"` in the pipeline's
`_crop_valid` equals the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu.utils import crop as jcrop  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.utils import crop as tcrop  # noqa: E402


def _brute_area(mask):
    """The largest all-valid rectangle's area, by prefix sums over every
    (y0, y1, x0, x1)."""
    H, W = mask.shape
    P = np.zeros((H + 1, W + 1), np.int64)
    P[1:, 1:] = mask.astype(np.int64).cumsum(0).cumsum(1)
    best = 0
    for y0 in range(H):
        for y1 in range(y0 + 1, H + 1):
            for x0 in range(W):
                row = (P[y1, x0 + 1:] - P[y0, x0 + 1:]
                       - P[y1, x0] + P[y0, x0])
                full = row == (y1 - y0) * np.arange(1, W - x0 + 1)
                if full.any():
                    w = int(np.nonzero(full)[0].max()) + 1
                    best = max(best, w * (y1 - y0))
    return best


def _masks():
    rng = np.random.default_rng(0)
    out = []
    for i, p in enumerate((0.5, 0.75, 0.9, 0.97)):
        out.append(rng.uniform(size=(12 + i, 17 - i)) < p)
    yy, xx = np.mgrid[0:30, 0:40]
    out.append(((yy - 15) ** 2 / 200 + (xx - 20) ** 2 / 300) < 1)  # ellipse
    out.append(np.zeros((6, 9), bool))
    out.append(np.ones((5, 7), bool))
    ties = np.zeros((8, 10), bool)
    ties[1:3, 1:5] = True
    ties[5:7, 5:9] = True                     # two equal rectangles
    out.append(ties)
    return out


@pytest.mark.parametrize("i", range(8))
def test_largest_interior_rect(i):
    mask = _masks()[i]
    want = np.asarray(jcrop.largest_interior_rect(jnp.asarray(mask)))
    got = tcrop.largest_interior_rect(mask)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    y0, x0, h, w = got
    assert mask[y0:y0 + h, x0:x0 + w].all()
    assert h * w == _brute_area(mask)


def test_crop_valid_interior_equal():
    rng = np.random.default_rng(1)
    pano = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    valid = _masks()[4]
    pj, vj = jpipe._crop_valid(pano, valid, "interior")
    pt, vt = tpipe._crop_valid(pano, valid, "interior")
    assert np.array_equal(pt, pj) and np.array_equal(vt, vj)
    assert vt.all()
    pj, vj = jpipe._crop_valid(pano, np.zeros_like(valid), "interior")
    pt, vt = tpipe._crop_valid(pano, np.zeros_like(valid), "interior")
    assert pt.shape == pj.shape == (1, 1, 3)
