"""imagestitch_tpu_torch's graph-cut seam (`seam/graphcut.py`, host NumPy on
the port's native solvers) against `imagestitch_tpu.seam.graphcut` on the
CPU, on the geometries of the JAX package's own tests
(`tests/test_graphcut.py`).

Both packages run the same NumPy cost maps into the same C++ solvers, so
every case asks for masks EQUAL to JAX's: BK (`method="bk"`) and the
banded dual solver (`"banded"`), COST_COLOR and COST_COLOR_GRAD, the
agreement column, a noisy corridor, a stacked pair (the banded solver's
transpose), trapezoid masks (the bad-region penalties), the band
doubling when the cut strays from the coarse seed, and a bbox crop with
the full canvas's orientation marginals and the crop origin. The cut of
the crop equals the full canvas's within it. With OpenCV present, the
port's cut also agrees with cv2.detail.GraphCutSeamFinder on 99.9% of the
overlap, the JAX test's bar.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from imagestitch_tpu.seam import graphcut as jgc  # noqa: E402
from imagestitch_tpu_torch.seam import graphcut as tgc  # noqa: E402


def _scene(H, W, seed):
    """A smooth random scene: 8x8-px random colours, bilinear upsampled."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (H // 8 + 1, W // 8 + 1, 3))
    ys = np.linspace(0, H // 8, H)
    xs = np.linspace(0, W // 8, W)
    y0 = np.floor(ys).astype(int).clip(0, H // 8 - 1)
    x0 = np.floor(xs).astype(int).clip(0, W // 8 - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = base[y0][:, x0] * (1 - fx) + base[y0][:, x0 + 1] * fx
    bot = base[y0 + 1][:, x0] * (1 - fx) + base[y0 + 1][:, x0 + 1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _agreement_column():
    H, W = 24, 32
    m1 = np.zeros((H, W), bool)
    m2 = np.zeros((H, W), bool)
    m1[:, :20] = True
    m2[:, 5:] = True
    i1 = np.zeros((H, W, 3), np.float32)
    i2 = np.full((H, W, 3), 60.0, np.float32)
    i2[:, 10:12] = 0.0
    return i1, i2, m1, m2


def _corridor():
    rng = np.random.RandomState(7)
    h, w = 120, 200
    img = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    i1 = img + rng.randn(h, w, 3).astype(np.float32) * 2
    i2 = img + rng.randn(h, w, 3).astype(np.float32) * 2
    m1 = np.zeros((h, w), bool)
    m1[:, :140] = True
    m2 = np.zeros((h, w), bool)
    m2[:, 60:] = True
    return i1, i2, m1, m2


def _stacked():
    rng = np.random.RandomState(11)
    h, w = 400, 300
    base = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    i1 = base.copy()
    i2 = base + 40.0
    i2[195:205] = base[195:205]
    m1 = np.zeros((h, w), bool)
    m1[:260] = True
    m2 = np.zeros((h, w), bool)
    m2[150:] = True
    return i1, i2, m1, m2


def _trapezoid():
    rng = np.random.default_rng(7)
    H, W = 360, 560
    scene = _scene(H, W, 2)
    x2, w1 = 200, 360
    m1 = np.zeros((H, W), bool)
    m2 = np.zeros((H, W), bool)
    for y in range(H):
        sh = int(30 * y / H)
        m1[y, :w1 - sh] = True
        m2[y, x2 + sh:] = True
    i1 = scene * m1[..., None]
    i2 = np.clip(scene * 0.94 + rng.normal(0, 5, scene.shape), 0, 255)
    i2 = (i2 * m2[..., None]).astype(np.float32)
    return i1.astype(np.float32), i2, m1, m2


def _gradient_pair():
    rng = np.random.default_rng(11)
    H, W = 300, 420
    sc = _scene(H, W, 4)
    i1 = np.clip(sc + rng.normal(0, 3, sc.shape), 0, 255).astype(np.float32)
    i2 = np.clip(sc * 1.05 + rng.normal(0, 3, sc.shape), 0,
                 255).astype(np.float32)
    m1 = np.zeros((H, W), bool)
    m1[:, :280] = True
    m2 = np.zeros((H, W), bool)
    m2[:, 140:] = True
    return i1, i2, m1, m2


def _stray():
    """The cheap cut channel lies 260 columns from the column the per-pixel
    cost prefers: the banded solver must double its band to reach it."""
    H, W = 360, 400
    m1 = np.zeros((H, W), bool)
    m1[:, :380] = True
    m2 = np.zeros((H, W), bool)
    m2[:, 20:] = True
    val = np.full((H, W), 100.0, np.float32)
    val[:, 40] = 0.0
    val[:, 41] = 500.0
    val[100:, 300:302] = 0.0
    val[:100, 300:302] = 30.0
    i1 = np.zeros((H, W, 3), np.float32)
    i2 = np.zeros((H, W, 3), np.float32)
    i2[..., 0] = np.sqrt(val)
    return i1, i2, m1, m2


SCENES = {"agreement_column": _agreement_column, "corridor": _corridor,
          "stacked": _stacked, "trapezoid": _trapezoid,
          "gradient_pair": _gradient_pair, "stray": _stray}
CASES = [
    ("agreement_column", "auto", False),
    ("corridor", "bk", False), ("corridor", "banded", False),
    ("stacked", "bk", False), ("stacked", "banded", False),
    ("trapezoid", "bk", False), ("trapezoid", "banded", False),
    ("gradient_pair", "bk", True), ("gradient_pair", "banded", True),
    ("stacked", "banded", True),
    ("stray", "bk", False), ("stray", "banded", False),
]


@pytest.fixture(scope="module")
def scenes():
    return {k: fn() for k, fn in SCENES.items()}


@pytest.mark.parametrize("scene,method,grad", CASES)
def test_graphcut_equals_jax(scenes, scene, method, grad):
    i1, i2, m1, m2 = scenes[scene]
    t1, t2 = tgc.graphcut_seam_pair(i1, i2, m1, m2, use_grad=grad,
                                    method=method)
    j1, j2 = jgc.graphcut_seam_pair(i1, i2, m1, m2, use_grad=grad,
                                    method=method)
    assert np.array_equal(t1, j1) and np.array_equal(t2, j2)
    ov = m1 & m2
    assert not (t1 & t2 & ov).any() and (t1 | t2)[ov].all()


def test_band_doubling_reaches_the_far_channel(scenes):
    i1, i2, m1, m2 = scenes["stray"]
    b1, b2 = tgc.graphcut_seam_pair(i1, i2, m1, m2, method="bk")
    d1, d2 = tgc.graphcut_seam_pair(i1, i2, m1, m2, method="banded")
    ov = m1 & m2
    assert ((b1 == d1) & (b2 == d2))[ov].all()
    kept1 = b1 & ov
    assert max(int(kept1[y].nonzero()[0].max())
               for y in range(100, 360)) >= 295


def _marginals(m1, m2):
    sets = [m1 & ~m2, m2 & ~m1, m1, m2]
    return (tuple(a.sum(axis=0).astype(np.float32) for a in sets),
            tuple(a.sum(axis=1).astype(np.float32) for a in sets))


@pytest.mark.parametrize("scene,grad", [("corridor", False),
                                        ("gradient_pair", True),
                                        ("stacked", False)])
def test_crop_with_orientation_marginals_equals_jax(scenes, scene, grad):
    """A bbox crop of the overlap (margin 8) with the full canvas's
    marginals and the crop origin: equal to JAX's, and to the full
    canvas's banded cut inside the crop."""
    i1, i2, m1, m2 = scenes[scene]
    ys, xs = np.nonzero(m1 & m2)
    y0, x0 = max(ys.min() - 8, 0), max(xs.min() - 8, 0)
    y1, x1 = ys.max() + 9, xs.max() + 9
    crop = (slice(y0, y1), slice(x0, x1))
    marg = _marginals(m1, m2)
    args = (i1[crop], i2[crop], m1[crop], m2[crop])
    kw = dict(use_grad=grad, method="banded", orient_marginals=marg,
              crop_origin=(y0, x0))
    t1, t2 = tgc.graphcut_seam_pair(*args, **kw)
    j1, j2 = jgc.graphcut_seam_pair(*args, **kw)
    assert np.array_equal(t1, j1) and np.array_equal(t2, j2)
    f1, f2 = tgc.graphcut_seam_pair(i1, i2, m1, m2, use_grad=grad,
                                    method="banded")
    assert np.array_equal(t1, f1[crop]) and np.array_equal(t2, f2[crop])


def test_graphcut_agrees_with_cv2(scenes):
    """COST_COLOR on the corridor scene as full-canvas tiles at (0, 0):
    both solvers within 0.1% of OpenCV's split of the overlap."""
    cv2 = pytest.importorskip("cv2")
    i1, i2, m1, m2 = scenes["corridor"]
    gc = cv2.detail_GraphCutSeamFinder("COST_COLOR")
    mo = gc.find([i1, i2], [(0, 0), (0, 0)],
                 [(m1 * 255).astype(np.uint8), (m2 * 255).astype(np.uint8)])
    mo = [m.get() if isinstance(m, cv2.UMat) else np.asarray(m)
          for m in mo]
    ov = m1 & m2
    for method in ("bk", "banded"):
        o1, o2 = tgc.graphcut_seam_pair(i1, i2, m1, m2, method=method)
        agree = ((o1 == (mo[0] > 0)) & (o2 == (mo[1] > 0)))[ov].mean()
        assert agree > 0.999, (method, agree)
