"""imagestitch_tpu_torch's full DpSeamFinder (`seam/dp_full.py`, host NumPy
on the port's native labeling) against `imagestitch_tpu.seam.dp_full` on
the CPU, on the cases of the JAX package's own tests
(`tests/test_dp_full.py`): a side-by-side pair, a stacked pair (the
horizontal seam), an overlap that fragments into two INTERS components,
the COLOR_GRAD cost, the shared-frame wrapper `dp_seam_find_full`, and
three views in one frame (the reversed i<j pair order).

The two packages run the same NumPy code over the same labeling, so the
masks must be EQUAL to JAX's in every case.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from imagestitch_tpu.seam import dp_full as jdp  # noqa: E402
from imagestitch_tpu_torch.seam import dp_full as tdp  # noqa: E402


def _textured(h, w, seed, base=0.0):
    """Random colours smoothed by a 5x5 box (edge-clamped)."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    p = np.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
    out = sum(p[dy:dy + h, dx:dx + w] for dy in range(5)
              for dx in range(5)) / 25.0
    return (out + base).astype(np.float32)


def _case(name):
    if name == "horizontal_pair":
        h, w = 120, 160
        return ([_textured(h, w, 0), _textured(h, w, 1)], [(0, 0), (100, 7)],
                [np.ones((h, w), bool)] * 2, "color")
    if name == "stacked_pair":
        h, w = 140, 150
        return ([_textured(h, w, 2), _textured(h, w, 3)], [(0, 0), (9, 90)],
                [np.ones((h, w), bool)] * 2, "color")
    if name == "two_components":
        h, w = 130, 170
        m1 = np.ones((h, w), bool)
        m1[50:80, 100:] = False
        return ([_textured(h, w, 4), _textured(h, w, 5)], [(0, 0), (100, 0)],
                [m1, np.ones((h, w), bool)], "color")
    if name == "color_grad":
        h, w = 110, 140
        return ([_textured(h, w, 6), _textured(h, w, 7)], [(0, 0), (80, 0)],
                [np.ones((h, w), bool)] * 2, "color_grad")
    H, W = 100, 300
    img = _textured(H, W, 8)
    ims, ms = [], []
    for k, (a, b) in enumerate([(0, 140), (80, 220), (160, 300)]):
        m = np.zeros((H, W), bool)
        m[:, a:b] = True
        ims.append(np.where(m[..., None], img + 3.0 * k, 0.0)
                   .astype(np.float32))
        ms.append(m)
    return ims, [(0, 0)] * 3, ms, "color"


CASES = ("horizontal_pair", "stacked_pair", "two_components", "color_grad",
         "three_views")


@pytest.mark.parametrize("name", CASES)
def test_dp_seam_finder_equals_jax(name):
    images, corners, masks, cost = _case(name)
    ours = tdp.DpSeamFinder(cost).find(images, corners, masks)
    ref = jdp.DpSeamFinder(cost).find(images, corners, masks)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_two_components_really_fragment():
    from imagestitch_tpu_torch.native.ccl import connected_components
    _, _, (m1, m2), _ = _case("two_components")
    u1 = np.zeros((130, 270), bool)
    u2 = np.zeros((130, 270), bool)
    u1[:, :170] = m1
    u2[:, 100:] = m2
    assert connected_components(u1 & u2)[1] >= 2


@pytest.mark.parametrize("use_grad", [False, True])
def test_shared_frame_wrapper_equals_jax(use_grad):
    H, W = 100, 220
    img = _textured(H, W, 8)
    i1 = np.zeros((H, W, 3), np.float32)
    i2 = np.zeros((H, W, 3), np.float32)
    m1 = np.zeros((H, W), bool)
    m2 = np.zeros((H, W), bool)
    m1[:, :140] = True
    m2[:, 80:] = True
    i1[m1] = img[m1]
    i2[m2] = img[m2] + 3.0
    ours = tdp.dp_seam_find_full([i1, i2], [(0, 0)] * 2, [m1, m2], use_grad)
    ref = jdp.dp_seam_find_full([i1, i2], [(0, 0)] * 2, [m1, m2], use_grad)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert ((ours[0] | ours[1]) == (m1 | m2)).mean() > 0.999


def test_finder_reused_for_a_pair_with_more_components():
    """The reference reuses one finder's component lists across pairs, so
    a later pair with more components than the first indexes past them
    (IndexError in the JAX package). The port sizes the lists per pair:
    where JAX runs, the masks are equal (above); here the port runs and
    partitions the overlap."""
    H, W = 90, 200
    img = _textured(H, W, 9)
    m0 = np.zeros((H, W), bool)
    m0[:, :130] = True
    m0[30:50, 90:] = False          # the 0-1 overlap splits in two
    m1 = np.zeros((H, W), bool)
    m1[:, 70:] = True
    m2 = np.zeros((H, W), bool)     # an empty view: its pairs come first
    ims = [img, img + 2.0, img]
    with pytest.raises(IndexError):
        jdp.dp_seam_find_full(ims, [(0, 0)] * 3, [m0, m1, m2])
    out = tdp.dp_seam_find_full(ims, [(0, 0)] * 3, [m0, m1, m2])
    ov = m0 & m1
    assert not (out[0] & out[1] & ov).any() and (out[0] | out[1])[ov].all()
