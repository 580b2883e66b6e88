"""imagestitch_tpu_torch detector: the plain version of the detector-maps
kernel (FAST-9 + NMS, Harris, blur), the pyramid and ORB
`detect_and_compute`, against the JAX package on the same inputs.

Tolerances: the port rounds every product and sum on its own in the JAX
package's order, so the maps agree bit for bit on the CPU (the test suite
compiles JAX at XLA optimization level 0, where nothing is fused). Where a
tolerance is given it is a float32 ulp or two, stated at the assertion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.config import DetectorConfig as JDetectorConfig  # noqa
from imagestitch_tpu.features.fast import (fast_score_map as j_fast,  # noqa
                                           harris_map as j_harris,
                                           nms3x3 as j_nms)
from imagestitch_tpu.features.orb import detect_and_compute as j_detect  # noqa
from imagestitch_tpu.ops.image import gaussian_blur as j_blur  # noqa: E402
from imagestitch_tpu.ops.image import rgb_to_gray as j_gray  # noqa: E402
from imagestitch_tpu.ops.pyramid import build_pyramid as j_pyramid  # noqa
from imagestitch_tpu_torch.features.orb import (  # noqa: E402
    _cumsum_tiled, detect_and_compute)
from imagestitch_tpu_torch.ops import cuda_detect  # noqa: E402
from imagestitch_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_pair  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(100, 150), (97, 131)]


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, shape)
            + rng.uniform(0, 1, shape)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_maps():
    fn = jax.jit(lambda x: (j_nms(j_fast(x, 20.0)), j_harris(x, 7),
                            j_blur(x, 7, 2.0)))
    return {s: [np.asarray(m) for m in fn(jnp.asarray(_img(s, i)))]
            for i, s in enumerate(SHAPES)}


@pytest.fixture(scope="module")
def pair_feats():
    """JAX and port features of both views of synthetic_pair(192, 256)."""
    i1, i2, _ = synthetic_pair(192, 256)
    jdet = jax.jit(lambda g: j_detect(j_gray(g), JDetectorConfig()))
    out = []
    for im in (i1, i2):
        fj = jdet(jnp.asarray(im, jnp.float32))
        ft = detect_and_compute(rgb_to_gray(torch.as_tensor(im)))
        out.append(({k: np.asarray(getattr(fj, k)) for k in
                     ("xy", "level", "valid", "descriptors", "response",
                      "angle", "size", "img_size")}, ft))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_detect_maps_match_jax_whole_map(jax_maps, shape):
    """Whole maps, borders included: FAST/NMS, Harris and blur all agree
    bit for bit with features/fast.py + ops/image.gaussian_blur."""
    img = torch.as_tensor(_img(shape, SHAPES.index(shape)))
    nms, har, blur = (m[0].numpy() for m in
                      cuda_detect.detect_maps(img[None], 20.0))
    j_nms_, j_har, j_blr = jax_maps[shape]
    assert np.array_equal(nms, j_nms_)
    assert np.array_equal(har, j_har)
    assert np.array_equal(blur, j_blr)
    assert (nms > 0).sum() > 20


def test_plain_detect_maps_batch_matches_single():
    imgs = torch.stack([torch.as_tensor(_img((60, 70), s)) for s in (3, 4)])
    batch = cuda_detect.detect_maps(imgs, 20.0)
    for b in range(2):
        single = cuda_detect.detect_maps(imgs[b:b + 1], 20.0)
        for m_b, m_s in zip(batch, single):
            assert torch.equal(m_b[b], m_s[0])


@pytest.mark.parametrize("threshold", [0.0, 20.0])
@pytest.mark.parametrize("block_size", [3, 5, 7])
@pytest.mark.parametrize("batch", [1, 2])
def test_detect_maps_levels_cpu_matches_plain(batch, block_size, threshold):
    """On CPU tensors the multi-level entry point is the plain version
    level by level, bit for bit: a 5-level 1.3 pyramid of a 97x131 image
    (its smallest levels are smaller than one kernel tile)."""
    imgs = torch.stack([torch.as_tensor(_img((97, 131), 10 + b))
                        for b in range(batch)])
    pyr = [lv.contiguous() for lv in build_pyramid(imgs, 5, 1.3)]
    got = cuda_detect.detect_maps_levels(pyr, threshold, block_size)
    assert len(got) == len(pyr)
    for lv, maps in zip(pyr, got):
        want = cuda_detect.detect_maps_plain(lv, threshold, block_size)
        for m_got, m_want in zip(maps, want):
            assert m_got.shape == lv.shape
            assert torch.equal(m_got, m_want)


def test_plain_detect_maps_match_pallas_interior():
    """Against the TPU kernel itself (interpret mode) on the interior, as
    tests/test_orb.py holds it: its zero-padded halo differs at borders.
    Harris/blur to 2e-6 relative: the TPU kernel's taps are normalized in
    float64 and its sums run in another order."""
    from imagestitch_tpu.ops.pallas_detect import detect_maps as p_detect
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (100, 150)).astype(np.float32)
    pn, ph, pb = (np.asarray(m) for m in
                  p_detect(jnp.asarray(img), 20.0, interpret=True))
    tn, th, tb = (m[0].numpy() for m in
                  cuda_detect.detect_maps(torch.as_tensor(img)[None], 20.0))
    B = 8
    sl = (slice(B, -B), slice(B, -B))
    assert np.array_equal(tn[sl], pn[sl])
    np.testing.assert_allclose(th[sl], ph[sl], rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(tb[sl], pb[sl], rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("width", [7, 16, 17, 117, 256, 300])
def test_cumsum_order_matches_jax(width):
    x = _img((5, width), width) * 0.37
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    assert np.array_equal(_cumsum_tiled(torch.as_tensor(x)).numpy(), ref)


def test_pyramid_matches_jax():
    """Levels agree bit for bit except where the JAX column product fuses
    its two taps (one level shape here): there within 1 ulp."""
    g = _img((192, 256), 9) * 0.9
    jl = jax.jit(lambda x: j_pyramid(x, 5, 1.3))(jnp.asarray(g))
    tl = build_pyramid(torch.as_tensor(g), 5, 1.3)
    exact = 0
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=1.2e-7, atol=0)
        exact += np.array_equal(b.numpy(), a)
    assert exact >= 4


@pytest.mark.parametrize("view", [0, 1])
def test_detect_and_compute_matches_jax(pair_feats, view):
    """Identical keypoints, levels, valid flags and descriptors; responses
    to 1e-6 relative and angles to 1e-4 rad (the angle's moment sums are
    differences of large prefix sums, summed in a slightly different
    order — their last bits differ, not the rounded sample offsets)."""
    j, t = pair_feats[view]
    assert np.array_equal(t.xy.numpy(), j["xy"])
    assert np.array_equal(t.level.numpy(), j["level"])
    assert np.array_equal(t.valid.numpy(), j["valid"])
    assert np.array_equal(t.descriptors.numpy(), j["descriptors"])
    assert np.array_equal(t.size.numpy(), j["size"])
    assert np.array_equal(t.img_size.numpy(), j["img_size"])
    np.testing.assert_allclose(t.response.numpy(), j["response"],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(t.angle.numpy(), j["angle"], atol=1e-4)
    assert int(t.num_valid()) == int(j["valid"].sum()) > 150
