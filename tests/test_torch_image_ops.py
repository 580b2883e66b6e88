"""imagestitch_tpu_torch's Sobel, box filter, erosion, nearest remap and
frame alignment against `imagestitch_tpu` on the CPU.

- `sobel`, `erode`, `remap_nearest`, `shift_to_frame` and
  `union_corner_size`: bit for bit. Sobel's taps are 0, ±1 and 2, so
  every product and partial sum of the two passes is exact in float32 on
  integer images, and the reflect-101 padding is the same; the others
  only select values.
- `box_filter` and `gaussian_blur` (each border: reflect-101, edge,
  zeros, on images smaller than the blur's radius too): bit for bit at
  XLA optimization level 0 (`tests/conftest.py`): the port rounds each
  tap's product and each partial sum in the JAX package's order
  (vertical pass, then horizontal), and pads as `jnp.pad` does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.blend import frame as jframe  # noqa: E402
from imagestitch_tpu.ops import image as jimg  # noqa: E402
from imagestitch_tpu_torch.blend.frame import (  # noqa: E402
    shift_to_frame, union_corner_size)
from imagestitch_tpu_torch.ops.image import (box_filter, erode,  # noqa
                                             gaussian_blur, remap_nearest,
                                             sobel)

torch.set_num_threads(2)


def _img(seed, shape, integer=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, shape)
    return (np.round(x) if integer else x).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 128), (101, 77, 3)])
@pytest.mark.parametrize("d", [(1, 0), (0, 1)])
def test_sobel_bit_for_bit(shape, d):
    x = _img(1, shape)
    want = np.asarray(jimg.sobel(jnp.asarray(x), *d))
    got = sobel(torch.as_tensor(x), *d).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("shape", [(96, 128), (64, 90, 3)])
def test_box_filter_bit_for_bit(ksize, shape):
    x = _img(2, shape, integer=False)
    want = np.asarray(jimg.box_filter(jnp.asarray(x), ksize))
    got = box_filter(torch.as_tensor(x), ksize).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("border", ["reflect", "edge", "constant"])
@pytest.mark.parametrize("shape", [(40, 52), (33, 29, 3), (2, 3), (1, 5, 3)])
def test_gaussian_blur_borders_bit_for_bit(border, shape):
    """The 7x7 σ=2 blur (radius 3) with each `jnp.pad` border; on the 2x3
    and 1x5 images the pad is wider than the image, where "reflect"
    reflects again past the far edge."""
    x = _img(5, shape, integer=False)
    want = np.asarray(jimg.gaussian_blur(jnp.asarray(x), 7, 2.0, border))
    got = gaussian_blur(torch.as_tensor(x), 7, 2.0, border).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ksize", [(3, 3), (4, 7), (20, 20)])
def test_erode_bit_for_bit(ksize):
    x = _img(3, (96, 128), integer=False)
    m = (np.random.default_rng(4).uniform(size=(96, 128)) > 0.2)
    for src in (x, m.astype(np.float32)):
        want = np.asarray(jimg.erode(jnp.asarray(src), ksize))
        got = erode(torch.as_tensor(src), ksize).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 3])
def test_remap_nearest_bit_for_bit(channels):
    """Maps that reach past every border and land on half-integers
    (both packages round half to even)."""
    shape = (60, 80) if channels is None else (60, 80, channels)
    img = _img(5, shape, integer=False)
    rng = np.random.default_rng(6)
    xm = rng.uniform(-3, 83, (50, 70)).astype(np.float32)
    ym = rng.uniform(-3, 63, (50, 70)).astype(np.float32)
    xm[::7, ::5] = np.round(xm[::7, ::5]) + 0.5
    ym[::3, ::4] = np.round(ym[::3, ::4]) - 0.5
    oj, vj = jimg.remap_nearest(jnp.asarray(img), jnp.asarray(xm),
                                jnp.asarray(ym), border_value=7.0)
    ot, vt = remap_nearest(torch.as_tensor(img), torch.as_tensor(xm),
                           torch.as_tensor(ym), border_value=7.0)
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    assert np.array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("offset", [(5, -7), (-12, 3), (0, 0), (200, 0)])
def test_shift_to_frame_bit_for_bit(offset):
    src = _img(7, (48, 64, 3), integer=False)
    sc = np.asarray([10 + offset[0], 20 + offset[1]], np.int32)
    dc = np.asarray([10, 20], np.int32)
    want = np.asarray(jframe.shift_to_frame(
        jnp.asarray(src), jnp.asarray(sc), jnp.asarray(dc), (40, 70),
        fill=-1.0))
    got = shift_to_frame(torch.as_tensor(src), torch.as_tensor(sc),
                         torch.as_tensor(dc), (40, 70), fill=-1.0).numpy()
    assert np.array_equal(got, want)


def test_union_corner_size_equal():
    corners = np.asarray([[3, -4], [-10, 7], [25, 0]], np.int32)
    sizes = np.asarray([[50, 40], [20, 30], [60, 10]], np.int32)
    lj, sj = jframe.union_corner_size(jnp.asarray(corners),
                                      jnp.asarray(sizes))
    lt, st = union_corner_size(torch.as_tensor(corners),
                               torch.as_tensor(sizes))
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
